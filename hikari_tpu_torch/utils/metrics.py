"""Render observability: per-sample throughput and progress reporting.

Port of ``hikari_tpu/utils/metrics.py``: ``RenderMeter`` accumulates wall
clock and traced rays per lap (a lap ends where the caller has waited for
the card, e.g. after reading a framebuffer), and ``time_device_fn`` times
a function on the card with CUDA events.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import torch


@dataclass
class RenderMeter:
    """Accumulates per-sample wall clock and traced-ray counts."""

    samples: int = 0
    rays: float = 0.0
    seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def lap(self, rays_traced: float) -> dict:
        now = time.perf_counter()
        dt = now - self._t0
        self._t0 = now
        self.samples += 1
        self.rays += float(rays_traced)
        self.seconds += dt
        return {"sample": self.samples, "sec": round(dt, 3),
                "mray_s": round(float(rays_traced) / max(dt, 1e-9) / 1e6, 3)}

    @property
    def mray_s(self) -> float:
        return self.rays / max(self.seconds, 1e-9) / 1e6

    def summary(self) -> dict:
        return {"samples": self.samples, "total_rays": int(self.rays),
                "seconds": round(self.seconds, 2), "mray_s": round(self.mray_s, 3)}

    def report(self) -> str:
        return json.dumps(self.summary())


def time_device_fn(fn, *args, iters: int = 5) -> float:
    """Seconds per call of fn(*args) on the card: one warm-up call, then
    `iters` calls between two CUDA events. Without a card this raises: a
    CPU time is no device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_device_fn needs a CUDA device")
    fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters
