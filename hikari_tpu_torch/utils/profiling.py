"""Profiling helpers (port of ``hikari_tpu/utils/profiling.py``): a device
trace, a median timer and per-stage wall clocks of a scene.

Timing synchronises the card once per repetition of chained calls
(``torch.cuda.synchronize``); on the CPU the calls are synchronous.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the block with torch.profiler (the CPU, and the card when
    there is one) and write a Chrome trace, viewable in Perfetto, to
    log_dir/trace_<pid>_<ns>.json:

        with profiling.trace("traces"):
            film = hk.render(vp, scene, cam)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def time_fn(fn, *args, iters: int = 4, reps: int = 3) -> float:
    """Median seconds per call of fn(*args) over `reps` repetitions of
    `iters` chained calls, after one warm-up call; one synchronisation per
    repetition."""
    fn(*args)
    _sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        _sync()
        ts.append((time.perf_counter() - t0) / iters)
    return sorted(ts)[len(ts) // 2]


def stage_timings(scene, camera, vp=None, filt=None, **time_kw) -> dict:
    """Per-stage wall clock of a scene, in seconds: one sample of the whole
    frame through render_lanes ("step"), and the closest-hit and any-hit
    traversals of the pixel-centre primary rays ("closest_primary",
    "anyhit_primary", the latter to t = 4). time_kw: time_fn's iters /
    reps."""
    from ..film.filters import make_filter
    from ..integrators.volpath import (VolPath, pixel_centre_rays, render_lanes,
                                       scene_any_hit, scene_closest_hit)

    if vp is None:
        vp = VolPath(max_depth=5, samples_per_pixel=16)
    if filt is None:
        filt = make_filter()
    w, h = camera.resolution
    n = w * h
    dev = scene.device
    lanes = torch.arange(n, device=dev)
    px, py = lanes % w, lanes // w
    o, d = pixel_centre_rays(camera, dev)
    return {
        "step": time_fn(lambda si: render_lanes(vp, scene, camera, filt, si, px, py)[0], 1,
                        **time_kw),
        "closest_primary": time_fn(lambda o, d, t: scene_closest_hit(scene, o, d, t).t, o, d,
                                   torch.full((n,), 3.0e37, device=dev), **time_kw),
        "anyhit_primary": time_fn(lambda o, d, t: scene_any_hit(scene, o, d, t), o, d,
                                  torch.full((n,), 4.0, device=dev), **time_kw),
    }
