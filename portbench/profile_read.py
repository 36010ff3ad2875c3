"""What a torch.profiler trace of the window says about the device: the
seconds some operation ran on it (the union of its operations' intervals),
the launches, the operations that took most time, and the longest idle
gaps labelled by what the host was doing (the innermost host operation
running at the gap's middle). DeviceClock: the device's busy seconds
alone over a whole window, from a profiler that records no host
operation (device_ms)."""

from __future__ import annotations

import heapq
import sys
from collections import defaultdict

import numpy as np
from torch.autograd import DeviceType

TOP = 10


def _events(prof):
    """(device, host) lists of (start_ns, end_ns, name)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        rec = (start, start + dur, e.name())
        if e.device_type() == DeviceType.CUDA:
            dev.append(rec)
        elif e.device_type() == DeviceType.CPU and dur > 0:
            host.append(rec)
    return dev, host


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _labels(host, gaps):
    """The innermost host event covering each gap's middle, in one sweep:
    host events enter a heap keyed by their start as the middles pass
    them, and leave once they end before the middle."""
    host.sort()
    out, heap, j = {}, [], 0
    for mid in sorted(s + g // 2 for g, s in gaps):
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(heap, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        out[mid] = heap[0][2] if heap else "host between operations"
    return out


def read(prof, window_s: float) -> dict | None:
    """busy_s, window_s, launches and the breakdown lists, or None when the
    trace holds no device operation (a CPU run)."""
    dev, host = _events(prof)
    if not dev:
        return None
    merged = _merge([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in merged) * 1e-9
    by_name = defaultdict(float)
    for s, e, name in dev:
        by_name[name[:160]] += (e - s) * 1e-9
    gaps = [(merged[k + 1][0] - merged[k][1], merged[k][1]) for k in range(len(merged) - 1)]
    labels = _labels(host, gaps)
    by_host = defaultdict(float)
    for g, s in gaps:
        by_host[labels[s + g // 2][:160]] += g * 1e-9
    launches = sum(1 for _, _, name in dev if not name.startswith(("Memcpy", "Memset")))
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": busy_s, "window_s": window_s, "launches": launches,
            "device_ops": top(by_name), "idle_gaps": top(by_host)}


def union_s(starts_ns, ends_ns) -> float:
    """Seconds covered by the union of [start, end] intervals (touching
    intervals merge, as in _merge)."""
    s, e = np.asarray(starts_ns, np.int64), np.asarray(ends_ns, np.int64)
    if s.size == 0:
        return 0.0
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)
    first = np.flatnonzero(np.concatenate(([True], s[1:] > reach[:-1])))
    return float((np.maximum.reduceat(e, first) - s[first]).sum()) * 1e-9


class DeviceClock:
    """The card's busy seconds over a stretch of the run: a profiler that
    records the device's operations alone (no host operation), and the
    union of their intervals, read once the stretch is over."""

    def __enter__(self):
        import torch

        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        import time

        t0 = time.perf_counter()
        self.prof.__exit__(*exc)
        self.stop_s = time.perf_counter() - t0

    def busy_s(self) -> float:
        import time

        t0 = time.perf_counter()
        starts, ends = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                start = e.start_ns()
                starts.append(start)
                ends.append(start + e.duration_ns())
        del self.prof
        busy = union_s(starts, ends)
        print(f"[portbench] device clock: {len(starts)} device operations, busy {busy:.6f} s, "
              f"profiler stop {self.stop_s:.3f} s, read {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)
        return busy
