"""Profiling helpers (port of ``hikari_tpu/utils/profiling.py``): a device
trace, a median timer and per-stage wall clocks of a scene; and the
program's own spans and counters.

Timing synchronises the card once per repetition of chained calls
(``torch.cuda.synchronize``); on the CPU the calls are synchronous.

Spans and counters record whenever a torch profiler is recording
(``torch.autograd._profiler_enabled()``): inside ``trace``, and inside any
``torch.profiler.profile``. With the profiler off a span or a count costs
one branch and records nothing; there is no other switch. The record holds
everything since the process started or since ``reset()``; ``trace``
starts a fresh one, and ``recorded()`` reads it:

    with profiling.trace("traces"):
        film = hk.render(vp, scene, cam)
    rec = profiling.recorded()
    rec["spans"]["hikari.sampler"]["self_ms"]  # on the card's timeline
    rec["counters"]["host_syncs"]["sites"]     # {"pair_list.live": 10, ...}

A span (``spanned``, a decorator: each call of the function) keeps its
name, its parent, attributes, its host clock (``time.perf_counter_ns``) at
entry and exit and, where the card is in use, a CUDA event at entry and at
exit on the current stream, which is the stream the program's kernels run
on. It is also a profiler range of the same name (a function-scope
``RecordFunction``), so the profiler's trace shows which span the host was
in when the card went idle. The card's timeline of a span runs from when
the card reached its entry event to when it reached its exit event, so it
follows whichever side binds: the kernels where the card is busy, the
host's enqueueing where it waits. A span's self time is its interval less
the intervals of its children; on one stream the self times of a tree add
up to its root's interval.

Counters are counted where the work happens, under the innermost open span
and a site name: ``count`` takes a host number or a tensor, summed on its
own device without a sync until ``recorded()``; ``host_sync`` counts one
place where the host waits for the card. The spans of the render path:

| span | where | layer |
|---|---|---|
| ``hikari.render`` | ``render_sample``, ``render_preview`` (roots) | integrator and film |
| ``hikari.lanes``, ``hikari.bounce`` | ``render_lanes``, ``_preview_lanes``; ``_bounce_core`` (attribute ``depth``) | integrator and film |
| ``hikari.film`` | ``film_add_weighted``, ``film_add_sample``, ``framebuffer`` | integrator and film |
| ``hikari.sampler`` | ``make_zsobol``, ``compute_pixel_sample``, ``path_sample_1d`` / ``_2d`` | sampler |
| ``hikari.shading`` | ``_surface_data``, the BSDF dispatches, ``emitted_radiance`` | shading |
| ``hikari.lights`` | light selection, ``sample_li``, ``env_radiance``, ``area_light_pdf`` | lights |
| ``hikari.traversal`` | ``scene_closest_hit``, ``scene_any_hit`` | traversal driver |
| ``hikari.sweep`` | the four sweep wrappers of ``sweep.py`` / ``sweep_pairs.py`` | kernels |

Counters: ``host_syncs`` (by site), ``pairs_listed`` and ``lanes_swept``
(per sweep: the pair list's length; the live prefix swept and the input
lanes) and ``rays_traced`` (the device sums of ``render_lanes`` and the
preview's lanes). Which path ran, a hand-written kernel or its plain
version, is not a counter here: the package's always-on launch record
(``hikari_tpu_torch._build.launches`` and ``plain_cuda_runs``) keeps it.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import os
import time
from collections import defaultdict

import torch

_profiler_enabled = torch.autograd._profiler_enabled
# a function-scope range: a user-scope one (torch.profiler.record_function)
# also puts a gpu_user_annotation over its kernels on the device's timeline,
# which a reader of device busy time would count as work
_Range = torch._C._profiler._RecordFunctionFast


def _on_card() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _sync():
    if _on_card():
        torch.cuda.synchronize()


class _Span:
    __slots__ = ("name", "parent", "attrs", "t0", "t1", "e0", "e1", "rng")

    def __init__(self, name, parent, attrs):
        self.name, self.parent, self.attrs = name, parent, attrs
        self.t1 = self.e0 = self.e1 = None


class _Record:
    def __init__(self):
        self.spans = []      # _Span, in entry order (a parent before its children)
        self.stack = []      # open spans
        self.counts = defaultdict(float)   # (counter, span, site) -> host sum
        self.tensors = {}    # (counter, span, site, device) -> 0-dim float64 tensor


_REC = _Record()


def reset():
    """Drop everything recorded so far."""
    global _REC
    _REC = _Record()


def recording() -> bool:
    """True while a torch profiler records, and so do spans and counters."""
    return _profiler_enabled()


def _enter(name, attrs) -> _Span:
    rec = _REC
    sp = _Span(name, rec.stack[-1] if rec.stack else None, attrs)
    sp.t0 = time.perf_counter_ns()
    sp.rng = _Range(name)
    sp.rng.__enter__()
    if _on_card():
        sp.e0 = torch.cuda.Event(enable_timing=True)
        sp.e0.record()
    rec.spans.append(sp)
    rec.stack.append(sp)
    return sp


def _exit(sp: _Span):
    if sp.e0 is not None:
        sp.e1 = torch.cuda.Event(enable_timing=True)
        sp.e1.record()
    sp.rng.__exit__(None, None, None)
    sp.t1 = time.perf_counter_ns()
    stack = _REC.stack
    if stack and stack[-1] is sp:
        stack.pop()


def spanned(name: str, attrs: tuple = ()):
    """Decorator: each call of the function is a span `name`, with the
    arguments named in `attrs` as its attributes, while the profiler
    records."""

    def deco(fn):
        sig = inspect.signature(fn) if attrs else None

        @functools.wraps(fn)
        def wrapped(*args, **kw):
            if not _profiler_enabled():
                return fn(*args, **kw)
            got = {}
            if sig is not None:
                bound = sig.bind(*args, **kw).arguments
                got = {a: bound[a] for a in attrs if a in bound}
            sp = _enter(name, got)
            try:
                return fn(*args, **kw)
            finally:
                _exit(sp)

        return wrapped

    return deco


def count(name: str, value, site: str):
    """Add `value` (a number, or a tensor summed on its own device without
    a host sync) to counter `name` at `site`, under the innermost open
    span, while the profiler records."""
    if not _profiler_enabled():
        return
    rec = _REC
    owner = rec.stack[-1].name if rec.stack else None
    if isinstance(value, torch.Tensor):
        v = value.detach().to(torch.float64)
        key = (name, owner, site, str(v.device))
        prev = rec.tensors.get(key)
        rec.tensors[key] = v if prev is None else prev + v
    else:
        rec.counts[(name, owner, site)] += value


def host_sync(site: str, device=None):
    """Count one place where the host waits for the card: a value read to
    the host or a compaction whose size the host needs (counted on every
    device, as the same site), or a copy between host memory and the card.
    device: where a copy of host data goes; none is counted when that is
    the CPU."""
    if not _profiler_enabled():
        return
    if device is not None and torch.device(device).type == "cpu":
        return
    count("host_syncs", 1, site)


def recorded() -> dict:
    """Aggregates of the record, after one synchronisation:

    spans: {name: {calls, total_ms, self_ms, host_total_ms, host_self_ms,
        parents: {parent name or None: calls}, by: {"depth=0": {calls, ...}}}},
        ``*_ms`` summed over the calls; total is the span's interval, self
        the interval less its children's; the plain ones on the card's
        timeline (None where a span of the name had no CUDA events), the
        ``host_`` ones on the host's clock; ``by`` splits a span with
        attributes by their values;
    roots: {calls, ms, host_ms}, the root spans' intervals summed;
    counters: {name: {total, sites: {site: v}, spans: {span: v}}}."""
    rec = _REC
    done = [s for s in rec.spans if s.t1 is not None]
    if any(s.e0 is not None for s in done) or rec.tensors:
        _sync()
    host, card = {}, {}
    for s in done:
        host[s] = (s.t1 - s.t0) * 1e-6
        card[s] = s.e0.elapsed_time(s.e1) if s.e1 is not None else None
    child_host, child_card = defaultdict(float), defaultdict(float)
    for s in done:
        if s.parent is not None and s.parent in host:
            child_host[s.parent] += host[s]
            if card[s] is not None:
                child_card[s.parent] += card[s]

    def add(into, key, s):
        a = into.setdefault(key, {"calls": 0, "total_ms": 0.0, "self_ms": 0.0,
                                  "host_total_ms": 0.0, "host_self_ms": 0.0})
        a["calls"] += 1
        a["host_total_ms"] += host[s]
        a["host_self_ms"] += host[s] - child_host[s]
        if card[s] is None or a["total_ms"] is None:
            a["total_ms"] = a["self_ms"] = None
        else:
            a["total_ms"] += card[s]
            a["self_ms"] += card[s] - child_card[s]
        return a

    spans, roots = {}, {"calls": 0, "ms": 0.0, "host_ms": 0.0}
    for s in done:
        a = add(spans, s.name, s)
        parent = s.parent.name if s.parent is not None else None
        a.setdefault("parents", defaultdict(int))[parent] += 1
        if s.attrs:
            add(a.setdefault("by", {}), ",".join(f"{k}={v}" for k, v in s.attrs.items()), s)
        if s.parent is None or s.parent not in host:
            roots["calls"] += 1
            roots["host_ms"] += host[s]
            roots["ms"] = None if card[s] is None or roots["ms"] is None else roots["ms"] + card[s]
    for a in spans.values():
        a["parents"] = dict(a["parents"])
    values = dict(rec.counts)
    by_device = defaultdict(list)
    for key, t in rec.tensors.items():
        by_device[key[3]].append((key[:3], t))
    for items in by_device.values():
        for (key, _), v in zip(items, torch.stack([t for _, t in items]).tolist()):
            values[key] = values.get(key, 0.0) + v
    counters = {}
    for (name, owner, site), v in values.items():
        c = counters.setdefault(name, {"total": 0.0, "sites": defaultdict(float),
                                       "spans": defaultdict(float)})
        c["total"] += v
        c["sites"][site] += v
        c["spans"][owner] += v
    for c in counters.values():
        c["sites"], c["spans"] = dict(c["sites"]), dict(c["spans"])
    return {"spans": spans, "roots": roots, "counters": counters}


def idle_by_span(prof) -> dict:
    """The card's idle time in a finished torch.profiler trace, by the
    innermost span of the record the host was in at the middle of each gap
    between the card's operations: {"busy_s", "window_s" (first operation
    to last), "idle_s": {span name or None (outside every span): s}}."""
    from torch.autograd import DeviceType

    names = {s.name for s in _REC.spans}
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            dev.append((start, end))
        elif e.device_type() == DeviceType.CPU and e.name() in names:
            host.append((start, end, e.name()))
    merged = []
    for s, e in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    idle = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) // 2
        inner = max((h for h in host if h[0] <= mid < h[1]), default=None)
        idle[inner[2] if inner else None] += (b - a) * 1e-9
    return {"busy_s": sum(e - s for s, e in merged) * 1e-9,
            "window_s": (merged[-1][1] - merged[0][0]) * 1e-9 if merged else 0.0,
            "idle_s": dict(idle)}


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the block with torch.profiler (the CPU, and the card when
    there is one) and write a Chrome trace, viewable in Perfetto, to
    log_dir/trace_<pid>_<ns>.json. The program's spans and counters start
    a fresh record, which ``recorded()`` reads afterwards:

        with profiling.trace("traces"):
            film = hk.render(vp, scene, cam)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
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
