#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port (hikari_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits nonzero without its result line:

1. device: the card's name, torch and CUDA versions, and nvidia-smi's name
   and power limit;
2. build: csrc/sweep_tiles.cu (flat tile sweeps K1/K2) and
   csrc/sweep_pairs.cu (pair-grid sweeps K5/K6), both instantiations of the
   shared body csrc/sweep_grid.cuh, and csrc/sweep_inst.cu (instanced
   sweeps K3/K4), one nvcc each, started together; K1-K6's registers a
   thread, spilled bytes and resident blocks per SM as the CUDA runtime
   reports them;
3. kernels vs plain: the camera, first-bounce and first-bounce NEE
   wavefronts of a 256x256 render of each scene go through each kernel and
   its plain PyTorch version on the same CUDA tensors. Flat scenes: default
   (61,450 triangles) and mesh (327,680), each wavefront through both the
   tile kernels (K1/K2) and the pair-grid kernels (K5/K6) on the same pair
   list, with K5 against K1 printed for information; tr and column must
   agree on >= 99.9% of live lanes, t within 1e-5 relative where they
   agree; K2's and K6's flags must equal the plain version's bit for bit.
   Where a flat kernel's output is not bit-equal, the plain hits that its
   pre-test would refuse are counted with the pre-test's PyTorch mirror (a
   diagnostic).
   Instanced scenes: the default scene with its spheres instanced, and the
   400-tree forest; tri must agree on >= 99.9% of live lanes, t within 1e-5
   relative and b1 / b2 within 1e-4 where it agrees.
   Occlusion flags on >= 99.9%. Every line gives the microseconds per
   listed pair and whether every output equals the plain version's bit for
   bit. Per scene, the kernels' pre-test run alone on the card
   (sweep.pretest_grid, sweep_inst.pretest_inst) must equal its PyTorch
   mirror bit for bit on listed pairs of the camera and NEE wavefronts and
   on grazing rays at the scene's triangles, and the mirror must refuse
   none of those rays' plain hits;
4. transport probes: the 64x64 probes of the default and mesh scenes
   against tools/transport_ref.json (rays within 0.5%, mean RGB within 2%);
   the default probe again under each mode of the main path: pair-grid
   sweep, banded closest hit, reversed shadows, gated and sorted material
   dispatch, resident loop, three depth segments; the instanced default
   scene against the flat one at 64x64, depth 5, 4 spp averaged, with the
   same tolerances;
5. main paths: render(VolPath(max_depth=5, samples_per_pixel=4)) at
   800x800 through the public API of the default scene (tile kernels), the
   default scene in pair-grid mode (K5/K6), the default scene with every
   switch on (pair grid, band, reversed shadows, sorted dispatch, resident
   loop; K5/K6), the instanced default scene and the forest (instanced
   kernels), each with the launch counts reset just before and read just
   after; the image must be finite and not black, the path's two kernels
   must have launched, and no other sweep, kernel or plain, may have run.
   Then each switch of the all-modes path alone on the pair grid, timed
   only;
6. timings: each kernel's wrapper call (pair_schedule and scratch
   included) against its plain version on every sweep call of its main
   path's first wavefront (one per bounce), summed per render beside the
   depth-0 call, and the tile kernels K1/K2 on the pair-grid path's
   depth-0 pair lists, so the two decompositions are compared on the same
   work, with K5's and K6's time over K1's and K2's. Each kernel's bound is
   reckoned from the ray-triangle tests its plain version needs on those
   inputs (see BOUND below); where a call's plain walk would take longer
   than PLAIN_CALL_S, only the kernel is timed, the record's sum of plain
   times is null, and a closest sweep's tests are counted from the
   kernel's final carry instead (sweep.tests_from_final, at most the
   walk's count; printed beside it wherever the walk runs), which the
   record names in "bound_tests".

The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}. It needs no network and one card; the
kernels are built into hikari_tpu_torch/build/ on first use.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
AGREE_MIN = 0.999   # tr/column (tri) and occlusion agreement, kernel vs plain
T_RTOL = 1e-5       # t where tr and column (tri) agree
B_ATOL = 1e-4       # instanced b1 / b2 where tri agrees
MAIN_RES = 800
MAIN_SPP = 4
PROBE_SPP = 4
BAND_FRAC = 0.15    # banded closest hit: band = 0.15 x the world diagonal
# phase 6 runs a kernel's plain version on a bounce's call only while that
# run is expected to stay under this many seconds (the longest, K3's at the
# instanced default scene's first bounce, takes ~36 s); the call's kernel is
# timed all the same.
PLAIN_CALL_S = 45.0
# phase 3's pre-test check: listed pairs of each wavefront, and treelets
# whose triangles the grazing rays aim at (four triangles each)
PRETEST_PAIRS = 48
PRETEST_TREELETS = 16

# BOUND: the least time the card could take for a sweep, the larger of its
# bytes (each tensor argument read once, each output written once) over
# the memory rate and its operations over the FP32 rate. Operations: the
# ray-triangle tests that the plain version's walk needs on these inputs
# (TREELET per lane that the treelet could still improve, for every pair
# it sweeps) times the FLOP of one test: the affine form's t, u and v are
# 38 FLOP of multiplies and adds, plus the divide and u + v at one FLOP
# each (flat); the instanced form dots four components (48 FLOP) and moves
# each lane into object space once per pair (44 FLOP per lane and pair).
# Compares are not counted. Published H100 SXM peaks at 700 W.
PEAK_FLOPS = 67e12   # FP32, outside the tensor cores
PEAK_BYTES = 3.35e12
TEST_FLOP = {"flat": 40, "inst": 48}
INST_LANE_PAIR_FLOP = 44


def log(*args):
    print(*args, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Recorder:
    """Wraps the sweep entry points a traversal module calls, keeping the
    arguments of every call so the same inputs can be replayed."""

    def __init__(self, module, names):
        self.module = module
        self.calls = {name: [] for name in names}
        self.orig = {name: getattr(module, name) for name in names}

    def __enter__(self):
        for name, orig in self.orig.items():
            def wrapped(*args, _orig=orig, _name=name):
                self.calls[_name].append(args)
                return _orig(*args)

            setattr(self.module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, orig in self.orig.items():
            setattr(self.module, name, orig)


@contextlib.contextmanager
def switched(module, **attrs):
    """Set module attributes (the traversal switches) for a block."""
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


SOURCES = {"tiles": "sweep_tiles.cu", "inst": "sweep_inst.cu", "pairs": "sweep_pairs.cu"}


def kernel_and_plain(name):
    from hikari_tpu_torch.geometry import sweep, sweep_inst, sweep_pairs

    module = {"tiles": sweep, "inst": sweep_inst, "pairs": sweep_pairs}[name.split("_")[1]]
    return getattr(module, name), getattr(module, name + "_plain")


def bound(name, args, out, stats):
    """(bound ms, what sets it) of one sweep call: see BOUND."""
    import torch

    outs = out if isinstance(out, tuple) else (out,)
    n_bytes = sum(x.numel() * x.element_size() for x in (*args, *outs)
                  if isinstance(x, torch.Tensor))
    if name.endswith("_inst"):
        flop = (stats["tests"] * TEST_FLOP["inst"]
                + stats["tests"] // 256 * INST_LANE_PAIR_FLOP)
    else:
        flop = stats["tests"] * TEST_FLOP["flat"]
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flop / PEAK_FLOPS
    return max(t_bytes, t_ops) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def same_lanes(name, args, out_a, out_b):
    """(same, live) masks of two results of sweep `name` on inputs `args`:
    where the winner (flat: treelet and column; instanced: tri) or the
    occlusion flag is equal, and the lanes that entered with a reach."""
    from hikari_tpu_torch.geometry.sweep import COL_MASK

    if name in ("closest_tiles", "closest_pairs"):
        (key_a, tr_a), (key_b, tr_b) = out_a, out_b
        return ((tr_a == tr_b) & ((key_a & COL_MASK) == (key_b & COL_MASK)),
                (args[2] & ~COL_MASK) > 0)
    if name == "closest_inst":
        return out_a[1] == out_b[1], args[2] > 0.0
    return out_a == out_b, args[2] > 0.0


def compare(name, args, tl=None, reps=10):
    """Kernel vs plain on one captured input; returns a result dict. tl:
    the flat treelets (the flat closest sweeps resolve t from their rows).
    reps: timed calls of the kernel after a warm-up call; the plain version
    runs once, timed."""
    import torch
    from hikari_tpu_torch.geometry.wavefront import _resolve_hits

    kernel, plain = kernel_and_plain(name)
    out_k = kernel(*args)
    stats = {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out_p = plain(*args, stats=stats)
    end.record()
    torch.cuda.synchronize()
    o, d = args[0], args[1]
    n = o.shape[0]
    b_err = 0.0
    same, live = same_lanes(name, args, out_k, out_p)
    if name in ("closest_tiles", "closest_pairs"):
        (key_k, tr_k), (key_p, tr_p) = out_k, out_p
        t_k = _resolve_hits(tl, key_k, tr_k, o, d)[0]
        t_p = _resolve_hits(tl, key_p, tr_p, o, d)[0]
        hit_k = tr_k >= 0
    elif name == "closest_inst":
        (t_k, tri_k, b1_k, b2_k), (t_p, _, b1_p, b2_p) = out_k, out_p
        hit_k = tri_k >= 0
        both = same & live & hit_k
        if both.any():
            b_err = max(float((b1_k - b1_p).abs()[both].max()),
                        float((b2_k - b2_p).abs()[both].max()))
    else:
        hit_k = out_k > 0
    agree = float(same[live].float().mean()) if live.any() else 1.0
    if name.startswith("closest"):
        both = same & live & hit_k
        dt = (t_k - t_p).abs()[both]
        err = float(dt.max()) if both.any() else 0.0
        rel = float((dt / t_p.abs()[both].clamp(min=1e-12)).max()) if both.any() else 0.0
        t_ok = bool((dt <= T_RTOL * t_p.abs()[both]).all())
        ok = agree >= AGREE_MIN and t_ok and b_err <= B_ATOL
    else:
        err = float((out_k - out_p).abs().max()) if n else 0.0
        rel = 0.0
        ok = agree >= AGREE_MIN
    outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
    outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
    exact = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(outs_k, outs_p))
    if name in ("occlusion_tiles", "occlusion_pairs"):  # exact (csrc/sweep_grid.cuh)
        ok = exact
    # the wrapper call, pair_schedule and scratch included
    ms_k = cuda_ms(lambda: kernel(*args), reps)
    ms_p = start.elapsed_time(end)
    tre = args[3] if name == "closest_inst" else args[4]
    bound_ms, bound_by = bound(name, args, out_k, stats)
    return dict(ok=ok, agree=agree, exact=exact, max_abs_err=err, max_rel_err=rel,
                b_err=b_err, lanes=n, live=int(live.sum()), pairs=int(tre.numel()),
                swept=stats["pairs"], tests=stats["tests"],
                hits=int(hit_k[live].sum()), ms=ms_k, plain_ms=ms_p, bound_ms=bound_ms,
                bound_by=bound_by, out=out_k)


def kernel_attributes() -> dict:
    """{kernel: (registers, spilled bytes, resident blocks per SM)} of the
    six sweep kernels."""
    from hikari_tpu_torch.geometry import sweep, sweep_inst, sweep_pairs

    return {**sweep.kernel_attributes(), **sweep_inst.kernel_attributes(),
            **sweep_pairs.kernel_attributes()}


def detail(name, r) -> str:
    """Microseconds per listed pair and whether every output equals the
    plain version's bit for bit; registers, spills and resident blocks per
    SM where the kernel's library reports them."""
    attrs = kernel_attributes().get(name)
    occupancy = ("" if attrs is None else
                 f"{attrs[0]} registers, {attrs[1]} B spilled, {attrs[2]} blocks/SM, ")
    per_pair = r["ms"] * 1e3 / max(r["pairs"], 1)
    return (f", {occupancy}{per_pair:.3f} us per listed pair, "
            f"bit-equal {'yes' if r['exact'] else 'no'}")


def flat_hit_test(name):
    """The plain hit test of a flat sweep kernel: K1/K2's or K5/K6's."""
    from hikari_tpu_torch.geometry import sweep, sweep_pairs

    return sweep_pairs._block_hit_pairs if name.endswith("_pairs") else sweep._block_hit


def pretest_line(label, what, name, args) -> str:
    """The plain hits of every listed pair of a flat wavefront that the grid
    kernels' pre-test would refuse, by its PyTorch mirror."""
    from hikari_tpu_torch.geometry import sweep

    o, d, bound_arg, _, tre, _, seg, coef = args
    if name.startswith("closest"):  # the carried key's t rounded up
        t_far = (bound_arg | sweep.COL_MASK).view(o.dtype)
    else:
        t_far = bound_arg
    hits, drops = sweep.pretest_drops(o, d, t_far, tre, seg, coef, flat_hit_test(name))
    return (f"[kernels] {label} {what}: the pre-test of {name} would refuse {drops} of "
            f"{hits} plain hits in {tre.numel()} listed pairs")


def compare_wavefronts(label, sc, cam, module, names, tl, smi, failures, also=()):
    """Kernels vs plain on the camera, bounce-1 and bounce-1 NEE wavefronts
    of a 256x256 render of `sc`. also: (closest, occlusion) kernel names
    with the same signatures run on the same captured inputs too, the
    closest one also held against the first closest kernel."""
    import torch
    import hikari_tpu_torch as hk
    from hikari_tpu_torch.integrators.volpath import render_lanes

    res = cam.resolution[0]
    lanes = torch.arange(res * res, device=sc.device)
    with Recorder(module, names) as rec:
        render_lanes(hk.VolPath(max_depth=2, samples_per_pixel=1), sc, cam,
                     hk.make_filter(), 0, lanes % res, lanes // res)
    closest, occlusion = names
    cases = [("camera rays", closest, rec.calls[closest][0]),
             ("bounce 1", closest, rec.calls[closest][1]),
             ("bounce 1 NEE", occlusion, rec.calls[occlusion][1])]
    if also:
        cases += [(what, also[names.index(name)], args) for what, name, args in cases]
    first = {}
    for what, name, args in cases:
        r = compare(name, args, tl)
        b = f", b1/b2 max abs err {r['b_err']:.2e}" if name == "closest_inst" else ""
        log(f"[kernels] {label} {what}: {name} agree {r['agree']:.6f} "
            f"(lanes {r['lanes']}, live {r['live']}, pairs {r['pairs']}, swept "
            f"{r['swept']}, hits {r['hits']}), t max rel err {r['max_rel_err']:.2e}{b}, "
            f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms{detail(name, r)} [{smi}] -> "
            f"{'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            failures.append(f"{label} {what} {name}")
        if not name.endswith("_inst") and not r["exact"]:  # diagnostic: the pre-test?
            log(pretest_line(label, what, name, args))
        if name == closest:
            first[what] = r["out"]
        elif also and name == also[0]:
            same, live = same_lanes(name, args, first[what], r["out"])
            log(f"[kernels] {label} {what}: {name} vs {closest} on the same pair list "
                f"agree {float(same[live].float().mean()):.6f} (for information)")
    return cases[:3]


def object_triangles(rows, a):
    """World-space [p0 | e1 | e2] (K, 9) of coefficient rows (K, 12) (the
    affine form [n | dw], [a_u | b_u], [a_v | b_v]: the points where u, v
    are (0, 0), (1, 0), (0, 1) on the plane) seen through the instance
    matrix a (4, 4; [o, 1] @ a is the object-space point; identity for a
    flat scene)."""
    import numpy as np

    rows = rows.astype(np.float64)
    m = np.stack([rows[:, 0:3], rows[:, 4:7], rows[:, 8:11]], 1)
    base = -rows[:, [3, 7, 11]]
    p = [np.linalg.solve(m, (base + np.array(e, np.float64))[..., None])[..., 0]
         for e in ((0, 0, 0), (0, 1, 0), (0, 0, 1))]
    inv = np.linalg.inv(a.astype(np.float64))
    w = [(np.concatenate([q, np.ones((len(q), 1))], 1) @ inv)[:, :3] for q in p]
    return np.concatenate([w[0], w[1] - w[0], w[2] - w[0]], 1).astype(np.float32)


def pretest_check(label, sc, cases, smi, failures):
    """Phase 3, per scene: the kernels' pre-test alone on the card
    (sweep.pretest_grid for a flat scene, sweep_inst.pretest_inst for an
    instanced one) against its PyTorch mirror, mask for mask, on
    PRETEST_PAIRS listed pairs of each wavefront in `cases` (the far limit:
    a closest carry's t, an occlusion reach) and on sweep.grazing_rays at
    four triangles of each of PRETEST_TREELETS treelets (the far limit 1e-5
    behind the point aimed at); and the plain hits of those grazing rays
    that the mirror refuses (each flat hit test, or the instanced one)."""
    import numpy as np
    import torch
    from hikari_tpu_torch.geometry import sweep, sweep_inst

    inst = sc.has_instances
    dev = sc.device

    def masks(o, d, t_far, coef, a):
        if inst:
            k = sweep_inst.pretest_inst(o, d, t_far, coef, a).bool()
            m = sweep_inst.may_hit_plain(o[None], d[None], a[None], coef[None], t_far[None])[0]
        else:
            k = sweep.pretest_grid(o, d, t_far, coef).bool()
            m = sweep.may_hit_plain(o[None], d[None], coef[None], t_far[None])[0]
        return int((k != m).sum()), k.numel(), m

    def treelet(wt):
        """(coef (256, 12), instance matrix (4, 4) or None) of a treelet."""
        if inst:
            return (sc.inst.coef[int(sc.inst.ti_obj[wt])],
                    sc.inst.inst_a[int(sc.inst.ti_inst[wt])])
        return sc.treelets.coef[wt], None

    differ = checked = 0
    for _, name, args in cases:
        o, d, bound_arg, tre, seg = args[0], args[1], args[2], args[4], args[6]
        if inst:
            tre, seg = args[3], args[5]
        t_far = ((bound_arg | sweep.COL_MASK).view(torch.float32)
                 if name in ("closest_tiles", "closest_pairs") else bound_arg)
        picks = torch.linspace(0, tre.numel() - 1, PRETEST_PAIRS, device=dev).long().unique()
        tiles = torch.searchsorted(seg[1:].long(), picks, right=True)
        for p, tile in zip(picks.tolist(), tiles.tolist()):
            lanes = slice(tile * 1024, tile * 1024 + 1024)
            n, k, _ = masks(o[lanes], d[lanes], t_far[lanes], *treelet(int(tre[p])))
            differ, checked = differ + n, checked + k
    rng = np.random.RandomState(7)
    lo = (sc.inst.lo if inst else sc.treelets.lo).cpu().numpy()
    bounded = np.nonzero(lo[:, 0] < 1e37)[0]
    hits = {}
    for wt in rng.choice(bounded, size=min(PRETEST_TREELETS, len(bounded)), replace=False):
        coef, a = treelet(int(wt))
        rows = coef.cpu().numpy()
        cols = np.nonzero(np.abs(rows[:, 0:3]).sum(1) > 0)[0]
        cols = rng.choice(cols, size=min(4, len(cols)), replace=False)
        a_np = np.eye(4, dtype=np.float32) if a is None else a.cpu().numpy()
        o, d, dist = (torch.from_numpy(x).to(dev) for x in sweep.grazing_rays(
            object_triangles(rows[cols], a_np), rng))
        o, d, t_far = o.reshape(-1, 3), d.reshape(-1, 3), dist.reshape(-1) * (1 + 1e-5)
        n, k, may = masks(o, d, t_far, coef, a)
        differ, checked = differ + n, checked + k
        if inst:
            a1 = a[None]
            t, _, _, hit = sweep_inst._block_tuv_inst(*sweep_inst._to_object(o[None], d[None], a1),
                                                      coef[None])
            tests = {"instanced": (t, hit)}
        else:
            tests = {name: flat_hit_test(name)(o[None], d[None], coef[None])
                     for name in ("closest_tiles", "closest_pairs")}
        for test, (t, hit) in tests.items():
            hit = (hit & (t <= t_far[None, :, None]))[0]
            h, r = hits.get(test, (0, 0))
            hits[test] = (h + int(hit.sum()), r + int((hit & ~may).sum()))
    refused = ", ".join(f"{r} of {h} ({'K3/K4' if t == 'instanced' else t.split('_')[1]} test)"
                        for t, (h, r) in hits.items())
    ok = differ == 0 and all(r == 0 for _, r in hits.values())
    log(f"[pretest] {label}: the {'instanced' if inst else 'grid'} pre-test on the card "
        f"differs from its mirror on {differ} of {checked} (ray, row) masks ({PRETEST_PAIRS} "
        f"pairs of each wavefront and grazing rays at {PRETEST_TREELETS} treelets); the mirror "
        f"refuses {refused} plain hits of the grazing rays [{smi}] -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{label} pre-test")


def main_path(label, sc, cam, module, names, smi, **vp_kw):
    """render(VolPath(max_depth=5, samples_per_pixel=4, **vp_kw)) of `sc`
    through the public API, after a warm-up render_lanes of sample batch 0
    that also counts rays and captures the traversal's sweep calls. The
    launch counts are reset just before the render and read just after;
    the image must be finite and not black, the kernels `names` must have
    launched and no other sweep (kernel or plain) may have run."""
    import torch
    import hikari_tpu_torch as hk
    from hikari_tpu_torch.geometry import sweep
    from hikari_tpu_torch.integrators.volpath import render_lanes

    dev = sc.device
    w, h = cam.resolution
    vp = hk.VolPath(max_depth=5, samples_per_pixel=MAIN_SPP, **vp_kw)
    k = vp.sample_batch
    lanes = torch.arange(w * h, device=dev)
    with Recorder(module, names) as rec:
        _, _, stats = render_lanes(
            vp, sc, cam, hk.make_filter(),
            torch.arange(k, device=dev).repeat_interleave(w * h),
            (lanes % w).repeat(k), (lanes // w).repeat(k))
    rays = float(stats["rays_traced"])
    nonfinite = float(stats["nonfinite_lanes"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sweep.reset_counts()
    t0 = time.perf_counter()
    img = hk.framebuffer(hk.render(vp, sc, cam))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(sweep.launches)
    plain_runs = dict(sweep.plain_cuda_runs)
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(img).all())
    mean_rgb = float(img.mean())
    log(f"[{label}] render {w}x{h}, {MAIN_SPP} spp, depth 5: {wall:.3f} s, "
        f"{rays / wall / 1e6:.3f} Mray/s ({rays:.0f} rays), "
        f"{wall / MAIN_SPP * 1e3:.1f} ms/sample, peak {peak / 2**30:.2f} GiB [{smi}]")
    log(f"[{label}] mean RGB {mean_rgb:.6f}, finite {finite}, nonfinite lanes "
        f"{nonfinite:.0f}, launches {counts}, plain sweeps on CUDA {plain_runs}")
    if not finite or nonfinite != 0.0 or mean_rgb <= 0.0:
        raise SystemExit(f"{label}: output is not a finite, non-black image")
    if (min(counts[n] for n in names) <= 0
            or any(v for n, v in counts.items() if n not in names)
            or any(plain_runs.values())):
        raise SystemExit(f"{label}: the render did not go through exactly the "
                         f"kernels {names}")
    return counts, rec


def time_render(label, sc, cam, smi, **vp_kw):
    """Wall time of render(VolPath(max_depth=5, samples_per_pixel=4,
    **vp_kw)) after one warm-up render (printed only)."""
    import torch
    import hikari_tpu_torch as hk

    vp = hk.VolPath(max_depth=5, samples_per_pixel=MAIN_SPP, **vp_kw)
    hk.render(vp, sc, cam)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hk.framebuffer(hk.render(vp, sc, cam))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"[modes] {label}: render {cam.resolution[0]}x{cam.resolution[1]}, {MAIN_SPP} spp, "
        f"depth 5: {wall:.3f} s, {wall / MAIN_SPP * 1e3:.1f} ms/sample [{smi}]")


def probe(sc, spp: int):
    """(rays traced, mean RGB) of the default scene's 64x64 depth-5 probe,
    averaged over samples 0..spp-1."""
    import torch
    import hikari_tpu_torch as hk
    from hikari_tpu_torch.integrators.volpath import render_lanes
    from hikari_tpu_torch.scenes import scene_camera

    lanes = torch.arange(64 * 64, device=sc.device)
    rays = rgb = 0.0
    for s in range(spp):
        img, _, st = render_lanes(hk.VolPath(max_depth=5, samples_per_pixel=spp), sc,
                                  scene_camera("default", 64), hk.make_filter(), s,
                                  lanes % 64, lanes // 64)
        rays, rgb = rays + float(st["rays_traced"]), rgb + float(img.mean())
    return rays / spp, rgb / spp


def final_carry_tests(name, args, out):
    """A closest sweep's ray-triangle tests counted from its output's final
    carry (sweep.tests_from_final); None for an occlusion sweep."""
    import torch
    from hikari_tpu_torch.geometry.sweep import COL_MASK, tests_from_final

    if name == "closest_inst":
        return tests_from_final(out[0].view(torch.int32), args[4], args[5])
    if name.startswith("closest"):
        return tests_from_final(out[0] | COL_MASK, args[5], args[6])
    return None


def time_kernels(cases, counts, smi, label="at main-path shape"):
    """Kernels vs plain on the recorded sweep calls of a main path's first
    wavefront, one per bounce; returns their JSON records: the depth-0 call's
    numbers, and the sums over the calls as *_render (the plain time null
    where a call's plain version was left out, see PLAIN_CALL_S; the bound
    then from the final carry's test count)."""
    records = []
    for name, replaces, calls, tl in cases:
        kernel, _ = kernel_and_plain(name)
        results, kernel_ms, bounds = [], [], []
        for i, args in enumerate(calls):
            where = f"{name} {label}, call {i + 1} of {len(calls)}"
            pairs = (args[3] if name == "closest_inst" else args[4]).numel()
            # the plain walk's time goes with the pairs listed
            expected_s = results[0]["plain_ms"] / results[0]["pairs"] * pairs / 1e3 if results else 0.0
            if expected_s > PLAIN_CALL_S:
                kernel_ms.append(cuda_ms(lambda: kernel(*args), 3))
                out = kernel(*args)
                tests = final_carry_tests(name, args, out)
                b = None if tests is None else bound(name, args, out, {"tests": tests})[0]
                bounds.append(b)
                log(f"[timing] {where}: pairs {pairs}, kernel {kernel_ms[-1]:.3f} ms, "
                    f"{kernel_ms[-1] * 1e3 / max(pairs, 1):.3f} us per listed pair; plain "
                    f"version left out ({expected_s:.0f} s expected)"
                    + ("" if b is None else
                       f"; bound {b:.3f} ms from the final carry's {tests} tests")
                    + f" [{smi}]")
                continue
            r = compare(name, args, tl, reps=5 if i == 0 else 3)
            results.append(r)
            kernel_ms.append(r["ms"])
            bounds.append(r["bound_ms"])
            final = final_carry_tests(name, args, r["out"])
            log(f"[timing] {where}: agree {r['agree']:.6f} (lanes {r['lanes']}, live "
                f"{r['live']}, pairs {r['pairs']}, swept {r['swept']}, tests {r['tests']}"
                + ("" if final is None else f", {final} from the final carry")
                + f"), kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
                f"{r['bound_ms']:.3f} ms ({r['bound_by']}){detail(name, r)} [{smi}] -> "
                f"{'ok' if r['ok'] else 'FAIL'}")
            if not r["ok"]:
                raise SystemExit(f"{where} disagrees with its plain version")
            del r["out"]
        first = results[0]
        whole = len(results) == len(calls)
        plain_total = sum(r["plain_ms"] for r in results) if whole else None
        bound_total = None if None in bounds else sum(bounds)
        counted = f"walk on {len(results)} of {len(calls)} calls"
        counted = ("walk" if whole else counted if bound_total is None
                   else f"{counted}, final carry on the rest")
        log(f"[timing] {name} {label}, {len(calls)} calls: kernel {sum(kernel_ms):.3f} ms, "
            + (f"plain {plain_total:.3f} ms" if whole
               else f"{len(results)} of them compared with the plain version")
            + ("" if bound_total is None else f", bound {bound_total:.3f} ms (tests: {counted})")
            + f" [{smi}]")
        records.append({
            "name": name, "route": "cuda",
            "source": f"hikari_tpu_torch/csrc/{SOURCES[name.split('_')[1]]}",
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": first["max_abs_err"], "agree": first["agree"],
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": None,
            "pairs_listed": first["pairs"], "pairs_swept": first["swept"],
            "bit_equal": all(r["exact"] for r in results),
            "min_agree": min(r["agree"] for r in results),
            "calls_timed": len(calls), "calls_compared": len(results),
            "ms_render": sum(kernel_ms), "plain_ms_render": plain_total,
            "bound_ms_render": bound_total, "bound_tests": counted,
        })
    return records


def main() -> int:
    if not (ROOT / "hikari_tpu_torch").is_dir():
        print("chip_smoke.py: hikari_tpu_torch/ not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this test runs only on the GPU",
              file=sys.stderr)
        return 3

    # phase 1: device
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[device] {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
        f"count {torch.cuda.device_count()}")
    log(f"[device] nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build the three sources at once, one nvcc each
    from concurrent.futures import ThreadPoolExecutor

    from hikari_tpu_torch.geometry import (instanced, sweep, sweep_inst, sweep_pairs,
                                           wavefront)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        builds = [pool.submit(sweep.sweep_library), pool.submit(sweep_inst.inst_library),
                  pool.submit(sweep_pairs.pairs_library)]
        for b in builds:
            b.result()
    log(f"[build] nvcc built csrc/sweep_tiles.cu, csrc/sweep_inst.cu and "
        f"csrc/sweep_pairs.cu in {time.perf_counter() - t0:.1f} s "
        f"(flags: {' '.join(sweep.NVCC_FLAGS)})")
    for name, (regs, spill, blocks) in kernel_attributes().items():
        log(f"[build] {name}: {regs} registers a thread, {spill} B spilled, "
            f"{blocks} resident blocks per SM")

    from hikari_tpu_torch.scenes import (BUILDERS, check_transport, forest_camera,
                                         forest_scene, instanced_default_scene,
                                         scene_camera)

    flat_names = ("closest_tiles", "occlusion_tiles")
    inst_names = ("closest_inst", "occlusion_inst")
    pair_names = ("closest_pairs", "occlusion_pairs")

    # phase 3: kernels vs plain on three wavefronts per scene
    failures = []
    scenes = {}
    for which in ("default", "mesh"):
        t0 = time.perf_counter()
        scenes[which] = BUILDERS[which]().build(device=dev)
        sc = scenes[which]
        log(f"[kernels] {which}: {sc.n_faces} triangles, "
            f"{sc.treelets.lo.shape[0]} treelets, built in {time.perf_counter() - t0:.1f} s")
        cases = compare_wavefronts(which, sc, scene_camera(which, 256), wavefront, flat_names,
                                   sc.treelets, smi, failures, also=pair_names)
        pretest_check(which, sc, [cases[0], cases[2]], smi, failures)
    for which, build, cam in (
            ("instanced default", instanced_default_scene, scene_camera("default", 256)),
            ("forest", forest_scene, forest_camera(256, 256))):
        t0 = time.perf_counter()
        scenes[which] = build().build(device=dev)
        sc = scenes[which]
        log(f"[kernels] {which}: {sc.n_faces} BLAS triangles (padded), "
            f"{sc.inst.coef.shape[0]} BLAS treelets, {sc.inst.lo.shape[0]} world "
            f"treelets, {sc.inst.inst_a.shape[0]} instances, built in "
            f"{time.perf_counter() - t0:.1f} s")
        cases = compare_wavefronts(which, sc, cam, instanced, inst_names, None, smi, failures)
        pretest_check(which, sc, [cases[0], cases[2]], smi, failures)
    if failures:
        raise SystemExit(f"kernel vs plain disagreement: {failures}")

    # phase 4: transport probes
    for which in ("default", "mesh"):
        ok, msg = check_transport(scenes[which], which)
        log(f"[transport] {msg} -> {'pass' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"transport probe failed: {msg}")
    del scenes["mesh"]
    torch.cuda.empty_cache()
    # the default probe under each mode of the main path
    for mode, switches, probe_kw in (
            ("pair-grid sweep", dict(SWEEP_MODE="pairs"), {}),
            (f"banded closest hit ({BAND_FRAC})", dict(BAND_FRAC=BAND_FRAC), {}),
            ("reversed shadows", dict(SHADOW_REV=True), {}),
            ("gated dispatch", {}, dict(material_coherence="gated")),
            ("sorted dispatch", {}, dict(material_coherence="sorted")),
            ("resident loop", {}, dict(resident="on")),
            ("3 depth segments", {}, dict(n_segments=3))):
        with switched(wavefront, **switches):
            ok, msg = check_transport(scenes["default"], "default", **probe_kw)
        log(f"[transport] {mode}: {msg} -> {'pass' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"transport probe failed under {mode}: {msg}")
    # the instanced default scene against the flat one: 4 spp averaged (the
    # two builds order the emissive quad's triangles differently, so single
    # samples differ by noise); the 1-spp probe beside the stored reference
    # is printed for information
    _, msg = check_transport(scenes["instanced default"], "default")
    log(f"[transport] instanced {msg} (1 spp, for information)")
    (fr, fc), (ir, ic) = (probe(scenes[w], PROBE_SPP) for w in ("default", "instanced default"))
    dr, dc = abs(ir - fr) / fr, abs(ic - fc) / abs(fc)
    ok = dr <= 0.005 and dc <= 0.02
    log(f"[transport] instanced vs flat default, 64x64 depth 5, {PROBE_SPP} spp: rays "
        f"{ir:.2f} vs {fr:.2f} ({dr * 100:.3f}%), mean RGB {ic:.7f} vs {fc:.7f} "
        f"({dc * 100:.3f}%) -> {'pass' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the instanced default scene does not match the flat one")

    # phase 5: the main paths at full size: flat (tile sweeps, pair grid,
    # every switch on), then instanced
    main_cam = scene_camera("default", MAIN_RES)
    flat_counts, flat_rec = main_path("main", scenes["default"], main_cam, wavefront,
                                      flat_names, smi)
    with switched(wavefront, SWEEP_MODE="pairs"):
        pair_counts, pair_rec = main_path("pair grid", scenes["default"], main_cam,
                                          wavefront, pair_names, smi)
    with switched(wavefront, SWEEP_MODE="pairs", BAND_FRAC=BAND_FRAC, SHADOW_REV=True):
        main_path("all modes", scenes["default"], main_cam, wavefront, pair_names, smi,
                  material_coherence="sorted", resident="on")
    # each switch of the all-modes path alone on the pair grid (times only)
    for label, switches, vp_kw in (
            ("banded closest hit", dict(BAND_FRAC=BAND_FRAC), {}),
            ("reversed shadows", dict(SHADOW_REV=True), {}),
            ("sorted dispatch", {}, dict(material_coherence="sorted")),
            ("resident loop", {}, dict(resident="on"))):
        with switched(wavefront, SWEEP_MODE="pairs", **switches):
            time_render(f"pair grid + {label}", scenes["default"], main_cam, smi, **vp_kw)
    inst_counts, inst_rec = main_path("instanced", scenes["instanced default"],
                                      scene_camera("default", MAIN_RES), instanced,
                                      inst_names, smi)
    main_path("forest", scenes["forest"], forest_camera(MAIN_RES, MAIN_RES), instanced,
              inst_names, smi)

    # phase 6: kernel times at the main paths' shapes (after the counts were read)
    flat_tl = scenes["default"].treelets
    records = time_kernels([
        ("closest_tiles", "hikari_tpu/geometry/wavefront.py:999",
         flat_rec.calls["closest_tiles"], flat_tl),
        ("occlusion_tiles", "hikari_tpu/geometry/wavefront.py:1052",
         flat_rec.calls["occlusion_tiles"], flat_tl),
    ], flat_counts, smi) + time_kernels([
        ("closest_inst", "hikari_tpu/geometry/instanced.py:146",
         inst_rec.calls["closest_inst"], None),
        ("occlusion_inst", "hikari_tpu/geometry/instanced.py:194",
         inst_rec.calls["occlusion_inst"], None),
    ], inst_counts, smi) + time_kernels([
        ("closest_pairs", "hikari_tpu/geometry/wavefront.py:773",
         pair_rec.calls["closest_pairs"], flat_tl),
        ("occlusion_pairs", "hikari_tpu/geometry/wavefront.py:827",
         pair_rec.calls["occlusion_pairs"], flat_tl),
    ], pair_counts, smi)
    # the tile kernels on the pair-grid path's depth-0 pair lists: the two
    # decompositions on the same work (printed only)
    same_work = time_kernels([(tiles, "", pair_rec.calls[pairs][:1], flat_tl)
                              for tiles, pairs in zip(flat_names, pair_names)],
                             flat_counts, smi, label="on the pair-grid path's pair list")
    by_name = {r["name"]: r for r in records}
    for tiles, pairs in zip(same_work, pair_names):
        log(f"[timing] {pairs} / {tiles['name']} at depth 0 of the pair-grid path: "
            f"{by_name[pairs]['ms']:.3f} / {tiles['ms']:.3f} ms = "
            f"{by_name[pairs]['ms'] / tiles['ms']:.3f} [{smi}]")
    log(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
