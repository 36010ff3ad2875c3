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
   same tolerances. Media: the fog's 64x64 depth-5 probe, its one-sample
   rays against tools/transport_ref.json within 0.5% (its mean RGB, one
   LCG draw, printed for information), and over FOG_PROBE_SPP samples
   against the JAX package's (hikari_tpu_torch/data/probe_ref.json,
   rays within 0.5%, mean RGB within 2%), as is, under the pair-grid sweep
   and under the resident loop; the grid cloud's 32x32 depth-12 16-sample
   probe against the JAX package's (rays within 0.5%, mean RGB within
   10%, bench.py's tolerance); every medium probe averages samples 0 ..
   spp-1 of VolPath(samples_per_pixel=spp). Lights: the sphere scene's 64x64
   depth-5 probe (sun and sky, no area light) against tools/transport_ref.json
   (rays 0.5%, mean RGB 2%); the sun-sky cloud's 32x32 depth-12 16-sample
   probe against the JAX package's six-draw mean (rays 0.5%, mean RGB
   10%); the default probe under the uniform and BVH light samplers and
   the lights scene's (spot, distant, ambient and equirect environment
   light) against the JAX package's (rays 0.5%, mean RGB 2%). Sparse
   volumes and filters: the sparse cloud's 32x32 depth-12 16-sample probe
   (a 96^3 cloud written to a NanoVDB file and read back as a
   BrickGridMedium, under the sun and sky) against the JAX package's
   six-draw mean (rays 0.5%, mean RGB 10%), and the default probe under
   the Mitchell and Lanczos filters against the JAX package's (rays 0.5%,
   mean RGB 1e-4). Materials: bench.py's materials scene (every
   BSDF-bearing material, the three layered coats among them) under each
   material dispatch ('none', 'gated', 'sorted') against the JAX package's
   probe (rays 0.5%, mean RGB 2%). Examples: the dispersion scene's
   32x32 depth-8 probe against the JAX package's (rays 0.5%, mean RGB 2%);
   the lensing, medium-example and cloud-example probes against the JAX
   six-draw means (rays 0.5%, mean RGB 10%), the medium example's taken
   on the JAX packet engine (its smoke box and floor share a plane, where
   the JAX skip-link walk keeps other faces, ROADMAP C; the skip-link
   walk's mean printed beside it);
   every JAX probe but the bench's in hikari_tpu_torch/data/probe_ref.json;
5. main paths: render(VolPath(max_depth=5, samples_per_pixel=4)) at
   800x800 through the public API of the default scene (tile kernels), the
   default scene in pair-grid mode (K5/K6), the default scene with every
   switch on (pair grid, band, reversed shadows, sorted dispatch, resident
   loop; K5/K6), the instanced default scene and the forest (instanced
   kernels), each with the launch counts reset just before and read just
   after; the image must be finite and not black, the path's two kernels
   must have launched, and no other sweep, kernel or plain, may have run.
   Then each switch of the all-modes path alone on the pair grid, timed
   only. The lights' paths with the same checks: the sphere scene under
   the sun and sky (K1/K2), the forest under its sun and sky (K3/K4, in
   the instanced paths above) and the default scene under the BVH light
   sampler (K1/K2); on each of these three, every kernel against its
   plain version on every sweep call of the warm-up render_lanes, bit for
   bit (hold_path; the forest's K3 on the calls whose plain walk fits
   under PLAIN_CALL_S). Then the medium paths: the fog (depth 5) with the tile
   sweeps and with the pair grid, the grid cloud (depth 12) and the sun-sky
   cloud (depth 8; the bench's 32), each at 800x800, 4 spp, through render
   with the same checks, where only the closest kernel (K1, or K5) may
   launch: scenes with Interface faces walk shadow rays through closest
   hits. Before each, an instrumented render_lanes
   of the same samples prints per bounce the closest-sweep calls and the
   delta and ratio tracking steps, and a synchronising stage split (delta
   tracking, ratio tracking, closest sweeps, the rest), and captures the
   closest kernel's sweep calls: before the render, the kernel against
   its plain version on every one of them (the path rays' and each
   shadow-walk segment's), bit for bit, with its summed time and bound.
   Then the sparse cloud at depth 4 (the example's 24 in path H) the same way, with the
   brick pool's and page table's bytes beside its peak memory; its dense
   twin (the same file read as a dense grid) the same way, whose mean RGB
   must be within TWIN_RGB_TOL of the sparse render's (the spread of two
   sparse draws, under sampler seeds 0 and 1, printed beside it), and the
   difference of their ms/sample; a 4096^3 index space of two bricks (a
   512^3 page table) tracked on the card (sparse_index_check). Last, the
   default scene under the Mitchell filter (K1/K2 held on every sweep
   call, as the lights' paths) and the same samples in a crop window,
   whose film must equal the full film's window. The materials paths,
   before the medium paths: the materials scene at depth 5 under each
   dispatch ('[materials none]', '[materials gated]', '[materials sorted]'
   lines): a synchronising stage split of one wavefront (layered sample,
   layered eval, the other BSDFs, traversal, the rest), K1/K2 held on
   every sweep call of the 'none' wavefront, then a warm-up and two timed
   renders with timed_render's checks; the three must trace the same rays
   and agree in mean RGB within MODES_RGB_RTOL; and each layered
   material's sample alone at 2.56M and 160k lanes (walk_widths). Then
   the Mix floor at
   depth 2 ('[mix]'): each child's share of the lit pixels within
   MIX_SHARE. '[time]' lines give the script's clock after phases 4 and 5
   and after the materials paths. Last, this slice's paths on the default
   scene at full size (slice_paths): A, Whitted() and B, FastWavefront()
   through render_preview ('[whitted]', '[fast]': sample 0's rays, the
   lanes alive at each bounce, a stage split traversal / NEE / BSDF sample
   / rest, K1 and K2 held on every sweep call of sample 0, then the timed
   render with timed_render's checks); C, SPPM() through render_sppm
   ('[sppm]': K1 and K2 held on every sweep call of the first iteration, ms
   an iteration split camera pass / photon pass / sort / gather / update,
   the deposits of each photon pass, the mean radius at the end); D, the
   default scene built with traversal='skiplink' ('[skiplink]': its 64x64
   probe traces the packets' rays, mean RGB within PREVIEW_RGB_RTOL, with no
   sweep kernel launched; the walk equals brute_force_closest_hit on
   BRUTE_RAYS seeded rays; one primary walk timed beside the packet engine
   and K1); E, render_sharded at world size 1 on an NCCL group
   ('[sharded]': its film equals the main path's render within
   SHARDED_RTOL); F, profiling.trace around one Whitted sample and
   stage_timings ('[profiling]'); G, examples/torch_quickstart.py in a new
   process, its three PNGs into chiprun_out/ ('[quickstart]'); H, the
   seven other examples/torch_*.py in this process through their main()
   at their defaults (the clouds at 4 samples; each render's samples in
   one wavefront but the instancing example's), each PNG into chiprun_out/
   and decoded to a finite, lit image, with the launch counts reset just
   before and read just after, each kernel it launched held bit for bit
   against its plain version on its first call, the clouds' K1 on every
   call of their depth 32 and 24 ('[examples]' lines:
   seconds, ms/sample, rays, peak memory, launches); then
   rgb2spec_gen.generate_table on the card at res 8 against the JAX
   generator's stored output and at res 64 against the shipped table
   (spectra within 1e-3 on every cell, >= 99.9% of the coefficients within
   one ulp at res 8 and bit-equal at res 64), and both res-64 tables' Lab
   round trip ('[generator]' lines);
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

The line before the last is the per-kernel JSON record (with each
kernel's launches on path H's examples); the last line is
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
# the fog probe's samples: one sample's mean RGB spreads ~6% from the
# media's LCG streams alone, which the port's and the JAX package's rays
# seed differently, and 512 samples ~0.5% (PERF.md; python3 -m
# hikari_tpu_torch.tools.media_check), well inside the probe's 2%
FOG_PROBE_SPP = 512
# the medium paths' depths: the bench's for the fog, the bench cloud
# probe's for the grid cloud, 8 for the sun-sky cloud (32 in the bench)
# and 4 for the sparse cloud (24 in its example; three renders): their
# tracking loops follow the machine's host, and at 16 and 24 the script
# ran past its time limit, at 8 and 8 to within 45 s of it (PERF.md).
# Path H holds K1 on every call of the cloud example at depth 32 and of
# the sparse cloud example at 24.
MEDIUM_DEPTH = {"fog": 5, "cloud_grid": 12, "cloud": 8, "sparse_cloud": 4}
# the sparse cloud's dense twin against it, mean RGB over one 800x800
# 4-sample render each (2.56M paths; a 16-sample 32x32 draw spreads 2.4%,
# so a draw of these ~0.2%)
TWIN_RGB_TOL = 0.03
# the filter probes: equal to the JAX package's, as the light probes are
FILTER_RGB_TOL = 1e-4
# this slice's paths: the textured scene (every texture source, image and
# constant alpha) under each dispatch; the flagship Cornell example at its
# depth, then its render_aux / denoise / postprocess / write_png; the foliage
# stack's alpha closest hits over a main path's worth of rays, whose escape
# share must be within tests/test_alpha_mix.py's bound of 0.7^8
TEXTURED_MODES = ("none", "sorted")
CORNELL_DEPTH = 6
AUX_RTOL = 1e-4   # render_aux against the JAX package's (aux_check)
OUT_DIR = ROOT / "chiprun_out"
CROP = ((0.25, 0.25), (0.75, 0.75))
# the materials paths: bench.py's materials scene under each material
# dispatch; the three trace the same rays and agree in mean RGB to this
MATERIAL_MODES = ("none", "gated", "sorted")
MODES_RGB_RTOL = 1e-5
MIX_SHARE = (0.2, 0.8)  # each Mix child's share of the lit floor pixels
SPARSE_INDEX_RES = 4096  # index voxels per axis of sparse_index_check
BAND_FRAC = 0.15    # banded closest hit: band = 0.15 x the world diagonal
# a path's plain walk runs on a sweep call only while it is expected to
# stay under this many seconds (the first call of each kernel always runs:
# the forest's K3 and K4 take 44 s and 27 s there); the call's kernel is
# timed all the same. Left out at this limit: K3's calls past 20 s, the
# instanced default scene's second and third bounces and the forest's
# third, 26-35 s each; K3 is held on a seeded subset of such a call's
# tiles whose plain walk fits the same limit (inst_subset_compare).
PLAIN_CALL_S = 20.0
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


def main_path(label, sc, cam, module, names, smi, ftype=None, **vp_kw):
    """render(VolPath(max_depth=5, samples_per_pixel=4, **vp_kw)) of `sc`
    through the public API (through filter ftype, make_filter's default when
    None), after a warm-up render_lanes of sample batch 0 that also counts
    rays and captures the traversal's sweep calls; see timed_render for the
    checks. Returns (launch counts, recorder, timed_render's result)."""
    import torch
    import hikari_tpu_torch as hk
    from hikari_tpu_torch.integrators.volpath import render_lanes

    dev = sc.device
    w, h = cam.resolution
    vp = hk.VolPath(max_depth=5, samples_per_pixel=MAIN_SPP, **vp_kw)
    filt = hk.make_filter() if ftype is None else hk.make_filter(ftype)
    k = vp.sample_batch
    lanes = torch.arange(w * h, device=dev)
    with Recorder(module, names) as rec:
        _, _, stats = render_lanes(
            vp, sc, cam, filt, torch.arange(k, device=dev).repeat_interleave(w * h),
            (lanes % w).repeat(k), (lanes // w).repeat(k))
    counts, result = timed_render(label, sc, cam, vp, names, smi, float(stats["rays_traced"]),
                                  float(stats["nonfinite_lanes"]), filt=filt)
    return counts, rec, result


def launched_exactly(label, names, counts, plain_runs):
    if (min(counts[n] for n in names) <= 0 or any(v for n, v in counts.items() if n not in names)
            or any(plain_runs.values())):
        raise SystemExit(f"{label}: the path did not go through exactly the kernels {names}: "
                         f"launches {counts}, plain sweeps on CUDA {plain_runs}")


def timed_render(label, sc, cam, vp, names, smi, rays, nonfinite, filt=None, film=None):
    """render(vp, sc, cam, film, filt) through the public API with the
    launch counts reset just before and read just after; rays: the rays of
    its sample batch, counted by an earlier render_lanes of the same
    samples (None: not counted). The image must be finite and not black,
    the kernels `names` must have launched and no other sweep (kernel or
    plain) may have run. Returns (launch counts, dict of the film, its
    seconds, ms per sample and mean RGB)."""
    import torch
    import hikari_tpu_torch as hk
    from hikari_tpu_torch.geometry import sweep

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sweep.reset_counts()
    t0 = time.perf_counter()
    film = hk.render(vp, sc, cam, film, filt)
    img = hk.framebuffer(film)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(sweep.launches)
    plain_runs = dict(sweep.plain_cuda_runs)
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(img).all())
    mean_rgb = float(img.mean())
    # not black: the film's weighted sum (a negative-lobed filter's pixel
    # whose samples weigh < 0 in all divides by framebuffer's 1e-8 floor)
    mean_sum = float(film.rgb_sum.mean())
    rate = "rays not counted" if rays is None else (
        f"{rays / wall / 1e6:.3f} Mray/s ({rays:.0f} rays)")
    log(f"[{label}] render {film.width}x{film.height}, {MAIN_SPP} spp, depth "
        f"{vp.max_depth}: {wall:.3f} s, {rate}, {wall / MAIN_SPP * 1e3:.1f} ms/sample, peak "
        f"{peak / 2**30:.2f} GiB [{smi}]")
    log(f"[{label}] mean RGB {mean_rgb:.6f} (weighted sum {mean_sum:.6f}), finite {finite}, "
        f"nonfinite lanes {nonfinite:.0f}, launches {counts}, plain sweeps on CUDA "
        f"{plain_runs}")
    if not finite or nonfinite != 0.0 or mean_sum <= 0.0:
        raise SystemExit(f"{label}: output is not a finite, non-black image")
    launched_exactly(label, names, counts, plain_runs)
    return counts, dict(film=film, secs=wall, ms_sample=wall / MAIN_SPP * 1e3,
                        mean_rgb=mean_rgb, peak=peak)


class MediumInstruments:
    """Synchronising wrappers around the stages of a medium path, for one
    instrumented render_lanes: per bounce (one _bounce_core call), the
    closest-sweep calls (scene_closest_hit: the path rays' and every
    shadow-walk segment's) and the tracking steps of delta_track (one call
    a bounce) and ratio_track_tr (one call a shadow-walk segment); per
    stage, the time between a synchronize before the call and one after."""

    def __init__(self):
        self.bounces = []
        self.secs = dict(delta=0.0, ratio=0.0, closest=0.0)

    def _timed(self, stage, fn, *args, **kw):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        self.secs[stage] += time.perf_counter() - t0
        return out

    def __enter__(self):
        from hikari_tpu_torch.integrators import volpath
        from hikari_tpu_torch.media import sample as ms

        self.saved = [(volpath, "_bounce_core"), (volpath, "scene_closest_hit"),
                      (ms, "delta_track"), (ms, "ratio_track_tr")]
        self.saved = [(m, n, getattr(m, n)) for m, n in self.saved]
        orig = {n: f for _, n, f in self.saved}

        def bounce(*args, **kw):
            self.bounces.append(dict(closest=0, delta=[], ratio=[]))
            return orig["_bounce_core"](*args, **kw)

        def closest(*args, **kw):
            self.bounces[-1]["closest"] += 1
            return self._timed("closest", orig["scene_closest_hit"], *args, **kw)

        def tracked(stage, name):
            def wrapped(*args, **kw):
                st = {}
                out = self._timed(stage, orig[name], *args, stats=st, **kw)
                lane = st["lane_steps"]
                self.bounces[-1][stage].append(
                    (st["steps"], int(lane.sum()), int((lane > 0).sum())))
                return out
            return wrapped

        volpath._bounce_core = bounce
        volpath.scene_closest_hit = closest
        ms.delta_track = tracked("delta", "delta_track")
        ms.ratio_track_tr = tracked("ratio", "ratio_track_tr")
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def medium_path(label, sc, cam, depth, names, smi):
    """A medium main path: render(VolPath(max_depth=depth,
    samples_per_pixel=4)) of `sc` (timed_render's checks), after an
    instrumented render_lanes of the same samples (MediumInstruments) that
    counts the rays, captures the closest kernel's sweep calls (the path
    rays' and every shadow-walk segment's) and prints, per bounce, the
    closest-sweep calls and the tracking steps (the loop's steps, the most
    any lane ran, and the mean over the lanes that tracked), and the
    synchronising stage split. Then the kernel goes against its plain
    version on every captured call (time_kernels) and must equal it bit
    for bit on each; the captured inputs are freed before the render.
    Returns timed_render's result."""
    import torch
    import hikari_tpu_torch as hk
    from hikari_tpu_torch.geometry import wavefront
    from hikari_tpu_torch.integrators.volpath import render_lanes

    if sc.device.type != "cuda":
        raise SystemExit(f"{label}: the scene is not on the card")
    dev = sc.device
    w, h = cam.resolution
    vp = hk.VolPath(max_depth=depth, samples_per_pixel=MAIN_SPP)
    k = vp.sample_batch
    lanes = torch.arange(w * h, device=dev)
    closest = names[0]
    with Recorder(wavefront, (closest,)) as rec, MediumInstruments() as ins:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, stats = render_lanes(vp, sc, cam, hk.make_filter(),
                                   torch.arange(k, device=dev).repeat_interleave(w * h),
                                   (lanes % w).repeat(k), (lanes // w).repeat(k))
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    for i, b in enumerate(ins.bounces):
        parts = [f"{b['closest']} closest-sweep calls"]
        for stage in ("delta", "ratio"):
            calls = b[stage]
            if calls:
                steps, lane_steps, live = (sum(c[j] for c in calls) for j in range(3))
                parts.append(f"{stage} tracking {len(calls)} call(s), {steps} steps (max "
                             f"{max(c[0] for c in calls)} a call), mean "
                             f"{lane_steps / max(live, 1):.2f} over {live} live lanes")
        log(f"[{label}] bounce {i}: " + "; ".join(parts))
    n_closest = sum(b["closest"] for b in ins.bounces)
    stages = dict(ins.secs, rest=total - sum(ins.secs.values()))
    log(f"[{label}] stage split of one synchronised {w}x{h} {k}-sample wavefront, "
        f"{total:.3f} s: " + ", ".join(
            f"{name} {sec * 1e3:.1f} ms ({sec / total * 100:.1f}%)"
            for name, sec in (("delta tracking", stages["delta"]),
                              ("ratio tracking", stages["ratio"]),
                              ("closest sweeps", stages["closest"]),
                              ("the rest", stages["rest"])))
        + f"; {n_closest} closest-sweep calls, {n_closest / max(len(ins.bounces), 1):.2f} "
        f"a bounce [{smi}]")
    hold_path(label, rec, [(closest, sc.treelets)], smi)
    del rec  # the captured inputs stay out of the render's peak memory
    return timed_render(label, sc, cam, vp, names, smi, float(stats["rays_traced"]),
                        float(stats["nonfinite_lanes"]))[1]


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


def inst_subset_compare(args, expected_s, seed=7):
    """K3 against its plain version on a seeded subset of a call's ray
    tiles, as many as fit PLAIN_CALL_S at the call's expected plain rate:
    each tile's lanes depend on its own segment of the pair list only, so
    the kernel's whole-call output on those tiles is held to the plain walk
    of the sub-list with compare's rules (tri on >= AGREE_MIN of the live
    lanes, t within T_RTOL and b1 / b2 within B_ATOL where tri agrees) and
    bit for bit. Returns (ok, bit-equal, tiles checked, tiles, agree, ms
    of the plain sub-walk)."""
    import numpy as np
    import torch
    from hikari_tpu_torch.geometry import sweep_inst
    from hikari_tpu_torch.geometry.sweep import RAY_TILE

    o, d, t_in, tre, tn_bits, seg, ti_obj, ti_inst, coef, inst_a = args
    seg_h = seg.cpu().numpy().astype(np.int64)
    n_tiles = len(seg_h) - 1
    pairs = np.diff(seg_h)
    budget = PLAIN_CALL_S / expected_s * pairs.sum()
    order = np.random.RandomState(seed).permutation(n_tiles)
    take = order[np.cumsum(pairs[order]) <= budget]
    take = np.sort(take if len(take) else order[:1])
    dev = o.device
    lanes = (torch.from_numpy(take).to(dev)[:, None] * RAY_TILE
             + torch.arange(RAY_TILE, device=dev)).reshape(-1)
    pidx = torch.from_numpy(np.concatenate(
        [np.arange(seg_h[t], seg_h[t + 1]) for t in take]).astype(np.int64)).to(dev)
    sub_seg = torch.from_numpy(np.concatenate([[0], np.cumsum(pairs[take])])).to(dev, seg.dtype)
    out_k = sweep_inst.closest_inst(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out_p = sweep_inst.closest_inst_plain(o[lanes], d[lanes], t_in[lanes], tre[pidx],
                                          tn_bits[pidx], sub_seg, ti_obj, ti_inst, coef, inst_a)
    end.record()
    torch.cuda.synchronize()
    t_k, tri_k, b1_k, b2_k = (x[lanes] for x in out_k)
    t_p, tri_p, b1_p, b2_p = out_p
    live = t_in[lanes] > 0.0
    same = tri_k == tri_p
    agree = float(same[live].float().mean()) if live.any() else 1.0
    both = same & live & (tri_k >= 0)
    t_ok = bool(((t_k - t_p).abs()[both] <= T_RTOL * t_p.abs()[both]).all())
    b_err = (max(float((b1_k - b1_p).abs()[both].max()), float((b2_k - b2_p).abs()[both].max()))
             if both.any() else 0.0)
    exact = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip((t_k, tri_k, b1_k, b2_k), out_p))
    ok = agree >= AGREE_MIN and t_ok and b_err <= B_ATOL and exact
    return ok, exact, len(take), n_tiles, agree, start.elapsed_time(end)


def time_kernels(cases, counts, smi, label="at main-path shape"):
    """Kernels vs plain on the recorded sweep calls of a main path's first
    wavefront, one per bounce; returns their JSON records: the depth-0 call's
    numbers, and the sums over the calls as *_render (the plain time null
    where a call's plain version was left out, see PLAIN_CALL_S; the bound
    then from the final carry's test count)."""
    records = []
    for name, replaces, calls, tl in cases:
        kernel, _ = kernel_and_plain(name)
        results, kernel_ms, bounds, subsets = [], [], [], []
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
                if name == "closest_inst":
                    ok, exact, k, n_tiles, agree, ms_sub = inst_subset_compare(args, expected_s)
                    subsets.append(ok)
                    log(f"[timing] {where}: K3 against its plain version on a seeded subset "
                        f"of {k} of {n_tiles} ray tiles ({k / n_tiles * 100:.1f}% checked; "
                        f"plain sub-walk {ms_sub / 1e3:.1f} s): agree {agree:.6f}, bit-equal "
                        f"{'yes' if exact else 'no'} [{smi}] -> {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise SystemExit(f"{where}: the tile subset disagrees with its plain "
                                         f"version")
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
            "calls_subset_compared": len(subsets),
            "ms_render": sum(kernel_ms), "plain_ms_render": plain_total,
            "bound_ms_render": bound_total, "bound_tests": counted,
        })
    return records


def hold_path(label, rec, cases, smi, partial=()):
    """Each kernel of a path against its plain version on every sweep call
    that the path's recorder captured (time_kernels), with its summed time
    and bound: every call must be compared and bit-equal, but for the
    kernels named in `partial`, whose calls past PLAIN_CALL_S are timed
    only (at least the first is compared)."""
    records = time_kernels([(name, "", rec.calls[name], tl) for name, tl in cases],
                           {name: len(rec.calls[name]) for name, _ in cases}, smi,
                           label=f"on the {label} path")
    for r in records:
        n_calls = r["calls_timed"]
        plain = r["plain_ms_render"]
        bound = r["bound_ms_render"]
        subset = (f", and on a tile subset of the {r['calls_subset_compared']} others"
                  if r["calls_subset_compared"] else "")
        log(f"[{label}] {r['name']} on the {n_calls} sweep calls of the path's warm-up "
            f"wavefront: kernel {r['ms_render']:.3f} ms, plain "
            + ("left out on some calls" if plain is None else f"{plain:.3f} ms")
            + ", bound " + ("not measured" if bound is None else f"{bound:.3f} ms")
            + f" ({r['bound_by']} at the first call); bit-equal with the plain version on "
            f"{r['calls_compared']} of {n_calls} calls compared{subset}: "
            f"{'yes' if r['bit_equal'] else 'NO'} [{smi}]")
        needed = 1 if r["name"] in partial else n_calls
        if not (r["bit_equal"] and r["calls_compared"] >= needed):
            raise SystemExit(f"{label}: {r['name']} does not equal its plain version bit for "
                             f"bit on every sweep call compared, or too few were compared")


class StageTimers:
    """Synchronising, exclusive stage timers around functions of the port's
    modules: stages maps a stage to (module, function name) pairs; time in
    a function of another stage called from inside one is counted in that
    other stage only. Everything else is "the rest" of the caller's total."""

    def __init__(self, stages):
        self.stages = stages
        self.secs = dict.fromkeys(stages, 0.0)
        self.stack = []

    def _timed(self, stage, fn):
        def wrapped(*args, **kw):
            import torch

            torch.cuda.synchronize()
            now = time.perf_counter()
            if self.stack:
                self.secs[self.stack[-1][0]] += now - self.stack[-1][1]
            self.stack.append([stage, now])
            try:
                out = fn(*args, **kw)
                torch.cuda.synchronize()
            finally:
                end = time.perf_counter()
                self.secs[stage] += end - self.stack.pop()[1]
                if self.stack:
                    self.stack[-1][1] = end
            return out
        return wrapped

    def __enter__(self):
        self.saved = []
        for stage, targets in self.stages.items():
            for module, name in targets:
                self.saved.append((module, name, getattr(module, name)))
                setattr(module, name, self._timed(stage, getattr(module, name)))
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self.saved):
            setattr(module, name, fn)

    def split(self, total, per=1) -> str:
        parts = dict(self.secs, rest=total - sum(self.secs.values()))
        return ", ".join(f"{name} {sec / per * 1e3:.1f} ms ({sec / total * 100:.1f}%)"
                         for name, sec in parts.items())


class ShadingInstruments(StageTimers):
    """Synchronising, exclusive stage timers around the shading and
    traversal functions of volpath, for one instrumented call. The caller
    maps each stage to what it times (MATERIAL_STAGES, TEXTURE_STAGES):
    "module.name" for a function of the port (volpath, bsdf), or
    "samplers:layered" / "evaluators:other" and the like for the layered or
    the other material types' entries of volpath's BSDF tables. A stage
    that runs inside another (a lookup inside a walk) is counted in its
    own stage only. Per bounce (one _bounce_core call) it counts the
    closest-sweep calls of the camera path (_closest_hit_surface: the first
    and one per alpha round) and of the shadow walk (_trace_shadow)."""

    def __init__(self, stages):
        super().__init__(stages)
        self.bounces = []
        self.context = None

    def _within(self, context, fn):
        def wrapped(*args, **kw):
            outer, self.context = self.context, context
            try:
                return fn(*args, **kw)
            finally:
                self.context = outer
        return wrapped

    def __enter__(self):
        from hikari_tpu_torch.integrators import volpath
        from hikari_tpu_torch.materials import bsdf

        modules = {"volpath": volpath, "bsdf": bsdf}
        tables = {"samplers": volpath._SAMPLERS, "evaluators": volpath._EVALUATORS}
        self.saved = [(volpath, n, getattr(volpath, n)) for n in (
            "scene_closest_hit", "_closest_hit_surface", "_trace_shadow", "_bounce_core")]
        self.tables = {k: dict(t) for k, t in tables.items()}
        for stage, targets in self.stages.items():
            for target in targets:
                if ":" in target:
                    table, kind = target.split(":")
                    for tag in tables[table]:
                        if (tag in volpath._LAYERED_TAGS) == (kind == "layered"):
                            tables[table][tag] = self._timed(stage, tables[table][tag])
                else:
                    module, name = target.split(".")
                    m = modules[module]
                    self.saved.append((m, name, getattr(m, name)))
                    setattr(m, name, self._timed(stage, getattr(m, name)))
        closest = volpath.scene_closest_hit

        def counted(*args, **kw):
            if self.bounces and self.context is not None:
                self.bounces[-1][self.context] += 1
            return closest(*args, **kw)

        bounce = volpath._bounce_core

        def bounce_counted(*args, **kw):
            self.bounces.append(dict(surface=0, shadow=0))
            return bounce(*args, **kw)

        volpath.scene_closest_hit = counted
        volpath._closest_hit_surface = self._within("surface", volpath._closest_hit_surface)
        volpath._trace_shadow = self._within("shadow", volpath._trace_shadow)
        volpath._bounce_core = bounce_counted
        return self

    def __exit__(self, *exc):
        from hikari_tpu_torch.integrators import volpath

        for module, name, fn in reversed(self.saved):  # the first saved is the original
            setattr(module, name, fn)
        volpath._SAMPLERS.update(self.tables["samplers"])
        volpath._EVALUATORS.update(self.tables["evaluators"])


TRAVERSAL = ("volpath.scene_closest_hit", "volpath.scene_any_hit")
# the materials paths' stages: the layered types' random walks (sample,
# NEE evaluation), every other type's BSDF, the traversal
MATERIAL_STAGES = {"layered sample": ("samplers:layered",),
                   "layered eval": ("evaluators:layered",),
                   "other BSDFs": ("samplers:other", "evaluators:other"),
                   "traversal": TRAVERSAL}
# the textured paths' stages: the atlas reads, uv footprints and per-lane
# spectral uplift; the alpha tests; the layered walks; the traversal
TEXTURE_STAGES = {"texture lookups and uplift": (
                      "bsdf.eval_rgb", "bsdf.eval_scalar", "bsdf.rgb_albedo_eval",
                      "bsdf.rgb_illuminant_eval", "volpath.eval_scalar",
                      "volpath._uv_screen_derivatives"),
                  "alpha tests": ("volpath._alpha_keep",),
                  "layered walks": ("samplers:layered", "evaluators:layered"),
                  "traversal": TRAVERSAL}


def instrumented_lanes(sc, cam, vp, stages, names=None):
    """One sample batch of vp through render_lanes under
    ShadingInstruments(stages) (and a Recorder of the wavefront sweeps
    `names`, when given): (stats, instruments, recorder or None, seconds)."""
    import torch
    import hikari_tpu_torch as hk
    from hikari_tpu_torch.geometry import wavefront
    from hikari_tpu_torch.integrators.volpath import render_lanes

    w, h = cam.resolution
    k = vp.sample_batch
    lanes = torch.arange(w * h, device=sc.device)
    record = Recorder(wavefront, names) if names else contextlib.nullcontext()
    with record as rec, ShadingInstruments(stages) as ins:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, stats = render_lanes(vp, sc, cam, hk.make_filter(),
                                   torch.arange(k, device=sc.device).repeat_interleave(w * h),
                                   (lanes % w).repeat(k), (lanes // w).repeat(k))
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    return stats, ins, rec, total


def materials_paths(sc, cam, smi):
    """bench.py's materials scene at full size under each material dispatch
    (MATERIAL_MODES): an instrumented render_lanes of sample batch 0
    (ShadingInstruments) prints the stage split and counts the rays; under
    'none' it also captures the tile sweeps' calls, and K1 / K2 go against
    their plain versions on every one of them, bit for bit (hold_path).
    Then a warm-up render and two timed renders (timed_render's checks:
    K1 and K2 launched, no other sweep). The modes must trace the same
    rays and agree in mean RGB within MODES_RGB_RTOL."""
    import hikari_tpu_torch as hk

    names = ("closest_tiles", "occlusion_tiles")
    w, h = cam.resolution
    rays, rgb = {}, {}
    for mode in MATERIAL_MODES:
        label = f"materials {mode}"
        vp = hk.VolPath(max_depth=5, samples_per_pixel=MAIN_SPP, material_coherence=mode)
        stats, ins, rec, total = instrumented_lanes(sc, cam, vp, MATERIAL_STAGES,
                                                    names if mode == "none" else None)
        log(f"[{label}] stage split of one synchronised {w}x{h} {vp.sample_batch}-sample "
            f"wavefront, {total:.3f} s: {ins.split(total)} [{smi}]")
        if rec is not None:
            hold_path(label, rec, [(n, sc.treelets) for n in names], smi)
            del rec  # the captured inputs stay out of the renders' peak memory
        rays[mode] = float(stats["rays_traced"])
        hk.render(vp, sc, cam)  # warm-up
        runs = [timed_render(label, sc, cam, vp, names, smi, rays[mode],
                             float(stats["nonfinite_lanes"])) for _ in range(2)]
        rgb[mode] = runs[-1][1]["mean_rgb"]
        ms = [r[1]["ms_sample"] for r in runs]
        log(f"[{label}] {ms[0]:.1f}, {ms[1]:.1f} ms/sample over two renders; "
            f"{rays[mode] / (sum(ms) / 2 * MAIN_SPP / 1e3) / 1e6:.3f} Mray/s on their mean "
            f"[{smi}]")
    ref = MATERIAL_MODES[0]
    rgb_err = max(abs(rgb[m] / rgb[ref] - 1) for m in MATERIAL_MODES)
    ok = len(set(rays.values())) == 1 and rgb_err <= MODES_RGB_RTOL
    log("[materials] the modes: rays " + ", ".join(f"{m} {rays[m]:.0f}" for m in MATERIAL_MODES)
        + ", mean RGB " + ", ".join(f"{m} {rgb[m]:.7f}" for m in MATERIAL_MODES)
        + f" (largest relative difference {rgb_err:.2e}, tolerance {MODES_RGB_RTOL:g}) "
        f"[{smi}] -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the material dispatch modes do not render the same image")
    walk_widths(sc, smi)


def walk_widths(sc, smi, widths=(2_560_000, 160_000)):
    """Each layered material's sample (one 10-step walk and its stochastic
    pdf) alone on the card at the main path's width and at 1/16 of it,
    on random directions (CUDA events over three calls after a warm-up):
    a walk whose time does not follow its width is bound by its launches."""
    import torch
    from hikari_tpu_torch.materials import layered as ml

    gen = torch.Generator(device="cpu").manual_seed(7)
    parts = []
    for name in ("coated_diffuse", "coated_conductor", "coated_diffuse_transmission"):
        ms = []
        for n in widths:
            wo = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1)
            lam = 360.0 + 470.0 * torch.rand(n, 4, generator=gen)
            args = [x.to(sc.device) for x in (
                torch.zeros(n, dtype=torch.int32), wo, lam, torch.rand(n, 2, generator=gen),
                torch.rand(n, generator=gen))]
            sample = getattr(ml, f"sample_{name}")
            ms.append(cuda_ms(lambda: sample(sc.materials, *args), 3))
        parts.append(f"{name} " + " / ".join(f"{t:.1f}" for t in ms))
    log(f"[materials] one layered sample alone, ms at {' / '.join(f'{n:,}' for n in widths)} "
        f"lanes: " + "; ".join(parts) + f" [{smi}]")


def mix_path(sc, cam, smi):
    """The Mix floor (scenes.mix_scene, depth 2) at full size through render
    (timed_render's checks): each child's share of the lit pixels, a pixel
    being red where R > 2G and green where G > 2R, must lie in MIX_SHARE."""
    import hikari_tpu_torch as hk

    names = ("closest_tiles", "occlusion_tiles")
    _, r = timed_render("mix", sc, cam, hk.VolPath(max_depth=2, samples_per_pixel=MAIN_SPP),
                        names, smi, None, 0.0)
    img = hk.framebuffer(r["film"])
    lit = img.sum(-1) > 1e-3
    red = float((img[..., 0] > 2 * img[..., 1])[lit].float().mean())
    green = float((img[..., 1] > 2 * img[..., 0])[lit].float().mean())
    lo, hi = MIX_SHARE
    ok = lo < red < hi and lo < green < hi
    log(f"[mix] {int(lit.sum())} lit pixels of {img.shape[1]}x{img.shape[0]}: red (m1) "
        f"{red:.4f}, green (m2) {green:.4f} (each within {lo}-{hi}) [{smi}] -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the Mix floor does not show both children")


def log_bounces(label, ins, smi):
    for i, b in enumerate(ins.bounces):
        log(f"[{label}] bounce {i}: {b['surface']} camera-path closest sweeps (1 + "
            f"{max(b['surface'] - 1, 0)} alpha rounds), {b['shadow']} shadow-walk closest "
            f"sweeps [{smi}]")


def textured_paths(sc, cam, smi):
    """Path A: the textured scene at full size, depth 5, under each
    TEXTURED_MODES dispatch. Its alpha makes shadow rays walk closest hits,
    so K1 alone launches. Per mode an instrumented wavefront prints the
    alpha rounds and shadow-walk sweeps per bounce and the stage split;
    under 'none' it also captures K1's calls (the alpha re-traces and
    shadow walks among them), and K1 goes against its plain version on
    every one, bit for bit (hold_path). Then a timed render
    (timed_render's checks). The modes must trace the same rays and agree
    in mean RGB within MODES_RGB_RTOL."""
    import hikari_tpu_torch as hk

    names = ("closest_tiles",)
    rays, rgb = {}, {}
    for mode in TEXTURED_MODES:
        label = f"textured {mode}"
        vp = hk.VolPath(max_depth=5, samples_per_pixel=MAIN_SPP, material_coherence=mode)
        stats, ins, rec, total = instrumented_lanes(sc, cam, vp, TEXTURE_STAGES,
                                                    names if mode == "none" else None)
        log_bounces(label, ins, smi)
        log(f"[{label}] stage split of one synchronised {cam.resolution[0]}x"
            f"{cam.resolution[1]} {vp.sample_batch}-sample wavefront, {total:.3f} s: "
            f"{ins.split(total)} [{smi}]")
        if rec is not None:
            hold_path(label, rec, [(names[0], sc.treelets)], smi)
            del rec  # the captured inputs stay out of the render's peak memory
        rays[mode] = float(stats["rays_traced"])
        _, r = timed_render(label, sc, cam, vp, names, smi, rays[mode],
                            float(stats["nonfinite_lanes"]))
        rgb[mode] = r["mean_rgb"]
        del r
    err = abs(rgb["sorted"] / rgb["none"] - 1)
    ok = rays["none"] == rays["sorted"] and err <= MODES_RGB_RTOL
    log(f"[textured] the modes: rays {rays['none']:.0f} / {rays['sorted']:.0f}, mean RGB "
        f"{rgb['none']:.7f} / {rgb['sorted']:.7f} ({err:.2e}, tolerance {MODES_RGB_RTOL:g}) "
        f"[{smi}] -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the textured scene renders differently under the two dispatches")


def cuda_secs(fn):
    """(result, seconds) of fn() between two synchronisations."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cornell_path(sc, cam, smi):
    """Path B: examples/cornell_scene.py's pipeline at full size through the
    public API: an instrumented wavefront (stage split; K1 and K2 against
    their plain versions on every captured call, bit for bit), a
    RenderMeter lap around render (timed_render's checks: K1 and K2
    launched, no other sweep), then render_aux, denoise, postprocess with
    ACES and write_png into chiprun_out/, each timed; the PNG must decode
    (read_png) to a finite, not black image of the render's size."""
    import numpy as np
    import hikari_tpu_torch as hk

    names = ("closest_tiles", "occlusion_tiles")
    vp = hk.VolPath(max_depth=CORNELL_DEPTH, samples_per_pixel=MAIN_SPP)
    stats, ins, rec, total = instrumented_lanes(sc, cam, vp, TEXTURE_STAGES, names)
    log_bounces("cornell", ins, smi)
    log(f"[cornell] stage split of one synchronised wavefront, {total:.3f} s: "
        f"{ins.split(total)} [{smi}]")
    hold_path("cornell", rec, [(n, sc.treelets) for n in names], smi)
    del rec
    rays = float(stats["rays_traced"])
    meter = hk.RenderMeter().start()
    _, r = timed_render("cornell", sc, cam, vp, names, smi, rays, float(stats["nonfinite_lanes"]))
    lap = meter.lap(rays)
    img = hk.framebuffer(r["film"])
    (albedo, normal, depth), aux_s = cuda_secs(lambda: hk.render_aux(sc, cam))
    den, den_s = cuda_secs(lambda: hk.denoise(img, albedo, normal, depth))
    OUT_DIR.mkdir(exist_ok=True)
    png = OUT_DIR / f"cornell_{cam.resolution[0]}.png"
    t0 = time.perf_counter()
    hk.write_png(png, hk.postprocess(den, tonemap="aces"))
    png_s = time.perf_counter() - t0
    back = hk.read_png(png)
    ok = (back.shape == (cam.resolution[1], cam.resolution[0], 3) and np.isfinite(back).all()
          and back.mean() > 0.0 and bool(den.isfinite().all()))
    log(f"[cornell] RenderMeter {json.dumps(lap)}; render_aux {aux_s * 1e3:.1f} ms, denoise "
        f"({hk.DenoiseConfig().iterations} passes) {den_s * 1e3:.1f} ms, postprocess + write_png "
        f"{png_s * 1e3:.1f} ms -> {png.relative_to(ROOT)} ({png.stat().st_size} B, decodes to "
        f"{back.shape}, mean {back.mean():.4f}; covered pixels "
        f"{float((depth > 0).float().mean()):.4f}) "
        f"[{smi}] -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the Cornell pipeline's PNG does not decode to a finite, lit image")


def foliage_path(sc, smi):
    """Path C: tests/test_alpha_mix.py's foliage stack; _closest_hit_surface
    over MAIN_RES^2 x MAIN_SPP rays along +z from seeded origins over
    [-3, 3]^2: its escape share within that test's bound of 0.7^8, the
    closest sweeps it took (K1 only), the stage split, time and peak
    memory."""
    import torch
    from hikari_tpu_torch.geometry import sweep
    from hikari_tpu_torch.integrators import volpath
    from hikari_tpu_torch.scenes import FOLIAGE_ALPHA, FOLIAGE_LAYERS

    n = MAIN_RES * MAIN_RES * MAIN_SPP
    gen = torch.Generator(device="cpu").manual_seed(0)
    o = torch.zeros(n, 3)
    o[:, :2] = torch.rand(n, 2, generator=gen) * 6.0 - 3.0
    o = o.to(sc.device)
    d = torch.tensor([0.0, 0.0, 1.0], device=sc.device).expand(n, 3).contiguous()
    t_max = torch.full((n,), float("inf"), device=sc.device)
    active = torch.ones(n, dtype=torch.bool, device=sc.device)
    volpath._closest_hit_surface(sc, o[:1024], d[:1024], t_max[:1024], active[:1024])  # warm
    torch.cuda.reset_peak_memory_stats()
    sweep.reset_counts()
    with ShadingInstruments(TEXTURE_STAGES) as ins:
        ins.bounces.append(dict(surface=0, shadow=0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = volpath._closest_hit_surface(sc, o, d, t_max, active)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = dict(sweep.launches)
    escape = 1.0 - float(rec.hit.float().mean())
    expect = (1.0 - FOLIAGE_ALPHA) ** FOLIAGE_LAYERS
    rays = ins.bounces[0]["surface"]
    ok = (abs(escape - expect) < 0.35 * expect + 0.01 and counts["closest_tiles"] > 0
          and not any(v for k, v in counts.items() if k != "closest_tiles"))
    log(f"[foliage] {n} rays through {FOLIAGE_LAYERS} alpha-{FOLIAGE_ALPHA} quads: "
        f"{secs * 1e3:.1f} ms ({n / secs / 1e6:.1f} M of these rays/s), {rays} closest sweeps "
        f"(1 + {rays - 1} alpha rounds), launches "
        f"{counts}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; stage split "
        f"{ins.split(secs)}; escape share {escape:.5f} (0.7^8 = {expect:.5f}, bound "
        f"{0.35 * expect + 0.01:.5f}) [{smi}] -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the foliage stack's escape share or launches are off")


def aux_check(which, sc, smi):
    """Phase 4: a 64x64 render_aux of a scene against the JAX package's,
    pixel for pixel (scenes.aux_against_reference; data/aux_ref.npz,
    tools/gen_probe_ref.py --renders): every pixel keeps the reference's
    face or sits on a verified tie (both faces hold the hit point, t
    within AUX_TIE_RTOL); depth within AUX_RTOL relative on every pixel,
    the shading normal within AUX_RTOL on the pixels of the same face, and
    their mean albedo within AUX_RTOL relative. The means over every
    pixel are printed beside the reference's for information (a tie
    pixel's normal and albedo are another face's)."""
    from hikari_tpu_torch.scenes import AUX_TIE_RTOL, aux_against_reference

    r = aux_against_reference(sc, which)
    ok = (r["unexplained"] == 0 and r["depth_err"] <= AUX_RTOL and r["normal_err"] <= AUX_RTOL
          and r["albedo_mean_err"] <= AUX_RTOL)
    (alb, nrm, dep), (ralb, rnrm, rdep) = r["means"], r["ref_means"]
    log(f"[transport] {which} render_aux {r['res']}x{r['res']}: {r['same']} of {r['pixels']} "
        f"pixels on the reference's face, {r['ties']} on a tie (t within {AUX_TIE_RTOL:g}; "
        f"pixels and (port, reference) faces {list(zip(r['tie_pixels'], r['tie_faces']))}), "
        f"{r['unexplained']} unexplained; largest differences: depth {r['depth_err']:.2e} "
        f"(every pixel), normal {r['normal_err']:.2e}, mean albedo {r['albedo_mean_err']:.2e} "
        f"(same face; per pixel {r['albedo_err']:.2e}), tolerance {AUX_RTOL:g}; means over "
        f"every pixel: albedo {alb:.6f} vs {ralb:.6f}, normal "
        f"{[round(x, 6) for x in nrm]} vs {[round(x, 6) for x in rnrm]}, depth {dep:.6f} vs "
        f"{rdep:.6f} [{smi}] -> {'pass' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{which} render_aux differs from the JAX package's")


def sparse_paths(sparse, cam, smi):
    """The sparse cloud's medium path (medium_path, the example's depth)
    with the brick pool's and page table's bytes beside its peak memory;
    the same samples again on the dense twin (the same file read as a
    dense grid: the same transport, so the ms/sample difference is what the
    brick reads cost); and the sparse cloud once more under another sampler
    seed, whose spread from the first sets the scale of the twin's
    agreement in mean RGB (within TWIN_RGB_TOL)."""
    import hikari_tpu_torch as hk
    from hikari_tpu_torch.scenes import sparse_cloud_scene

    depth = MEDIUM_DEPTH["sparse_cloud"]
    names = ("closest_tiles",)
    media = sparse.media
    pool, table = (media.brick_vals.numel() * 4, media.brick_table.numel() * 4)
    a = medium_path("sparse cloud", sparse, cam, depth, names, smi)
    log(f"[sparse cloud] brick pool {pool / 2**20:.3f} MiB ({pool // 2048} bricks), page "
        f"table {table / 2**10:.1f} KiB ({tuple(media.grid_res[0].tolist())} index voxels), "
        f"beside a peak of {a['peak'] / 2**30:.2f} GiB [{smi}]")
    del a["film"]
    dense = sparse_cloud_scene(dense=True).build(device=sparse.device)
    b = medium_path("sparse cloud dense twin", dense, cam, depth, names, smi)
    del b["film"], dense
    _, c = timed_render("sparse cloud seed 1", sparse, cam,
                        hk.VolPath(max_depth=depth, samples_per_pixel=MAIN_SPP, seed=1),
                        names, smi, None, 0.0)
    spread = abs(c["mean_rgb"] / a["mean_rgb"] - 1)
    diff = abs(b["mean_rgb"] / a["mean_rgb"] - 1)
    ok = diff <= TWIN_RGB_TOL
    log(f"[sparse cloud] sparse {a['ms_sample']:.1f} ms/sample, dense twin "
        f"{b['ms_sample']:.1f} ms/sample: the brick reads cost "
        f"{a['ms_sample'] - b['ms_sample']:.1f} ms/sample ({a['ms_sample'] / b['ms_sample']:.3f}x); "
        f"mean RGB sparse {a['mean_rgb']:.6f}, dense {b['mean_rgb']:.6f} ({diff * 100:.3f}%, "
        f"tolerance {TWIN_RGB_TOL * 100:g}%), sparse under seed 1 {c['mean_rgb']:.6f} "
        f"({spread * 100:.3f}%: the spread of two draws) [{smi}] -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the dense twin does not render as the sparse cloud")


def sparse_index_check(dev, smi):
    """A 4096^3 index space of two opaque corner bricks (a 512^3 int32 page
    table, 512 MiB) on the card: delta tracking passes the empty middle
    (>= 0.99) and is stopped by a corner brick (< 0.2), and the device
    memory grows by under 1 GiB where the dense extent would be 256 GiB."""
    import numpy as np
    import torch
    from hikari_tpu_torch.media import sample as ms
    from hikari_tpu_torch.media.types import BrickGridMedium, pack_media
    from hikari_tpu_torch.spectral.rgb2spec import srgb_table

    nb = SPARSE_INDEX_RES // 8
    table = np.full((nb, nb, nb), -1, np.int32)
    table[0, 0, 0] = 0
    table[-1, -1, -1] = 1
    t0 = time.perf_counter()
    banks = pack_media([BrickGridMedium(table=table, bricks=np.full((2, 512), 8.0, np.float32),
                                        bounds_lo=(0, 0, 0), bounds_hi=(1, 1, 1),
                                        sigma_a=(2000.0,) * 3, sigma_s=(0.0,) * 3)])
    del table
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    banks = banks.to(dev)
    lut = srgb_table().to(dev)
    n = 65536
    gen = torch.Generator(device="cpu").manual_seed(7)
    through = {}
    for name, cx, spread in (("middle", 0.5, 0.1),
                             ("corner brick", 0.0, 4.0 / SPARSE_INDEX_RES)):
        o = torch.zeros(n, 3)
        o[:, :2] = cx + torch.rand(n, 2, generator=gen) * spread
        o[:, 2] = -0.1 - torch.rand(n, generator=gen) * 0.01
        ones = torch.ones(n, 4, device=dev)
        res = ms.delta_track(
            banks, lut, torch.zeros(n, dtype=torch.int32, device=dev), o.to(dev),
            torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n, 3).contiguous(),
            torch.full((n,), 1.3, device=dev),
            torch.tensor([500.0, 550.0, 600.0, 650.0], device=dev).expand(n, 4).contiguous(),
            ones, ones, ones, torch.ones(n, dtype=torch.bool, device=dev),
            torch.zeros(n, dtype=torch.bool, device=dev))
        through[name] = float((res.status != ms.ABSORBED).float().mean())
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - base
    ok = (through["middle"] >= 0.99 and through["corner brick"] < 0.2 and growth < 2**30
          and banks.brick_vals.numel() == 1024)
    log(f"[sparse index] {SPARSE_INDEX_RES}^3 index voxels ({nb}^3 page table, "
        f"{banks.brick_table.numel() * 4 / 2**20:.0f} MiB; 2 bricks, "
        f"{banks.brick_vals.numel() * 4} B; packed on the host in {host_s:.1f} s): "
        f"{n} delta-tracked rays pass the empty middle at {through['middle']:.4f} and a "
        f"corner brick at {through['corner brick']:.4f}; device memory grew by "
        f"{growth / 2**20:.1f} MiB (the dense extent: "
        f"{SPARSE_INDEX_RES ** 3 * 4 / 2**30:g} GiB) [{smi}] -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"the {SPARSE_INDEX_RES}^3 sparse index space check failed")


def filter_paths(sc, cam, smi):
    """The default scene under the Mitchell filter (negative lobes, the
    tabulated 2D distribution) at full size, each kernel held against its
    plain version on every sweep call of the warm-up wavefront; then the
    same samples in the crop window ((0.25, 0.25), (0.75, 0.75)), whose
    film must equal the full film's window (lanes carry full-image pixels)
    within rtol 1e-5 / atol 1e-6."""
    import torch
    import hikari_tpu_torch as hk
    from hikari_tpu_torch.geometry import wavefront

    names = ("closest_tiles", "occlusion_tiles")
    _, rec, full = main_path("mitchell", sc, cam, wavefront, names, smi, ftype=hk.MITCHELL)
    hold_path("mitchell", rec, [(n, sc.treelets) for n in names], smi)
    del rec
    w, h = cam.resolution
    film = hk.make_film(w, h, device=sc.device, crop_bounds=CROP)
    _, crop = timed_render("mitchell crop", sc, cam,
                           hk.VolPath(max_depth=5, samples_per_pixel=MAIN_SPP), names, smi,
                           None, 0.0, filt=hk.make_filter(hk.MITCHELL), film=film)
    x0, y0 = film.crop_x0, film.crop_y0
    err = {}
    for name in ("rgb_sum", "weight_sum"):
        got = getattr(crop["film"], name)
        want = getattr(full["film"], name)[y0:y0 + film.height, x0:x0 + film.width]
        err[name] = float(((got - want).abs() / (1e-6 + 1e-5 * want.abs())).max())
    ok = max(err.values()) <= 1.0
    log(f"[mitchell crop] window {film.width}x{film.height} at ({x0}, {y0}) of {w}x{h}: "
        f"{crop['ms_sample']:.1f} ms/sample against the full {full['ms_sample']:.1f} "
        f"({crop['ms_sample'] / full['ms_sample']:.3f}x); the film sums against the full "
        f"film's window, worst error over (1e-6 + 1e-5 |full|): rgb_sum "
        f"{err['rgb_sum']:.3f}, weight_sum {err['weight_sum']:.3f} [{smi}] -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the crop window's film differs from the full render's window")
    del full, crop
    torch.cuda.empty_cache()


# --- this slice's paths: the preview integrators, SPPM, the skip-link walk, the sharded
# render, the profiling helpers and the port's quickstart (phase 5, A-G) -----------------

PREVIEW_RGB_RTOL = 1e-5   # the skip-link probe's mean RGB against the packets'
SHARDED_RTOL = 1e-6       # render_sharded's film against render's, every pixel
BRUTE_RAYS = 4096         # seeded rays of the skip-link walk against the brute force
TRACE_KEEP_BYTES = 16 * 2**20  # a larger profiler trace is removed once checked


def preview_path(label, integ, sc, cam, smi):
    """Paths A / B: a preview integrator at its defaults through
    render_preview. First sample 0 alone, instrumented: the rays it traces
    (closest-hit lanes and shadow rays), the lanes alive at each bounce
    (Whitted: the specular lanes still followed), a synchronising stage
    split (traversal / NEE / BSDF sample / the rest), and every K1 / K2 call
    captured and held against its plain version bit for bit (hold_path).
    Then the timed render_preview with the launch counts reset just before
    and read just after: finite, not black, K1 and K2 launched and no other
    sweep."""
    import torch
    import hikari_tpu_torch as hk
    from hikari_tpu_torch.geometry import sweep, wavefront
    from hikari_tpu_torch.integrators import preview

    names = ("closest_tiles", "occlusion_tiles")
    w, h = cam.resolution
    stages = {"traversal": [(preview, "scene_closest_hit"), (preview, "scene_any_hit")],
              "NEE": [(preview, "_direct_light_bsdf"), (preview, "_direct_light_rgb")],
              "BSDF sample": [(preview, "_sample_bsdf_dispatch")]}
    stats = {"rays": torch.zeros((), device=sc.device), "alive": []}
    with Recorder(wavefront, names) as rec, StageTimers(stages) as ins:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preview.preview_lanes(integ, sc, cam, 0, stats)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    rays = float(stats["rays"])
    alive = [int(a) for a in stats["alive"]]
    log(f"[{label}] sample 0 of {w}x{h}: {rays:.0f} rays; lanes alive at each bounce "
        f"{alive}; stage split of the synchronised sample, {total:.3f} s: "
        f"{ins.split(total)}; sweep calls {dict((n, len(c)) for n, c in rec.calls.items())} "
        f"[{smi}]")
    hold_path(label, rec, [(n, sc.treelets) for n in names], smi)
    del rec
    hk.render_preview(integ, sc, cam)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sweep.reset_counts()
    t0 = time.perf_counter()
    img = hk.framebuffer(hk.render_preview(integ, sc, cam))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, plain_runs = dict(sweep.launches), dict(sweep.plain_cuda_runs)
    spp = integ.samples_per_pixel
    finite, mean_rgb = bool(torch.isfinite(img).all()), float(img.mean())
    log(f"[{label}] render_preview {w}x{h}, {spp} spp: {wall:.3f} s, "
        f"{wall / spp * 1e3:.1f} ms/sample, {rays * spp / wall / 1e6:.3f} Mray/s (sample 0's "
        f"rays x {spp}), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; mean RGB "
        f"{mean_rgb:.6f}, finite {finite}; launches {counts} [{smi}]")
    if not finite or mean_rgb <= 0.0:
        raise SystemExit(f"{label}: output is not a finite, non-black image")
    launched_exactly(label, names, counts, plain_runs)
    return wall / spp * 1e3


def sppm_path(sc, cam, smi):
    """Path C: SPPM() at its defaults through render_sppm. The first
    iteration alone, with every K1 / K2 call (the camera pass's closest and
    shadow sweeps, the photon pass's closest sweeps) captured and held
    against its plain version bit for bit. Then the timed render_sppm with
    the launch counts reset just before and read just after, under
    synchronising stage timers: ms an iteration of the camera pass, photon
    pass, sort, gather and update; the deposits of each photon pass; the
    mean radius after the last iteration. Finite, not black, K1 and K2
    launched and no other sweep."""
    import torch
    import hikari_tpu_torch as hk
    from hikari_tpu_torch.geometry import sweep, wavefront
    from hikari_tpu_torch.integrators import sppm

    names = ("closest_tiles", "occlusion_tiles")
    integ = hk.SPPM()
    w, h = cam.resolution
    with Recorder(wavefront, names) as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sppm._sppm_iteration(integ, sc, cam, sppm.sppm_initial_state(integ, w * h, sc.device),
                             0)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
    log(f"[sppm] iteration 0, recorded: {first:.3f} s, sweep calls "
        f"{dict((n, len(c)) for n, c in rec.calls.items())} [{smi}]")
    hold_path("sppm", rec, [(n, sc.treelets) for n in names], smi)
    del rec
    deposits, last = [], {}
    sort = sppm._sort_photons
    update = sppm._sppm_update

    def counted_sort(ph_p, ph_pow, ph_n, ph_ok, *rest):
        deposits.append(int(ph_ok.sum()))
        return sort(ph_p, ph_pow, ph_n, ph_ok, *rest)

    def kept_update(*args):
        last["state"] = update(*args)
        return last["state"]

    stages = {"camera pass": [(sppm, "_visible_points")], "photon pass": [(sppm, "_trace_photons")],
              "sort": [(sppm, "_sort_photons")], "gather": [(sppm, "_gather_sorted")],
              "update": [(sppm, "_sppm_update")]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sweep.reset_counts()
    sppm._sort_photons, sppm._sppm_update = counted_sort, kept_update
    try:
        with StageTimers(stages) as ins:
            t0 = time.perf_counter()
            img = hk.render_sppm(integ, sc, cam)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        sppm._sort_photons, sppm._sppm_update = sort, update
    counts, plain_runs = dict(sweep.launches), dict(sweep.plain_cuda_runs)
    n_it = integ.iterations
    radius = float(torch.sqrt(last["state"]["r2"]).mean())
    finite, mean_rgb = bool(torch.isfinite(img).all()), float(img.mean())
    log(f"[sppm] render_sppm {w}x{h}, {n_it} iterations of {integ.photons_per_iteration} "
        f"photons, depth {integ.max_depth}: {wall:.3f} s, {wall / n_it * 1e3:.1f} ms an "
        f"iteration: {ins.split(wall, per=n_it)} (per iteration); deposits a photon pass "
        f"{deposits} of {integ.photons_per_iteration * (integ.max_depth - 1)} slots; mean "
        f"radius after the last iteration {radius:.6f} (initial {integ.initial_radius}); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; mean RGB {mean_rgb:.6f}, finite "
        f"{finite}; launches {counts} [{smi}]")
    if not finite or mean_rgb <= 0.0 or not deposits or min(deposits) <= 0:
        raise SystemExit("sppm: the image is not finite and lit, or a photon pass deposited "
                         "nothing")
    launched_exactly("sppm", names, counts, plain_runs)
    return wall / n_it * 1e3


def skiplink_checks(packets_scene, cam, smi):
    """Path D: the default scene built with traversal='skiplink'. Its 64x64
    transport probe traces the packet engine's rays, mean RGB within
    PREVIEW_RGB_RTOL, and launches no sweep kernel; the walk equals
    brute_force_closest_hit on BRUTE_RAYS seeded rays (hit, t, tri); one
    primary sweep of the camera's pixel centres timed beside the packet
    engine's closest hit and K1 alone on its call (for information)."""
    import torch
    from hikari_tpu_torch.geometry import sweep, traverse, wavefront
    from hikari_tpu_torch.integrators.volpath import pixel_centre_rays, scene_closest_hit
    from hikari_tpu_torch.scenes import default_scene, transport_probe

    dev = packets_scene.device
    t0 = time.perf_counter()
    sk = default_scene().build(traversal="skiplink", device=dev)
    build_s = time.perf_counter() - t0
    sweep.reset_counts()
    (rays_s, rgb_s), probe_s = cuda_secs(lambda: transport_probe(sk, "default"))
    counts = dict(sweep.launches)
    rays_p, rgb_p = transport_probe(packets_scene, "default")
    err = abs(rgb_s / rgb_p - 1)
    ok = rays_s == rays_p and err <= PREVIEW_RGB_RTOL and not any(counts.values())
    log(f"[skiplink] default scene built with traversal='skiplink' in {build_s:.1f} s "
        f"({sk.bvh.lo.shape[0]} nodes); 64x64 probe in {probe_s:.1f} s: rays {rays_s:.0f} vs "
        f"the packets' {rays_p:.0f}, mean RGB {rgb_s:.7f} vs {rgb_p:.7f} ({err:.2e}, tolerance "
        f"{PREVIEW_RGB_RTOL:g}); launches {counts} [{smi}] -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the skip-link walk does not render as the packet engine")
    gen = torch.Generator(device="cpu").manual_seed(11)
    lo, hi = sk.world_lo.cpu(), sk.world_hi.cpu()
    o = (lo + (hi - lo) * torch.rand(BRUTE_RAYS, 3, generator=gen)).to(dev)
    d = torch.nn.functional.normalize(torch.randn(BRUTE_RAYS, 3, generator=gen), dim=-1).to(dev)
    inf = torch.full((BRUTE_RAYS,), float("inf"), device=dev)
    rec = traverse.closest_hit(sk.bvh, o, d, inf)
    ref = traverse.brute_force_closest_hit(sk.bvh.p0, sk.bvh.p1, sk.bvh.p2, o, d, inf)
    ok = (torch.equal(rec.hit, ref.hit) and torch.equal(rec.tri, ref.tri)
          and torch.equal(rec.t[rec.hit], ref.t[ref.hit]))
    log(f"[skiplink] closest_hit against brute_force_closest_hit on {BRUTE_RAYS} seeded rays "
        f"({sk.n_faces} triangles): {int(rec.hit.sum())} hits, hit / tri / t equal "
        f"{'yes' if ok else 'NO'} [{smi}] -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the skip-link walk differs from the brute force")
    o, d = pixel_centre_rays(cam, dev)
    inf = torch.full((o.shape[0],), float("inf"), device=dev)
    rec_s, walk_s = cuda_secs(lambda: traverse.closest_hit(sk.bvh, o, d, inf))
    with Recorder(wavefront, ("closest_tiles",)) as r:
        rec_p = scene_closest_hit(packets_scene, o, d, inf)
    _, packets_s = cuda_secs(lambda: scene_closest_hit(packets_scene, o, d, inf))
    k1_ms = cuda_ms(lambda: sweep.closest_tiles(*r.calls["closest_tiles"][0]), 3)
    same = float((rec_s.tri == rec_p.tri).float().mean())
    log(f"[skiplink] one {cam.resolution[0]}x{cam.resolution[1]} primary sweep: the walk "
        f"{walk_s * 1e3:.1f} ms, the packet engine {packets_s * 1e3:.1f} ms (K1 alone "
        f"{k1_ms:.3f} ms); the same face on {same:.6f} of the lanes (for information) [{smi}]")
    del sk


def sharded_check(sc, cam, ref_film, smi):
    """Path E: render_sharded at world size 1 (an NCCL group of this
    process, dp = sp = 1) of the default scene, VolPath(max_depth=5,
    samples_per_pixel=MAIN_SPP): its film against the main path's render,
    every pixel's rgb_sum and weight_sum within SHARDED_RTOL relative; K1
    and K2 launched and no other sweep."""
    import socket

    import torch
    import torch.distributed as dist
    import hikari_tpu_torch as hk
    from hikari_tpu_torch.geometry import sweep

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(sc.device.index or 0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = hk.make_render_mesh(dp=1)
        sweep.reset_counts()
        film, secs = cuda_secs(lambda: hk.render_sharded(
            hk.VolPath(max_depth=5, samples_per_pixel=MAIN_SPP), sc, cam, mesh))
        counts, plain_runs = dict(sweep.launches), dict(sweep.plain_cuda_runs)
    finally:
        dist.destroy_process_group()
    err = max(float(((getattr(film, k) - getattr(ref_film, k)).abs()
                     / getattr(ref_film, k).abs().clamp(min=1e-30)).max())
              for k in ("rgb_sum", "weight_sum"))
    ok = err <= SHARDED_RTOL and film.iteration == ref_film.iteration
    log(f"[sharded] render_sharded on a ('dp', 'sp') = {tuple(mesh.mesh.shape)} NCCL mesh, "
        f"{cam.resolution[0]}x{cam.resolution[1]}, {MAIN_SPP} spp: {secs:.3f} s, "
        f"{secs / MAIN_SPP * 1e3:.1f} ms/sample; its film against render's: largest relative "
        f"difference {err:.2e} (tolerance {SHARDED_RTOL:g}); launches {counts} [{smi}] -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("render_sharded does not equal render")
    launched_exactly("sharded", ("closest_tiles", "occlusion_tiles"), counts, plain_runs)


def profiling_check(sc, cam, smi):
    """Path F: profiling.trace around one Whitted sample (path A) must write
    a Chrome trace into chiprun_out/trace/ (kept up to TRACE_KEEP_BYTES);
    stage_timings of the default scene prints its three times."""
    import hikari_tpu_torch as hk
    from hikari_tpu_torch.integrators import preview
    from hikari_tpu_torch.utils import profiling

    out = OUT_DIR / "trace"
    before = set(out.glob("trace_*.json")) if out.is_dir() else set()
    _, secs = cuda_secs(lambda: _traced_sample(profiling, preview, hk, sc, cam, out))
    new = sorted(set(out.glob("trace_*.json")) - before)
    ok = len(new) == 1 and new[0].stat().st_size > 0
    size = new[0].stat().st_size if new else 0
    kept = "kept"
    if size > TRACE_KEEP_BYTES:  # chiprun_out/ must stay small
        new[0].unlink()
        kept = "removed after the check"
    t = profiling.stage_timings(sc, cam)
    log(f"[profiling] trace of one Whitted sample: {secs:.3f} s with the profiler, "
        f"{'; '.join(str(p.relative_to(ROOT)) for p in new)} ({size / 2**20:.1f} MiB, "
        f"{kept}); "
        f"stage_timings of the default scene at {cam.resolution[0]}x{cam.resolution[1]}: "
        + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in t.items())
        + f" [{smi}] -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("profiling.trace wrote no trace file")


def _traced_sample(profiling, preview, hk, sc, cam, out):
    with profiling.trace(str(out)):
        preview.preview_lanes(hk.Whitted(), sc, cam, 0)


def quickstart_example(smi):
    """Path G: examples/torch_quickstart.py as a user runs it, writing its
    three PNGs into chiprun_out/; each must decode (read_png) to a finite,
    lit 192x192 image."""
    import numpy as np
    import hikari_tpu_torch as hk

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_quickstart.py"),
                          str(OUT_DIR)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if out.returncode:
        raise SystemExit(f"examples/torch_quickstart.py failed:\n{out.stdout}\n{out.stderr}")
    parts = []
    ok = True
    for which in ("volpath", "whitted", "preview"):
        png = OUT_DIR / f"torch_quickstart_{which}.png"
        img = hk.read_png(png)
        good = img.shape == (192, 192, 3) and np.isfinite(img).all() and img.mean() > 0.0
        ok = ok and good
        parts.append(f"{png.relative_to(ROOT)} mean {img.mean():.4f}")
    log(f"[quickstart] examples/torch_quickstart.py ran in {secs:.1f} s (a new process): "
        + "; ".join(parts) + f" [{smi}] -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("examples/torch_quickstart.py wrote an image that is not finite and lit")


def slice_paths(scenes, main_cam, main_film, smi):
    """Phase 5's paths A-G on the default scene at full size."""
    import hikari_tpu_torch as hk

    sc = scenes["default"]
    t0 = time.perf_counter()
    ms = {"whitted": preview_path("whitted", hk.Whitted(), sc, main_cam, smi),
          "fast": preview_path("fast", hk.FastWavefront(), sc, main_cam, smi),
          "sppm": sppm_path(sc, main_cam, smi)}
    skiplink_checks(sc, main_cam, smi)
    sharded_check(sc, main_cam, main_film, smi)
    profiling_check(sc, main_cam, smi)
    quickstart_example(smi)
    log(f"[time] paths A-G took {time.perf_counter() - t0:.0f} s: Whitted "
        f"{ms['whitted']:.1f} ms/sample, FastWavefront {ms['fast']:.1f} ms/sample, SPPM "
        f"{ms['sppm']:.1f} ms an iteration [{smi}]")


# --- this slice's path H: the seven examples and the table generator (phase 5) -----------

# examples/torch_<name>.py -> arguments besides --out; each runs at its own
# defaults but for the clouds' samples (their tracking loops cost steps)
EXAMPLE_ARGS = {"cornell_scene": [], "dispersion_example": [], "instancing_example": [],
                "lensing_example": [], "medium_example": [],
                "cloud_example": ["--spp", "4"], "sparse_cloud_example": ["--spp", "4"]}
INST_EXAMPLES = ("instancing_example",)  # K3 / K4; the others K1 (and K2)
# the examples whose kernel is held on every sweep call (the clouds: their
# K1 calls at every bounce of depth 24 and 32); the others on their first
EVERY_CALL_EXAMPLES = ("cloud_example", "sparse_cloud_example")
POSITIONAL_OUT = ("instancing_example", "sparse_cloud_example")  # no --out flag
GEN_SPECTRUM_ATOL = 1e-3  # a generated table's spectra against its reference's
# share of float32 coefficients bit-equal (res 64), or within one ulp (res 8,
# 4,608 entries: tests/test_torch_rgb2spec_gen.py)
GEN_BIT_EQUAL_MIN = 0.999


class FirstCalls(Recorder):
    """A Recorder that keeps the first call of each entry point only."""

    def __enter__(self):
        for name, orig in self.orig.items():
            def wrapped(*args, _orig=orig, _name=name):
                if not self.calls[_name]:
                    self.calls[_name].append(args)
                return _orig(*args)

            setattr(self.module, name, wrapped)
        return self


class RenderProbe:
    """Counts the rays of every render_lanes call and times every
    hikari_tpu_torch.render call (between two synchronisations) while an
    example runs, keeping the last render's VolPath and camera. With
    one_wavefront, each render traces all its samples in one wavefront
    (sample_batch = samples_per_pixel; the same samples, so the same
    image): the examples' loops cost their host syncs, not their lanes, and
    the default batch of 4 took path H past its time budget on a slow
    host. (Not for the instancing example: its render is short, and its
    first K3 call, held against the plain walk, grows with the batch.)"""

    def __init__(self, one_wavefront: bool):
        self.one_wavefront = one_wavefront

    def __enter__(self):
        import dataclasses

        import hikari_tpu_torch as hk
        from hikari_tpu_torch.integrators import volpath

        self.rays, self.secs, self.vp, self.cam = 0.0, 0.0, None, None
        self.saved = [(volpath, "render_lanes", volpath.render_lanes),
                      (hk, "render", hk.render)]
        lanes, render = volpath.render_lanes, hk.render

        def counted(*args, **kw):
            out = lanes(*args, **kw)
            self.rays += float(out[2]["rays_traced"])
            return out

        def timed(vp, scene, camera, *args, **kw):
            if self.one_wavefront:
                vp = dataclasses.replace(vp, sample_batch=vp.samples_per_pixel)
            film, secs = cuda_secs(lambda: render(vp, scene, camera, *args, **kw))
            self.secs += secs
            self.vp, self.cam = vp, camera
            return film

        volpath.render_lanes = counted
        hk.render = timed
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def example_path(name, smi):
    """examples/torch_<name>.py through its main() at its defaults
    (EXAMPLE_ARGS), writing into chiprun_out/, with the launch counts reset
    just before and read just after: the PNG must decode (read_png) to a
    finite, lit image of the render's size, the path's closest kernel must
    have launched, no other family's kernel and no plain sweep on the card;
    then each kernel it launched against its plain version, bit for bit, on
    its first captured call, or on every one for EVERY_CALL_EXAMPLES
    (hold_path). Returns the launch counts."""
    import importlib.util

    import numpy as np
    import torch
    import hikari_tpu_torch as hk
    from hikari_tpu_torch.geometry import instanced, sweep, wavefront

    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    png = OUT_DIR / f"torch_{name}.png"
    out = [str(png)] if name in POSITIONAL_OUT else ["--out", str(png)]
    names = (("closest_inst", "occlusion_inst") if name in INST_EXAMPLES
             else ("closest_tiles", "occlusion_tiles"))
    module = instanced if name in INST_EXAMPLES else wavefront
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sweep.reset_counts()
    recorder = Recorder if name in EVERY_CALL_EXAMPLES else FirstCalls
    with recorder(module, names) as rec, \
            RenderProbe(one_wavefront=name not in INST_EXAMPLES) as probe:
        result, secs = cuda_secs(lambda: script.main([*out, *EXAMPLE_ARGS[name]]))
    counts = dict(sweep.launches)
    plain_runs = dict(sweep.plain_cuda_runs)
    peak = torch.cuda.max_memory_allocated()
    spp, (w, h) = probe.vp.samples_per_pixel, probe.cam.resolution
    img = hk.read_png(png)
    lit = (img.shape == (h, w, 3) and bool(np.isfinite(img).all()) and img.mean() > 0.0
           and bool(torch.isfinite(hk.framebuffer(result["film"])).all()))
    log(f"[examples] torch_{name} {' '.join(EXAMPLE_ARGS[name]) or '(defaults)'}: {secs:.1f} s "
        f"in main, render {w}x{h}, {spp} spp, depth {probe.vp.max_depth}: {probe.secs:.3f} s, "
        f"{probe.secs / spp * 1e3:.1f} ms/sample, {probe.rays:.0f} rays "
        f"({probe.rays / probe.secs / 1e6:.3f} Mray/s), peak {peak / 2**30:.2f} GiB; launches "
        f"{ {k: v for k, v in counts.items() if v} }; {png.relative_to(ROOT)} decodes to "
        f"{img.shape}, mean {img.mean():.4f} [{smi}] -> {'ok' if lit else 'FAIL'}")
    if not lit:
        raise SystemExit(f"torch_{name}: the PNG does not decode to a finite, lit image")
    if (counts[names[0]] <= 0 or any(v for n, v in counts.items() if n not in names)
            or any(plain_runs.values())):
        raise SystemExit(f"torch_{name}: launches {counts} and plain sweeps on CUDA "
                         f"{plain_runs}: not the path's kernels {names}")
    tl = None if name in INST_EXAMPLES else result["scene"].treelets
    if name in EVERY_CALL_EXAMPLES:
        hold_path(f"torch_{name}", rec, [(k, tl) for k in names if counts[k]], smi)
        return counts
    for kname in names:
        if not counts[kname]:
            continue
        r = compare(kname, rec.calls[kname][0], tl, reps=3)
        log(f"[examples] torch_{name} {kname}, first of its {counts[kname]} calls: agree "
            f"{r['agree']:.6f}, kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}), bit-equal "
            f"{'yes' if r['exact'] else 'NO'} [{smi}]")
        if not (r["ok"] and r["exact"]):
            raise SystemExit(f"torch_{name}: {kname} does not equal its plain version bit for "
                             f"bit on its first call")
    return counts


def generator_check(smi):
    """rgb2spec_gen.generate_table on the card: at res 8 against the JAX
    generator's stored output (hikari_tpu_torch/data/rgb2spec_gen_ref.npz),
    and at res 64, timed, against the shipped table
    (data/srgb_spectrum_table.npz): spectra within GEN_SPECTRUM_ATOL on every
    cell and >= GEN_BIT_EQUAL_MIN of the coefficients bit-equal; then both
    res-64 tables' Lab round trip (each cell's spectrum integrated back to
    sRGB against its grid RGB). The tables are written into chiprun_out/."""
    import numpy as np
    from hikari_tpu_torch._data import data_path
    from hikari_tpu_torch.spectral import rgb2spec_gen as gen

    OUT_DIR.mkdir(exist_ok=True)
    ok = True
    for res, ref_name, share in ((8, "rgb2spec_gen_ref.npz", "ulp_equal_share"),
                                 (64, "srgb_spectrum_table.npz", "bit_equal_share")):
        path = OUT_DIR / f"srgb_spectrum_table_{res}.npz"
        (scale, coeffs), secs = cuda_secs(
            lambda: gen.generate_table(res=res, verbose=False, device="cuda", path=path))
        with np.load(data_path(ref_name)) as ref:
            cmp = gen.compare_tables(coeffs, ref["coeffs"], device="cuda")
            same_scale = bool(np.array_equal(scale.astype(np.float32), ref["scale"]))
            good = (same_scale and cmp["max_spectrum_diff"] <= GEN_SPECTRUM_ATOL
                    and cmp[share] >= GEN_BIT_EQUAL_MIN)
            ok = ok and good
            log(f"[generator] generate_table(res={res}) on the card: {secs:.2f} s "
                f"({3 * res * res} cells x {res} brightness steps x 15 iterations); against "
                f"{ref_name}: scale equal {same_scale}, {json.dumps(cmp)} (spectra within "
                f"{GEN_SPECTRUM_ATOL:g}, {share} >= {GEN_BIT_EQUAL_MIN:.1%}) [{smi}] -> "
                f"{'ok' if good else 'FAIL'}")
            if res == 64:
                for label, (s_, c_) in (("generated", (scale, coeffs)),
                                        ("shipped", (ref["scale"], ref["coeffs"]))):
                    lab, lab_s = cuda_secs(lambda: gen.lab_round_trip(s_, c_, device="cuda"))
                    log(f"[generator] Lab round trip of the {label} res-64 table "
                        f"({lab_s:.2f} s): Delta E max {float(lab.max()):.6f}, median "
                        f"{float(lab.median()):.3e}, mean {float(lab.mean()):.6f}, "
                        f"{float((lab < 1.0).double().mean()):.4%} of cells under 1 [{smi}]")
    if not ok:
        raise SystemExit("the table generator does not reproduce its references")


def examples_path(smi):
    """Path H: every examples/torch_*.py but the quickstart (path G) in this
    process (example_path), then the table generator (generator_check).
    Returns {example: launch counts}."""
    t0 = time.perf_counter()
    OUT_DIR.mkdir(exist_ok=True)
    counts = {name: example_path(name, smi) for name in EXAMPLE_ARGS}
    t_ex = time.perf_counter() - t0
    generator_check(smi)
    log(f"[time] path H took {time.perf_counter() - t0:.0f} s (the examples "
        f"{t_ex:.0f} s) [{smi}]")
    return counts


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
    t_start = time.perf_counter()
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

    from hikari_tpu_torch.film.filters import LANCZOS, MITCHELL
    from hikari_tpu_torch.scenes import (BUILDERS, PACKET_PROBES, check_transport,
                                         cloud_grid_scene, cloud_scene, cornell_scene,
                                         default_scene, fog_scene, foliage_scene,
                                         forest_camera, forest_scene, instanced_default_scene,
                                         lights_scene, materials_scene, mix_scene,
                                         probe_reference,
                                         scene_camera, sparse_cloud_scene, sphere_scene,
                                         textured_scene, transport_probe, triangle_scene)

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
    # the medium probes (see FOG_PROBE_SPP)
    scenes["fog"] = fog_scene().build(device=dev)
    scenes["cloud grid"] = cloud_grid_scene().build(device=dev)
    rays, mean_rgb = transport_probe(scenes["fog"], "fog")
    ref = probe_reference("fog")
    dr = abs(rays / ref["rays_traced"] - 1)
    log(f"[transport] fog, the bench's 1-sample probe: rays {rays:.0f} vs "
        f"{ref['rays_traced']:.0f} ({dr * 100:.3f}%, tolerance 0.5%), mean RGB "
        f"{mean_rgb:.7f} vs {ref['mean_rgb']:.7f} "
        f"({abs(mean_rgb / ref['mean_rgb'] - 1) * 100:.3f}%, for information: one "
        f"sample's LCG draw) -> {'pass' if dr <= 0.005 else 'FAIL'}")
    if dr > 0.005:
        raise SystemExit("fog probe failed: rays of sample 0 against tools/transport_ref.json")
    for mode, switches, probe_kw in (("", {}, {}),
                                     (" under the pair-grid sweep", dict(SWEEP_MODE="pairs"), {}),
                                     (" under the resident loop", {}, dict(resident="on"))):
        with switched(wavefront, **switches):
            ok, msg = check_transport(scenes["fog"], "fog", spp=FOG_PROBE_SPP, **probe_kw)
        log(f"[transport] {msg}{mode} -> {'pass' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"fog probe failed{mode}: {msg}")
    ok, msg = check_transport(scenes["cloud grid"], "cloud_grid")
    log(f"[transport] {msg} -> {'pass' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"grid-cloud probe failed: {msg}")
    # the lights: sun and sky (sphere, sun-sky cloud), the uniform and BVH
    # samplers on the default scene, and the spot / distant / ambient /
    # environment lights scene
    scenes["sphere"] = sphere_scene().build(device=dev)
    scenes["cloud"] = cloud_scene().build(device=dev)
    scenes["lights"] = lights_scene().build(device=dev)
    for sampler in ("uniform", "bvh"):
        s = default_scene()
        s.set_light_sampler(sampler)
        scenes[f"default {sampler}"] = s.build(device=dev)
    for which, key in (("sphere", "sphere"), ("cloud", "cloud"), ("default", "default uniform"),
                       ("default", "default bvh"), ("lights", "lights")):
        ok, msg = check_transport(scenes[key], which)
        log(f"[transport] {msg} -> {'pass' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{key} probe failed: {msg}")
    del scenes["default uniform"], scenes["lights"]
    # the sparse cloud (a NanoVDB file read back as bricks) against the JAX
    # package's six-draw mean; the default scene under the tabulated filters
    t0 = time.perf_counter()
    scenes["sparse cloud"] = sparse_cloud_scene().build(device=dev)
    log(f"[transport] sparse cloud: generated, written, read back sparse and built in "
        f"{time.perf_counter() - t0:.1f} s")
    ok, msg = check_transport(scenes["sparse cloud"], "sparse_cloud")
    log(f"[transport] {msg} -> {'pass' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"sparse cloud probe failed: {msg}")
    for ftype in (MITCHELL, LANCZOS):
        ok, msg = check_transport(scenes["default"], "default", ftype=ftype,
                                  rgb_tol=FILTER_RGB_TOL)
        log(f"[transport] {msg} -> {'pass' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"filter probe failed: {msg}")
    # every material: the materials scene's probe under each dispatch
    scenes["materials"] = materials_scene().build(device=dev)
    for mode in MATERIAL_MODES:
        ok, msg = check_transport(scenes["materials"], "materials", material_coherence=mode)
        log(f"[transport] {mode} dispatch: {msg} -> {'pass' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"materials probe failed under {mode} dispatch: {msg}")
    # textures, alpha and the flagship example: the triangle, textured and
    # Cornell probes, and render_aux's means
    for which, build in (("triangle", triangle_scene), ("textured", textured_scene),
                         ("cornell", cornell_scene)):
        scenes[which] = build().build(device=dev)
        ok, msg = check_transport(scenes[which], which)
        log(f"[transport] {msg} -> {'pass' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{which} probe failed: {msg}")
    aux_check("textured", scenes["textured"], smi)
    aux_check("cornell", scenes["cornell"], smi)
    del scenes["triangle"]
    # the examples' scenes: dispersion against its stored JAX value; lensing,
    # the medium example and the cloud example against the JAX six-draw
    # means, the medium example's taken on the JAX packet engine (its smoke
    # box shares the floor's plane, ROADMAP C), with the JAX skip-link
    # walk's mean printed beside it
    for which in ("dispersion", "lensing", "medium_example", "cloud_example"):
        sc, build_s = cuda_secs(lambda: BUILDERS[which]().build(device=dev))
        (ok, msg), probe_s = cuda_secs(lambda: check_transport(sc, which))
        log(f"[transport] {msg} (built in {build_s:.1f} s, probed in {probe_s:.1f} s) -> "
            f"{'pass' if ok else 'FAIL'}")
        if which in PACKET_PROBES:
            ref = probe_reference(which, packets=False)
            log(f"[transport] {which}: the JAX skip-link walk's mean, for information: "
                f"rays_traced {ref['rays_traced']:.2f}, mean_rgb {ref['mean_rgb']:.7f}")
        if not ok:
            raise SystemExit(f"{which} probe failed: {msg}")
        del sc
    log(f"[time] phases 1-4 done at {time.perf_counter() - t_start:.0f} s")

    # phase 5: the main paths at full size: flat (tile sweeps, pair grid,
    # every switch on), then instanced
    main_cam = scene_camera("default", MAIN_RES)
    flat_counts, flat_rec, flat_result = main_path("main", scenes["default"], main_cam,
                                                   wavefront, flat_names, smi)
    main_film = flat_result.pop("film")
    del flat_result
    with switched(wavefront, SWEEP_MODE="pairs"):
        pair_counts, pair_rec, _ = main_path("pair grid", scenes["default"], main_cam,
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
    inst_counts, inst_rec, _ = main_path("instanced", scenes["instanced default"],
                                         scene_camera("default", MAIN_RES), instanced,
                                         inst_names, smi)
    # the lights' paths, each kernel held against its plain version on
    # every sweep call of the path: the sun and sky's shadow rays run to
    # twice the scene's radius (on the forest through 401 treelets of
    # unbounded world boxes); the BVH sampler descends its light tree per
    # lane. The forest's K3 walks grow past PLAIN_CALL_S after the first.
    for label, which, cam, module, names, partial in (
            ("forest", "forest", forest_camera(MAIN_RES, MAIN_RES), instanced, inst_names,
             ("closest_inst",)),
            ("sphere", "sphere", scene_camera("sphere", MAIN_RES), wavefront, flat_names, ()),
            ("bvh sampler", "default bvh", main_cam, wavefront, flat_names, ())):
        sc = scenes[which]
        _, rec, _ = main_path(label, sc, cam, module, names, smi)
        hold_path(label, rec, [(n, None if sc.has_instances else sc.treelets) for n in names],
                  smi, partial=partial)
        del rec  # the captured inputs stay out of the next path's peak memory
    # every material: the materials scene under each dispatch, the Mix floor
    materials_paths(scenes["materials"], scene_camera("materials", MAIN_RES), smi)
    del scenes["materials"]
    mix_path(mix_scene().build(device=dev), scene_camera("mix", MAIN_RES), smi)
    torch.cuda.empty_cache()
    # textures and alpha: the textured scene (K1 only), the Cornell example's
    # pipeline (K1 and K2), the foliage stack's alpha closest hits
    t0 = time.perf_counter()
    textured_paths(scenes["textured"], scene_camera("textured", MAIN_RES), smi)
    cornell_path(scenes["cornell"], scene_camera("cornell", MAIN_RES), smi)
    foliage_path(foliage_scene().build(device=dev), smi)
    del scenes["textured"], scenes["cornell"]
    torch.cuda.empty_cache()
    log(f"[time] the textured, Cornell and foliage paths took {time.perf_counter() - t0:.0f} s")
    log(f"[time] the flat, instanced, lights' and materials paths done at "
        f"{time.perf_counter() - t_start:.0f} s")
    # the medium paths: K1 (or K5) for camera rays and every shadow-walk
    # segment, no occlusion sweep
    for label, which, names, switches in (
            ("fog", "fog", ("closest_tiles",), {}),
            ("fog pair grid", "fog", ("closest_pairs",), dict(SWEEP_MODE="pairs")),
            ("cloud grid", "cloud_grid", ("closest_tiles",), {}),
            ("sun-sky cloud", "cloud", ("closest_tiles",), {})):
        t0 = time.perf_counter()
        with switched(wavefront, **switches):
            medium_path(label, scenes[which.replace("_", " ")],
                        scene_camera(which, MAIN_RES), MEDIUM_DEPTH[which], names, smi)
        log(f"[time] the {label} path at depth {MEDIUM_DEPTH[which]} took "
            f"{time.perf_counter() - t0:.0f} s")
    # the sparse cloud at the example's depth, its dense twin, a 4096^3
    # index space; the default scene under the Mitchell filter and its crop
    t0 = time.perf_counter()
    sparse_paths(scenes["sparse cloud"], scene_camera("sparse_cloud", MAIN_RES), smi)
    log(f"[time] the sparse cloud paths at depth {MEDIUM_DEPTH['sparse_cloud']} took "
        f"{time.perf_counter() - t0:.0f} s")
    del scenes["sparse cloud"]
    torch.cuda.empty_cache()
    sparse_index_check(dev, smi)
    filter_paths(scenes["default"], main_cam, smi)
    # the preview integrators, SPPM, the skip-link walk, the sharded render,
    # the profiling helpers and the port's quickstart example
    slice_paths(scenes, main_cam, main_film, smi)
    del main_film
    torch.cuda.empty_cache()
    # the seven examples and the table generator
    example_counts = examples_path(smi)
    log(f"[time] phase 5 done at {time.perf_counter() - t_start:.0f} s")

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
    for r in records:  # each kernel's launches on path H's examples
        r["launches_examples"] = {name: c[r["name"]] for name, c in example_counts.items()}
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.0f} s")
    log(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
