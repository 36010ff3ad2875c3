#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port (hikari_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits nonzero without its result line:

1. device: the card's name, torch and CUDA versions, and nvidia-smi's name
   and power limit;
2. build: csrc/sweep_tiles.cu (flat tile sweeps K1/K2), csrc/sweep_inst.cu
   (instanced sweeps K3/K4) and csrc/sweep_pairs.cu (pair-grid sweeps
   K5/K6), one nvcc each, started together;
3. kernels vs plain: the camera, first-bounce and first-bounce NEE
   wavefronts of a 256x256 render of each scene go through each kernel and
   its plain PyTorch version on the same CUDA tensors. Flat scenes: default
   (61,450 triangles) and mesh (327,680), each wavefront through both the
   tile kernels (K1/K2) and the pair-grid kernels (K5/K6) on the same pair
   list, with K5 against K1 printed for information; tr and column must
   agree on >= 99.9% of live lanes, t within 1e-5 relative where they
   agree.
   Instanced scenes: the default scene with its spheres instanced, and the
   400-tree forest; tri must agree on >= 99.9% of live lanes, t within 1e-5
   relative and b1 / b2 within 1e-4 where it agrees.
   Occlusion flags on >= 99.9%;
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
6. timings: each kernel against its plain version on a wavefront of its
   main path, and the tile kernels K1/K2 on the pair-grid path's pair
   lists, so the two decompositions are compared on the same work. Each
   kernel's bound is reckoned from the ray-triangle tests its plain
   version needs on those inputs (see BOUND below).

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


def compare(name, args, tl=None, reps=(10, 2)):
    """Kernel vs plain on one captured input; returns a result dict. tl:
    the flat treelets (the flat closest sweeps resolve t from their rows)."""
    import torch
    from hikari_tpu_torch.geometry import sweep
    from hikari_tpu_torch.geometry.wavefront import _resolve_hits

    kernel, plain = kernel_and_plain(name)
    out_k = kernel(*args)
    stats = {}
    out_p = plain(*args, stats=stats)
    torch.cuda.synchronize()
    o, d = args[0], args[1]
    n = o.shape[0]
    b_err = 0.0
    if name in ("closest_tiles", "closest_pairs"):
        live = (args[2] & ~sweep.COL_MASK) > 0  # initial reach > 0
        (key_k, tr_k), (key_p, tr_p) = out_k, out_p
        same = (tr_k == tr_p) & ((key_k & sweep.COL_MASK) == (key_p & sweep.COL_MASK))
        t_k = _resolve_hits(tl, key_k, tr_k, o, d)[0]
        t_p = _resolve_hits(tl, key_p, tr_p, o, d)[0]
        hit_k = tr_k >= 0
    elif name == "closest_inst":
        live = args[2] > 0.0
        (t_k, tri_k, b1_k, b2_k), (t_p, tri_p, b1_p, b2_p) = out_k, out_p
        same = tri_k == tri_p
        hit_k = tri_k >= 0
        both = same & live & hit_k
        if both.any():
            b_err = max(float((b1_k - b1_p).abs()[both].max()),
                        float((b2_k - b2_p).abs()[both].max()))
    else:
        live = args[2] > 0.0
        same = out_k == out_p
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
    ms_k = cuda_ms(lambda: kernel(*args), reps[0])
    ms_p = cuda_ms(lambda: plain(*args), reps[1])
    tre = args[3] if name == "closest_inst" else args[4]
    bound_ms, bound_by = bound(name, args, out_k, stats)
    return dict(ok=ok, agree=agree, max_abs_err=err, max_rel_err=rel, b_err=b_err,
                lanes=n, live=int(live.sum()), pairs=int(tre.numel()),
                swept=stats["pairs"], tests=stats["tests"],
                hits=int(hit_k[live].sum()), ms=ms_k, plain_ms=ms_p, bound_ms=bound_ms,
                bound_by=bound_by, out=out_k)


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
            f"{r['bound_ms']:.3f} ms [{smi}] -> {'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            failures.append(f"{label} {what} {name}")
        if name == closest:
            first[what] = r["out"]
        elif also and name == also[0]:
            (key_a, tr_a), (key_b, tr_b) = first[what], r["out"]
            live = (args[2] & ~255) > 0
            same = (tr_a == tr_b) & ((key_a & 255) == (key_b & 255))
            log(f"[kernels] {label} {what}: {name} vs {closest} on the same pair list "
                f"agree {float(same[live].float().mean()):.6f} (for information)")


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


def time_kernels(cases, counts, smi, label="at main-path shape"):
    """Kernels vs plain at main-path shapes; returns their JSON records."""
    records = []
    for name, replaces, args, tl in cases:
        r = compare(name, args, tl, reps=(5, 1))
        log(f"[timing] {name} {label}: agree {r['agree']:.6f} (lanes {r['lanes']}, "
            f"pairs {r['pairs']}, swept {r['swept']}, tests {r['tests']}), kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}) [{smi}] -> {'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            raise SystemExit(f"{name} disagrees with its plain version {label}")
        records.append({
            "name": name, "route": "cuda",
            "source": f"hikari_tpu_torch/csrc/{SOURCES[name.split('_')[1]]}",
            "replaces": replaces, "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "agree": r["agree"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "pairs_swept": r["swept"],
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
        compare_wavefronts(which, sc, scene_camera(which, 256), wavefront, flat_names,
                           sc.treelets, smi, failures, also=pair_names)
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
        compare_wavefronts(which, sc, cam, instanced, inst_names, None, smi, failures)
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
         flat_rec.calls["closest_tiles"][0], flat_tl),
        ("occlusion_tiles", "hikari_tpu/geometry/wavefront.py:1052",
         flat_rec.calls["occlusion_tiles"][0], flat_tl),
    ], flat_counts, smi) + time_kernels([
        ("closest_inst", "hikari_tpu/geometry/instanced.py:146",
         inst_rec.calls["closest_inst"][0], None),
        ("occlusion_inst", "hikari_tpu/geometry/instanced.py:194",
         inst_rec.calls["occlusion_inst"][0], None),
    ], inst_counts, smi) + time_kernels([
        ("closest_pairs", "hikari_tpu/geometry/wavefront.py:773",
         pair_rec.calls["closest_pairs"][0], flat_tl),
        ("occlusion_pairs", "hikari_tpu/geometry/wavefront.py:827",
         pair_rec.calls["occlusion_pairs"][0], flat_tl),
    ], pair_counts, smi)
    # the tile kernels on the pair-grid path's pair lists: the two
    # decompositions on the same work (printed only)
    time_kernels([(tiles, "", pair_rec.calls[pairs][0], flat_tl)
                  for tiles, pairs in zip(flat_names, pair_names)],
                 flat_counts, smi, label="on the pair-grid path's pair list")
    log(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
