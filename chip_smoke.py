#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port (hikari_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits nonzero without its result line:

1. device: the card's name, torch and CUDA versions, and nvidia-smi's name
   and power limit;
2. build: the two sweep kernels from hikari_tpu_torch/csrc with nvcc;
3. kernels vs plain: on the default (~33k triangles) and mesh (327,680
   triangles) scenes, the pair lists of three wavefronts of a 256x256
   render (camera rays, the first bounce, that bounce's NEE shadow rays)
   go through each kernel and its plain PyTorch version on the same CUDA
   tensors; tr and column must agree on >= 99.9% of live lanes, t within
   1e-5 relative where they agree, occlusion flags on >= 99.9%;
4. transport probes: the 64x64 probes of the default and mesh scenes
   against tools/transport_ref.json (rays within 0.5%, mean RGB within 2%);
5. main path: render(VolPath(max_depth=5, samples_per_pixel=4)) of the
   default scene at 800x800 through the public API, with the launch counts
   reset just before and read just after; the image must be finite, both
   kernels must have launched and the plain sweeps must not have run; then
   both kernels are timed against their plain versions on wavefronts of
   that main path.

The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}. It needs no network and one card; the
kernels are built into hikari_tpu_torch/build/ on first use.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
AGREE_MIN = 0.999   # tr/column and occlusion agreement, kernel vs plain
T_RTOL = 1e-5       # t where tr and column agree
MAIN_RES = 800
MAIN_SPP = 4


def log(*args):
    print(*args, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Recorder:
    """Wraps the sweep entry points the traversal calls, keeping the
    arguments of every call so the same inputs can be replayed."""

    def __init__(self, wavefront):
        self.wavefront = wavefront
        self.calls = {"closest_tiles": [], "occlusion_tiles": []}

    def __enter__(self):
        for name in self.calls:
            orig = getattr(self.wavefront, name)

            def wrapped(*args, _orig=orig, _name=name):
                self.calls[_name].append(args)
                return _orig(*args)

            setattr(self.wavefront, name, wrapped)
        return self

    def __exit__(self, *exc):
        from hikari_tpu_torch.geometry import sweep

        for name in self.calls:
            setattr(self.wavefront, name, getattr(sweep, name))


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


def compare(name, args, tl, reps=(10, 2)):
    """Kernel vs plain on one captured input; returns a result dict."""
    import torch
    from hikari_tpu_torch.geometry import sweep
    from hikari_tpu_torch.geometry.wavefront import _resolve_hits

    kernel = getattr(sweep, name)
    plain = getattr(sweep, name + "_plain")
    out_k = kernel(*args)
    out_p = plain(*args)
    torch.cuda.synchronize()
    o, d = args[0], args[1]
    n = o.shape[0]
    if name == "closest_tiles":
        live = (args[2] & ~sweep.COL_MASK) > 0  # initial reach > 0
        (key_k, tr_k), (key_p, tr_p) = out_k, out_p
        same = (tr_k == tr_p) & ((key_k & sweep.COL_MASK) == (key_p & sweep.COL_MASK))
        agree = float(same[live].float().mean()) if live.any() else 1.0
        t_k = _resolve_hits(tl, key_k, tr_k, o, d)[0]
        t_p = _resolve_hits(tl, key_p, tr_p, o, d)[0]
        both = same & live & (tr_k >= 0)
        err = float((t_k - t_p).abs()[both].max()) if both.any() else 0.0
        rel = float(((t_k - t_p).abs() / t_p.abs().clamp(min=1e-12))[both].max()) \
            if both.any() else 0.0
        ok = agree >= AGREE_MIN and rel <= T_RTOL
        hits = int((tr_k >= 0).sum())
    else:
        live = args[2] > 0.0
        same = out_k == out_p
        agree = float(same[live].float().mean()) if live.any() else 1.0
        err = float((out_k - out_p).abs().max()) if n else 0.0
        rel = 0.0
        ok = agree >= AGREE_MIN
        hits = int((out_k[live] > 0).sum())
    ms_k = cuda_ms(lambda: kernel(*args), reps[0])
    ms_p = cuda_ms(lambda: plain(*args), reps[1])
    return dict(ok=ok, agree=agree, max_abs_err=err, max_rel_err=rel, lanes=n,
                live=int(live.sum()), pairs=int(args[4].numel()), hits=hits,
                ms=ms_k, plain_ms=ms_p)


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

    # phase 2: build
    from hikari_tpu_torch.geometry import sweep, wavefront

    t0 = time.perf_counter()
    sweep.sweep_library()
    log(f"[build] nvcc built csrc/sweep_tiles.cu in {time.perf_counter() - t0:.1f} s "
        f"(flags: {' '.join(sweep.NVCC_FLAGS)})")

    import hikari_tpu_torch as hk
    from hikari_tpu_torch.integrators.volpath import render_lanes
    from hikari_tpu_torch.scenes import BUILDERS, check_transport, scene_camera

    # phase 3: kernels vs plain on three wavefronts per scene
    failures = []
    scenes = {}
    for which in ("default", "mesh"):
        t0 = time.perf_counter()
        scenes[which] = BUILDERS[which]().build(device=dev)
        sc = scenes[which]
        log(f"[kernels] {which}: {sc.n_faces} triangles, "
            f"{sc.treelets.lo.shape[0]} treelets, built in {time.perf_counter() - t0:.1f} s")
        res = 256
        lanes = torch.arange(res * res, device=dev)
        with Recorder(wavefront) as rec:
            render_lanes(hk.VolPath(max_depth=2, samples_per_pixel=1), sc,
                         scene_camera(which, res), hk.make_filter(), 0,
                         lanes % res, lanes // res)
        cases = [("camera rays", "closest_tiles", rec.calls["closest_tiles"][0]),
                 ("bounce 1", "closest_tiles", rec.calls["closest_tiles"][1]),
                 ("bounce 1 NEE", "occlusion_tiles", rec.calls["occlusion_tiles"][1])]
        for label, name, args in cases:
            r = compare(name, args, sc.treelets)
            log(f"[kernels] {which} {label}: {name} agree {r['agree']:.6f} "
                f"(lanes {r['lanes']}, live {r['live']}, pairs {r['pairs']}, "
                f"hits {r['hits']}), t max rel err {r['max_rel_err']:.2e}, "
                f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms "
                f"[{smi}] -> {'ok' if r['ok'] else 'FAIL'}")
            if not r["ok"]:
                failures.append(f"{which} {label}")
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

    # phase 5: the main path at full size
    sc = scenes["default"]
    cam = scene_camera("default", MAIN_RES)
    vp = hk.VolPath(max_depth=5, samples_per_pixel=MAIN_SPP)
    k = vp.sample_batch
    n = MAIN_RES * MAIN_RES
    lanes = torch.arange(n, device=dev)
    # warm-up: sample 0 of the same render through render_lanes, which also
    # reports its ray count and non-finite lanes and captures wavefronts
    with Recorder(wavefront) as rec:
        _, _, stats = render_lanes(
            vp, sc, cam, hk.make_filter(), torch.arange(k, device=dev).repeat_interleave(n),
            (lanes % MAIN_RES).repeat(k), (lanes // MAIN_RES).repeat(k))
    rays = float(stats["rays_traced"])
    nonfinite = float(stats["nonfinite_lanes"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sweep.reset_counts()
    t0 = time.perf_counter()
    film = hk.render(vp, sc, cam)
    img = hk.framebuffer(film)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(sweep.launches)
    plain_runs = dict(sweep.plain_cuda_runs)
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(img).all())
    mean_rgb = float(img.mean())
    log(f"[main] render {MAIN_RES}x{MAIN_RES}, {MAIN_SPP} spp, depth 5: {wall:.3f} s, "
        f"{rays / wall / 1e6:.3f} Mray/s ({rays:.0f} rays), "
        f"{wall / MAIN_SPP * 1e3:.1f} ms/sample, peak {peak / 2**30:.2f} GiB [{smi}]")
    log(f"[main] mean RGB {mean_rgb:.6f}, finite {finite}, nonfinite lanes "
        f"{nonfinite:.0f}, launches {counts}, plain sweeps on CUDA {plain_runs}")
    if not finite or nonfinite != 0.0 or mean_rgb <= 0.0:
        raise SystemExit("main path output is not a finite, non-black image")
    if min(counts.values()) <= 0 or any(plain_runs.values()):
        raise SystemExit("the main path did not go through both kernels")

    # kernel times at the main path's shapes (after the counts were read)
    records = []
    for name, line, args in (
            ("closest_tiles", 999, rec.calls["closest_tiles"][0]),
            ("occlusion_tiles", 1052, rec.calls["occlusion_tiles"][0])):
        r = compare(name, args, sc.treelets, reps=(5, 1))
        log(f"[main] {name} at main-path shape: agree {r['agree']:.6f} "
            f"(lanes {r['lanes']}, pairs {r['pairs']}), kernel {r['ms']:.3f} ms, "
            f"plain {r['plain_ms']:.3f} ms [{smi}] -> {'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            raise SystemExit(f"{name} disagrees with its plain version at main-path shape")
        records.append({
            "name": name, "route": "cuda",
            "source": "hikari_tpu_torch/csrc/sweep_tiles.cu",
            "replaces": f"hikari_tpu/geometry/wavefront.py:{line}",
            "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "agree": r["agree"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        })
    log(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
