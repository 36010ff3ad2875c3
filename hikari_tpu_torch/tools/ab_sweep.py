"""A/B of one family of sweep kernels against another checkout's, on one
GPU, in one process.

    python3 -m hikari_tpu_torch.tools.ab_sweep {tiles,pairs,inst} OTHER_CHECKOUT

OTHER_CHECKOUT is a directory holding another version of the repository,
for instance ``git archive <rev> | tar -x -C .chipcheck/other``. Its
``hikari_tpu_torch`` package is loaded beside this one under another name,
so its wrappers, whose signatures are the contract, build and launch its own
kernels. The families: ``tiles`` (K1 ``closest_tiles``, K2
``occlusion_tiles``; the default scene's main path), ``pairs`` (K5/K6; the
same path in pair-grid mode) and ``inst`` (K3/K4; the instanced default
scene and the forest). This tree records every sweep call of the first
wavefront of the family's main paths (800x800, one 4-sample wavefront,
depth 5, as ``chip_smoke.py`` renders them: one call per bounce), and both
versions run on those inputs: the outputs are compared (winner or occlusion
agreement on live lanes, and bit equality), then each is timed with CUDA
events in turns (other, this, this, other; 3 calls each after a warm-up
call). One ``[a/b]`` line per call, and one with the sums over the bounces.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
REPS = 3

# family -> (module of the wrappers, its two kernels, traversal module that
# calls them, SWEEP_MODE of that module or None)
FAMILIES = {
    "tiles": ("sweep", ("closest_tiles", "occlusion_tiles"), "wavefront", "tile"),
    "pairs": ("sweep_pairs", ("closest_pairs", "occlusion_pairs"), "wavefront", "pairs"),
    "inst": ("sweep_inst", ("closest_inst", "occlusion_inst"), "instanced", None),
}


def load_other(checkout: Path, module: str):
    """The other checkout's geometry.<module>, its package loaded as
    ``hikari_other``."""
    init = checkout.resolve() / "hikari_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "hikari_other", init, submodule_search_locations=[str(init.parent)])
    package = importlib.util.module_from_spec(spec)
    sys.modules["hikari_other"] = package
    spec.loader.exec_module(package)
    return importlib.import_module(f"hikari_other.geometry.{module}")


def record(sc, cam, chip_smoke, traversal, names):
    """The sweep calls of the first wavefront of a main path."""
    import torch
    import hikari_tpu_torch as hk
    from hikari_tpu_torch.integrators.volpath import render_lanes

    w, h = cam.resolution
    vp = hk.VolPath(max_depth=5, samples_per_pixel=chip_smoke.MAIN_SPP)
    k = vp.sample_batch
    lanes = torch.arange(w * h, device=sc.device)
    with chip_smoke.Recorder(traversal, names) as rec:
        render_lanes(vp, sc, cam, hk.make_filter(),
                     torch.arange(k, device=sc.device).repeat_interleave(w * h),
                     (lanes % w).repeat(k), (lanes // w).repeat(k))
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("family", choices=sorted(FAMILIES), help="which kernels to compare")
    ap.add_argument("other", type=Path, help="another checkout of the repository")
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from hikari_tpu_torch.scenes import (default_scene, forest_camera, forest_scene,
                                         instanced_default_scene, scene_camera)

    if not torch.cuda.is_available():
        print("ab_sweep: no CUDA device", file=sys.stderr)
        return 3
    module, names, traversal, mode = FAMILIES[opts.family]
    this_mod = importlib.import_module(f"hikari_tpu_torch.geometry.{module}")
    traversal = importlib.import_module(f"hikari_tpu_torch.geometry.{traversal}")
    other_mod = load_other(opts.other, module)
    smi = chip_smoke.smi_line()
    res = chip_smoke.MAIN_RES
    if opts.family == "inst":
        paths = (("instanced default", instanced_default_scene, scene_camera("default", res)),
                 ("forest", forest_scene, forest_camera(res, res)))
    else:
        paths = (("default", default_scene, scene_camera("default", res)),)
    switches = {} if mode is None else {"SWEEP_MODE": mode}
    for label, build, cam in paths:
        with chip_smoke.switched(traversal, **switches):
            rec = record(build().build(device=torch.device("cuda:0")), cam, chip_smoke,
                         traversal, names)
        for name in names:
            this, that = getattr(this_mod, name), getattr(other_mod, name)
            total = [0.0] * 4
            for i, args in enumerate(rec.calls[name]):
                out_t, out_o = this(*args), that(*args)
                torch.cuda.synchronize()
                same, live = chip_smoke.same_lanes(name, args, out_t, out_o)
                agree = float(same[live].float().mean()) if live.any() else 1.0
                outs_t, outs_o = (x if isinstance(x, tuple) else (x,) for x in (out_t, out_o))
                exact = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                            for a, b in zip(outs_t, outs_o))
                ms = [chip_smoke.cuda_ms(lambda fn=fn: fn(*args), REPS)
                      for fn in (that, this, this, that)]
                total = [a + b for a, b in zip(total, ms)]
                pairs = args[3 if name == "closest_inst" else 4].numel()
                print(f"[a/b] {label} {name} call {i + 1} ({int(live.sum())} live lanes, "
                      f"{pairs} pairs): other {ms[0]:.3f} / {ms[3]:.3f} ms, this {ms[1]:.3f} "
                      f"/ {ms[2]:.3f} ms, {(ms[0] + ms[3]) / (ms[1] + ms[2]):.3f}x; agree "
                      f"{agree:.6f} of live lanes, bit-equal {'yes' if exact else 'no'} "
                      f"[{smi}]", flush=True)
            print(f"[a/b] {label} {name}, {len(rec.calls[name])} calls summed: other "
                  f"{total[0]:.3f} / {total[3]:.3f} ms, this {total[1]:.3f} / "
                  f"{total[2]:.3f} ms, {(total[0] + total[3]) / (total[1] + total[2]):.3f}x "
                  f"[{smi}]", flush=True)
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
