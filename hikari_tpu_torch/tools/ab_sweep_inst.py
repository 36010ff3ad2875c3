"""A/B of the instanced sweeps (K3 ``closest_inst``, K4 ``occlusion_inst``)
against another checkout's, on one GPU, in one process.

    python3 -m hikari_tpu_torch.tools.ab_sweep_inst OTHER_CHECKOUT

OTHER_CHECKOUT is a directory holding another version of the repository,
for instance ``git archive <rev> | tar -x -C .chipcheck/other``. Its
``hikari_tpu_torch`` package is loaded beside this one under another name,
so its wrappers, whose signatures are the contract, build and launch its own
``csrc/sweep_inst.cu``. This tree records the first K3 and K4 calls of the
instanced default scene's and the forest's main path (800x800, one 4-sample
wavefront, depth 5, as ``chip_smoke.py`` renders them), and both versions
run on those inputs: the outputs are compared (tri or occlusion agreement
on live lanes, and bit equality), then each is timed with CUDA events in
turns (other, this, this, other; 5 calls each after a warm-up call).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NAMES = ("closest_inst", "occlusion_inst")


def load_other(checkout: Path):
    """The other checkout's geometry.sweep_inst, its package loaded as
    ``hikari_other``."""
    init = checkout.resolve() / "hikari_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "hikari_other", init, submodule_search_locations=[str(init.parent)])
    package = importlib.util.module_from_spec(spec)
    sys.modules["hikari_other"] = package
    spec.loader.exec_module(package)
    return importlib.import_module("hikari_other.geometry.sweep_inst")


def record(sc, cam, chip_smoke):
    """The instanced sweep calls of the first wavefront of a main path."""
    import torch
    import hikari_tpu_torch as hk
    from hikari_tpu_torch.geometry import instanced
    from hikari_tpu_torch.integrators.volpath import render_lanes

    w, h = cam.resolution
    vp = hk.VolPath(max_depth=5, samples_per_pixel=chip_smoke.MAIN_SPP)
    k = vp.sample_batch
    lanes = torch.arange(w * h, device=sc.device)
    with chip_smoke.Recorder(instanced, NAMES) as rec:
        render_lanes(vp, sc, cam, hk.make_filter(),
                     torch.arange(k, device=sc.device).repeat_interleave(w * h),
                     (lanes % w).repeat(k), (lanes // w).repeat(k))
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="another checkout of the repository")
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from hikari_tpu_torch.geometry import sweep_inst
    from hikari_tpu_torch.scenes import (forest_camera, forest_scene,
                                         instanced_default_scene, scene_camera)

    if not torch.cuda.is_available():
        print("ab_sweep_inst: no CUDA device", file=sys.stderr)
        return 3
    smi = chip_smoke.smi_line()
    other = load_other(opts.other)
    dev = torch.device("cuda:0")
    res = chip_smoke.MAIN_RES
    for label, build, cam in (
            ("instanced default", instanced_default_scene, scene_camera("default", res)),
            ("forest", forest_scene, forest_camera(res, res))):
        rec = record(build().build(device=dev), cam, chip_smoke)
        for name in NAMES:
            args = rec.calls[name][0]
            this, that = getattr(sweep_inst, name), getattr(other, name)
            out_t, out_o = this(*args), that(*args)
            torch.cuda.synchronize()
            closest = name == "closest_inst"
            # (t, tri, b1, b2) or (occ,); tri or occ decides agreement
            outs_t, outs_o = (x if closest else (x,) for x in (out_t, out_o))
            k = 1 if closest else 0
            live = args[2] > 0.0
            same = float((outs_t[k] == outs_o[k])[live].float().mean())
            exact = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(outs_t, outs_o))
            ms = [chip_smoke.cuda_ms(lambda fn=fn: fn(*args), 5)
                  for fn in (that, this, this, that)]
            old, new = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
            pairs = args[3 if closest else 4].numel()
            print(f"[a/b] {label} {name} ({pairs} pairs): other {ms[0]:.3f} / {ms[3]:.3f} "
                  f"ms, this {ms[1]:.3f} / {ms[2]:.3f} ms, {old / new:.3f}x; agree "
                  f"{same:.6f} of live lanes, bit-equal {'yes' if exact else 'no'} [{smi}]",
                  flush=True)
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
