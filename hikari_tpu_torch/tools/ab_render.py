"""A/B of whole renders against another checkout's, on one GPU, in one
process.

    python3 -m hikari_tpu_torch.tools.ab_render OTHER_CHECKOUT [--reps N]

OTHER_CHECKOUT is a directory holding another version of the repository
(``git archive <rev> | tar -x -C .chipcheck/other``); its
``hikari_tpu_torch`` is loaded beside this one (``ab_sweep.load_other``).
Each package renders ``chip_smoke.py``'s five main paths through its own
public API (800x800, 4 spp, depth 5: the default scene with tile sweeps,
with the pair grid and with every switch on, the instanced default scene,
the forest) on its own scene, after one warm-up render each, in turns
(other, this, this, other) N times. One ``[a/b render]`` line per path:
every wall time in ms per sample, the medians, their ratio, and both
images' mean RGB.
"""

from __future__ import annotations

import argparse
import importlib
import statistics
import sys
import time
from pathlib import Path

from .ab_sweep import ROOT, load_other

# label, scene builder, camera, wavefront switches, VolPath fields
PATHS = (
    ("tile", "default_scene", "default", {}, {}),
    ("pair grid", "default_scene", "default", {"SWEEP_MODE": "pairs"}, {}),
    ("every switch", "default_scene", "default",
     {"SWEEP_MODE": "pairs", "BAND_FRAC": 0.15, "SHADOW_REV": True},
     {"material_coherence": "sorted", "resident": "on"}),
    ("instanced", "instanced_default_scene", "default", {}, {}),
    ("forest", "forest_scene", "forest", {}, {}),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="another checkout of the repository")
    ap.add_argument("--reps", type=int, default=2, help="turns of (other, this, this, other)")
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    import hikari_tpu_torch

    if not torch.cuda.is_available():
        print("ab_render: no CUDA device", file=sys.stderr)
        return 3
    load_other(opts.other, "wavefront")
    packages = {"this": hikari_tpu_torch, "other": sys.modules["hikari_other"]}
    smi = chip_smoke.smi_line()
    res, spp = chip_smoke.MAIN_RES, chip_smoke.MAIN_SPP
    dev = torch.device("cuda:0")
    for label, builder, camera, switches, vp_kw in PATHS:
        runs = {}
        for who, pkg in packages.items():
            scenes = importlib.import_module(f"{pkg.__name__}.scenes")
            wavefront = importlib.import_module(f"{pkg.__name__}.geometry.wavefront")
            cam = (scenes.forest_camera(res, res) if camera == "forest"
                   else scenes.scene_camera(camera, res))
            sc = getattr(scenes, builder)().build(device=dev)
            vp = pkg.VolPath(max_depth=5, samples_per_pixel=spp, **vp_kw)

            def render(pkg=pkg, wavefront=wavefront, vp=vp, sc=sc, cam=cam):
                with chip_smoke.switched(wavefront, **switches):
                    img = pkg.framebuffer(pkg.render(vp, sc, cam))
                torch.cuda.synchronize()
                return img

            runs[who] = {"render": render, "ms": [], "rgb": float(render().mean())}
        for _ in range(opts.reps):
            for who in ("other", "this", "this", "other"):
                t0 = time.perf_counter()
                runs[who]["render"]()
                runs[who]["ms"].append((time.perf_counter() - t0) / spp * 1e3)
        med = {who: statistics.median(r["ms"]) for who, r in runs.items()}
        print(f"[a/b render] {label}, {res}x{res}, {spp} spp, depth 5, ms/sample: other "
              + " ".join(f"{x:.1f}" for x in runs["other"]["ms"])
              + ", this " + " ".join(f"{x:.1f}" for x in runs["this"]["ms"])
              + f"; medians {med['other']:.1f} / {med['this']:.1f}, "
              f"{med['other'] / med['this']:.3f}x; mean RGB {runs['other']['rgb']:.6f} / "
              f"{runs['this']['rgb']:.6f} [{smi}]", flush=True)
        del runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
