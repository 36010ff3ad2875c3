#!/usr/bin/env python
"""examples/lensing_example.py on the PyTorch/CUDA port: rays bend around a
compact mass at the null events of a thin medium the camera sits in
(deflection ("gravity", origin, 60), majorant_scale 20,000), before a
starfield.

    python examples/torch_lensing_example.py [--res 256] [--spp 16]
        [--out lensing.png] [--device cpu]

The scene is hikari_tpu_torch.scenes.lensing_scene, built on the first
CUDA device unless --device names another.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root run

import hikari_tpu_torch as hk  # noqa: E402
from hikari_tpu_torch.scenes import lensing_scene, scene_camera  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--out", type=str, default="lensing.png")
    ap.add_argument("--device", default=None, help="torch device of the scene (default: cuda)")
    args = ap.parse_args(argv)

    scene = lensing_scene().build(device=args.device)
    cam = scene_camera("lensing", args.res)
    film = hk.render(hk.VolPath(samples_per_pixel=args.spp, max_depth=3), scene, cam)
    img = hk.framebuffer(film)
    hk.write_png(args.out, hk.postprocess(img, tonemap="aces", exposure=1.5))
    print(f"wrote {args.out}  mean: {float(img.mean())}")
    return {"scene": scene, "film": film, "png": Path(args.out)}


if __name__ == "__main__":
    main()
