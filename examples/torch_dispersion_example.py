#!/usr/bin/env python
"""examples/dispersion_example.py on the PyTorch/CUDA port: a Diamond()
sphere (two-term Sellmeier, n_d 2.42) splitting a narrow, bright beam into
a spectrum at depth 8.

    python examples/torch_dispersion_example.py [--res 256] [--spp 64]
        [--out dispersion.png] [--device cpu]

The scene is hikari_tpu_torch.scenes.dispersion_scene, built on the first
CUDA device unless --device names another.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root run

import hikari_tpu_torch as hk  # noqa: E402
from hikari_tpu_torch.scenes import dispersion_scene, scene_camera  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--out", type=str, default="dispersion.png")
    ap.add_argument("--device", default=None, help="torch device of the scene (default: cuda)")
    args = ap.parse_args(argv)

    scene = dispersion_scene().build(device=args.device)
    cam = scene_camera("dispersion", args.res)
    film = hk.render(hk.VolPath(samples_per_pixel=args.spp, max_depth=8), scene, cam)
    img = hk.framebuffer(film)
    hk.write_png(args.out, hk.postprocess(img, tonemap="aces"))
    print(f"wrote {args.out}  mean: {float(img.mean())}")
    return {"scene": scene, "film": film, "png": Path(args.out)}


if __name__ == "__main__":
    main()
