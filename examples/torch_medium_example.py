#!/usr/bin/env python
"""examples/medium_example.py on the PyTorch/CUDA port: a glass sphere
filled with milk, a smoke grid in an invisible box and a Matte floor under
a point and a distant light, at depth 10.

    python examples/torch_medium_example.py [--res 256] [--spp 32]
        [--out medium.png] [--device cpu]

The scene is hikari_tpu_torch.scenes.medium_example_scene, built on the
first CUDA device unless --device names another.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root run

import hikari_tpu_torch as hk  # noqa: E402
from hikari_tpu_torch.scenes import medium_example_scene, scene_camera  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--out", type=str, default="medium.png")
    ap.add_argument("--device", default=None, help="torch device of the scene (default: cuda)")
    args = ap.parse_args(argv)

    scene = medium_example_scene().build(device=args.device)
    cam = scene_camera("medium_example", args.res)
    film = hk.render(hk.VolPath(max_depth=10, samples_per_pixel=args.spp), scene, cam)
    hk.write_png(args.out, hk.postprocess(hk.framebuffer(film), tonemap="aces"))
    print("wrote", args.out)
    return {"scene": scene, "film": film, "png": Path(args.out)}


if __name__ == "__main__":
    main()
