#!/usr/bin/env python
"""examples/cloud_example.py on the PyTorch/CUDA port: a procedural
Worley / Perlin cloud (g 0.877) at depth 32 under a turbidity-3 Hosek-Wilkie
sun and sky, with the cloud's NanoVDB round trip.

    python examples/torch_cloud_example.py [--spp 24] [--res 256] [--depth 32]
        [--grid 96] [--nvdb FILE] [--out cloud.png] [--device cpu]

Without --nvdb the procedural cloud is also written as a NanoVDB file
beside the PNG (OUT with the suffix .nvdb). The scene is
hikari_tpu_torch.scenes.cloud_example_scene, built on the first CUDA
device unless --device names another.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root run

import numpy as np  # noqa: E402

import hikari_tpu_torch as hk  # noqa: E402
from hikari_tpu_torch.scenes import (cloud_example_scene, example_cloud,  # noqa: E402
                                     scene_camera)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=24)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--depth", type=int, default=32)
    ap.add_argument("--grid", type=int, default=96)
    ap.add_argument("--nvdb", type=str, default=None,
                    help="optional NanoVDB file to load instead of the procedural cloud")
    ap.add_argument("--out", type=str, default="cloud.png")
    ap.add_argument("--device", default=None, help="torch device of the scene (default: cuda)")
    args = ap.parse_args(argv)

    nvdb = None
    if args.nvdb:
        cloud = hk.nanovdb_medium(args.nvdb, sigma_s=(10.0,) * 3, sigma_a=(0.05,) * 3, g=0.877)
    else:
        cloud = example_cloud(args.grid)
        # the NanoVDB round trip of the reference example, beside the PNG
        nvdb = Path(args.out).with_suffix(".nvdb")
        hk.save_nanovdb(str(nvdb), cloud.density, origin=cloud.bounds_lo,
                        extent=tuple(np.subtract(cloud.bounds_hi, cloud.bounds_lo)))
    scene = cloud_example_scene(cloud=cloud).build(device=args.device)

    cam = scene_camera("cloud_example", args.res)
    film = hk.render(hk.VolPath(max_depth=args.depth, samples_per_pixel=args.spp), scene, cam)
    hk.write_png(args.out, hk.postprocess(hk.framebuffer(film), tonemap="aces"))
    print("wrote", args.out)
    return {"scene": scene, "film": film, "png": Path(args.out), "nvdb": nvdb}


if __name__ == "__main__":
    main()
