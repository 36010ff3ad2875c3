#!/usr/bin/env python
"""examples/sparse_cloud_example.py on the PyTorch/CUDA port: a procedural
cloud saved as a NanoVDB file, read back through the sparse brick path
(active 8^3 bricks under an int32 page table) and rendered at depth 24
under the sun and sky (g 0.877).

    python examples/torch_sparse_cloud_example.py [OUT] [--res 384] [--spp 24]
        [--grid 96] [--device cpu]

OUT defaults to sparse_cloud.png; the NanoVDB file is written beside it
(OUT with the suffix .nvdb). The image is RES wide and 2/3 of RES high
(384 x 256 by default). The scene is
hikari_tpu_torch.scenes.sparse_cloud_scene, built on the first CUDA device
unless --device names another.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root run

import hikari_tpu_torch as hk  # noqa: E402
from hikari_tpu_torch.scenes import (scene_camera, sparse_cloud_medium,  # noqa: E402
                                     sparse_cloud_scene)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="sparse_cloud.png")
    ap.add_argument("--res", type=int, default=384, help="image width (height: 2/3 of it)")
    ap.add_argument("--spp", type=int, default=24)
    ap.add_argument("--grid", type=int, default=96, help="voxels per axis of the cloud")
    ap.add_argument("--device", default=None, help="torch device of the scene (default: cuda)")
    args = ap.parse_args(argv)

    nvdb = Path(args.out).with_suffix(".nvdb")
    cloud = sparse_cloud_medium(args.grid, nvdb)
    print(f"sparse cloud: {cloud.bricks.shape[0]} bricks over a "
          f"{tuple(cloud.table.shape)} page table")
    scene = sparse_cloud_scene(cloud=cloud).build(device=args.device)

    cam = scene_camera("sparse_cloud", args.res, args.res * 2 // 3)
    film = hk.render(hk.VolPath(samples_per_pixel=args.spp, max_depth=24), scene, cam)
    hk.write_png(args.out, hk.postprocess(hk.framebuffer(film), tonemap="aces"))
    print("wrote", args.out)
    return {"scene": scene, "film": film, "png": Path(args.out), "nvdb": nvdb}


if __name__ == "__main__":
    main()
