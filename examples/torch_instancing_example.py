#!/usr/bin/env python
"""examples/instancing_example.py on the PyTorch/CUDA port: 400 placements
of one tree mesh through the two-level (instanced) traversal, under the
sun and sky; memory stays proportional to the unique mesh.

    python examples/torch_instancing_example.py [OUT] [--res 384] [--spp 16]
        [--trees 400] [--device cpu]

OUT defaults to instancing.png. The image is RES wide and 2/3 of RES high
(384 x 256 by default). The scene is hikari_tpu_torch.scenes.forest_scene,
built on the first CUDA device unless --device names another.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root run

import hikari_tpu_torch as hk  # noqa: E402
from hikari_tpu_torch.scenes import forest_camera, forest_scene  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="instancing.png")
    ap.add_argument("--res", type=int, default=384, help="image width (height: 2/3 of it)")
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--trees", type=int, default=400, help="placements of the tree mesh")
    ap.add_argument("--device", default=None, help="torch device of the scene (default: cuda)")
    args = ap.parse_args(argv)

    sd = forest_scene(args.trees).build(device=args.device)
    print(f"instanced scene: {sd.n_faces} unique faces, "
          f"{sd.inst.ti_inst.shape[0]} world treelets, "
          f"{sd.inst.coef.shape[0]} BLAS treelets")
    cam = forest_camera(args.res, args.res * 2 // 3)
    film = hk.render(hk.VolPath(samples_per_pixel=args.spp, max_depth=4), sd, cam)
    hk.write_png(args.out, hk.postprocess(hk.framebuffer(film), tonemap="aces"))
    print("wrote", args.out)
    return {"scene": sd, "film": film, "png": Path(args.out)}


if __name__ == "__main__":
    main()
