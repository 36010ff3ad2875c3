#!/usr/bin/env python
"""examples/cornell_scene.py on the PyTorch/CUDA port: the flagship
spectral Cornell box (a textured floor, Gold, BK7 and Plastic spheres, an
emissive ceiling quad), rendered through a RenderMeter lap, optionally
denoised with render_aux's albedo, normal and depth.

    python examples/torch_cornell_scene.py [--spp 32] [--res 256] [--depth 6]
        [--obj FILE] [--out cornell.png] [--denoise] [--device cpu]

The scene is hikari_tpu_torch.scenes.cornell_scene (with --obj, that mesh
in Gold in place of the three spheres), built on the first CUDA device
unless --device names another.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root run

import hikari_tpu_torch as hk  # noqa: E402
from hikari_tpu_torch.scenes import cornell_scene, scene_camera  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--obj", type=str, default=None)
    ap.add_argument("--out", type=str, default="cornell.png")
    ap.add_argument("--denoise", action="store_true")
    ap.add_argument("--device", default=None, help="torch device of the scene (default: cuda)")
    args = ap.parse_args(argv)

    s = cornell_scene(obj=args.obj)
    scene = s.build(device=args.device)
    print(s)

    cam = scene_camera("cornell", args.res)
    vp = hk.VolPath(max_depth=args.depth, samples_per_pixel=args.spp)

    meter = hk.RenderMeter().start()
    film = hk.render(vp, scene, cam)
    img = hk.framebuffer(film)
    print("render:", meter.lap(args.res * args.res * args.spp * args.depth))

    if args.denoise:
        albedo, normal, depth = hk.render_aux(scene, cam)
        img = hk.denoise(img, albedo, normal, depth)

    hk.write_png(args.out, hk.postprocess(img, tonemap="aces"))
    print("wrote", args.out)
    return {"scene": scene, "film": film, "png": Path(args.out)}


if __name__ == "__main__":
    main()
