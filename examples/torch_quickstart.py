#!/usr/bin/env python
"""examples/quickstart.py on the PyTorch/CUDA port: one Plastic sphere on
a floor under a point light, rendered by VolPath, Whitted and
FastWavefront side by side.

    python examples/torch_quickstart.py [OUT_DIR] [--device cpu]

Writes torch_quickstart_{volpath,whitted,preview}.png into OUT_DIR (default:
the current directory). The scene is built on the first CUDA device unless
--device names another.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root run

import hikari_tpu_torch as hk  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("out_dir", nargs="?", default=".")
ap.add_argument("--device", default=None, help="torch device of the scene (default: cuda)")
args = ap.parse_args()
out = Path(args.out_dir)
out.mkdir(parents=True, exist_ok=True)

s = hk.Scene()
s.add(hk.make_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4)),
      hk.Matte(kd=(0.6, 0.6, 0.6)))
s.add(hk.make_sphere((0, 0.6, 0), 0.6), hk.Plastic(kd=(0.8, 0.15, 0.1), roughness=0.15))
s.add_light(hk.PointLight(position=(2, 4, -2), intensity=(30, 30, 30)))
scene = s.build(device=args.device)
print(s)

cam = hk.make_perspective_camera((0, 1.4, -3.2), (0, 0.5, 0), (192, 192), fov_deg=45.0)

img = hk.framebuffer(hk.render(hk.VolPath(samples_per_pixel=16, max_depth=4), scene, cam))
hk.write_png(out / "torch_quickstart_volpath.png", hk.postprocess(img, tonemap="aces"))

img = hk.framebuffer(hk.render_preview(hk.Whitted(max_depth=3, samples_per_pixel=4), scene, cam))
hk.write_png(out / "torch_quickstart_whitted.png", hk.postprocess(img, tonemap="aces"))

img = hk.framebuffer(hk.render_preview(hk.FastWavefront(samples_per_pixel=1), scene, cam))
hk.write_png(out / "torch_quickstart_preview.png", hk.postprocess(img, tonemap="aces"))
print(f"wrote {out}/torch_quickstart_{{volpath,whitted,preview}}.png")
