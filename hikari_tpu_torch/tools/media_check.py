"""How far a medium render can move by chance, and the card against the CPU.

    python3 -m hikari_tpu_torch.tools.media_check [--device cuda|cpu] [--reseeds N]
                                                  [--renders N] [--scenes WHICH ...]

Media draw from per-lane LCG streams seeded from the bits of each ray
(``media/sample.py``), so two implementations whose rays differ in a bit
draw independently. Two measurements:

* ``[reseeds]``: a probe (``scenes.transport_probe``) rendered N times
  with every lane's LCG seed XORed with a per-run constant, the rest of
  the render unchanged: the spread of its rays and mean RGB is the room a
  comparison with another implementation's probe needs. On the card: the
  fog's 64x64 probe over 1 and 512 samples, the grid cloud's 32x32
  depth-12 16-sample probe and the lensing, medium and cloud examples'
  probes (``chip_smoke.py``'s); on the CPU: the
  16x16 probes of ``tests/test_torch_media_render.py`` and the fog's
  1-sample 64x64 probe. Where ``data/probe_ref.json`` holds the
  JAX package's draws of the same probe with the same salts
  (``tools/gen_probe_ref.py``), the two means are compared: their
  difference in standard errors of the difference.
* ``[renders]`` (with ``--device cuda``): the fog (depth 5) and grid cloud
  (depth 12) main paths, ``render`` at 800x800 and 4 samples, each
  rendered N times in turns after a warm-up: ms per sample of each.
* ``[cpu vs cuda]`` (with ``--device cuda``): ``delta_track`` and
  ``ratio_track_tr`` on the same 65,536 rays through four media
  (homogeneous, density grid, RGB grid, deflected) on the CPU and on the
  card: the share of lanes whose status (delta) or transmitting class
  (ratio: largest T above 1e-3) agree, and the mean beta and T.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import time

import numpy as np
import torch

from .. import VolPath, framebuffer, render
from ..media import sample as ms
from ..media import types as mt
from ..scenes import (BUILDERS, PACKET_PROBES, probe_config, probe_key, probe_reference,
                      scene_camera, transport_probe)
from ..spectral.rgb2spec import srgb_table

# label, scene, transport_probe keywords
PROBES = {
    "cuda": (("fog 64x64, 1 sample", "fog", {}),
             ("fog 64x64, 512 samples", "fog", dict(spp=512)),
             ("grid cloud 32x32 depth 12, 16 samples", "cloud_grid", {}),
             ("lensing 32x32 depth 3, 64 samples", "lensing", {}),
             ("medium example 32x32 depth 10, 32 samples", "medium_example", {}),
             ("cloud example 32x32 depth 32, 32 samples", "cloud_example", {})),
    "cpu": (("fog 64x64, 1 sample", "fog", {}),
            ("fog 16x16, 256 samples", "fog", dict(res=16, spp=256)),
            ("grid cloud 16x16 depth 4, 64 samples", "cloud_grid",
             dict(res=16, depth=4, spp=64))),
}


def salt(k: int) -> int:
    """The k-th multiple of the golden ratio, 63 bits (0 for k = 0)."""
    return (k * 0x9E3779B97F4A7C15) & 0x7FFFFFFFFFFFFFFF


@contextlib.contextmanager
def reseeded(k: int):
    """Every LCG seed XORed with salt(k)."""
    orig = ms.lcg_init
    ms.lcg_init = lambda o, d, t_max: orig(o, d, t_max) ^ salt(k)
    try:
        yield
    finally:
        ms.lcg_init = orig


def spreads(device: str, n: int, only=None) -> None:
    """The [reseeds] lines of the device's PROBES (of the scenes in `only`
    if given)."""
    scenes = {}
    for label, which, kw in PROBES[device]:
        if only and which not in only:
            continue
        if which not in scenes:
            scenes[which] = BUILDERS[which]().build(device=device)
        runs = []
        for k in range(n):
            with reseeded(k):
                runs.append(transport_probe(scenes[which], which, **kw))
        v = np.array(runs)
        rel = v.std(0, ddof=1) / v.mean(0)
        print(f"[reseeds] {label}, {n} runs: rays {v[:, 0].round(2).tolist()}, mean RGB "
              f"{v[:, 1].round(7).tolist()}; relative spread: rays {rel[0]:.5f}, mean RGB "
              f"{rel[1]:.5f}", flush=True)
        try:
            ref = probe_reference(which, **kw)
        except KeyError:
            continue
        if "draws" not in ref:
            continue
        j = np.array([ref["draws"]["rays_traced"], ref["draws"]["mean_rgb"]]).T
        se = np.sqrt(v.var(0, ddof=1) / len(v) + j.var(0, ddof=1) / len(j))
        diff = v.mean(0) - j.mean(0)
        print(f"[reseeds] {label} against the JAX package's {len(j)} draws "
              f"({probe_key(which, *probe_config(which, **kw), packets=which in PACKET_PROBES)}): "
              f"mean RGB "
              f"{v[:, 1].mean():.7f} vs {j[:, 1].mean():.7f} "
              f"({diff[1] / j[:, 1].mean() * 100:+.3f}%, {diff[1] / se[1]:+.2f} standard "
              f"errors); rays {v[:, 0].mean():.2f} vs {j[:, 0].mean():.2f} "
              f"({diff[0] / j[:, 0].mean() * 100:+.4f}%, {diff[0] / se[0]:+.2f})", flush=True)


def renders(n: int, smi: str) -> None:
    """The medium main paths rendered n times in turns (see the module
    docstring)."""
    paths = (("fog", "fog", 5), ("grid cloud", "cloud_grid", 12))
    scenes = [(label, BUILDERS[which]().build(device="cuda"), scene_camera(which, 800),
               VolPath(max_depth=depth, samples_per_pixel=4)) for label, which, depth in paths]
    times = {label: [] for label, *_ in scenes}
    for i in range(n + 1):
        for label, sc, cam, vp in scenes:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            framebuffer(render(vp, sc, cam))
            torch.cuda.synchronize()
            if i:
                times[label].append((time.perf_counter() - t0) / 4 * 1e3)
    for label, ms in times.items():
        print(f"[renders] {label} 800x800, 4 spp, {n} renders in turns after a warm-up: "
              f"{', '.join(f'{t:.1f}' for t in ms)} ms/sample [{smi}]", flush=True)


def _media():
    rng = np.random.RandomState(1)
    dens = (rng.rand(12, 10, 8) * 3).astype(np.float32)
    rgb = (rng.rand(6, 7, 5, 3) * 4).astype(np.float32)
    box = dict(bounds_lo=(-1.0, -1.0, -1.0), bounds_hi=(1.0, 1.0, 1.0))
    return [mt.HomogeneousMedium(sigma_a=(0.3, 0.2, 0.1), sigma_s=(1.5, 1.0, 0.5), g=0.3),
            mt.GridMedium(density=dens, sigma_a=(0.5,) * 3, sigma_s=(4.0, 3.0, 2.0), g=0.8,
                          **box),
            mt.RGBGridMedium(sigma_a_grid=rgb * 0.2, sigma_s_grid=rgb, le_grid=rgb * 0.1,
                             g=-0.3, **box),
            mt.HomogeneousMedium(sigma_a=(0.1,) * 3, sigma_s=(0.8,) * 3,
                                 deflection=("gravity", (0.0, 0.0, 0.0), 0.5),
                                 majorant_scale=2.0)]


def cpu_vs_cuda(n: int = 65536) -> None:
    banks = mt.pack_media(_media())
    rng = np.random.RandomState(10)
    o = ((rng.rand(n, 3) * 2 - 1) * 0.9).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = (rng.rand(n) * 3).astype(np.float32)
    t_max[::10] = np.inf
    lam = (360.0 + rng.rand(n, 4) * 470.0).astype(np.float32)
    active, mdh = rng.rand(n) > 0.1, rng.rand(n) < 0.2
    mi = (np.arange(n) % 4).astype(np.int32)
    ones = np.ones((n, 4), np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        b, table = banks.to(dev), srgb_table().to(dev)

        def t(x):
            return torch.from_numpy(x).to(dev)

        args = (t(mi), t(o), t(d), t(t_max), t(lam))
        dt = ms.delta_track(b, table, *args, t(ones), t(ones), t(ones), t(active),
                            t(mdh))
        tr = ms.ratio_track_tr(b, table, *args, t(active))
        out[dev] = (dt.status.cpu().numpy(), dt.beta.cpu().numpy(), tr[0].cpu().numpy())
    (cs, cb, ct), (gs, gb, gt) = out["cpu"], out["cuda"]
    for m, name in enumerate(("homogeneous", "density grid", "RGB grid", "deflected")):
        sel = mi == m
        print(f"[cpu vs cuda] {name}: delta status agrees on {(cs == gs)[sel].mean():.5f} of "
              f"{sel.sum()} lanes, mean beta {cb[sel].mean():.6f} / {gb[sel].mean():.6f}; "
              f"ratio class agrees on "
              f"{((ct.max(-1) > 1e-3) == (gt.max(-1) > 1e-3))[sel].mean():.5f}, mean T "
              f"{ct[sel].mean():.6f} / {gt[sel].mean():.6f}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reseeds", type=int, default=6)
    ap.add_argument("--renders", type=int, default=2)
    ap.add_argument("--scenes", nargs="*", help="reseed only these scenes' probes")
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("media_check: no CUDA device (pass --device cpu)")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True, capture_output=True,
                             text=True, timeout=60).stdout.strip()
        print(smi, flush=True)
        cpu_vs_cuda()
        if args.renders:
            renders(args.renders, smi)
    spreads(args.device, args.reseeds, args.scenes)


if __name__ == "__main__":
    main()
