"""Port parity for the example scenes of hikari_tpu_torch.scenes against the
JAX package: the probes (scenes.SCENE_DEFS; rays traced and mean RGB of
render_lanes over samples 0 .. spp-1) of dispersion_scene,
lensing_scene, medium_example_scene and cloud_example_scene, each built
through either package's API from the same code.

* dispersion (surface, 32x32, depth 8, 16 samples): no medium, so the
  render is deterministic given the sampler; it equals the JAX package's
  stored probe to rounding (the same rays, mean RGB within 1e-5), well
  inside the surface probes' 0.5% rays / 2% RGB.
* lensing, the medium example and the cloud example draw per-lane LCG
  streams seeded from ray bits, so they are held to the JAX package's
  six-draw means (tools/gen_probe_ref.py) at 0.5% rays / 10% RGB, each at
  a sample count whose draw spreads under a third of the 10% in mean RGB
  and under half the 0.5% in rays (the stored "draw_rel_std"): lensing 64
  samples (1.9% in RGB), the medium example 32 (0.2%), the cloud
  example 32 (2.0%; 16 spread 3.4%) at its full 96^3 grid and depth 32. These take minutes on
  the CPU (slow); the quick tier renders each scene at 8 x 8 (the cloud on
  a 16^3 grid) and checks a finite, lit image and a ray count between one
  and 2 * depth + 1 a lane.
* the medium example's smoke box shares its bottom face's plane with the
  floor (y = 0). A ray meeting the floor there meets both faces at one t,
  and the JAX package's two walks keep different faces: on shared LCG
  streams its skip-link walk (its CPU default) and its packet engine
  (Scene.build(traversal="packets_interp"), the walk the port's sweeps
  mirror) part on 35 of 2,048 lanes, 0.8% in rays, while the port parts
  from the packet engine on 3 (slow). So the scene's probe is held to the
  JAX packet engine's six-draw mean (scenes.PACKET_PROBES, ROADMAP C).
"""

import numpy as np
import pytest
import torch

import hikari_tpu_torch as hk
from hikari_tpu_torch.scenes import (BUILDERS, check_transport, probe_reference,
                                     scene_camera, transport_probe)
from test_torch_scene import F32_RTOL  # noqa: F401  (each worker's share of the cores)

MEDIUM_PROBES = ("lensing", "medium_example", "cloud_example")


def test_dispersion_probe_equals_jax():
    sc = BUILDERS["dispersion"]().build(device="cpu")
    ok, msg = check_transport(sc, "dispersion")
    assert ok, msg
    rays, rgb = transport_probe(sc, "dispersion")
    ref = probe_reference("dispersion")
    assert rays == ref["rays_traced"], msg
    assert abs(rgb / ref["mean_rgb"] - 1.0) <= 1e-5, msg


@pytest.mark.parametrize("which", MEDIUM_PROBES)
def test_stored_medium_probe_spreads_under_a_third_of_its_tolerance(which):
    ref = probe_reference(which)
    assert len(ref["draws"]["mean_rgb"]) == 6
    assert ref["draw_rel_std"]["mean_rgb"] < 0.10 / 3, ref["draw_rel_std"]
    assert ref["draw_rel_std"]["rays_traced"] < 0.005 / 2, ref["draw_rel_std"]


@pytest.mark.parametrize("which, kw", [("lensing", {}), ("medium_example", {}),
                                       ("cloud_example", {"grid": 16})])
def test_example_scene_renders_at_8x8(which, kw):
    sc = BUILDERS[which](**kw).build(device="cpu")
    depth = {"lensing": 3, "medium_example": 10, "cloud_example": 32}[which]
    n = 8 * 8
    lanes = torch.arange(n)
    rgb, _, stats = hk.render_lanes(hk.VolPath(max_depth=depth, samples_per_pixel=1), sc,
                                    scene_camera(which, 8), hk.make_filter(), 0, lanes % 8,
                                    lanes // 8)
    assert rgb.shape == (n, 3) and bool(torch.isfinite(rgb).all()) and float(rgb.mean()) > 0.0
    assert n <= float(stats["rays_traced"]) <= n * (2 * depth + 1)
    assert float(stats["nonfinite_lanes"]) == 0.0


@pytest.mark.slow
@pytest.mark.parametrize("which", MEDIUM_PROBES)
def test_medium_probe_matches_jax_six_draw_mean(which):
    ok, msg = check_transport(BUILDERS[which]().build(device="cpu"), which)
    assert ok, msg


@pytest.mark.slow
def test_medium_example_ties_part_the_jax_walks_not_the_port(monkeypatch):
    """With both packages' LCG seeded from rays rounded to 1/256, the
    medium example (16x16, depth 10, 8 samples) through the JAX skip-link
    walk, the JAX packet engine and the port: the two JAX walks part on the
    lanes where the smoke box and the floor tie (35 of 2,048, 0.8% in
    rays), and the port renders as the packet engine but on a few of them
    (3): 99% of lanes within 1e-4 relative and the rays within 0.1%, as
    on the other scenes' shared streams, the mean RGB within 1%."""
    import jax
    import jax.numpy as jnp
    import hikari_tpu
    from hikari_tpu.camera.camera import make_perspective_camera
    from hikari_tpu.film.filters import make_filter as j_filter
    from hikari_tpu.integrators.volpath import VolPath as JVolPath
    from hikari_tpu.integrators.volpath import render_lanes as j_render_lanes
    from hikari_tpu.media import sample as jms
    from hikari_tpu_torch.media import sample as tms
    from hikari_tpu_torch.scenes import SCENE_DEFS

    q, res, depth, spp, which = 256.0, 16, 10, 8, "medium_example"
    j_init, t_init = jms.lcg_init, tms.lcg_init
    monkeypatch.setattr(jms, "lcg_init", lambda o, d, t: j_init(
        jnp.round(o * q) / q, jnp.round(d * q) / q, jnp.ones_like(t)))
    monkeypatch.setattr(tms, "lcg_init", lambda o, d, t: t_init(
        torch.round(o * q) / q, torch.round(d * q) / q, torch.ones_like(t)))
    lanes = np.arange(res * res)
    si = np.repeat(np.arange(spp), res * res)
    px, py = np.tile(lanes % res, spp), np.tile(lanes // res, spp)
    (eye, at, fov), _ = SCENE_DEFS[which]
    jcam = make_perspective_camera(eye, at, (res, res), fov_deg=fov)
    jvp = JVolPath(max_depth=depth, samples_per_pixel=spp)
    out = {}
    for walk in ("skiplink", "packets_interp"):
        js = BUILDERS[which](api=hikari_tpu).build(traversal=walk)
        rgb, _, st = jax.jit(lambda a, b, c: j_render_lanes(jvp, js, jcam, j_filter(), a, b,
                                                            c))(
            *(jnp.asarray(x, jnp.uint32) for x in (si, px, py)))
        out[walk] = (np.asarray(rgb, np.float64), float(st["rays_traced"]))
    t, _, tst = hk.render_lanes(
        hk.VolPath(max_depth=depth, samples_per_pixel=spp),
        BUILDERS[which]().build(device="cpu"), scene_camera(which, res), hk.make_filter(),
        *(torch.from_numpy(x) for x in (si, px, py)))
    out["port"] = (t.numpy().astype(np.float64), float(tst["rays_traced"]))

    def parted(a, b):
        return int((~np.isclose(out[a][0], out[b][0], rtol=1e-4, atol=1e-6).all(-1)).sum())

    n = spp * res * res
    sk_rays, (pk, pk_rays), (pt, pt_rays) = out["skiplink"][1], out["packets_interp"], out["port"]
    # the tie: the JAX walks part on 1% of the lanes or more, and by 0.5% in rays
    assert parted("skiplink", "packets_interp") >= 0.01 * n, parted("skiplink", "packets_interp")
    assert abs(pk_rays - sk_rays) >= 5e-3 * sk_rays, (pk_rays, sk_rays)
    # the port keeps the packet engine's faces
    assert parted("packets_interp", "port") <= 0.01 * n, parted("packets_interp", "port")
    assert abs(pt_rays - pk_rays) <= 1e-3 * pk_rays, (pt_rays, pk_rays)
    assert abs(pt.mean() - pk.mean()) <= 1e-2 * pk.mean() and pk.mean() > 0.01
