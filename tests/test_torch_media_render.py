"""Port parity for the medium paths as a whole: renders of fog and grid clouds.

Media draw from per-lane LCG streams seeded from the bits of each ray.
The JAX package's rays differ from the port's in their last bits (XLA
contracts a * b + c into FMAs; its CPU reference walks a skip-link BVH),
so the two packages' streams are independent and renders agree only as
averages over the same samples: every comparison below is a mean over
enough samples that its tolerance is several standard errors of the
difference (the spread from the LCG streams alone, measured on the port
by reseeding them with `python -m hikari_tpu_torch.tools.media_check
--device cpu`: 1.44% of the mean for the fog at 16x16 over 256 samples,
0.78% for the grid cloud at 16x16, depth 4, over 64, so the 5% bounds
are 2.5 and 4.5 standard errors of the difference). The JAX
side of each comparison is stored in
hikari_tpu_torch/data/probe_ref.json by tools/gen_probe_ref.py
(the JAX renders take minutes on the CPU); the slow tier recomputes one
of them.

* shared streams: with both packages' LCG seeded from the ray rounded to
  1/256 (so the streams no longer hang on the rays' last bits), the fog
  (8x8, depth 5, 2 samples; slow: the grid and sun-sky clouds at 16x16,
  depth 12, 2 samples, and at 8x8, 2 samples, the lensing example at its
  depth 3, its null events bent by gravity, and the cloud example at its
  depth 32) renders as the JAX package's lane for lane: rays within 0.1%,
  99% of lanes within 1e-4 relative, mean RGB within 0.1%;
* fog (scenes.fog_scene, bench.build_fog_scene): 16x16, depth 5, 256
  samples, rays within 0.5% and mean RGB within 5% of the JAX package;
* grid cloud (scenes.cloud_grid_scene): 16x16, depth 4, 64 samples, the
  same tolerances;
* the instanced shadow walk: shadow rays through the fog box as an
  instance pass, attenuate and block as through the flat box (slow: the
  whole render, 512 samples, same tolerances as above);
* the bounce-loop modes on the fog: resident loop, two depth segments and
  the pair-grid sweep equal the default render bit for bit on the CPU;
* slow: the 64x64 fog probe's rays against tools/transport_ref.json (1
  sample, 0.5%) and its mean RGB over 512 samples against the JAX
  package's (2%); the grid cloud's 32x32 depth-12 16-sample probe against
  the JAX package's (rays within 0.5%, mean RGB within 10%: bench.py's
  tolerance for its cloud probe); the stored JAX cloud probe recomputed.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import hikari_tpu_torch as hk
from hikari_tpu_torch.geometry import wavefront as twf
from hikari_tpu_torch.integrators.volpath import render_lanes_segmented
from hikari_tpu_torch.scenes import (check_transport, cloud_grid_scene, fog_scene,
                                     probe_reference, scene_camera, transport_probe)
from test_torch_scene import F32_RTOL  # noqa: F401  (each worker's share of the cores)

ROOT = Path(__file__).resolve().parent.parent


def _tool():
    """tools/gen_probe_ref.py (the JAX side of the stored probes)."""
    spec = importlib.util.spec_from_file_location(
        "gen_probe_ref", ROOT / "tools" / "gen_probe_ref.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def fog():
    return fog_scene().build(device="cpu")


def test_fog_render_matches_jax(fog):
    ok, msg = check_transport(fog, "fog", res=16, spp=256, rgb_tol=0.05)
    assert ok, msg


def test_cloud_grid_render_matches_jax():
    ok, msg = check_transport(cloud_grid_scene().build(device="cpu"), "cloud_grid", res=16,
                              depth=4, spp=64, rgb_tol=0.05)
    assert ok, msg


def _shared_stream_renders(which, res, depth, spp, monkeypatch, q=256.0):
    """(JAX, port) of render_lanes' (rgb (N, 3), rays traced) on samples
    0..spp-1 of every pixel, with each package's lcg_init seeding from the
    ray's o and d rounded to 1/q and t_max 1."""
    import jax
    import jax.numpy as jnp
    from hikari_tpu.camera.camera import make_perspective_camera
    from hikari_tpu.film.filters import make_filter as j_filter
    from hikari_tpu.integrators.volpath import VolPath as JVolPath
    from hikari_tpu.integrators.volpath import render_lanes as j_render_lanes
    from hikari_tpu.media import sample as jms
    from hikari_tpu_torch.media import sample as tms
    from hikari_tpu_torch.scenes import BUILDERS, SCENE_DEFS

    j_init, t_init = jms.lcg_init, tms.lcg_init
    monkeypatch.setattr(jms, "lcg_init", lambda o, d, t: j_init(
        jnp.round(o * q) / q, jnp.round(d * q) / q, jnp.ones_like(t)))
    monkeypatch.setattr(tms, "lcg_init", lambda o, d, t: t_init(
        torch.round(o * q) / q, torch.round(d * q) / q, torch.ones_like(t)))
    lanes = np.arange(res * res)
    si = np.repeat(np.arange(spp), res * res)
    px, py = np.tile(lanes % res, spp), np.tile(lanes // res, spp)
    (eye, at, fov), _ = SCENE_DEFS[which]
    js = _tool().jax_scene(which)
    jcam = make_perspective_camera(eye, at, (res, res), fov_deg=fov)
    jvp = JVolPath(max_depth=depth, samples_per_pixel=spp)
    jrgb, _, jst = jax.jit(lambda a, b, c: j_render_lanes(jvp, js, jcam, j_filter(), a, b, c))(
        *(jnp.asarray(x, jnp.uint32) for x in (si, px, py)))
    trgb, _, tst = hk.render_lanes(
        hk.VolPath(max_depth=depth, samples_per_pixel=spp),
        BUILDERS[which]().build(device="cpu"), scene_camera(which, res), hk.make_filter(),
        *(torch.from_numpy(x) for x in (si, px, py)))
    return ((np.asarray(jrgb, np.float64), float(jst["rays_traced"])),
            (trgb.numpy().astype(np.float64), float(tst["rays_traced"])))


@pytest.mark.parametrize("which, res, depth, spp", [
    ("fog", 8, 5, 2),
    pytest.param("cloud_grid", 16, 12, 2, marks=pytest.mark.slow),
    pytest.param("cloud", 16, 12, 2, marks=pytest.mark.slow),
    pytest.param("lensing", 8, 3, 2, marks=pytest.mark.slow),
    pytest.param("cloud_example", 8, 32, 2, marks=pytest.mark.slow)])
def test_render_equals_jax_on_shared_streams(which, res, depth, spp, monkeypatch):
    (j, jrays), (t, trays) = _shared_stream_renders(which, res, depth, spp, monkeypatch)
    assert abs(trays - jrays) <= 1e-3 * jrays, (trays, jrays)
    close = np.isclose(t, j, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, (close.mean(), np.abs(t - j).max())
    assert abs(t.mean() - j.mean()) <= 1e-3 * j.mean(), (t.mean(), j.mean())
    assert j.mean() > 0.01


def _fog_with_instanced_box():
    """fog_scene with its medium box as one instance of a unit cube, scaled
    and moved onto the flat box."""
    s = hk.Scene()
    white = hk.Matte(kd=(0.73, 0.73, 0.73))
    s.add(hk.make_quad((-1, 0, 0), (1, 0, 0), (1, 0, 2), (-1, 0, 2)), white)
    s.add(hk.make_quad((-1, 2, 0), (-1, 2, 2), (1, 2, 2), (1, 2, 0)), white)
    s.add(hk.make_quad((-1, 0, 2), (1, 0, 2), (1, 2, 2), (-1, 2, 2)), white)
    s.add(hk.make_quad((-1, 0, 0), (-1, 0, 2), (-1, 2, 2), (-1, 2, 0)),
          hk.Matte(kd=(0.65, 0.05, 0.05)))
    s.add(hk.make_quad((1, 0, 0), (1, 2, 0), (1, 2, 2), (1, 0, 2)),
          hk.Matte(kd=(0.12, 0.45, 0.15)))
    tr = np.diag([1.9, 1.93, 1.9, 1.0]).astype(np.float32)
    tr[:3, 3] = (0.0, 0.985, 1.0)
    fog = hk.HomogeneousMedium(sigma_a=(0.05,) * 3, sigma_s=(0.25,) * 3, g=0.3)
    s.add_instanced(hk.make_box((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5)), tr[None], hk.Interface(),
                    inside_medium=fog)
    s.add(hk.make_quad((-0.3, 1.99, 0.7), (0.3, 1.99, 0.7), (0.3, 1.99, 1.3),
                       (-0.3, 1.99, 1.3)),
          hk.Emissive(le=(1.0, 0.9, 0.7), scale=20.0))
    s.add_light(hk.PointLight(position=(0.0, 1.5, 0.3), intensity=(2.0, 2.0, 2.0)))
    return s.build(device="cpu")


def test_instanced_shadow_walk_matches_flat(fog):
    """_trace_shadow's instanced hook: shadow rays from the camera side
    through the fog box, as an instance and flat. Rays to points inside
    the box cross its face (instanced face decode, material and normal)
    and are ratio-tracked in the fog: the two scenes pass the same share
    of them (3 points over 4096 rays) and attenuate the same on average;
    rays to points behind the back wall leave the box and are blocked by
    the wall in both."""
    from hikari_tpu_torch.integrators.volpath import _trace_shadow

    inst = _fog_with_instanced_box()
    assert inst.has_instances and inst.has_media
    rng = np.random.RandomState(8)
    n = 4096
    o = np.array([0.0, 1.0, -0.5], np.float32) + rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    target = rng.uniform((-0.8, 0.2, 0.5), (0.8, 1.8, 1.9), (n, 3)).astype(np.float32)
    target[n // 2:, 2] = 2.3
    d = target - o
    dist = np.linalg.norm(d, axis=1)
    lam = torch.from_numpy((360.0 + rng.rand(n, 4) * 470.0).astype(np.float32))
    args = (torch.from_numpy(o), torch.from_numpy(d / dist[:, None]),
            torch.from_numpy(dist * 0.999), torch.full((n,), -1, dtype=torch.int32), lam,
            torch.ones(n, dtype=torch.bool))
    inside = slice(0, n // 2)
    shares = []
    for sc in (fog, inst):
        T, _, _ = _trace_shadow(sc, *args)
        assert not T[n // 2:].any()  # behind the back wall
        passed = T[inside, 0] > 1e-3
        shares.append((float(passed.float().mean()), float(T[inside].mean())))
        assert 0.2 < shares[-1][0] < 0.98
    (fp, ft), (ip, it) = shares
    assert abs(ip - fp) <= 0.03 and abs(it - ft) <= 0.03 * ft, shares


@pytest.mark.parametrize("mode", ["resident", "segments", "pairs"])
def test_fog_modes_equal_default(fog, mode, monkeypatch):
    res, spp = 16, 4
    lanes = torch.arange(res * res).repeat(spp)
    args = (fog, scene_camera("fog", res), hk.make_filter(),
            torch.arange(spp).repeat_interleave(res * res), lanes % res, lanes // res)
    vp = hk.VolPath(max_depth=5, samples_per_pixel=1)
    want, _, want_st = hk.render_lanes(vp, *args)
    if mode == "resident":
        got, _, st = hk.render_lanes(hk.VolPath(max_depth=5, samples_per_pixel=1,
                                                resident="on"), *args)
    elif mode == "segments":
        got, _, st = render_lanes_segmented(vp, *args, 2)
    else:
        monkeypatch.setattr(twf, "SWEEP_MODE", "pairs")
        got, _, st = hk.render_lanes(vp, *args)
    assert torch.equal(got, want)
    assert float(st["rays_traced"]) == float(want_st["rays_traced"])
    assert float(want.mean()) > 0.1


@pytest.mark.slow
def test_fog_probe_against_the_references(fog):
    """The bench's fog probe (64x64, depth 5): rays of sample 0 against
    tools/transport_ref.json within 0.5%; mean RGB over 512 samples
    against the JAX package's within 2% (~2 min on the CPU). Sample 0's
    own mean RGB is one draw with a 6% spread (PERF.md), so it is not held
    to the stored 1-sample value."""
    rays, _ = transport_probe(fog, "fog")
    ref = probe_reference("fog")["rays_traced"]
    assert abs(rays - ref) <= 0.005 * ref, (rays, ref)
    ok, msg = check_transport(fog, "fog", spp=512)
    assert ok, msg


@pytest.mark.slow
def test_instanced_fog_box_matches_flat(fog):
    """The fog scene with its box as an instance renders as the flat one:
    16x16, depth 5, 512 samples, rays within 0.5%, mean RGB within 5%
    (~2 min on the CPU: the instanced plain sweeps)."""
    inst = _fog_with_instanced_box()
    (fr, fc), (ir, ic) = (transport_probe(sc, "fog", res=16, spp=512) for sc in (fog, inst))
    assert abs(ir - fr) <= 0.005 * fr, (ir, fr)
    assert abs(ic - fc) <= 0.05 * fc, (ic, fc)


@pytest.mark.slow
def test_cloud_grid_probe_against_the_reference():
    """The grid cloud at the bench cloud probe's configuration (32x32,
    depth 12, 16 samples) against the JAX package's: rays within 0.5%,
    mean RGB within 10% (bench.py's tolerance)."""
    ok, msg = check_transport(cloud_grid_scene().build(device="cpu"), "cloud_grid")
    assert ok, msg


@pytest.mark.slow
def test_stored_jax_cloud_probe_is_current():
    """Recompute draw 0 of the JAX package's grid-cloud probe (the tool's
    code, a few minutes on the CPU) and hold the stored draw to it within
    half the probe's tolerance (another CPU may round other bits and
    reseed)."""
    tool = _tool()
    rays, mean_rgb, _ = tool.jax_probe(tool.jax_cloud_grid_scene(), "cloud_grid", 32, 12, 16,
                                       16)
    ref = probe_reference("cloud_grid")["draws"]
    assert abs(rays - ref["rays_traced"][0]) <= 0.005 * ref["rays_traced"][0]
    assert abs(mean_rgb - ref["mean_rgb"][0]) <= 0.05 * ref["mean_rgb"][0]
