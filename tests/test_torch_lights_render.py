"""Port parity: the lights on the render path (VolPath render_lanes).

Each scene is built by each package through its own public API and
rendered by both on the CPU (the port through its plain sweeps):

* the bench's sphere scene (glass and gold spheres under the Hosek-Wilkie
  sun and sky, no area light) with coarse spheres at 32x32, 1 spp: at
  depth 1 (camera hit, escaped rays' sky, NEE from the sun and the sky)
  >= 99% of pixels within 1e-3 relative + 1e-5 absolute, and the
  transport probe's invariants at depth 5 (rays within 0.5%, mean RGB
  within 2%); and (slow) the bench's own 64x64 probe against
  tools/transport_ref.json, which chip_smoke.py also runs;
* the BVH and uniform light samplers on tests/test_bvh_lights.py's grid
  of point lights over a floor (per pixel as above, at depth 2; the JAX
  package renders both samplers in one compiled program), and the
  BVH sampler's emission MIS (bvh_pmf replayed at the last vertex) on a
  scene with area lights and a sky: resident loop and depth segments
  equal the plain loop, which carry the last vertex's normal;
* (an instanced scene under a sun and sky is
  tests/test_torch_instanced_render.py's test_instanced_sky_matches_jax_flat);
* the lights scene (spot, distant, ambient, equirect environment; the
  64x64 probe slow) and (slow) the default scene under the uniform and BVH
  samplers against the JAX package's stored probes, and (slow) the
  bench's sun-sky cloud probe against the JAX package's six-draw mean
  (data/probe_ref.json, tools/gen_probe_ref.py).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu as jhk
from hikari_tpu.camera.camera import make_perspective_camera as j_camera
from hikari_tpu.film.filters import make_filter as j_filter
from hikari_tpu.integrators.volpath import VolPath as JVolPath
from hikari_tpu.integrators.volpath import render_lanes as j_render_lanes
from hikari_tpu.lights.sunsky import sunsky_environment as j_sunsky
from hikari_tpu.scene.scene import Scene as JScene
import hikari_tpu_torch as hk
from hikari_tpu_torch.lights import types as tlt
from hikari_tpu_torch.scenes import check_transport, default_scene, lights_scene, sphere_scene
from test_torch_scene import SPHERE_RES

RES = 32
JAX_API = SimpleNamespace(Scene=JScene, make_quad=jhk.make_quad, make_sphere=jhk.make_sphere,
                          Matte=jhk.Matte, Glass=jhk.Glass, Gold=jhk.Gold,
                          Emissive=jhk.Emissive, PointLight=jhk.PointLight,
                          sunsky_environment=j_sunsky)


def _jax_renderer(js, camera_args, max_depth):
    """JAX renders by depth at RES x RES, 1 spp; one compiled program
    serves every depth through depth_hi (as in test_torch_volpath.py)."""
    eye, at, fov = camera_args
    jcam = j_camera(eye, at, (RES, RES), fov_deg=fov)
    jl = jnp.arange(RES * RES, dtype=jnp.uint32)
    fn = jax.jit(lambda depth: j_render_lanes(
        JVolPath(max_depth=max_depth, samples_per_pixel=1), js, jcam, j_filter(),
        jnp.uint32(0), jl % RES, jl // RES, depth_lo=jnp.int32(0), depth_hi=depth))
    return lambda depth: fn(jnp.int32(depth))


def _port_render(ts, camera_args, depth, res=RES, **vp_kw):
    eye, at, fov = camera_args
    lanes = torch.arange(res * res)
    rgb, _, st = hk.render_lanes(hk.VolPath(max_depth=depth, samples_per_pixel=1, **vp_kw), ts,
                                 hk.make_perspective_camera(eye, at, (res, res), fov_deg=fov),
                                 hk.make_filter(), 0, lanes % res, lanes // res)
    assert float(st["nonfinite_lanes"]) == 0.0
    return rgb.numpy(), float(st["rays_traced"])


def _both(jax_render, ts, camera_args, depth):
    jrgb, _, jst = jax_render(depth)
    trgb, trays = _port_render(ts, camera_args, depth)
    return np.asarray(jrgb), float(jst["rays_traced"]), trgb, trays


def _assert_pixels(jrgb, trgb):
    close = (np.abs(trgb - jrgb) <= 1e-3 * np.abs(jrgb) + 1e-5).all(-1)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} pixels differ"


def _assert_invariants(jrgb, jrays, trgb, trays):
    assert abs(trays - jrays) <= 0.005 * jrays, (trays, jrays)
    assert abs(trgb.mean() - jrgb.mean()) <= 0.02 * abs(jrgb.mean()), (trgb.mean(), jrgb.mean())


# --- the sphere scene ------------------------------------------------------------


def _sphere_scene(m, sphere_res):
    """bench.py build_sphere_scene through API m, spheres at sphere_res."""
    s = m.Scene()
    s.add(m.make_quad((-6, 0, -6), (6, 0, -6), (6, 0, 6), (-6, 0, 6)), m.Matte(kd=(0.55,) * 3))
    s.add(m.make_sphere((-0.7, 0.55, 0.2), 0.55, *sphere_res), m.Glass(eta=1.5))
    s.add(m.make_sphere((0.7, 0.5, -0.2), 0.5, *sphere_res), m.Gold(roughness=0.1))
    for light in m.sunsky_environment(direction=(0.4, 0.35, 0.6)):
        s.add_light(light)
    return s


SPHERE_CAMERA = ((0.0, 1.0, -3.2), (0.0, 0.5, 0.0), 45.0)


@pytest.fixture(scope="module")
def sphere():
    js = _sphere_scene(JAX_API, SPHERE_RES).build()
    ts = sphere_scene(SPHERE_RES).build(device="cpu")
    return _jax_renderer(js, SPHERE_CAMERA, 5), ts


def test_sphere_scene_pixels_depth1(sphere):
    jrgb, jrays, trgb, trays = _both(*sphere, SPHERE_CAMERA, 1)
    _assert_pixels(jrgb, trgb)
    assert abs(trays - jrays) <= 0.005 * jrays
    assert trgb[: RES * 4].mean() > 0.05  # the top rows see the sky


def test_sphere_scene_transport_depth5(sphere):
    jrgb, jrays, trgb, trays = _both(*sphere, SPHERE_CAMERA, 5)
    _assert_invariants(jrgb, jrays, trgb, trays)


@pytest.mark.slow
def test_sphere_scene_bench_probe():
    """The bench's sphere scene at its probe size against
    tools/transport_ref.json (10,434 rays, mean RGB 0.164942)."""
    ok, msg = check_transport(sphere_scene().build(device="cpu"), "sphere")
    assert ok, msg


# --- the BVH and uniform samplers ------------------------------------------------


def _grid_lights_scene(m, sampler):
    """tests/test_bvh_lights.py's render scene: a floor under a 3 x 3 grid
    of point lights, one of them 50 times brighter."""
    s = m.Scene()
    s.set_light_sampler(sampler)
    s.add(m.make_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4)), m.Matte(kd=(0.7,) * 3))
    for i in range(3):
        for j in range(3):
            inten = 50.0 if (i, j) == (0, 0) else 1.0
            s.add_light(m.PointLight(position=(i * 2.0, 2.0, j * 2.0), intensity=(inten,) * 3))
    return s


GRID_CAMERA = ((2.0, 4.0, -4.0), (2.0, 0.0, 2.0), 50.0)


SAMPLERS = ("uniform", "bvh")


@pytest.fixture(scope="module")
def sampler_renders():
    """The JAX package's depth-2 renders of the grid-lights scene under each
    sampler, (rgb, stats) by sampler, from one compiled program that takes
    both scenes' light tables as inputs."""
    eye, at, fov = GRID_CAMERA
    jcam = j_camera(eye, at, (RES, RES), fov_deg=fov)
    jl = jnp.arange(RES * RES, dtype=jnp.uint32)
    vp = JVolPath(max_depth=2, samples_per_pixel=1)
    return jax.jit(lambda scenes: {
        s: j_render_lanes(vp, js, jcam, j_filter(), jnp.uint32(0), jl % RES, jl // RES)[::2]
        for s, js in scenes.items()})(
            {s: _grid_lights_scene(JAX_API, s).build() for s in SAMPLERS})


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_light_sampler_pixels(sampler, sampler_renders):
    jrgb, jst = sampler_renders[sampler]
    jrgb, jrays = np.asarray(jrgb), float(jst["rays_traced"])
    trgb, trays = _port_render(_grid_lights_scene(hk, sampler).build(device="cpu"),
                               GRID_CAMERA, 2)
    _assert_pixels(jrgb, trgb)
    _assert_invariants(jrgb, jrays, trgb, trays)
    assert trgb.mean() > 0.01


def _sky_area_scene():
    s = default_scene(SPHERE_RES)
    s.set_light_sampler("bvh")
    for light in hk.sunsky_environment(resolution=32):
        s.add_light(light)
    return s.build(device="cpu")


@pytest.mark.parametrize("mode", ["resident loop", "3 depth segments"])
def test_bvh_sampler_modes_carry_the_last_normal(mode):
    """Emission MIS under the BVH sampler replays bvh_pmf at the last
    scattering vertex with its shading normal (prev_ns): the resident loop
    permutes the lanes and the depth segments hand the state on, and both
    must give the plain loop's image."""
    from hikari_tpu_torch.integrators.volpath import render_lanes_segmented

    ts = _sky_area_scene()
    cam = ((0.0, 1.6, -2.8), (0.0, 0.9, 2.0), 45.0)
    plain, rays = _port_render(ts, cam, 4, res=24)
    if mode == "resident loop":
        other, other_rays = _port_render(ts, cam, 4, res=24, resident="on")
    else:
        lanes = torch.arange(24 * 24)
        rgb, _, st = render_lanes_segmented(
            hk.VolPath(max_depth=4, samples_per_pixel=1), ts,
            hk.make_perspective_camera(*cam[:2], (24, 24), fov_deg=cam[2]), hk.make_filter(),
            0, lanes % 24, lanes // 24, 3)
        other, other_rays = rgb.numpy(), float(st["rays_traced"])
    assert other_rays == rays
    np.testing.assert_allclose(other, plain, rtol=1e-3, atol=2e-3)
    assert plain.mean() > 0.1


# --- stored JAX probes ------------------------------------------------------------


@pytest.mark.parametrize("sampler, cfg", [
    pytest.param("power", {}, id="power 64x64", marks=pytest.mark.slow),
    pytest.param("bvh", dict(res=32, spp=4), id="bvh 32x32 x 4")])
def test_lights_scene_probe(sampler, cfg):
    s = lights_scene()
    s.set_light_sampler(sampler)
    sc = s.build(device="cpu")
    assert sc.lights.present_types == {tlt.SPOT, tlt.DISTANT, tlt.ENV}
    assert sc.lights.has_ambient
    ok, msg = check_transport(sc, "lights", **cfg)
    assert ok, msg


@pytest.mark.slow
@pytest.mark.parametrize("sampler", ["uniform", "bvh"])
def test_default_scene_sampler_probe(sampler):
    """The benchmark's default scene (61,450 triangles) under a sampler at
    the probe size, against the stored JAX probe (~25 s on the CPU)."""
    s = default_scene()
    s.set_light_sampler(sampler)
    ok, msg = check_transport(s.build(device="cpu"), "default")
    assert ok, msg


@pytest.mark.slow
def test_sunsky_cloud_bench_probe():
    """The bench's sun-sky cloud probe (32x32, depth 12, 16 samples)
    against the JAX package's mean over six LCG draws (rays 0.5%, mean RGB
    10%, as the grid cloud's; the lane-for-lane check is
    test_torch_media_render.py's shared-streams render of this scene)."""
    from hikari_tpu_torch.scenes import cloud_scene

    sc = cloud_scene().build(device="cpu")
    assert sc.lights.has_env and sc.has_media
    ok, msg = check_transport(sc, "cloud")
    assert ok, msg
