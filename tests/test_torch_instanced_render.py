"""Port parity: the instanced path as a whole (renders).

The 3x3 instanced sphere grid of tests/test_torch_instanced.py (one
instance rotated and non-uniformly scaled, per-instance materials with
Gold, an emissive quad in BLAS 0): VolPath render_lanes against the JAX
render, and against the same grid built flattened in the port alone; the instanced default
scene against the flat one; and an instanced scene under a sun and sky
against the JAX package's flat build of it. Kept apart from the
table and traversal tests so that pytest-xdist's file-level scheduling
runs the JAX instanced render's compile beside them.

Tolerances: at depth 1 >= 99% of pixels within 1e-3 relative + 1e-5
absolute (silhouette pixels flip an edge hit between the bf16x3 and
float32 sweeps), at depth 3 rays within 0.5% and mean RGB within 2% (the
transport probe's tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.camera.camera import make_perspective_camera as j_camera
from hikari_tpu.film.filters import make_filter as j_filter
from hikari_tpu.integrators.volpath import VolPath as JVolPath
from hikari_tpu.integrators.volpath import render_lanes as j_render_lanes
import hikari_tpu as jhk
from hikari_tpu.lights.sunsky import sunsky_environment as j_sunsky
from hikari_tpu.scene.mesh import TriangleMesh as JTriangleMesh
from hikari_tpu.scene.scene import Scene as JScene
import hikari_tpu_torch as hk
from test_torch_lights_render import _assert_invariants, _both, _jax_renderer
from test_torch_instanced import AT, EYE, FOV, PORT_API, RES, _build_grid, grid  # noqa: F401


@pytest.fixture(scope="module")
def jax_render(grid):
    """JAX renders of the grid by depth; one compiled program serves every
    depth through depth_hi (as in test_torch_volpath.py)."""
    js, _ = grid
    # the reference flags every instanced scene whose BLAS are padded as
    # having stochastic alpha (ROADMAP C); no face of the grid has alpha
    # below 1, so the flag changes no sample, only the compile time. The
    # port has no alpha path: render both without it.
    js = js.replace(has_alpha=False)
    jcam = j_camera(EYE, AT, (RES, RES), fov_deg=FOV)
    jvp = JVolPath(max_depth=3, samples_per_pixel=1)
    jl = jnp.arange(RES * RES, dtype=jnp.uint32)
    fn = jax.jit(lambda depth: j_render_lanes(
        jvp, js, jcam, j_filter(), jnp.uint32(0), jl % RES, jl // RES,
        depth_lo=jnp.int32(0), depth_hi=depth))
    return lambda depth: fn(jnp.int32(depth))


def _port_render(ts, depth, res=RES, spp=1):
    """render_lanes of the grid, averaged over spp samples."""
    cam = hk.make_perspective_camera(EYE, AT, (res, res), fov_deg=FOV)
    lanes = torch.arange(res * res)
    rgb_sum, rays = 0.0, 0.0
    for s in range(spp):
        rgb, _, st = hk.render_lanes(hk.VolPath(max_depth=depth, samples_per_pixel=spp), ts,
                                     cam, hk.make_filter(), s, lanes % res, lanes // res)
        assert float(st["nonfinite_lanes"]) == 0.0
        rgb_sum, rays = rgb_sum + rgb.numpy(), rays + float(st["rays_traced"])
    return rgb_sum / spp, rays / spp


def test_slice_pixels_depth1(grid, jax_render):
    _, ts = grid
    jrgb, _, jstats = jax_render(1)
    trgb, trays = _port_render(ts, 1)
    jrgb = np.asarray(jrgb)
    close = (np.abs(trgb - jrgb) <= 1e-3 * np.abs(jrgb) + 1e-5).all(-1)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} pixels differ"
    assert abs(trays - float(jstats["rays_traced"])) <= 0.005 * float(jstats["rays_traced"])
    assert trgb.mean() > 0.01


def test_slice_transport_depth3(grid, jax_render):
    _, ts = grid
    jrgb, _, jstats = jax_render(3)
    trgb, trays = _port_render(ts, 3)
    jrays = float(jstats["rays_traced"])
    assert abs(trays - jrays) <= 0.005 * jrays
    jm = float(np.asarray(jrgb).mean())
    assert abs(trgb.mean() - jm) <= 0.02 * abs(jm)


def test_instanced_matches_flattened_in_port(grid):
    """The grid built instanced renders like the grid built flattened (the
    thresholds of tests/test_instancing.py)."""
    _, ts = grid
    flat = _build_grid(PORT_API, flatten=True).build(device="cpu")
    assert not flat.has_instances and flat.inst is None
    img_i, rays_i = _port_render(ts, 3, res=48, spp=4)
    img_f, rays_f = _port_render(flat, 3, res=48, spp=4)
    diff = np.abs(img_f - img_i)
    assert diff.mean() / max(img_f.mean(), 1e-6) < 0.03
    assert (diff.max(-1) > 0.05).mean() < 0.05
    assert abs(rays_i - rays_f) <= 0.005 * rays_f


@pytest.mark.slow
def test_instanced_default_scene_matches_flat_default():
    """The instanced default scene (16 instances of one sphere) against the
    flat default at 64x64, depth 5, 4 spp averaged, with the transport
    probe's tolerances (the two builds order the emissive quad's triangles
    differently, so single samples are noisier)."""
    from hikari_tpu_torch.scenes import default_scene, instanced_default_scene, scene_camera

    out = []
    for build in (default_scene, instanced_default_scene):
        sc = build().build(device="cpu")
        lanes = torch.arange(64 * 64)
        rays = rgb = 0.0
        for s in range(4):
            img, _, st = hk.render_lanes(hk.VolPath(max_depth=5, samples_per_pixel=4), sc,
                                         scene_camera("default", 64), hk.make_filter(), s,
                                         lanes % 64, lanes // 64)
            rays, rgb = rays + float(st["rays_traced"]), rgb + float(img.mean())
        out.append((rays / 4, rgb / 4))
    (fr, fc), (ir, ic) = out
    assert abs(ir - fr) <= 0.005 * fr and abs(ic - fc) <= 0.02 * fc, out


def _placements():
    tr = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    for k in range(5):
        s = 0.6 + 0.15 * k
        tr[k, :3, :3] = np.diag([s, s * 1.2, s])
        tr[k, :3, 3] = (-2.0 + k, 0.5 * s * 1.2, 0.5 * (k % 2))
    return tr


def test_instanced_sky_matches_jax_flat():
    """Five placements of one 8 x 16 sphere (a padded BLAS) on a floor,
    under the sun and sky: the port's instanced build against the JAX
    package's flat build of the same triangles (the JAX package's own
    instanced build has an infinite scene radius, ROADMAP C, so its
    distant and environment lights are no reference). The radius is the
    flat one's; rays within 0.5% and mean RGB within 2% at depth 3."""
    tr = _placements()
    unit = hk.make_sphere((0.0, 0.0, 0.0), 0.5, 8, 16)
    sky = dict(direction=(0.3, 0.5, 0.4), resolution=32)

    s = hk.Scene()
    s.add(hk.make_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4)), hk.Matte(kd=(0.5,) * 3))
    s.add_instanced(unit, tr, hk.Matte(kd=(0.3, 0.5, 0.7)))
    for light in hk.sunsky_environment(**sky):
        s.add_light(light)
    ts = s.build(device="cpu")

    j = JScene()
    j.add(jhk.make_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4)), jhk.Matte(kd=(0.5,) * 3))
    v = np.asarray(unit.vertices, np.float32)
    for m in tr:
        j.add(JTriangleMesh(vertices=v @ m[:3, :3].T + m[:3, 3], faces=unit.faces),
              jhk.Matte(kd=(0.3, 0.5, 0.7)))
    for light in j_sunsky(**sky):
        j.add_light(light)
    js = j.build()

    assert ts.has_instances and bool((ts.inst.hi > 1e37).any())
    assert ts.scene_radius == pytest.approx(float(js.scene_radius), rel=1e-6)
    cam = ((0.0, 2.0, -5.0), (0.0, 0.4, 0.0), 50.0)
    jrgb, jrays, trgb, trays = _both(_jax_renderer(js, cam, 3), ts, cam, 3)
    _assert_invariants(jrgb, jrays, trgb, trays)
