"""Port parity: the flat scene build.

The port's Scene.build must produce the JAX SceneData's arrays: BVH leaf
order, packed face rows, treelet boxes and rows, the float32 affine
coefficients (against their reconstruction from the JAX bf16 split), the
light sampler's pmf and alias tables, and the material banks. Integer and
host-computed arrays must be equal; arrays computed in float32 on both
sides (coefficients of the RGB uplift, triangle normals and areas) agree
to 1e-6 relative.
"""

import os
from dataclasses import fields

import numpy as np
import pytest
import torch

from hikari_tpu.geometry import wavefront as jwf
from hikari_tpu.lights.bvh_sampler import LightBVH as JLightBVH
from hikari_tpu.lights.types import PointLight as JPointLight
from hikari_tpu.materials import types as jmt
from hikari_tpu.scene.mesh import make_quad as j_quad
from hikari_tpu.scene.mesh import make_sphere as j_sphere
from hikari_tpu.scene.scene import Scene as JScene
from hikari_tpu_torch.geometry import wavefront as twf
from hikari_tpu_torch.lights.types import LightBanks
from hikari_tpu_torch.materials.types import MaterialBanks
from hikari_tpu_torch.sampling.distributions import Distribution2D
from hikari_tpu_torch.scene.bridge import coef_from_bw, scene_from_numpy
from hikari_tpu_torch.scenes import default_scene

# pytest-xdist runs several workers on the host's cores, and each worker
# imports every test module when it collects: give each worker its share
# of the cores here, or torch's spinning intra-op threads oversubscribe
# them and every port render slows down many times over
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

F32_RTOL = 1e-6
SPHERE_RES = (8, 16)  # the benchmark scene with coarse spheres: 3082 faces


def jax_default_scene(traversal="skiplink"):
    """bench.py build_scene through the JAX API, spheres at SPHERE_RES."""
    s = JScene()
    white = jmt.Matte(kd=(0.73, 0.73, 0.73))
    s.add(j_quad((-3, 0, -1), (3, 0, -1), (3, 0, 5), (-3, 0, 5)), white)
    s.add(j_quad((-3, 0, 5), (3, 0, 5), (3, 4, 5), (-3, 4, 5)), white)
    s.add(j_quad((-3, 0, -1), (-3, 0, 5), (-3, 4, 5), (-3, 4, -1)),
          jmt.Matte(kd=(0.65, 0.05, 0.05)))
    s.add(j_quad((3, 0, -1), (3, 4, -1), (3, 4, 5), (3, 0, 5)),
          jmt.Matte(kd=(0.12, 0.45, 0.15)))
    mats = [jmt.Gold(roughness=0.15), jmt.Glass(eta=1.5), jmt.Mirror(),
            jmt.Matte(kd=(0.3, 0.4, 0.8)), jmt.Matte(kd=(0.8, 0.6, 0.2))]
    k = 0
    for ix in range(4):
        for iz in range(4):
            s.add(j_sphere((-1.8 + 1.2 * ix, 0.45, 0.2 + 1.2 * iz), 0.42, *SPHERE_RES),
                  mats[k % len(mats)])
            k += 1
    s.add(j_quad((-1.0, 3.99, 1.0), (1.0, 3.99, 1.0), (1.0, 3.99, 3.0), (-1.0, 3.99, 3.0)),
          jmt.Emissive(le=(1.0, 0.95, 0.85), scale=25.0))
    s.add_light(JPointLight(position=(0.0, 3.0, -0.5), intensity=(8.0, 8.0, 8.0)))
    return s.build(traversal=traversal)


def jax_scene_arrays(js) -> dict:
    """Flatten a JAX SceneData to the numpy dict scene_from_numpy takes."""
    tl = js.treelets
    out = {
        "face_rows": np.asarray(js.face_rows), "mat_type": np.asarray(js.mat_type),
        "mat_idx": np.asarray(js.mat_idx), "world_lo": np.asarray(js.world_lo),
        "world_hi": np.asarray(js.world_hi),
        "scene_radius": np.asarray(js.scene_radius),
        "present_materials": np.asarray(js.present_materials),
        "treelets.bw": np.asarray(tl.bw).astype(np.float32),
    }
    for k in ("lo", "hi", "sup_lo", "sup_hi", "tri"):
        out[f"treelets.{k}"] = np.asarray(getattr(tl, k))
    for f in fields(MaterialBanks):
        out[f"materials.{f.name}"] = np.asarray(getattr(js.materials, f.name))
    out.update(jax_light_arrays(js))
    out.update(jax_surface_arrays(js))
    return out


def jax_surface_arrays(js) -> dict:
    """The texture and alpha arrays of a JAX SceneData, as scene_from_numpy
    takes them."""
    out = {k: np.asarray(getattr(js, k)) for k in ("tex_rows", "alpha_const", "alpha_tex")}
    out["tri_p"] = np.concatenate([np.asarray(getattr(js.bvh, k)) for k in ("p0", "p1", "p2")],
                                  axis=1)
    for k in ("data", "offset", "width", "height", "uv_scale", "uv_offset"):
        out[f"atlas.{k}"] = np.asarray(getattr(js.atlas, k))
    return out


def jax_light_arrays(js) -> dict:
    """The light banks, the environment's distribution, the BVH light
    sampler's tree and the sampler of a JAX SceneData, flattened to
    numpy."""
    out = {"light_sampler": js.light_sampler}
    for f in fields(LightBanks):
        v = getattr(js.lights, f.name)
        if f.name == "env_dist":
            out.update({f"lights.env_dist.{g.name}": np.asarray(getattr(v, g.name))
                        for g in fields(Distribution2D)})
        else:
            out[f"lights.{f.name}"] = np.asarray(v)
    for f in fields(JLightBVH):
        out[f"light_bvh.{f.name}"] = np.asarray(getattr(js.light_bvh, f.name))
    return out


@pytest.fixture(scope="module")
def scenes():
    js = jax_default_scene()
    ts = default_scene(SPHERE_RES).build(device="cpu")
    return js, ts, jax_scene_arrays(js)


def test_geometry_and_face_rows(scenes):
    js, ts, arr = scenes
    assert ts.n_faces == js.n_faces == 3082
    for key, got in (("face_rows", ts.face_rows), ("mat_type", ts.mat_type),
                     ("mat_idx", ts.mat_idx), ("world_lo", ts.world_lo),
                     ("world_hi", ts.world_hi)):
        np.testing.assert_array_equal(got.numpy(), arr[key], err_msg=key)
    assert ts.present_materials == tuple(js.present_materials)
    assert ts.n_lights == js.n_lights
    assert ts.scene_radius == pytest.approx(float(js.scene_radius), rel=F32_RTOL)


def test_treelets(scenes):
    js, ts, arr = scenes
    tl = ts.treelets
    assert tl.lo.shape[0] >= 8
    for k in ("lo", "hi", "sup_lo", "sup_hi", "tri"):
        np.testing.assert_array_equal(getattr(tl, k).numpy(), arr[f"treelets.{k}"],
                                      err_msg=k)
    # the port's own f32 coefficients equal the exact sum of the bf16 split
    np.testing.assert_array_equal(tl.coef.numpy(), coef_from_bw(arr["treelets.bw"]))


def test_lights(scenes):
    js, ts, arr = scenes
    exact = ("light_type", "light_idx", "pmf", "alias_q", "alias_j", "area_p0",
             "area_p1", "area_p2", "area_le", "area_two_sided", "point_pos", "point_i")
    for k in exact:
        np.testing.assert_array_equal(getattr(ts.lights, k).numpy(),
                                      arr[f"lights.{k}"], err_msg=k)
    for k in ("area_n", "area_area", "point_i_c4", "area_le_c4"):
        np.testing.assert_allclose(getattr(ts.lights, k).numpy(), arr[f"lights.{k}"],
                                   rtol=F32_RTOL, atol=1e-7, err_msg=k)
    assert ts.lights.area_flat_base == js.lights.area_flat_base
    assert ts.lights.n_flat == js.lights.n_flat


def test_material_banks(scenes):
    js, ts, arr = scenes
    for f in fields(MaterialBanks):
        got = np.asarray(getattr(ts.materials, f.name))  # has_textures is a bool
        want = arr[f"materials.{f.name}"]
        if got.dtype == np.bool_:
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=1e-7,
                                       err_msg=f.name)


def test_bridge_carries_the_jax_scene(scenes):
    js, ts, arr = scenes
    bs = scene_from_numpy(arr, "cpu")
    np.testing.assert_array_equal(bs.face_rows.numpy(), ts.face_rows.numpy())
    np.testing.assert_array_equal(bs.treelets.coef.numpy(), ts.treelets.coef.numpy())
    np.testing.assert_array_equal(bs.lights.alias_j.numpy(), ts.lights.alias_j.numpy())
    assert bs.present_materials == ts.present_materials
    assert bs.lights.area_flat_base == ts.lights.area_flat_base


def test_build_treelets_random_triangles():
    rng = np.random.RandomState(0)
    p = 700  # three treelets, the last one partly padding
    c = rng.rand(p, 3).astype(np.float32) * 4 - 2
    p0, p1, p2 = (c + rng.rand(p, 3).astype(np.float32) * 0.5 for _ in range(3))
    p1[5] = p0[5]  # one degenerate triangle: all-zero coefficient rows
    supers = (np.zeros((1, 3), np.float32), np.ones((1, 3), np.float32))
    jt = jwf.build_treelets(p0, p1, p2)
    tt = twf.build_treelets(p0, p1, p2, supers)
    np.testing.assert_array_equal(tt.coef.numpy(),
                                  coef_from_bw(np.asarray(jt.bw).astype(np.float32)))
    np.testing.assert_array_equal(tt.tri.numpy(), np.asarray(jt.tri))
    np.testing.assert_array_equal(tt.lo.numpy(), np.asarray(jt.lo))
    assert not tt.coef[0, 5].any()
    assert torch.equal(tt.coef[2, p - 512:], torch.zeros_like(tt.coef[2, p - 512:]))


def _one_quad():
    from hikari_tpu_torch import Matte, Scene, make_quad

    s = Scene()
    s.add(make_quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1)), Matte())
    return s


def test_build_needs_a_device_without_cuda(monkeypatch):
    """Without a card, build() raises instead of falling back to the CPU;
    device="cpu" builds there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _one_quad().build()
    assert _one_quad().build(device="cpu").device.type == "cpu"


def test_make_film_needs_a_device_without_cuda(monkeypatch):
    from hikari_tpu_torch.film.film import make_film

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_film(8, 4)
    film = make_film(8, 4, device="cpu")
    assert film.rgb_sum.shape == (4, 8, 3) and film.rgb_sum.device.type == "cpu"


@pytest.mark.parametrize("native", [True, False])
def test_bvh_builders_match_reference(native):
    """The C++ builder compiled by the port and its numpy fallback build the
    JAX package's trees."""
    from hikari_tpu.geometry.bvh import build_bvh as j_build_bvh
    from hikari_tpu_torch.geometry.bvh import build_bvh as t_build_bvh

    rng = np.random.RandomState(2)
    c = rng.rand(800, 3).astype(np.float32) * 8 - 4
    ext = rng.rand(800, 3).astype(np.float32) * 0.3
    j, t = j_build_bvh(c - ext, c + ext, native=native), t_build_bvh(c - ext, c + ext,
                                                                     native=native)
    for k in ("lo", "hi", "first", "count", "skip", "prim_order"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k), err_msg=k)
