"""Port parity for what the main path left out: filters, crop windows, OBJ
meshes, material presets, transforms, bounds, the matrix camera, the ray
queries and the exports.

* filters: make_filter's 64 x 64 table, its |f| distribution and integral
  equal the JAX package's for all five types (exact); filter_sample on
  4096 seeded u gives the same offsets within 1e-6 and weights within 1e-5
  relative (Mitchell's and Lanczos' negative lobes included), and
  filter_eval the same table values;
* crop windows: the pbrt window [ceil(res lo), ceil(res hi)) equals the
  JAX package's for several bounds, adjacent crops tile the image, and a
  window covering no pixel raises ValueError (the JAX package renders one
  pixel there); a cropped 24x24 port render equals the full render's
  window within rtol 1e-5 / atol 1e-6 (tests/test_film_crop.py's bound);
* load_obj on an OBJ this test writes (a quad, a triangle, v/vt/vn
  corners, negative position indices), the glass and metal presets'
  packed banks, the transforms, Bounds3, make_matrix_camera's rays and
  scene_closest_hit / scene_any_hit each against the JAX package on the
  same inputs;
* every name this slice exports is in both packages' __all__;
* slow: the default scene at 16x16 under Mitchell, and under Lanczos in a
  crop window, against the JAX render (pixels within 1e-4), and the
  default 64x64 probe under each against the JAX package's stored probes
  (hikari_tpu_torch/data/probe_ref.json, rays 0.5%, mean RGB 1e-4).
"""

from dataclasses import fields

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu as jhk
import hikari_tpu_torch as hk
from hikari_tpu.camera import camera as jcam
from hikari_tpu.core import bounds as jbounds
from hikari_tpu.core import transform as jtf
from hikari_tpu.film import film as jfilm
from hikari_tpu.film import filters as jfilt
from hikari_tpu.materials import types as jmt
from hikari_tpu.scene import mesh as jmesh
from hikari_tpu_torch.camera import camera as tcam
from hikari_tpu_torch.core import bounds as tbounds
from hikari_tpu_torch.core import transform as ttf
from hikari_tpu_torch.film import film as tfilm
from hikari_tpu_torch.film import filters as tfilt
from hikari_tpu_torch.materials import types as tmt
from hikari_tpu_torch.scene import mesh as tmesh
from test_torch_scene import F32_RTOL, SPHERE_RES, jax_default_scene

FILTERS = {"box": tfilt.BOX, "triangle": tfilt.TRIANGLE, "gaussian": tfilt.GAUSSIAN,
           "mitchell": tfilt.MITCHELL, "lanczos": tfilt.LANCZOS}
N_U = 4096


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("name", FILTERS)
def test_filter_tables_and_samples(name):
    ftype = FILTERS[name]
    jf, tf = jfilt.make_filter(ftype), tfilt.make_filter(ftype)
    np.testing.assert_array_equal(tf.table.numpy(), np.asarray(jf.table))
    np.testing.assert_array_equal(np.asarray(tf.radius, np.float32), np.asarray(jf.radius))
    assert np.float32(tf.integral) == np.float32(jf.integral)
    for f in fields(tf.dist):
        np.testing.assert_array_equal(getattr(tf.dist, f.name).numpy(),
                                      np.asarray(getattr(jf.dist, f.name)), err_msg=f.name)
    rng = np.random.RandomState(3)
    u = rng.rand(N_U, 2).astype(np.float32)
    j_off, j_w = jfilt.filter_sample(jf, jnp.asarray(u))
    t_off, t_w = tfilt.filter_sample(tf, _t(u))
    np.testing.assert_allclose(t_off.numpy(), np.asarray(j_off), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), rtol=1e-5, atol=1e-5)
    if ftype in (tfilt.MITCHELL, tfilt.LANCZOS):  # the negative lobes are sampled
        assert (t_w.numpy() < 0).any() and (t_w.numpy() > 0).any()
    p = ((rng.rand(N_U, 2) * 2.4 - 1.2) * np.asarray(tf.radius)).astype(np.float32)
    np.testing.assert_array_equal(tfilt.filter_eval(tf, _t(p)).numpy(),
                                  np.asarray(jfilt.filter_eval(jf, jnp.asarray(p))))


WINDOWS = [((0.0, 0.0), (1.0, 1.0)), ((0.25, 0.25), (0.75, 0.75)), ((0.1, 0.3), (0.55, 0.9)),
           ((0.0, 0.5), (0.5, 1.0)), ((1 / 3, 0.2), (2 / 3, 0.3)), ((0.9, 0.0), (1.0, 0.05))]
# windows that cover no pixel at both resolutions, where the JAX package
# renders one pixel
EMPTY = [((0.5, 0.0), (0.5, 1.0)), ((0.99, 0.0), (1.0, 1.0)), ((0.0, 0.2), (1.0, 0.205)),
         ((0.6, 0.0), (0.4, 1.0))]


@pytest.mark.parametrize("res", [(24, 24), (25, 17)])
def test_crop_windows(res):
    w, h = res
    keys = ("width", "height", "full_width", "full_height", "crop_x0", "crop_y0")
    for bounds in WINDOWS:
        tf = tfilm.make_film(w, h, device="cpu", crop_bounds=bounds)
        jf = jfilm.make_film(w, h, crop_bounds=bounds)
        assert [getattr(tf, k) for k in keys] == [getattr(jf, k) for k in keys], bounds
        assert tf.rgb_sum.shape == (tf.height, tf.width, 3)
    # adjacent crops tile the image exactly
    cuts = [0.0, 1 / 3, 0.5, 0.8, 1.0]
    covered = np.zeros((h, w), int)
    for x0, x1 in zip(cuts, cuts[1:]):
        for y0, y1 in zip(cuts, cuts[1:]):
            f = tfilm.make_film(w, h, device="cpu", crop_bounds=((x0, y0), (x1, y1)))
            covered[f.crop_y0:f.crop_y0 + f.height, f.crop_x0:f.crop_x0 + f.width] += 1
    assert (covered == 1).all()
    for empty in EMPTY:
        with pytest.raises(ValueError, match="covers no pixel"):
            tfilm.make_film(w, h, device="cpu", crop_bounds=empty)
        jf = jfilm.make_film(w, h, crop_bounds=empty)
        assert min(jf.width, jf.height) == 1
    for outside in (((-0.1, 0.0), (1.0, 1.0)), ((0.0, 0.0), (1.0, 1.5))):
        with pytest.raises(ValueError, match="not inside"):
            tfilm.make_film(w, h, device="cpu", crop_bounds=outside)


def test_cropped_render_equals_the_full_window():
    from hikari_tpu_torch.scenes import default_scene, scene_camera

    sc = default_scene(SPHERE_RES).build(device="cpu")
    cam = scene_camera("default", 24)
    vp = hk.VolPath(max_depth=3, samples_per_pixel=1)
    filt = hk.make_filter(hk.MITCHELL)
    full = hk.render(vp, sc, cam, hk.make_film(24, 24, device="cpu"), filt)
    crop = hk.render(vp, sc, cam, hk.make_film(24, 24, device="cpu",
                                               crop_bounds=((0.25, 0.25), (0.75, 0.75))), filt)
    assert crop.rgb_sum.shape == (12, 12, 3) and (crop.crop_x0, crop.crop_y0) == (6, 6)
    # the films' sums: a pixel whose one Mitchell sample weighs < 0 divides
    # by the 1e-8 floor in framebuffer, as in the JAX package
    for name in ("rgb_sum", "weight_sum"):
        np.testing.assert_allclose(getattr(crop, name).numpy(),
                                   getattr(full, name)[6:18, 6:18].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert (full.weight_sum < 0).any() and float(full.rgb_sum.abs().mean()) > 0.01


def _write_obj(path):
    path.write_text("""# a quad of v/vt/vn corners and a triangle by negative indices
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0.5
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0.6 0.8

f 1/1/1 2/2/1 3/3/2 4/4/2
v 2 0 0
v 2 1 0
v 3 0 1
f -3 -2 -1
""")


def test_load_obj_matches_jax(tmp_path):
    path = tmp_path / "mesh.obj"
    _write_obj(path)
    jm, tm = jmesh.load_obj(str(path)), tmesh.load_obj(str(path))
    assert tm.n_faces == 3
    for k in ("vertices", "faces", "normals", "uvs"):
        want, got = getattr(jm, k), getattr(tm, k)
        assert (want is None) == (got is None), k
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=k)
    # positions only
    (tmp_path / "plain.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 4 3\n")
    jm, tm = jmesh.load_obj(str(tmp_path / "plain.obj")), tmesh.load_obj(str(tmp_path / "plain.obj"))
    np.testing.assert_array_equal(tm.faces, jm.faces)
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    assert tm.normals is None and jm.normals is None
    np.testing.assert_array_equal(tmesh.compute_vertex_normals(tm.vertices, tm.faces),
                                  jmesh.compute_vertex_normals(jm.vertices, jm.faces))


def _presets(m):
    return [m.BK7(), m.SF11(), m.Sapphire(), m.FusedSilica(), m.Diamond(u_roughness=0.05,
                                                                        v_roughness=0.05),
            m.Silver(), m.Copper(roughness=0.1), m.Aluminum(), m.Brass(roughness=0.3),
            m.Diffuse(kd=(0.2, 0.5, 0.7)), m.Dielectric(eta=1.33), m.Metal(metal="AG")]


def test_presets_pack_like_jax():
    jbanks, jtags, jidx, jpresent = jmt.pack_materials(_presets(jmt))
    tbanks, ttags, tidx, tpresent = tmt.pack_materials(_presets(tmt))
    np.testing.assert_array_equal(ttags, jtags)
    np.testing.assert_array_equal(tidx, jidx)
    assert set(tpresent) == set(jpresent)
    for f in fields(tbanks):
        got = getattr(tbanks, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jbanks, f.name)),
                                       rtol=F32_RTOL, atol=1e-7, err_msg=f.name)


def _transforms(m):
    return {"identity": m.identity(), "translate": m.translate((0.5, -2.0, 3.0)),
            "scale": m.scale((2.0, 0.5, 1.5)), "rotate": m.rotate(0.7, (1.0, 2.0, -0.5)),
            "rotate_x": m.rotate_x(0.3), "rotate_y": m.rotate_y(-1.1), "rotate_z": m.rotate_z(2.0),
            "look_at": m.look_at((1.0, 2.0, -3.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0)),
            "perspective": m.perspective(0.8)}


def test_transforms_match_jax():
    jt, tt = _transforms(jtf), _transforms(ttf)
    pts = np.random.RandomState(5).randn(64, 3).astype(np.float32)
    for name in jt:
        np.testing.assert_allclose(tt[name].m.numpy(), np.asarray(jt[name].m), rtol=F32_RTOL,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(tt[name].m_inv.numpy(), np.asarray(jt[name].m_inv),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    jc = jt["translate"] @ jt["rotate"] @ jt["scale"]
    tc = tt["translate"] @ tt["rotate"] @ tt["scale"]
    np.testing.assert_allclose(tc.apply_point(_t(pts)).numpy(),
                               np.asarray(jc.apply_point(jnp.asarray(pts))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc.inverse().apply_vector(_t(pts)).numpy(),
                               np.asarray(jc.inverse().apply_vector(jnp.asarray(pts))),
                               rtol=1e-5, atol=1e-5)


def test_bounds3_match_jax():
    rng = np.random.RandomState(6)
    a, b, p = (rng.randn(32, 3).astype(np.float32) for _ in range(3))
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    jb, tb = jbounds.Bounds3(jnp.asarray(lo), jnp.asarray(hi)), tbounds.Bounds3(_t(lo), _t(hi))
    jo = jbounds.bounds_from_points(jnp.asarray(p))
    to = tbounds.bounds_from_points(p)
    for jx, tx in ((jb.union(jo), tb.union(to)), (jb.union_point(jnp.asarray(p)),
                                                  tb.union_point(_t(p))),
                   (jb.expand(0.1), tb.expand(0.1)), (jo, to),
                   (jbounds.empty_bounds3().union(jo), tbounds.empty_bounds3().union(to))):
        np.testing.assert_array_equal(tx.lo.numpy(), np.asarray(jx.lo))
        np.testing.assert_array_equal(tx.hi.numpy(), np.asarray(jx.hi))
    for name in ("diagonal", "centroid", "surface_area"):
        np.testing.assert_allclose(getattr(tb, name)().numpy(),
                                   np.asarray(getattr(jb, name)()), rtol=F32_RTOL, err_msg=name)
    np.testing.assert_array_equal(tb.contains(_t(p)).numpy(), np.asarray(jb.contains(p)))
    np.testing.assert_allclose(tb.offset(_t(p)).numpy(), np.asarray(jb.offset(jnp.asarray(p))),
                               rtol=F32_RTOL, atol=1e-6)
    np.testing.assert_allclose(tb.bounding_sphere()[1].numpy(),
                               np.asarray(jb.bounding_sphere()[1]), rtol=F32_RTOL)
    d = rng.randn(32, 3).astype(np.float32)
    inv_d = (1.0 / d).astype(np.float32)
    for j, t in zip(jb.intersect_p(jnp.asarray(p), jnp.asarray(inv_d), 5.0),
                    tb.intersect_p(_t(p), _t(inv_d), 5.0)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=F32_RTOL, atol=1e-6)


def test_matrix_camera_rays_match_jax():
    view = np.asarray(jtf.look_at((0.5, 1.5, -3.0), (0.0, 0.8, 0.0), (0.0, 1.0, 0.0)).m_inv)
    proj = np.asarray(jtf.perspective(0.9).m)
    res = (32, 24)
    jc, tc = jcam.make_matrix_camera(view, proj, res), hk.make_matrix_camera(view, proj, res)
    rng = np.random.RandomState(8)
    p_film = (rng.rand(512, 2) * np.asarray(res)).astype(np.float32)
    lens, time = rng.rand(512, 2).astype(np.float32), rng.rand(512).astype(np.float32)
    jo, jd = jc.generate_rays(jcam.CameraSample(jnp.asarray(p_film), jnp.asarray(lens),
                                                jnp.asarray(time), jnp.ones(512)))
    to, td = tc.generate_rays(tcam.CameraSample(_t(p_film), _t(lens), _t(time),
                                                torch.ones(512)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    assert tc.resolution == res and tc.lens_radius == 0.0


def test_ray_queries_match_jax():
    js = jax_default_scene()
    from hikari_tpu_torch.scenes import default_scene

    ts = default_scene(SPHERE_RES).build(device="cpu")
    rng = np.random.RandomState(9)
    n = 2048
    o = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(0.2, 3.5, n),
                  rng.uniform(-0.5, 4.5, n)], -1).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, np.inf, np.float32)
    t_max[::3] = rng.uniform(0.1, 2.0, len(t_max[::3]))
    jrec = jhk.scene_closest_hit(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    trec = hk.scene_closest_hit(ts, _t(o), _t(d), _t(t_max))
    same = trec.tri.numpy() == np.asarray(jrec.tri)
    assert same.mean() >= 0.999, same.mean()
    both = same & trec.hit.numpy()
    assert both.mean() > 0.3
    np.testing.assert_allclose(trec.t.numpy()[both], np.asarray(jrec.t)[both], rtol=1e-5)
    t_sh = np.where(np.isfinite(t_max), t_max, 3.0).astype(np.float32)
    jocc = np.asarray(jhk.scene_any_hit(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_sh)))
    tocc = hk.scene_any_hit(ts, _t(o), _t(d), _t(t_sh)).numpy()
    assert (tocc == jocc.reshape(-1)).mean() >= 0.999
    assert 0.05 < tocc.mean() < 0.95


SLICE_EXPORTS = (
    "load_obj", "compute_vertex_normals", "BK7", "SF11", "Sapphire", "FusedSilica", "Diamond",
    "Silver", "Copper", "Aluminum", "Brass", "Diffuse", "Dielectric", "Metal", "identity",
    "translate", "rotate", "rotate_x", "rotate_y", "rotate_z", "Transform", "look_at",
    "perspective", "from_matrix", "scale", "make_matrix_camera", "PerspectiveCamera",
    "scene_closest_hit", "scene_any_hit", "perlin3d", "fbm3d", "worley3d",
    "generate_cloud_density", "BrickGridMedium", "save_nanovdb", "load_nanovdb",
    "load_nanovdb_sparse", "nanovdb_medium", "BOX", "TRIANGLE", "GAUSSIAN", "MITCHELL",
    "LANCZOS", "Film")


@pytest.mark.parametrize("name", SLICE_EXPORTS)
def test_slice_exports_are_in_both_packages(name):
    assert name in hk.__all__ and name in jhk.__all__
    assert callable(getattr(hk, name)) or isinstance(getattr(hk, name), int)


def _jax_render(ftype, crop, res=16):
    from hikari_tpu.integrators.volpath import VolPath, render

    cam = jcam.make_perspective_camera((0.0, 1.6, -2.8), (0.0, 0.9, 2.0), (res, res),
                                       fov_deg=45.0)
    film = jfilm.make_film(res, res, crop_bounds=crop)
    out = render(VolPath(max_depth=5, samples_per_pixel=1), jax_default_scene(), cam, film,
                 jfilt.make_filter(ftype))
    return np.asarray(jfilm.framebuffer(out))


@pytest.mark.slow
@pytest.mark.parametrize("name, crop", [("mitchell", None),
                                        ("lanczos", ((0.25, 0.125), (0.875, 0.75)))])
def test_filtered_render_matches_jax(name, crop):
    from hikari_tpu_torch.scenes import check_transport, default_scene, scene_camera

    sc = default_scene(SPHERE_RES).build(device="cpu")
    film = hk.make_film(16, 16, device="cpu", crop_bounds=crop)
    got = hk.framebuffer(hk.render(hk.VolPath(max_depth=5, samples_per_pixel=1), sc,
                                   scene_camera("default", 16), film,
                                   hk.make_filter(FILTERS[name]))).numpy()
    want = _jax_render(FILTERS[name], crop)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    ok, msg = check_transport(default_scene().build(device="cpu"), "default",
                              ftype=FILTERS[name], rgb_tol=1e-4)
    assert ok, msg
