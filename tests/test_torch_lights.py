"""Port parity: the lights (hikari_tpu_torch/lights, sampling/distributions).

The same inputs, made from numpy seeds, go through the JAX function (run
eagerly on the CPU) and its port:

* host functions: the Hosek-Wilkie bake, equirect_to_equal_area, the
  packed banks of every light type with both alias tables (power and
  uniform; light_powers weighs spot, distant and environment lights by
  their cone and the scene's radius), and build_light_bvh's nodes and
  bit trails: equal within 1e-6 relative (the bake and the resample are
  the same float64 numpy, so they are held bit for bit);
* per-lane functions: equal_area_square_to_sphere and its inverse, the
  1D and 2D distributions' samples and pdfs, sample_li per light type,
  env_radiance, bvh_sample_light and bvh_pmf: the same index, texel or
  flag on >= 99.9% of lanes, values within 1e-5 relative + 1e-6 there
  (1e-3 on every lane: the BVH importance divides differences of cosines,
  which amplifies the last bits near a cone's edge);
* the scene radius of instanced scenes is their real triangles' (the JAX
  package's is inf on padded BLAS, ROADMAP C), so their lights stay
  finite;
* the bridge carries a JAX scene's environment distribution, light BVH
  and light sampler into the port.
"""

from dataclasses import fields

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.lights import bvh_sampler as jbvh
from hikari_tpu.lights import sunsky as jsky
from hikari_tpu.lights import types as jlt
from hikari_tpu.sampling import distributions as jdist
from hikari_tpu.spectral.rgb2spec import srgb_table as j_table
from hikari_tpu_torch.lights import bvh_sampler as tbvh
from hikari_tpu_torch.lights import sunsky as tsky
from hikari_tpu_torch.lights import types as tlt
from hikari_tpu_torch.sampling import distributions as tdist
from hikari_tpu_torch.scene.bridge import scene_from_numpy
from hikari_tpu_torch.spectral.rgb2spec import srgb_table as t_table
from test_torch_scene import F32_RTOL, jax_scene_arrays

RTOL, ATOL, AGREE, WORST = 1e-5, 1e-6, 0.999, 1e-3
N = 4096
RADIUS = 6.0


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(t, j, what, agree=AGREE):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    np.testing.assert_allclose(t, j, rtol=WORST, atol=ATOL, err_msg=what)
    ok = np.abs(t - j) <= ATOL + RTOL * np.abs(j)
    ok = ok.reshape(len(ok), -1).all(-1) if ok.ndim > 1 else ok
    assert ok.mean() >= agree, f"{what}: {(~ok).sum()} lanes beyond {RTOL} relative"


def _env_image(rng, res=16):
    img = rng.rand(res, res, 3).astype(np.float32) * 0.5
    img[3, 11] = (40.0, 35.0, 30.0)  # a bright texel for the importance sampler
    img[9, 2] = 0.0
    return img


def _lights(m, env_img):
    """Every light type of module m (the JAX package's or the port's)."""
    return [m.PointLight(position=(0.0, 3.0, -0.5), intensity=(8.0, 8.0, 8.0)),
            m.SpotLight(position=(1.0, 2.5, 0.0), direction=(0.0, -1.0, 0.3),
                        intensity=(10.0, 9.0, 8.0), cone_angle_deg=40.0, falloff_start_deg=25.0),
            m.SpotLight(position=(-1.5, 2.0, 1.0), direction=(0.5, -1.0, 0.0),
                        intensity=(3.0, 5.0, 4.0), scale=2.0),
            m.DistantLight(direction=(-0.3, -1.0, 0.2), radiance=(1.0, 1.0, 1.1), scale=2.0),
            m.SunLight(direction=(0.2, -1.0, -0.4), radiance=(3.0, 2.9, 2.6)),
            m.AmbientLight(radiance=(0.05, 0.05, 0.06)),
            m.EnvironmentLight(image=env_img, scale=0.7)]


def _area(rng, na=6):
    p0 = rng.rand(na, 3).astype(np.float32) * 2 + np.float32([0, 3, 0])
    p1 = p0 + rng.rand(na, 3).astype(np.float32) * 0.5
    p2 = p0 + rng.rand(na, 3).astype(np.float32) * 0.5
    return p0, p1, p2, rng.rand(na, 3).astype(np.float32) * 10, rng.rand(na) > 0.5


@pytest.fixture(scope="module")
def banks():
    """{sampler: (JAX banks, port banks)} of every light type plus six area
    lights, and the numpy generator for the lanes."""
    rng = np.random.RandomState(3)
    env_img = _env_image(rng)
    area = _area(rng)
    out = {s: (jlt.pack_lights(_lights(jlt, env_img), area, scene_radius=RADIUS, sampler=s),
               tlt.pack_lights(_lights(tlt, env_img), area, scene_radius=RADIUS, sampler=s))
           for s in ("power", "uniform")}
    return out, rng


def _lanes(rng, n=N):
    p = (rng.rand(n, 3) * 6 - 3).astype(np.float32)
    ns = rng.randn(n, 3).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    ns[: n // 8] = 0.0  # medium lanes carry no normal
    lam = (360.0 + rng.rand(n, 4) * 470.0).astype(np.float32)
    return p, ns, lam


# --- host functions ------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(resolution=32), dict(resolution=24, up="y"),
                                dict(direction=(0.5, 0.45, 0.3), turbidity=4.3,
                                     ground_enabled=False, resolution=16)],
                         ids=["z up", "y up", "turbid, no ground"])
def test_sunsky_bake(kw):
    (je, js), (te, ts) = jsky.sunsky_environment(**kw), tsky.sunsky_environment(**kw)
    assert te.image.dtype == np.float32
    np.testing.assert_array_equal(te.image, je.image)
    assert te.scale == je.scale
    assert ts == tlt.SunLight(**{f.name: getattr(js, f.name) for f in fields(js)})


@pytest.mark.parametrize("up", ["y", "z"])
def test_equirect_to_equal_area(up):
    img = np.random.RandomState(5).rand(12, 24, 3).astype(np.float32)
    np.testing.assert_array_equal(tlt.equirect_to_equal_area(img, 16, up=up),
                                  jlt.equirect_to_equal_area(img, 16, up=up))


@pytest.mark.parametrize("sampler", ["power", "uniform"])
def test_packed_banks_and_alias_tables(banks, sampler):
    jb, tb = banks[0][sampler]
    for f in fields(tlt.LightBanks):
        got, want = getattr(tb, f.name), getattr(jb, f.name)
        if f.name == "env_dist":
            for g in fields(tdist.Distribution2D):
                np.testing.assert_allclose(getattr(got, g.name).numpy(),
                                           np.asarray(getattr(want, g.name)),
                                           rtol=F32_RTOL, err_msg=f"env_dist.{g.name}")
        elif isinstance(got, torch.Tensor) and got.dtype.is_floating_point:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL,
                                       atol=1e-7, err_msg=f.name)
        elif isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f.name)
        else:
            assert got == want, f.name
    assert tb.present_types == {tlt.POINT, tlt.SPOT, tlt.DISTANT, tlt.AREA, tlt.ENV}
    assert tb.has_ambient


def test_light_powers_every_type(banks):
    from hikari_tpu.lights.sampler import light_powers as j_powers
    from hikari_tpu_torch.lights.sampler import light_powers as t_powers

    types = np.array([0, 1, 1, 2, 2, 4, 4, 5])
    idx = np.array([0, 0, 1, 0, 1, 0, 1, 0])
    rng = np.random.RandomState(2)
    kw = dict(point_i=rng.rand(1, 3).astype(np.float32),
              spot_i=rng.rand(2, 3).astype(np.float32),
              spot_cos_total=np.float32([0.8, 0.5]), spot_cos_falloff=np.float32([0.9, 0.7]),
              dist_l=rng.rand(2, 3).astype(np.float32), area_le=rng.rand(2, 3).astype(np.float32),
              area_area=np.float32([0.3, 2.0]), area_two_sided=np.array([True, False]),
              env_mean_lum=0.4, env_scale=1.5, scene_radius=7.5)
    np.testing.assert_allclose(t_powers(types, idx, **kw), j_powers(types, idx, **kw),
                               rtol=1e-12)


def _grid_point_lights(m, k=4):
    return [m.PointLight(position=(i * 2.0, 2.0, j * 2.0),
                         intensity=((50.0 if (i, j) == (0, 0) else 1.0),) * 3)
            for i in range(k) for j in range(k)]


@pytest.fixture(scope="module")
def bvhs(banks):
    """(JAX, port) light BVHs over every light type (two infinite lights
    and an environment outside the tree), and over a grid of 16 points."""
    (by_sampler, _) = banks
    jb, tb = by_sampler["power"]
    jg = jlt.pack_lights(_grid_point_lights(jlt), scene_radius=10.0)
    tg = tlt.pack_lights(_grid_point_lights(tlt), scene_radius=10.0)
    return {"every type": (jbvh.build_light_bvh(jb), tbvh.build_light_bvh(tb)),
            "grid": (jbvh.build_light_bvh(jg), tbvh.build_light_bvh(tg))}


@pytest.mark.parametrize("which", ["every type", "grid"])
def test_build_light_bvh(bvhs, which):
    jt, tt = bvhs[which]
    for f in fields(jbvh.LightBVH):
        got, want = getattr(tt, f.name), getattr(jt, f.name)
        if isinstance(got, torch.Tensor) and got.dtype.is_floating_point:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL,
                                       atol=1e-7, err_msg=f.name)
        elif isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(got.numpy().dtype),
                                          err_msg=f.name)
        else:
            assert got == want, f.name
    assert tt.depth == int(np.asarray(jt.light_depth)[np.asarray(jt.light_in_bvh)].max())


# --- per-lane functions -------------------------------------------------------------


def test_equal_area_maps():
    rng = np.random.RandomState(7)
    uv = rng.rand(N, 2).astype(np.float32)
    uv[:8] = [[0.5, 0.5], [0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [0.25, 0.75],
              [0.5, 0.0], [0.5, 1.0], [1.0, 0.5]]  # poles, corners, seams
    d_t = tlt.equal_area_square_to_sphere(_t(uv))
    _close(d_t.numpy(), jlt.equal_area_square_to_sphere(jnp.asarray(uv)), "square_to_sphere")
    d = rng.randn(N, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:6] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0], [-0.6, 0.8, 0], [0, 0.6, -0.8]]
    _close(tlt.equal_area_sphere_to_square(_t(d)).numpy(),
           jlt.equal_area_sphere_to_square(jnp.asarray(d)), "sphere_to_square")
    np.testing.assert_allclose(tlt.equal_area_sphere_to_square(d_t).numpy()[8:], uv[8:],
                               atol=2e-5)  # the round trip
    np.testing.assert_allclose(
        tlt.equal_area_square_to_sphere_np(uv[:, 0].astype(np.float64), uv[:, 1]),
        d_t.numpy(), atol=1e-5)


def test_distribution_1d():
    rng = np.random.RandomState(8)
    func = rng.rand(37).astype(np.float32)
    func[[3, 4, 20]] = 0.0
    jd, td = jdist.make_distribution_1d(jnp.asarray(func)), tdist.make_distribution_1d(func)
    np.testing.assert_allclose(td.cdf.numpy(), np.asarray(jd.cdf), rtol=F32_RTOL)
    u = rng.rand(N).astype(np.float32)
    jx, jp, ji = jdist.sample_distribution_1d(jd, jnp.asarray(u))
    tx, tp, ti = tdist.sample_distribution_1d(td, _t(u))
    assert (ti.numpy() == np.asarray(ji)).mean() >= AGREE
    _close(tx.numpy(), jx, "x")
    _close(tp.numpy(), jp, "pdf")


@pytest.mark.parametrize("shape", [(16, 16), (32, 64), (1, 1)])
def test_distribution_2d(shape):
    rng = np.random.RandomState(9)
    func = rng.rand(*shape).astype(np.float32) ** 4
    if shape[0] > 1:
        func[2] = 0.0  # a row of zeros: the uniform conditional CDF
        func[5, : shape[1] // 2] = 0.0
    jd, td = jdist.make_distribution_2d(jnp.asarray(func)), tdist.make_distribution_2d(func)
    for g in fields(tdist.Distribution2D):
        np.testing.assert_allclose(getattr(td, g.name).numpy(),
                                   np.asarray(getattr(jd, g.name)), rtol=F32_RTOL,
                                   err_msg=g.name)
    u = rng.rand(N, 2).astype(np.float32)
    u[:4] = [[0.0, 0.0], [0.999999, 0.999999], [0.5, 0.0], [0.0, 0.5]]
    juv, jp = jdist.sample_distribution_2d(jd, jnp.asarray(u))
    tuv, tp = tdist.sample_distribution_2d(td, _t(u))
    h, w = shape
    texel = lambda uv: (np.clip((np.asarray(uv)[:, 0] * w).astype(int), 0, w - 1)
                        + w * np.clip((np.asarray(uv)[:, 1] * h).astype(int), 0, h - 1))
    assert (texel(tuv.numpy()) == texel(juv)).mean() >= AGREE
    _close(tuv.numpy(), juv, "uv")
    _close(tp.numpy(), jp, "pdf")
    _close(tdist.pdf_distribution_2d(td, tuv).numpy(),
           jdist.pdf_distribution_2d(jd, jnp.asarray(tuv.numpy())), "pdf_distribution_2d")


@pytest.mark.parametrize("ltype", ["point", "spot", "distant", "area", "env"])
def test_sample_li_per_type(banks, ltype):
    (by_sampler, rng) = banks
    jb, tb = by_sampler["power"]
    t_id = getattr(tlt, ltype.upper())
    flat = np.nonzero(tb.light_type.numpy()[: tb.n_flat] == t_id)[0]
    pick = flat[rng.randint(0, len(flat), N)]
    lt_, li = tb.light_type.numpy()[pick], tb.light_idx.numpy()[pick]
    p, _, lam = _lanes(rng)
    u2 = rng.rand(N, 2).astype(np.float32)
    js = jlt.sample_li(jb, j_table(), *(jnp.asarray(a) for a in (lt_, li, p, lam, u2)),
                       jnp.float32(RADIUS))
    ts = tlt.sample_li(tb, t_table(), *(_t(a) for a in (lt_, li, p, lam, u2)), RADIUS)
    for f in ("is_delta", "valid"):
        assert (getattr(ts, f).numpy() == np.asarray(getattr(js, f))).mean() >= AGREE, f
    for f in ("wi", "li", "pdf", "t_max"):
        _close(getattr(ts, f).numpy(), getattr(js, f), f"sample_li.{f}")
    assert bool(ts.valid.any())


def test_env_radiance(banks):
    (by_sampler, rng) = banks
    jb, tb = by_sampler["power"]
    _, _, lam = _lanes(rng)
    d = rng.randn(N, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jle, jpdf = jlt.env_radiance(jb, j_table(), jnp.asarray(d), jnp.asarray(lam))
    tle, tpdf = tlt.env_radiance(tb, t_table(), _t(d), _t(lam))
    _close(tle.numpy(), jle, "Le")
    _close(tpdf.numpy(), jpdf, "pdf")
    assert float(tpdf.max()) > 10.0 * float(tpdf.median())  # the bright texel's


@pytest.mark.parametrize("which", ["every type", "grid"])
def test_bvh_sample_light_and_pmf(bvhs, which):
    jt, tt = bvhs[which]
    rng = np.random.RandomState(11)
    p, ns, _ = _lanes(rng)
    u = rng.rand(N).astype(np.float32)
    jl, jp = jbvh.bvh_sample_light(jt, jnp.asarray(p), jnp.asarray(ns), jnp.asarray(u))
    tl, tp = tbvh.bvh_sample_light(tt, _t(p), _t(ns), _t(u))
    assert (tl.numpy() == np.asarray(jl)).mean() >= AGREE
    same = tl.numpy() == np.asarray(jl)
    _close(tp.numpy()[same], np.asarray(jp)[same], "bvh_sample_light pmf")
    # the replayed pmf of the chosen light, and of every light at each lane
    _close(tbvh.bvh_pmf(tt, _t(p), _t(ns), tl).numpy(), tp.numpy(), "replay = descent")
    q = rng.randint(0, tt.n_total, N).astype(np.int32)
    _close(tbvh.bvh_pmf(tt, _t(p), _t(ns), _t(q)).numpy(),
           jbvh.bvh_pmf(jt, jnp.asarray(p), jnp.asarray(ns), jnp.asarray(q)), "bvh_pmf")
    total = sum(tbvh.bvh_pmf(tt, _t(p), _t(ns), torch.full((N,), light)).numpy()
                for light in range(tt.n_total))
    sums_to_one = np.abs(total - 1.0) < 1e-4
    assert sums_to_one.mean() >= 0.99, f"{(~sums_to_one).sum()} lanes"


# --- scenes --------------------------------------------------------------------------


def test_instanced_scene_radius_is_the_real_one():
    from hikari_tpu_torch.scenes import default_scene, instanced_default_scene

    flat = default_scene().build(device="cpu")
    inst = instanced_default_scene().build(device="cpu")
    assert bool((inst.inst.hi > 1e37).any())  # the traversal's padded boxes stay
    assert inst.scene_radius == pytest.approx(flat.scene_radius, rel=1e-6)


def test_forest_lights_are_finite():
    from hikari_tpu_torch.scenes import forest_scene

    sc = forest_scene().build(device="cpu")
    assert np.isfinite(sc.scene_radius) and sc.scene_radius < 100.0
    assert sc.lights.has_env and sc.lights.present_types == {tlt.DISTANT, tlt.ENV}
    assert bool(torch.isfinite(sc.lights.pmf).all()) and bool((sc.lights.pmf > 0.0).all())
    assert float(sc.lights.pmf.sum()) == pytest.approx(1.0, rel=1e-6)


def _sky_scene(m, sky, sampler):
    """A floor, a sphere and an emissive quad under a spot and a baked sky:
    the JAX package's (m = its modules) or the port's."""
    s = m.Scene()
    s.set_light_sampler(sampler)
    s.add(m.make_quad((-2, 0, -2), (2, 0, -2), (2, 0, 2), (-2, 0, 2)), m.Matte(kd=(0.5,) * 3))
    s.add(m.make_sphere((0.0, 0.5, 0.0), 0.5, 6, 12), m.Matte(kd=(0.3, 0.4, 0.8)))
    s.add(m.make_quad((-0.5, 2.0, -0.5), (0.5, 2.0, -0.5), (0.5, 2.0, 0.5), (-0.5, 2.0, 0.5)),
          m.Emissive(le=(1.0, 1.0, 1.0), scale=5.0))
    s.add_light(m.SpotLight(position=(1.0, 2.0, -1.0), direction=(-0.5, -1.0, 0.5)))
    for light in sky:
        s.add_light(light)
    return s


@pytest.mark.parametrize("sampler", ["uniform", "bvh"])
def test_bridge_carries_lights(sampler):
    from types import SimpleNamespace

    import hikari_tpu as jhk
    import hikari_tpu_torch as thk
    from hikari_tpu.scene.scene import Scene as JScene

    jm = SimpleNamespace(Scene=JScene, make_quad=jhk.make_quad, make_sphere=jhk.make_sphere,
                         Matte=jhk.Matte, Emissive=jhk.Emissive, SpotLight=jlt.SpotLight)
    js = _sky_scene(jm, jsky.sunsky_environment(resolution=16), sampler).build()
    ts = _sky_scene(thk, tsky.sunsky_environment(resolution=16), sampler).build(device="cpu")
    bs = scene_from_numpy(jax_scene_arrays(js), "cpu")
    assert bs.light_sampler == ts.light_sampler == sampler
    assert bs.lights.has_env and bs.lights.present_types == ts.lights.present_types
    for g in fields(tdist.Distribution2D):
        np.testing.assert_allclose(getattr(bs.lights.env_dist, g.name).numpy(),
                                   getattr(ts.lights.env_dist, g.name).numpy(),
                                   rtol=F32_RTOL, err_msg=g.name)
    for k in ("pmf", "alias_q", "env_image", "dist_dir", "spot_cos_total"):
        np.testing.assert_allclose(getattr(bs.lights, k).numpy(),
                                   getattr(ts.lights, k).numpy(), rtol=F32_RTOL, err_msg=k)
    for f in fields(tbvh.LightBVH):
        got, want = getattr(bs.light_bvh, f.name), getattr(ts.light_bvh, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_RTOL,
                                       err_msg=f.name)
        else:
            assert got == want, f.name
