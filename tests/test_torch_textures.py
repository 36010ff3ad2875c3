"""Port parity: textures (ROADMAP A10) against the JAX package.

* the atlas: AtlasBuilder.build array for array and exactly, for odd,
  1 x N and N x 1 images and pyramids of mixed depth; atlas_lookup, _lod,
  textured_lookup, eval_rgb and eval_scalar on N = 4096 seeded lanes with
  uv in [-3, 3] (the wrap) within 1e-6 absolute;
* the mappings: UVMapping2D, TransformMapping3D and eval_noise3d within
  1e-6 (eval_noise3d's torch fields also against media/noise.py's numpy
  ones on the same points);
* the uv derivatives: _solve_duv, _uv_screen_derivatives and
  _uv_diff_derivatives within 1e-5 relative + 1e-7 on every lane of a
  well-conditioned uv map and on >= 99.9% of the values, and 1e-3
  relative on all (see _close_duv);
* packing: pack_materials with every textured field kind, tags, indices,
  *_tex columns and has_textures equal; the JAX package's build of the
  textured scene carried over by bridge.scene_from_numpy equals the port's
  own build array for array;
* the textured BSDFs and coats: the layered walks with textured albedo
  against the JAX package's at tests/test_torch_layered.py's tolerance
  (1e-4 relative on >= 99.5% of lanes), and the Matte / Glass / Conductor
  / DiffuseTransmission lobes with textured fields within 1e-5 relative on
  >= 99.9%;
* renders, against the JAX package's results stored in
  hikari_tpu_torch/data/probe_ref.json by tools/gen_probe_ref.py --renders
  (so that this file compiles no JAX render): the textured scene with
  coarse spheres at 32x32, depth 5, 4 samples (rays within 0.5%, mean RGB
  within 2%: the transport probe's tolerances), and the swatch scene's
  vertex-colour and textured-Mix bands (mean within three of the stored
  standard errors of a band mean, a Mix child being picked by a hash of
  the barycentrics' bits, which the two packages' traversals round apart);
* (slow) the full textured scene's 64x64 probe under 'none' and 'sorted'
  dispatch against the stored JAX probe.
"""

import json
from dataclasses import fields
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu
from hikari_tpu.core import transform as jtr
from hikari_tpu.integrators import volpath as jv
from hikari_tpu.materials import bsdf as jb
from hikari_tpu.materials import layered as jl
from hikari_tpu.materials import types as jmt
from hikari_tpu.spectral.rgb2spec import srgb_table as j_table
from hikari_tpu.textures import atlas as ja
from hikari_tpu.textures import mapping as jm
import hikari_tpu_torch as hk
from hikari_tpu_torch.core import transform as ttr
from hikari_tpu_torch.integrators import volpath as tv
from hikari_tpu_torch.materials import bsdf as tb
from hikari_tpu_torch.materials import layered as tl
from hikari_tpu_torch.materials import types as tmt
from hikari_tpu_torch.media import noise
from hikari_tpu_torch.scene.bridge import scene_from_numpy
from hikari_tpu_torch.scenes import (PROBE_REF, SWATCH_BANDS, check_transport, probe_config,
                                     scene_camera, swatch_scene, textured_scene,
                                     transport_probe)
from hikari_tpu_torch.spectral.rgb2spec import srgb_table as t_table
from hikari_tpu_torch.textures import atlas as ta
from hikari_tpu_torch.textures import mapping as tm
from test_torch_scene import jax_scene_arrays

N = 4096
COARSE = (8, 16)
RTOL, ATOL, SHARE = 1e-5, 1e-6, 0.999
WALK_RTOL, WALK_SHARE = 1e-4, 0.995


def _images(rng):
    """Odd, 1 x N, N x 1 and square images: pyramids of 5, 5, 7 and 4 levels."""
    return [rng.rand(13, 7, 3).astype(np.float32), rng.rand(1, 9, 3).astype(np.float32),
            rng.rand(33, 1).astype(np.float32), rng.rand(8, 8, 3).astype(np.float32)]


@pytest.fixture(scope="module")
def atlases():
    rng = np.random.RandomState(0)
    jb_, tb_ = ja.AtlasBuilder(), ta.AtlasBuilder()
    for k, img in enumerate(_images(rng)):
        kw = dict(uv_scale=(1.0 + k, 2.0 - 0.5 * k), uv_offset=(0.1 * k, -0.2 * k))
        assert jb_.add(ja.ImageTexture(img, **kw)) == tb_.add(ta.ImageTexture(img, **kw)) == k
    return jb_.build(), tb_.build()


def _lanes(seed=1, n=N):
    rng = np.random.RandomState(seed)
    return dict(tex=rng.randint(-2, 4, n).astype(np.int32),
                uv=rng.uniform(-3, 3, (n, 2)).astype(np.float32),
                vcol=rng.rand(n, 3).astype(np.float32),
                dx=(rng.randn(n, 2) * 10.0 ** rng.uniform(-4, -0.5, (n, 1))).astype(np.float32),
                dy=(rng.randn(n, 2) * 10.0 ** rng.uniform(-4, -0.5, (n, 1))).astype(np.float32),
                const=rng.rand(n, 3).astype(np.float32))


def _ctx(lanes, deriv=True):
    jc = ja.TexCtx(uv=jnp.asarray(lanes["uv"]), vcolor=jnp.asarray(lanes["vcol"]),
                   duvdx=jnp.asarray(lanes["dx"]) if deriv else None,
                   duvdy=jnp.asarray(lanes["dy"]) if deriv else None)
    tc = ta.TexCtx(uv=torch.from_numpy(lanes["uv"]), vcolor=torch.from_numpy(lanes["vcol"]),
                   duvdx=torch.from_numpy(lanes["dx"]) if deriv else None,
                   duvdy=torch.from_numpy(lanes["dy"]) if deriv else None)
    return jc, tc


def _close(got, want, rtol=0.0, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# --- the atlas -------------------------------------------------------------------------


def test_atlas_builder_equals_jax(atlases):
    jat, tat = atlases
    assert tat.offset.shape[1] == 7
    for f in fields(ta.TextureAtlas):
        got, want = getattr(tat, f.name).numpy(), np.asarray(getattr(jat, f.name))
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    empty_j, empty_t = ja.AtlasBuilder().build(), ta.AtlasBuilder().build()
    for f in fields(ta.TextureAtlas):
        np.testing.assert_array_equal(getattr(empty_t, f.name).numpy(),
                                      np.asarray(getattr(empty_j, f.name)))


def test_atlas_lookup_and_lod(atlases):
    jat, tat = atlases
    lanes = _lanes()
    img_tex = np.abs(lanes["tex"]) % 4
    level = np.random.RandomState(2).randint(0, 6, N).astype(np.int32)
    _close(ta.atlas_lookup(tat, torch.from_numpy(img_tex), torch.from_numpy(lanes["uv"]),
                           torch.from_numpy(level)),
           ja.atlas_lookup(jat, jnp.asarray(img_tex), jnp.asarray(lanes["uv"]),
                           jnp.asarray(level)))
    _close(ta.atlas_lookup(tat, torch.from_numpy(img_tex), torch.from_numpy(lanes["uv"])),
           ja.atlas_lookup(jat, jnp.asarray(img_tex), jnp.asarray(lanes["uv"])))
    jc, tc = _ctx(lanes)
    _close(ta._lod(tat, torch.from_numpy(img_tex), tc), ja._lod(jat, jnp.asarray(img_tex), jc),
           atol=1e-5)
    _close(ta.textured_lookup(tat, torch.from_numpy(img_tex), tc),
           ja.textured_lookup(jat, jnp.asarray(img_tex), jc))


def test_wrap_is_a_floor_modulo(atlases):
    """uv < 0 and uv > 1 read the texel that uv mod 1 reads."""
    _, tat = atlases
    uv = torch.tensor([[0.3, 0.6], [-0.7, -0.4], [2.3, 1.6], [-2.7, 3.6]])
    out = ta.atlas_lookup(tat, torch.zeros(4, dtype=torch.int32), uv)
    torch.testing.assert_close(out, out[:1].expand(4, 3), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("deriv", [False, True], ids=["level0", "trilinear"])
def test_eval_rgb_and_scalar(atlases, deriv):
    jat, tat = atlases
    lanes = _lanes(3)
    jc, tc = _ctx(lanes, deriv)
    tex_j, tex_t = jnp.asarray(lanes["tex"]), torch.from_numpy(lanes["tex"])
    _close(ta.eval_rgb(tat, tex_t, torch.from_numpy(lanes["const"]), tc),
           ja.eval_rgb(jat, tex_j, jnp.asarray(lanes["const"]), jc))
    _close(ta.eval_scalar(tat, tex_t, torch.from_numpy(lanes["const"][:, 0]), tc),
           ja.eval_scalar(jat, tex_j, jnp.asarray(lanes["const"][:, 0]), jc))


# --- mappings ------------------------------------------------------------------------------


def test_mappings_and_noise():
    rng = np.random.RandomState(4)
    uv, dx, dy = (rng.randn(N, 2).astype(np.float32) for _ in range(3))
    jmap, tmap = jm.UVMapping2D(2.0, 0.5, 0.25, -1.0), tm.UVMapping2D(2.0, 0.5, 0.25, -1.0)
    assert tmap.as_texture_kwargs() == jmap.as_texture_kwargs()
    for got, want in zip(tmap.map(*(torch.from_numpy(x) for x in (uv, dx, dy))),
                         jmap.map(*(jnp.asarray(x) for x in (uv, dx, dy)))):
        _close(got, want)
    p, dp = rng.uniform(-2, 2, (N, 3)).astype(np.float32), rng.randn(N, 3).astype(np.float32)
    jt = jtr.translate((0.3, -1.0, 2.0)).compose(jtr.scale(1.7))
    tt = ttr.translate((0.3, -1.0, 2.0)).compose(ttr.scale(1.7))
    j3, t3 = jm.TransformMapping3D(jt), tm.TransformMapping3D(tt)
    for got, want in zip(t3.map(torch.from_numpy(p), torch.from_numpy(dp), None),
                         j3.map(jnp.asarray(p), jnp.asarray(dp), None)):
        if want is None:
            assert got is None
        else:
            _close(got, want, atol=1e-5)
    pt = t3.map(torch.from_numpy(p))[0].double().numpy().T
    for kind, host in (("perlin", noise.perlin3d), ("worley", noise.worley3d),
                       ("fbm", noise.fbm3d)):
        got = tm.eval_noise3d(t3, torch.from_numpy(p), kind)
        _close(got, jm.eval_noise3d(j3, jnp.asarray(p), kind))
        # the torch fields are media/noise.py's host numpy ones
        np.testing.assert_allclose(got.numpy(), host(*pt).astype(np.float32), rtol=1e-7,
                                   atol=1e-7)
    with pytest.raises(ValueError):
        tm.eval_noise3d(t3, torch.from_numpy(p), "cells")


# --- uv derivatives --------------------------------------------------------------------------


def _triangles(seed=5, n=N):
    rng = np.random.RandomState(seed)
    p0 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    p1 = (p0 + rng.randn(n, 3) * 0.5).astype(np.float32)
    p2 = (p0 + rng.randn(n, 3) * 0.5).astype(np.float32)
    uvs = [rng.rand(n, 2).astype(np.float32) for _ in range(3)]
    uvs[2][:16] = uvs[0][:16]  # degenerate uv: zero derivatives
    b = rng.dirichlet((1, 1, 1), n).astype(np.float32)
    p = (b[:, :1] * p0 + b[:, 1:2] * p1 + b[:, 2:] * p2).astype(np.float32)
    return [p, p0, p1, p2, *uvs]


# the condition number of a triangle's (dp/du, dp/dv) below which its uv
# derivatives hold at 1e-5 relative + 1e-7 (about 4% of _triangles' lanes
# lie above it)
COND_MAX = 100.0


def _uv_condition(p0, p1, p2, uv0, uv1, uv2):
    """Per lane, the largest over the smallest singular value (float64) of
    the triangle's 3 x 2 (dp/du, dp/dv); inf where its uv map is
    degenerate."""
    dp1, dp2 = (p1 - p0).astype(np.float64), (p2 - p0).astype(np.float64)
    d1, d2 = (uv1 - uv0).astype(np.float64), (uv2 - uv0).astype(np.float64)
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        dpdu = (d2[:, 1:2] * dp1 - d1[:, 1:2] * dp2) / det[:, None]
        dpdv = (-d2[:, 0:1] * dp1 + d1[:, 0:1] * dp2) / det[:, None]
    jac = np.nan_to_num(np.stack([dpdu, dpdv], -1), nan=0.0, posinf=0.0, neginf=0.0)
    s = np.linalg.svd(jac, compute_uv=False)
    with np.errstate(divide="ignore", invalid="ignore"):
        cond = s[:, 0] / s[:, 1]
    return np.where((det != 0) & np.isfinite(cond), cond, np.inf)


def _close_duv(got, want, tri):
    """Within 1e-5 relative + 1e-7 on every lane of a triangle whose
    (dp/du, dp/dv) has a condition number below COND_MAX and on >= 99.9% of
    all values; within 1e-3 relative on all. The least-squares solve
    multiplies the inputs' last-bit differences (the two packages sum the
    camera transform's dot products in another order) by that condition
    number, so the values beyond 1e-5 lie on the few ill-conditioned
    triangles."""
    tight = _uv_condition(*tri) < COND_MAX
    assert tight.mean() > 0.9
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(g[tight], w[tight], rtol=1e-5, atol=1e-7)
        ok = np.abs(g - w) <= 1e-7 + 1e-5 * np.abs(w)
        assert ok.mean() >= SHARE, f"{(~ok).sum()} of {ok.size} values beyond 1e-5"


def test_solve_duv_and_screen_derivatives():
    p, *tri = _triangles()
    rng = np.random.RandomState(6)
    dpdx, dpdy = (rng.randn(N, 3).astype(np.float32) * 1e-2 for _ in range(2))
    args = [*tri, dpdx, dpdy]
    _close_duv(tv._solve_duv(*(torch.from_numpy(x) for x in args)),
               jv._solve_duv(*(jnp.asarray(x) for x in args)), tri)
    jcam = hikari_tpu.make_perspective_camera((0.5, 1.0, -6.0), (0.0, 0.0, 0.0), (96, 64))
    tcam = hk.make_perspective_camera((0.5, 1.0, -6.0), (0.0, 0.0, 0.0), (96, 64))
    _close_duv(tv._uv_screen_derivatives(tcam, *(torch.from_numpy(x) for x in (p, *tri))),
               jv._uv_screen_derivatives(jcam, *(jnp.asarray(x) for x in (p, *tri))), tri)


def test_ray_differential_derivatives():
    p, *tri = _triangles(7)
    rng = np.random.RandomState(8)
    ng = np.cross(tri[1] - tri[0], tri[2] - tri[0])
    ng = (ng / np.linalg.norm(ng, axis=-1, keepdims=True)).astype(np.float32)
    diff = {k: rng.randn(N, 3).astype(np.float32) for k in ("rx_o", "rx_d", "ry_o", "ry_d")}
    jd = SimpleNamespace(**{k: jnp.asarray(v) for k, v in diff.items()})
    td = SimpleNamespace(**{k: torch.from_numpy(v) for k, v in diff.items()})
    _close_duv(tv._uv_diff_derivatives(td, *(torch.from_numpy(x) for x in (p, ng, *tri))),
               jv._uv_diff_derivatives(jd, *(jnp.asarray(x) for x in (p, ng, *tri))), tri)


# --- packing and the bridge ---------------------------------------------------------------


def _textured_list(m, img, mask):
    """Every field the JAX package textures, as an image or a vertex
    colour, beside constants; the images in a fixed order."""
    it = m.ImageTexture
    return [m.Matte(kd=it(img)), m.Matte(kd=m.VertexColorTexture()), m.Mirror(kr=it(img)),
            m.Glass(kr=it(img), kt=m.VertexColorTexture(), u_roughness=it(mask),
                    v_roughness=0.3),
            m.Conductor(roughness=it(mask)), m.Emissive(le=it(img), scale=2.0),
            m.DiffuseTransmission(reflectance=it(img), transmittance=it(img)),
            m.CoatedDiffuse(reflectance=it(img)),
            m.CoatedDiffuseTransmission(reflectance=m.VertexColorTexture(),
                                        transmittance=it(img)),
            m.Mix(m1=m.Matte(), m2=m.Mirror(), amount=it(mask)),
            m.Matte(kd=(0.2, 0.3, 0.4))]


def test_pack_materials_textured_fields():
    rng = np.random.RandomState(9)
    img, mask = rng.rand(6, 5, 3).astype(np.float32), rng.rand(4, 4).astype(np.float32)
    jab, tab = ja.AtlasBuilder(), ta.AtlasBuilder()
    jbanks, jtags, jidx, jpres = jmt.pack_materials(_textured_list(hikari_tpu, img, mask), jab)
    tbanks, ttags, tidx, tpres = tmt.pack_materials(_textured_list(hk, img, mask), tab)
    np.testing.assert_array_equal(ttags, jtags)
    np.testing.assert_array_equal(tidx, jidx)
    assert tpres == jpres and tbanks.has_textures and jbanks.has_textures
    assert len(tab.images) == len(jab.images) == 11
    for f in fields(tmt.MaterialBanks):
        if f.name.endswith("_tex") or f.name in ("matte_kd", "glass_ax", "glass_ay",
                                                 "cond_ax", "mix_amount", "emissive_le"):
            np.testing.assert_array_equal(getattr(tbanks, f.name).numpy(),
                                          np.asarray(getattr(jbanks, f.name)), err_msg=f.name)
    plain = tmt.pack_materials([tmt.Matte(), tmt.Gold()])[0]
    assert not plain.has_textures and int(plain.matte_kd_tex[0]) == ta.CONST_TEX


@pytest.fixture(scope="module")
def coarse():
    """(JAX build, port build) of the textured scene with coarse spheres."""
    return (textured_scene(COARSE, api=hikari_tpu).build(),
            textured_scene(COARSE).build(device="cpu"))


def test_bridge_carries_the_textured_scene(coarse):
    js, ts = coarse
    bs = scene_from_numpy(jax_scene_arrays(js), "cpu")
    for name in ("face_rows", "tex_rows", "alpha_const", "alpha_tex", "tri_p", "mat_type",
                 "mat_idx"):
        np.testing.assert_array_equal(getattr(bs, name).numpy(), getattr(ts, name).numpy(),
                                      err_msg=name)
    for f in fields(ta.TextureAtlas):
        np.testing.assert_array_equal(getattr(bs.atlas, f.name).numpy(),
                                      getattr(ts.atlas, f.name).numpy(), err_msg=f.name)
    for f in fields(tmt.MaterialBanks):
        if f.name.endswith("_tex"):
            np.testing.assert_array_equal(getattr(bs.materials, f.name).numpy(),
                                          getattr(ts.materials, f.name).numpy())
    assert bs.materials.has_textures and ts.materials.has_textures
    assert bs.has_alpha and ts.has_alpha and js.has_alpha
    assert bs.present_materials == ts.present_materials


# --- textured BSDFs ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def shading():
    """Banks of textured rows of every lobe, both atlases, and seeded lanes
    (a TexCtx with derivatives) for the BSDF comparisons."""
    rng = np.random.RandomState(10)
    img = rng.rand(16, 16, 3).astype(np.float32)
    mask = rng.rand(8, 8).astype(np.float32)

    def mats(m):
        it = m.ImageTexture
        return [m.Matte(kd=it(img)), m.Glass(kt=it(img), u_roughness=it(mask)),
                m.Conductor(roughness=it(mask)),
                m.DiffuseTransmission(reflectance=it(img), transmittance=m.VertexColorTexture()),
                m.CoatedDiffuse(reflectance=it(img), roughness=0.2),
                m.CoatedDiffuseTransmission(reflectance=it(img), transmittance=it(img)),
                m.Emissive(le=it(img), scale=3.0)]

    jab, tab = ja.AtlasBuilder(), ta.AtlasBuilder()
    jbanks = jmt.pack_materials(mats(hikari_tpu), jab)[0]
    tbanks = tmt.pack_materials(mats(hk), tab)[0]
    lanes = _lanes(11)
    lanes["dx"] *= 0.05
    lanes["dy"] *= 0.05
    jc, tc = _ctx(lanes)

    def unit(n):
        v = rng.randn(n, 3).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    data = dict(wo=unit(N), wi=unit(N), lam=(360.0 + rng.rand(N, 4) * 470.0).astype(np.float32),
                u2=rng.rand(N, 2).astype(np.float32), uc=rng.rand(N).astype(np.float32),
                idx=np.zeros(N, np.int32))
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    td = {k: torch.from_numpy(v) for k, v in data.items()}
    return (jbanks, (jab.build(), jc), jd), (tbanks, (tab.build(), tc, t_table()), td)


def _cmp(got, want, what, rtol=RTOL, share=SHARE):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), what
    ok = (np.abs(got - want) <= ATOL + rtol * np.abs(want)).reshape(len(got), -1).all(-1)
    assert ok.mean() >= share, f"{what}: {(~ok).sum()} lanes beyond {rtol}"


def _cmp_sample(ts, js, what, rtol=RTOL, share=SHARE):
    flags = np.ones(N, bool)
    for f in ("specular", "transmission", "valid"):
        eq = getattr(ts, f).numpy() == np.asarray(getattr(js, f))
        assert eq.mean() >= share, f"{what}.{f}"
        flags &= eq
    for f in ("wi", "f", "pdf"):
        _cmp(getattr(ts, f).numpy()[flags], np.asarray(getattr(js, f))[flags], f"{what}.{f}",
             rtol, share)


LOBES = {"matte": (jmt.MATTE, "sample_matte", "eval_matte"),
         "glass": (jmt.GLASS, "sample_glass", "eval_glass"),
         "conductor": (jmt.CONDUCTOR, "sample_conductor", "eval_conductor"),
         "diffuse_transmission": (jmt.DIFFUSE_TRANSMISSION, "sample_diffuse_transmission",
                                  "eval_diffuse_transmission")}


@pytest.mark.parametrize("lobe", list(LOBES))
def test_textured_lobes(shading, lobe):
    (jbanks, jtex, jd), (tbanks, ttex, td) = shading
    _, sample, evaluate = LOBES[lobe]
    table = j_table()
    js = getattr(jb, sample)(jbanks, jd["idx"], table, jd["wo"], jd["lam"], jd["u2"], jd["uc"],
                             tex=jtex)
    ts = getattr(tb, sample)(tbanks, td["idx"], td["wo"], td["lam"], td["u2"], td["uc"],
                             tex=ttex)
    _cmp_sample(ts, js, sample)
    je = getattr(jb, evaluate)(jbanks, jd["idx"], table, jd["wo"], jd["wi"], jd["lam"],
                               tex=jtex)
    te = getattr(tb, evaluate)(tbanks, td["idx"], td["wo"], td["wi"], td["lam"], tex=ttex)
    for k in range(2):
        _cmp(te[k].numpy(), je[k], f"{evaluate}[{k}]")


def test_textured_emission(shading):
    (jbanks, jtex, jd), (tbanks, ttex, td) = shading
    cos = jd["wo"][:, 2]
    je = jb.emitted_radiance(jbanks, jd["idx"], j_table(), jd["lam"], cos, jtex)
    te = tb.emitted_radiance(tbanks, td["idx"], td["lam"], td["wo"][:, 2], tex=ttex)
    _cmp(te.numpy(), je, "emitted_radiance")
    assert float(te.amax()) > 0.0


@pytest.mark.parametrize("name", ["coated_diffuse", "coated_diffuse_transmission"])
def test_textured_coats(shading, name):
    (jbanks, jtex, jd), (tbanks, ttex, td) = shading
    table = j_table()
    js = getattr(jl, f"sample_{name}")(jbanks, jd["idx"], table, jd["wo"], jd["lam"], jd["u2"],
                                       jd["uc"], jtex)
    ts = getattr(tl, f"sample_{name}")(tbanks, td["idx"], td["wo"], td["lam"], td["u2"],
                                       td["uc"], tex=ttex)
    _cmp_sample(ts, js, f"sample_{name}", WALK_RTOL, WALK_SHARE)
    je = getattr(jl, f"eval_{name}")(jbanks, jd["idx"], table, jd["wo"], jd["wi"], jd["lam"],
                                     jd["u2"], jd["uc"], jtex)
    te = getattr(tl, f"eval_{name}")(tbanks, td["idx"], td["wo"], td["wi"], td["lam"], td["u2"],
                                     td["uc"], tex=ttex)
    for k in range(2):
        _cmp(te[k].numpy(), je[k], f"eval_{name}[{k}]", WALK_RTOL, WALK_SHARE)


# --- renders ---------------------------------------------------------------------------------


def _stored(key):
    """The JAX package's result `key`, stored by tools/gen_probe_ref.py
    --renders."""
    return json.loads(PROBE_REF.read_text())["renders"][key]


@pytest.mark.parametrize("mode", ["none", "sorted"])
def test_textured_scene_against_jax(coarse, mode):
    _, ts = coarse
    ref = _stored("textured coarse")
    rays, mean_rgb = transport_probe(ts, "textured", res=ref["res"], depth=ref["depth"],
                                     spp=ref["spp"], material_coherence=mode)
    assert abs(rays - ref["rays_traced"]) <= 0.005 * ref["rays_traced"], (rays, ref)
    assert abs(mean_rgb - ref["mean_rgb"]) <= 0.02 * ref["mean_rgb"], (mean_rgb, ref)


def swatch_bands(sc):
    """Mean RGB of each SWATCH_BANDS band of the swatch probe, port side."""
    res, depth, spp = probe_config("swatch")
    lanes = torch.arange(res * res)
    si = torch.arange(spp).repeat_interleave(res * res)
    rgb, _, _ = hk.render_lanes(hk.VolPath(max_depth=depth, samples_per_pixel=spp), sc,
                                scene_camera("swatch", res), hk.make_filter(), si,
                                (lanes % res).repeat(spp), (lanes // res).repeat(spp))
    px = rgb.numpy().reshape(spp, res, res, 3).mean(-1)
    return [float(b.mean()) for b in np.split(px, len(SWATCH_BANDS), axis=2)]


@pytest.fixture(scope="module")
def swatch():
    return swatch_bands(swatch_scene().build(device="cpu")), _stored("swatch")


@pytest.mark.parametrize("band", [0, 1], ids=SWATCH_BANDS[:2])
def test_swatch_textured_bands(swatch, band):
    got, ref = swatch
    assert abs(got[band] - ref["band_mean"][band]) <= 3.0 * ref["band_sem"][band] + 1e-6, (
        got[band], ref["band_mean"][band], ref["band_sem"][band])
    assert got[band] > 0.0


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["none", "sorted"])
def test_textured_probe_against_jax(mode):
    ok, msg = check_transport(textured_scene().build(device="cpu"), "textured",
                              material_coherence=mode)
    assert ok, msg
