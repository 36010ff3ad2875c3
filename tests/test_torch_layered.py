"""Port parity: the materials of the layered slice. ThinDielectric,
DiffuseTransmission, the bare dielectric interface, the layered walk of
CoatedDiffuse / CoatedConductor / CoatedDiffuseTransmission and its PCG,
and the packing of every material class (Mix included).

The JAX package runs eager on the CPU; both packages pack the same host
materials, and N = 4096 lanes of wo, wi, lam, u2 and uc come from
np.random.RandomState, as in tests/test_torch_materials_lights.py.

Tolerances:

* the PCG's states and words are equal as uint32 on every lane, and its
  uniforms bit for bit;
* the interface, ThinDielectric and DiffuseTransmission, smooth and rough:
  values within 1e-5 relative (1e-6 absolute) on >= 99.9% of lanes and
  within 1e-4 on every lane, flags equal on >= 99.9% (the tolerance of
  tests/test_torch_materials_lights.py);
* the three coated materials: every lane finite, flags equal on >= 99.5%
  of lanes, and wi, f and pdf within 1e-4 relative (1e-6 absolute) on
  >= 99.5% of the lanes whose flags agree. A walk compares a free flight
  with the slab's depth and a uniform with a Fresnel term about 40 times;
  XLA and torch round log1p, exp, sqrt and cos / sin differently, so a
  lane whose comparison sits on its edge takes the other branch and then
  walks on differently. Measured on the CPU on these inputs: the sample
  flags of every coated material agree on all 4096 lanes, the sampled
  values within 1e-4 on all lanes but one (CoatedDiffuse), and the
  evaluations within 1e-5 on every lane.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.materials import bsdf as jb
from hikari_tpu.materials import layered as jl
from hikari_tpu.materials import types as jmt
from hikari_tpu.spectral.rgb2spec import srgb_table
from hikari_tpu_torch.materials import bsdf as tb
from hikari_tpu_torch.materials import layered as tl
from hikari_tpu_torch.materials import types as tmt

RTOL, ATOL, FLAGS, WORST = 1e-5, 1e-6, 0.999, 1e-4
WALK_RTOL, WALK_SHARE = 1e-4, 0.995
N = 4096


def _materials(m):
    """Two rows of each new type: one smooth, one rough, with and without a
    scattering slab."""
    return [m.ThinDielectric(), m.ThinDielectric(kr=(0.9, 0.8, 0.7), eta=1.33),
            m.DiffuseTransmission(),
            m.DiffuseTransmission(reflectance=(0.6, 0.3, 0.1), transmittance=(0.1, 0.5, 0.2)),
            m.CoatedDiffuse(),
            m.Plastic(kd=(0.2, 0.6, 0.3), roughness=0.2, thickness=0.3,
                      albedo=(0.6, 0.5, 0.4), g=0.4),
            m.CoatedConductor(),
            m.CoatedConductor(interface_roughness=0.15, metal=None, conductor_roughness=0.0,
                              thickness=0.2, albedo=(0.3, 0.3, 0.5), g=-0.2),
            m.CoatedDiffuseTransmission(),
            m.CoatedDiffuseTransmission(reflectance=(0.7, 0.4, 0.2),
                                        transmittance=(0.2, 0.3, 0.6), roughness=0.25,
                                        thickness=0.2, albedo=(0.5, 0.5, 0.5), g=0.0)]


@pytest.fixture(scope="module")
def mats():
    jbanks, jtags, jidx, _ = jmt.pack_materials(_materials(jmt))
    tbanks, ttags, tidx, _ = tmt.pack_materials(_materials(tmt))
    np.testing.assert_array_equal(jtags, ttags)
    np.testing.assert_array_equal(jidx, tidx)
    rng = np.random.RandomState(0)

    def unit(n):
        v = rng.randn(n, 3).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    data = dict(wo=unit(N), wi=unit(N),
                lam=(360.0 + rng.rand(N, 4) * 470.0).astype(np.float32),
                u2=rng.rand(N, 2).astype(np.float32), uc=rng.rand(N).astype(np.float32),
                pick=rng.randint(0, 2, N).astype(np.int32))
    return jbanks, tbanks, data


def _both(data, *keys):
    return ([jnp.asarray(data[k]) for k in keys],
            [torch.from_numpy(np.ascontiguousarray(data[k])) for k in keys])


def _close(t, j, what, rtol=RTOL, share=FLAGS, worst=WORST):
    t, j = np.asarray(t), np.asarray(j)
    if worst is not None:
        np.testing.assert_allclose(t, j, rtol=worst, atol=ATOL, err_msg=what)
    ok = np.abs(t - j) <= ATOL + rtol * np.abs(j)
    ok = ok.reshape(len(ok), -1).all(-1)
    assert ok.mean() >= share, f"{what}: {(~ok).sum()} lanes beyond {rtol} relative"


def _compare_sample(ts, js, what, rtol=RTOL, share=FLAGS, worst=WORST):
    flags_ok = np.ones(N, bool)
    for f in ("specular", "transmission", "valid"):
        eq = getattr(ts, f).numpy() == np.asarray(getattr(js, f))
        assert eq.mean() >= share, f"{what}.{f}: {(~eq).sum()} lanes differ"
        flags_ok &= eq
    for f in ("wi", "f", "pdf", "eta_scale"):
        got = getattr(ts, f).numpy()
        assert np.isfinite(got).all(), f"{what}.{f} not finite"
        _close(got[flags_ok], np.asarray(getattr(js, f))[flags_ok], f"{what}.{f}", rtol,
               share, worst)


def test_pcg_words_equal(mats):
    """_rng_init, then ten _rng_next: states and uniforms bit for bit."""
    _, _, data = mats
    (ju2, juc), (tu2, tuc) = _both(data, "u2", "uc")
    js, ts = jl._rng_init(ju2, juc), tl._rng_init(tu2, tuc)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    for _ in range(10):
        js, ju = jl._rng_next(js)
        ts, tu = tl._rng_next(ts)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
        np.testing.assert_array_equal(tu.numpy().view(np.uint32), np.asarray(ju).view(np.uint32))
    js, j2 = jl._rng_next2(js)
    ts, t2 = tl._rng_next2(ts)
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))


@pytest.mark.parametrize("rough", [False, True], ids=["smooth", "rough"])
def test_dielectric_interface(mats, rough):
    _, _, data = mats
    (jwo, jwi, ju2, juc), (two, twi, tu2, tuc) = _both(data, "wo", "wi", "u2", "uc")
    eta = np.where(data["pick"] == 0, 1.5, 1.33).astype(np.float32)
    alpha = np.full(N, 0.3 if rough else 0.0, np.float32)
    (je, ja), (te, ta) = _both(dict(eta=eta, alpha=alpha), "eta", "alpha")
    js = jb.dielectric_interface_sample(jwo, je, ja, ja, ju2, juc)
    ts = tb.dielectric_interface_sample(two, te, ta, ta, tu2, tuc)
    flags_ok = np.ones(N, bool)
    for f in ("is_trans", "specular", "valid"):
        eq = ts[f].numpy() == np.asarray(js[f])
        assert eq.mean() >= FLAGS, f
        flags_ok &= eq
    for f in ("wi", "weight", "pdf"):
        _close(ts[f].numpy()[flags_ok], np.asarray(js[f])[flags_ok], f"sample.{f}")
    jf = jb.dielectric_interface_f(jwo, jwi, je, ja, ja)
    tf = tb.dielectric_interface_f(two, twi, te, ta, ta)
    for k, what in enumerate(("f", "pdf")):
        _close(tf[k].numpy(), jf[k], f"f.{what}")
    if not rough:
        assert not tf[0].any()  # a smooth interface is a delta


@pytest.mark.parametrize("tag", [jmt.THIN_DIELECTRIC, jmt.DIFFUSE_TRANSMISSION])
def test_thin_and_diffuse_transmission(mats, tag):
    jbanks, tbanks, data = mats
    (ji, jwo, jlam, ju2, juc, jwi), (ti, two, tlam, tu2, tuc, twi) = _both(
        data, "pick", "wo", "lam", "u2", "uc", "wi")
    table = srgb_table()
    if tag == jmt.THIN_DIELECTRIC:
        js = jb.sample_thin_dielectric(jbanks, ji, table, jwo, jlam, ju2, juc)
        ts = tb.sample_thin_dielectric(tbanks, ti, two, tlam, tu2, tuc)
    else:
        js = jb.sample_diffuse_transmission(jbanks, ji, table, jwo, jlam, ju2, juc)
        ts = tb.sample_diffuse_transmission(tbanks, ti, two, tlam, tu2, tuc)
        je = jb.eval_diffuse_transmission(jbanks, ji, table, jwo, jwi, jlam)
        te = tb.eval_diffuse_transmission(tbanks, ti, two, twi, tlam)
        _close(te[0].numpy(), je[0], "eval.f")
        _close(te[1].numpy(), je[1], "eval.pdf")
    _compare_sample(ts, js, f"sample[{tag}]")
    assert ts.transmission.any() == (tag == jmt.DIFFUSE_TRANSMISSION)


LAYERED = {
    jmt.COATED_DIFFUSE: ("coated_diffuse", "CoatedDiffuse"),
    jmt.COATED_CONDUCTOR: ("coated_conductor", "CoatedConductor"),
    jmt.COATED_DIFFUSE_TRANSMISSION: ("coated_diffuse_transmission",
                                      "CoatedDiffuseTransmission"),
}


@pytest.mark.parametrize("tag", list(LAYERED), ids=[v[1] for v in LAYERED.values()])
def test_layered_sample_and_eval(mats, tag):
    jbanks, tbanks, data = mats
    name = LAYERED[tag][0]
    (ji, jwo, jlam, ju2, juc, jwi), (ti, two, tlam, tu2, tuc, twi) = _both(
        data, "pick", "wo", "lam", "u2", "uc", "wi")
    table = srgb_table()
    js = getattr(jl, f"sample_{name}")(jbanks, ji, table, jwo, jlam, ju2, juc)
    ts = getattr(tl, f"sample_{name}")(tbanks, ti, two, tlam, tu2, tuc)
    _compare_sample(ts, js, f"sample_{name}", WALK_RTOL, WALK_SHARE, None)
    assert ts.valid.float().mean() > 0.3
    if tag == jmt.COATED_DIFFUSE_TRANSMISSION:
        assert (ts.transmission & ts.valid).any()
    je = getattr(jl, f"eval_{name}")(jbanks, ji, table, jwo, jwi, jlam, ju2, juc)
    te = getattr(tl, f"eval_{name}")(tbanks, ti, two, twi, tlam, tu2, tuc)
    for k, what in enumerate(("f", "pdf")):
        got = te[k].numpy()
        assert np.isfinite(got).all(), f"eval_{name}.{what} not finite"
        _close(got, je[k], f"eval_{name}.{what}", WALK_RTOL, WALK_SHARE, None)
    assert (te[0] > 0).any()


def _bench_list(m):
    """bench.py build_materials_scene's materials in the scene's slot order
    (room, ten sphere materials, emitter), then two Mixes that share a
    child which is not in the list itself."""
    shared = m.Matte(kd=(0.2, 0.8, 0.2))
    return [m.Matte(kd=(0.73, 0.73, 0.73)), m.Matte(kd=(0.65, 0.05, 0.05)),
            m.Matte(kd=(0.12, 0.45, 0.15)), m.Matte(kd=(0.3, 0.4, 0.8)), m.Mirror(),
            m.Glass(eta=1.5), m.Gold(roughness=0.15), m.ThinDielectric(),
            m.DiffuseTransmission(), m.CoatedDiffuse(), m.CoatedConductor(),
            m.CoatedDiffuseTransmission(), m.Glass(eta=1.33),
            m.Emissive(le=(1.0, 0.95, 0.85), scale=25.0),
            m.Mix(m1=shared, m2=m.Plastic(), amount=0.3),
            m.Mix(m1=m.Mirror(kr=(0.5, 0.5, 0.5)), m2=shared, amount=0.6)]


def test_pack_materials_matches_jax():
    jbanks, jtags, jidx, jpresent = jmt.pack_materials(_bench_list(jmt))
    tbanks, ttags, tidx, tpresent = tmt.pack_materials(_bench_list(tmt))
    np.testing.assert_array_equal(ttags, jtags)
    np.testing.assert_array_equal(tidx, jidx)
    assert tpresent == jpresent
    assert len(ttags) == 16 + 3  # the Mix children past the list: shared, Plastic, Mirror
    for f in ("mix_m1_type", "mix_m1_idx", "mix_m2_type", "mix_m2_idx", "mix_amount",
              "thin_eta", "cd_eta", "cc_eta", "cdt_eta", "cd_ax", "cc_cax", "cdt_thick"):
        np.testing.assert_array_equal(getattr(tbanks, f).numpy(), np.asarray(getattr(jbanks, f)),
                                      err_msg=f)
    for f in ("cc_cond_eta_pw", "cc_cond_k_pw", "cd_refl_c4", "cdt_trans_c4", "dt_refl_c4",
              "thin_kt_c4"):
        np.testing.assert_allclose(getattr(tbanks, f).numpy(), np.asarray(getattr(jbanks, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


def test_pack_materials_refusals():
    """Nested Mix is refused; a field that is neither a constant nor a
    texture raises TypeError, and so does a texture on a field that the JAX
    package takes only as a constant (textures are ported: ROADMAP A10)."""
    with pytest.raises(ValueError, match="nested Mix"):
        tmt.pack_materials([tmt.Mix(m1=tmt.Mix(m1=tmt.Matte(), m2=tmt.Mirror()),
                                    m2=tmt.Matte())])
    with pytest.raises(TypeError):
        tmt.pack_materials([tmt.CoatedDiffuse(reflectance=object())])
    with pytest.raises(TypeError):
        tmt.pack_materials([tmt.Mix(m1=tmt.Matte(), m2=tmt.Mirror(), amount=object())])
    with pytest.raises(TypeError, match="constant"):
        tmt.pack_materials([tmt.ThinDielectric(kr=tmt.ImageTexture(np.ones((2, 2, 3))))])


def test_new_names_are_exported():
    import hikari_tpu
    import hikari_tpu_torch

    names = ("ThinDielectric", "DiffuseTransmission", "CoatedDiffuse", "Plastic",
             "CoatedConductor", "CoatedDiffuseTransmission", "Mix")
    for n in names:
        assert n in hikari_tpu.__all__ and n in hikari_tpu_torch.__all__, n
        assert getattr(hikari_tpu_torch, n) is getattr(tmt, n)
