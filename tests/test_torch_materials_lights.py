"""Port parity: BSDF sampling / evaluation of the five main-path materials,
emission, and point / area light sampling with the power alias table.

Inputs come from a numpy seed; both packages pack the same host materials
and lights. Tolerance: float32 on both sides in another operation order,
so values agree to 1e-5 relative (1e-6 absolute for values that cancel to
~0) on >= 99.9% of lanes and to 1e-4 on every lane: the few lanes in
between are ill-conditioned ones (grazing angles, light points seen edge
on) that amplify last-bit differences. Flags (specular, transmission,
valid) must be equal on >= 99.9% of lanes, the rest sitting on a
comparison's edge.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.lights import types as jlt
from hikari_tpu.materials import bsdf as jb
from hikari_tpu.materials import types as jmt
from hikari_tpu.spectral.rgb2spec import srgb_table
from hikari_tpu_torch.lights import types as tlt
from hikari_tpu_torch.materials import bsdf as tb
from hikari_tpu_torch.materials import types as tmt
from hikari_tpu_torch.spectral.rgb2spec import srgb_table as t_srgb_table

RTOL, ATOL, FLAGS, WORST = 1e-5, 1e-6, 0.999, 1e-4
N = 4096


def _materials(m):
    return [m.Matte(kd=(0.7, 0.2, 0.1)), m.Matte(kd=(0.3, 0.4, 0.8), sigma=20.0),
            m.Mirror(kr=(0.9, 0.9, 0.8)), m.Glass(eta=1.5),
            m.Glass(eta=1.33, u_roughness=0.05, v_roughness=0.05),
            m.Glass(eta=1.5, cauchy_b=0.01), m.Gold(roughness=0.15),
            m.Conductor(metal=None, roughness=0.0),
            m.Emissive(le=(1.0, 0.95, 0.85), scale=25.0)]


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
                pick=rng.randint(0, 4, N))
    return jbanks, tbanks, data


def _j(data, *keys):
    return [jnp.asarray(data[k]) for k in keys]


def _t(data, *keys):
    return [torch.from_numpy(np.ascontiguousarray(data[k])) for k in keys]


def _close(t, j, what):
    t, j = np.asarray(t), np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=WORST, atol=ATOL, err_msg=what)
    ok = np.abs(t - j) <= ATOL + RTOL * np.abs(j)
    assert ok.mean() >= FLAGS, f"{what}: {(~ok).sum()} lanes beyond {RTOL} relative"


def _compare_sample(ts, js, what):
    flags_ok = np.ones(N, bool)
    for f in ("specular", "transmission", "valid"):
        eq = getattr(ts, f).numpy() == np.asarray(getattr(js, f))
        assert eq.mean() >= FLAGS, f"{what}.{f}"
        flags_ok &= eq
    for f in ("wi", "f", "pdf", "eta_scale"):
        _close(getattr(ts, f).numpy()[flags_ok], np.asarray(getattr(js, f))[flags_ok],
               f"{what}.{f}")


# (material tag, bank rows): two Mattes, one Mirror, three Glasses, two Conductors
@pytest.mark.parametrize("tag,rows", [(jmt.MATTE, 2), (jmt.MIRROR, 1), (jmt.GLASS, 3),
                                      (jmt.CONDUCTOR, 2)])
def test_sample_and_eval(mats, tag, rows):
    jbanks, tbanks, data = mats
    idx = (data["pick"] % rows).astype(np.int32)
    ji, ti = jnp.asarray(idx), torch.from_numpy(idx)
    table = srgb_table()
    jwo, jlam, ju2, juc, jwi = _j(data, "wo", "lam", "u2", "uc", "wi")
    two, tlam, tu2, tuc, twi = _t(data, "wo", "lam", "u2", "uc", "wi")
    if tag == jmt.MATTE:
        js = jb.sample_matte(jbanks, ji, table, jwo, jlam, ju2, juc)
        ts = tb.sample_matte(tbanks, ti, two, tlam, tu2, tuc)
        je = jb.eval_matte(jbanks, ji, table, jwo, jwi, jlam)
        te = tb.eval_matte(tbanks, ti, two, twi, tlam)
    elif tag == jmt.MIRROR:
        js = jb.sample_mirror(jbanks, ji, table, jwo, jlam, ju2, juc)
        ts = tb.sample_mirror(tbanks, ti, two, tlam, tu2, tuc)
        je = te = None
    elif tag == jmt.GLASS:
        js = jb.sample_glass(jbanks, ji, table, jwo, jlam, ju2, juc)
        ts = tb.sample_glass(tbanks, ti, two, tlam, tu2, tuc)
        je = jb.eval_glass(jbanks, ji, table, jwo, jwi, jlam)
        te = tb.eval_glass(tbanks, ti, two, twi, tlam)
    else:
        reg = data["uc"] > 0.5  # regularized lanes roughen the smooth conductor
        js = jb.sample_conductor(jbanks, ji, table, jwo, jlam, ju2, juc,
                                 regularize=jnp.asarray(reg))
        ts = tb.sample_conductor(tbanks, ti, two, tlam, tu2, tuc,
                                 regularize=torch.from_numpy(reg))
        je = jb.eval_conductor(jbanks, ji, table, jwo, jwi, jlam)
        te = tb.eval_conductor(tbanks, ti, two, twi, tlam)
    _compare_sample(ts, js, f"sample[{tag}]")
    if te is not None:
        _close(te[0].numpy(), je[0], f"eval[{tag}].f")
        _close(te[1].numpy(), je[1], f"eval[{tag}].pdf")


def test_emission(mats):
    jbanks, tbanks, data = mats
    cos_wo = data["wo"][:, 2]
    idx = np.zeros(N, np.int32)
    j = jb.emitted_radiance(jbanks, jnp.asarray(idx), srgb_table(),
                            jnp.asarray(data["lam"]), jnp.asarray(cos_wo))
    t = tb.emitted_radiance(tbanks, torch.from_numpy(idx), torch.from_numpy(data["lam"]),
                            torch.from_numpy(cos_wo))
    _close(t.numpy(), j, "emitted_radiance")
    assert (t.numpy()[cos_wo <= 0] == 0).all()


@pytest.fixture(scope="module")
def lights():
    rng = np.random.RandomState(1)
    na = 6
    p0 = rng.rand(na, 3).astype(np.float32) * 2 + np.float32([0, 3, 0])
    p1 = p0 + rng.rand(na, 3).astype(np.float32) * 0.5
    p2 = p0 + rng.rand(na, 3).astype(np.float32) * 0.5
    le = rng.rand(na, 3).astype(np.float32) * 10
    two = rng.rand(na) > 0.5
    area = (p0, p1, p2, le, two)
    pts = [((0.0, 3.0, -0.5), (8.0, 8.0, 8.0)), ((1.0, 2.0, 1.0), (2.0, 4.0, 1.0))]
    jb_ = jlt.pack_lights([jlt.PointLight(position=p, intensity=i) for p, i in pts],
                          area, scene_radius=5.0)
    tb_ = tlt.pack_lights([tlt.PointLight(position=p, intensity=i) for p, i in pts], area,
                          scene_radius=5.0)
    return jb_, tb_, rng


def test_alias_sampler(lights):
    jbk, tbk, rng = lights
    for k in ("pmf", "alias_q", "alias_j", "light_type", "light_idx"):
        np.testing.assert_array_equal(getattr(tbk, k).numpy(), np.asarray(getattr(jbk, k)))
    u = rng.rand(N).astype(np.float32)
    ji, jp = jlt.sample_light_index(jbk, jnp.asarray(u))
    ti, tp = tlt.sample_light_index(tbk, torch.from_numpy(u))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_sample_li_and_area_pdf(lights):
    jbk, tbk, rng = lights
    n_flat = tbk.n_flat
    flat = rng.randint(0, n_flat, N)
    ltype = tbk.light_type.numpy()[flat]
    lidx = tbk.light_idx.numpy()[flat]
    p = (rng.rand(N, 3) * 4 - 2).astype(np.float32)
    lam = (360.0 + rng.rand(N, 4) * 470.0).astype(np.float32)
    u2 = rng.rand(N, 2).astype(np.float32)
    js = jlt.sample_li(jbk, srgb_table(), jnp.asarray(ltype), jnp.asarray(lidx),
                       jnp.asarray(p), jnp.asarray(lam), jnp.asarray(u2), jnp.float32(5.0))
    ts = tlt.sample_li(tbk, t_srgb_table(), *(torch.from_numpy(a)
                                               for a in (ltype, lidx, p, lam, u2)), 5.0)
    for f in ("wi", "li", "pdf", "t_max"):
        _close(getattr(ts, f).numpy(), getattr(js, f), f"sample_li.{f}")
    for f in ("is_delta", "valid"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    aidx = rng.randint(0, 6, N).astype(np.int32)
    p_hit = np.asarray(js.wi) * 2.0 + p
    n_hit = np.asarray(jlt.area_light_pdf(jbk, jnp.asarray(aidx), jnp.asarray(p),
                                          jnp.asarray(p_hit), jnp.asarray(js.wi)))
    t_pdf = tlt.area_light_pdf(tbk, torch.from_numpy(aidx), torch.from_numpy(p),
                               torch.from_numpy(p_hit.astype(np.float32)),
                               torch.from_numpy(np.array(js.wi)))
    _close(t_pdf.numpy(), n_hit, "area_light_pdf")
