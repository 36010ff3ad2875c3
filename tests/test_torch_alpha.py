"""Port parity: stochastic alpha (ROADMAP A10) against the JAX package.

* _alpha_keep equals the JAX package's bit for bit on seeded hit points,
  barycentrics and faces, for constant and image alpha and every round's
  salt. The two packages' renders do not meet the same hit points lane for
  lane (the hash reads the bits of o + t d, which XLA contracts into an FMA
  and eager torch does not), so renders are held by their means;
* the foliage stack (tests/test_alpha_mix.py's eight alpha-0.3 quads) on
  that test's 8192 rays: the escape share within its bound of 0.7^8 and
  within three standard errors of the JAX package's share on the same rays
  (stored by tools/gen_probe_ref.py --renders);
* the swatch scene's alpha-0 band (transparent: the wall shows through)
  and alpha-0.5 band (blended) against the JAX package's stored band means,
  within three stored standard errors of a band mean;
* shadow rays pass alpha-failed occluders: an alpha-0 pane between the
  light and a floor leaves the floor as lit as without it, an opaque pane
  darkens it;
* has_alpha counts real faces only: a padded instanced scene without alpha
  has it False (the JAX package's padding rows set it: a deliberate
  departure, ROADMAP C), and an instanced scene with an image alpha
  renders as its flat twin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu
from hikari_tpu.geometry.traverse import HitRecord as JHit
from hikari_tpu.integrators import volpath as jv
import hikari_tpu_torch as hk
from hikari_tpu_torch.geometry.traverse import HitRecord as THit
from hikari_tpu_torch.integrators import volpath as tv
from hikari_tpu_torch.scenes import (FOLIAGE_ALPHA, FOLIAGE_LAYERS, SWATCH_BANDS, foliage_scene,
                                     stripes_mask, swatch_scene)
from test_torch_textures import _stored, swatch_bands

N = 4096


def _alpha_scene(m):
    """Quads of alpha 0.3, 0.7 and a stripes image, and an opaque one."""
    s = m.Scene()
    for k, alpha in enumerate((0.3, 0.7, m.ImageTexture(stripes_mask(32)), None)):
        x = -2.0 + k
        s.add(m.make_quad((x, 0, 0), (x + 0.9, 0, 0), (x + 0.9, 1, 0), (x, 1, 0)), m.Matte(),
              alpha=alpha)
    return s


@pytest.mark.parametrize("u_salt", [0, 3, 7])
def test_alpha_keep_matches_jax_bit_for_bit(u_salt):
    js, ts = _alpha_scene(hikari_tpu).build(), _alpha_scene(hk).build(device="cpu")
    np.testing.assert_array_equal(ts.tex_rows.numpy(), np.asarray(js.tex_rows))
    rng = np.random.RandomState(12 + u_salt)
    tri = rng.randint(0, ts.n_faces, N).astype(np.int32)
    b1 = rng.rand(N).astype(np.float32)
    b2 = (rng.rand(N) * (1 - b1)).astype(np.float32)
    hit = rng.rand(N) < 0.9
    t = rng.uniform(0.1, 5.0, N).astype(np.float32)
    p = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    p[:8, 0] = [0.0, -0.0, 1e-30, -1e-30, 2.0 ** 20, 1.5, -0.75, 3.0]  # sign bits, tiny, exact
    jrec = JHit(hit=jnp.asarray(hit), t=jnp.asarray(t), tri=jnp.asarray(tri),
                b1=jnp.asarray(b1), b2=jnp.asarray(b2))
    trec = THit(hit=torch.from_numpy(hit), t=torch.from_numpy(t), tri=torch.from_numpy(tri),
                b1=torch.from_numpy(b1), b2=torch.from_numpy(b2))
    want = np.asarray(jv._alpha_keep(js, jrec, jnp.asarray(p), u_salt=u_salt))
    got = tv._alpha_keep(ts, trec, torch.from_numpy(p), u_salt=u_salt).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.2 < got[hit].mean() < 0.95  # both outcomes occur


def test_foliage_escape_share():
    """tests/test_alpha_mix.py::test_alpha_stack_transmission_stress on the
    port, and against the JAX package's share on the same rays."""
    ref = _stored("foliage escape")
    ts = foliage_scene().build(device="cpu")
    n = ref["rays"]
    rng = np.random.RandomState(0)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-3, 3, (n, 2))
    d = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3).contiguous()
    rec = tv._closest_hit_surface(ts, torch.from_numpy(o), d, torch.full((n,), float("inf")),
                                  torch.ones(n, dtype=torch.bool))
    escape = 1.0 - float(rec.hit.float().mean())
    expect = (1.0 - FOLIAGE_ALPHA) ** FOLIAGE_LAYERS
    assert abs(escape - expect) < 0.35 * expect + 0.01, (escape, expect)
    # two independent shares of n rays each: the difference's standard error
    se = np.sqrt(2.0 * expect * (1.0 - expect) / n)
    assert abs(escape - ref["escape"]) <= 3.0 * se, (escape, ref["escape"], se)
    hit_t = rec.t[rec.hit]
    assert float(hit_t.min()) >= 1.0 - 1e-4 and float(hit_t.max()) <= 1.7 + 1e-3


@pytest.fixture(scope="module")
def swatch():
    return swatch_bands(swatch_scene().build(device="cpu")), _stored("swatch")


@pytest.mark.parametrize("band", [2, 3], ids=SWATCH_BANDS[2:])
def test_swatch_alpha_bands(swatch, band):
    got, ref = swatch
    assert abs(got[band] - ref["band_mean"][band]) <= 3.0 * ref["band_sem"][band] + 1e-6, (
        got[band], ref["band_mean"][band], ref["band_sem"][band])


def _shadow_scene(pane_alpha):
    """A floor lit by a point light through a pane (alpha pane_alpha; no
    pane when None) that the camera does not see."""
    s = hk.Scene()
    s.add(hk.make_quad((-2, 0, -2), (2, 0, -2), (2, 0, 2), (-2, 0, 2)), hk.Matte())
    if pane_alpha is not None:
        s.add(hk.make_quad((-1, 1.5, -1), (-1, 1.5, 1), (1, 1.5, 1), (1, 1.5, -1)),
              hk.Matte(), alpha=pane_alpha)
    s.add_light(hk.PointLight(position=(0, 3, 0), intensity=(10, 10, 10)))
    return s.build(device="cpu")


def _render(sc, res=16, depth=1, eye=(0.0, 1.0, -3.5), at=(0.0, 0.0, 0.0)):
    lanes = torch.arange(res * res)
    rgb, _, st = hk.render_lanes(hk.VolPath(max_depth=depth, samples_per_pixel=1), sc,
                                 hk.make_perspective_camera(eye, at, (res, res), fov_deg=40.0),
                                 hk.make_filter(), 0, lanes % res, lanes // res)
    assert float(st["nonfinite_lanes"]) == 0.0
    return rgb.numpy()


def test_shadows_pass_alpha_failed_occluders():
    bare = _render(_shadow_scene(None))
    clear = _render(_shadow_scene(0.0))
    opaque = _render(_shadow_scene(1.0))
    assert _shadow_scene(0.0).has_alpha and not _shadow_scene(1.0).has_alpha
    np.testing.assert_allclose(clear, bare, rtol=1e-5, atol=1e-7)
    assert opaque.mean() < 0.7 * bare.mean()


def _instanced_spheres(m, alpha, flat):
    """A floor and three spheres of one mesh, as instances (padded BLAS) or
    as flat meshes at the same places."""
    s = m.Scene()
    s.add(m.make_quad((-3, 0, -3), (3, 0, -3), (3, 0, 3), (-3, 0, 3)), m.Matte(kd=(0.5, 0.5, 0.5)))
    tr = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    tr[:, 0, 3] = (-1.1, 0.0, 1.1)
    tr[:, 1, 3] = 0.5
    mat = m.Matte(kd=(0.8, 0.3, 0.2))
    if flat:
        for t in tr:
            s.add(m.make_sphere(tuple(t[:3, 3]), 0.45, 8, 16), mat, alpha=alpha)
    else:
        s.add_instanced(m.make_sphere((0, 0, 0), 0.45, 8, 16), tr, mat, alpha=alpha)
    s.add_light(m.PointLight(position=(0, 3, -1), intensity=(10, 10, 10)))
    return s


def test_has_alpha_counts_real_faces_only():
    js = _instanced_spheres(hikari_tpu, None, flat=False).build(traversal="packets_interp")
    ts = _instanced_spheres(hk, None, flat=False).build(device="cpu")
    assert ts.has_instances and js.has_alpha and not ts.has_alpha
    np.testing.assert_array_equal(ts.tex_rows.numpy(), np.asarray(js.tex_rows))
    assert float(ts.alpha_const.min()) == 0.0  # padding rows, as the JAX package's


def test_instanced_alpha_renders_as_flat_twin():
    """The stripes' alpha is 0 or 1 but on the one-texel bilinear seams (3%
    of the mask), where the hash, which reads the face row (another number
    in the BLAS than in the flat build), decides."""
    alpha = hk.ImageTexture(stripes_mask(256, stripes=4))
    inst = _instanced_spheres(hk, alpha, flat=False).build(device="cpu")
    flat = _instanced_spheres(hk, alpha, flat=True).build(device="cpu")
    assert inst.has_alpha and flat.has_alpha
    view = dict(res=24, depth=2, eye=(0.0, 1.2, -3.5), at=(0.0, 0.4, 0.0))
    a, b = _render(inst, **view), _render(flat, **view)
    close = (np.abs(a - b) <= 1e-3 * np.abs(b) + 1e-4).all(-1)
    assert close.mean() >= 0.97, f"{(~close).sum()} of {close.size} pixels differ"
    assert abs(a.mean() - b.mean()) <= 0.02 * b.mean()
