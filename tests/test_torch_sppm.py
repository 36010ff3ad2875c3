"""Port parity: SPPM and its copy of jax.random's threefry generator.

* sampling/threefry.py's PRNGKey, fold_in and uniform equal jax.random's
  bit for bit (JAX's default threefry-2x32, partitionable layout), for
  several seeds, fold-in data and shapes (n,) and (n, 2).
* _gather on seeded photons (a cell of 200, past MAX_PER_CELL, scaled by
  its count; parked invalid photons; points on the far side) against the
  JAX package's fori_loop: tau and the photon count within 1e-6 relative.
* One _sppm_iteration on tests/test_sppm.py's box at 16x16 with 8,192
  photons (SPPM(iterations=4, photons_per_iteration=8192,
  initial_radius=0.3, max_depth=3)) against the JAX package's state stored
  in hikari_tpu_torch/data/probe_ref.json (tools/gen_probe_ref.py
  --renders): r2 and N equal, tau and direct within 1e-5 of each array's
  largest value per pixel. The photons are the JAX package's lane for
  lane (the same threefry words), so the state differs by rounding only.
* render_sppm's image mean within 1% of the JAX package's; the radius
  shrinks where photons land; tests/test_sppm.py's direct-and-indirect
  checks on the port.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu_torch as hk
from hikari_tpu.integrators import sppm as jsppm
from hikari_tpu_torch.integrators import sppm as tsppm
from hikari_tpu_torch.sampling import threefry
from hikari_tpu_torch.scenes import PROBE_REF, box_scene, scene_camera

STATE_RTOL = 1e-5
MEAN_RTOL = 0.01


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 - 1])
@pytest.mark.parametrize("shape", [(1000,), (333, 2)])
def test_threefry_equals_jax_random(seed, shape):
    key = jax.random.PRNGKey(seed)
    pk = threefry.prng_key(seed)
    assert tuple(int(x) for x in np.asarray(key)) == pk
    for data in (0, 1, 70, 2 ** 32 - 1):
        kf = jax.random.fold_in(key, data)
        pf = threefry.fold_in(pk, data)
        assert tuple(int(x) for x in np.asarray(kf)) == pf
        ref = np.asarray(jax.random.uniform(kf, shape))
        got = threefry.uniform(pf, shape).numpy()
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
        np.testing.assert_array_equal(threefry.random_bits(pf, shape).numpy().astype(np.uint32),
                                      np.asarray(jax.random.bits(kf, shape)))


def _gather_inputs():
    rng = np.random.RandomState(5)
    n_vp, n_ph = 300, 900
    vp_p = rng.uniform(0, 2, (n_vp, 3)).astype(np.float32)
    vp_ns = np.tile(np.float32([[0, 1, 0]]), (n_vp, 1))
    vp_ns[::7] *= -1  # the far side: these gather nothing of the upward photons
    vp_valid = rng.rand(n_vp) > 0.1
    r2 = rng.uniform(0.01, 0.09, n_vp).astype(np.float32)
    ph_p = rng.uniform(0, 2, (n_ph, 3)).astype(np.float32)
    ph_p[:200] = rng.uniform(1.0, 1.05, (200, 3))  # one cell far past MAX_PER_CELL
    vp_p[:40] = rng.uniform(0.95, 1.1, (40, 3))    # points around it
    ph_pow = rng.rand(n_ph, 3).astype(np.float32)
    ph_n = np.tile(np.float32([[0, 1, 0]]), (n_ph, 1))
    ph_ok = rng.rand(n_ph) > 0.2
    return (vp_p, vp_ns, vp_valid, r2, ph_p, ph_pow, ph_n, ph_ok,
            np.zeros(3, np.float32), np.float32(2.0 / 64 * 1.5), 64)


def test_gather_equals_jax():
    args = _gather_inputs()
    jt, jm = jsppm._gather(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                             for a in args))
    tt, tm = tsppm._gather(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else
                             torch.tensor(a) if isinstance(a, np.floating) else a
                             for a in args))
    jt, jm = np.asarray(jt), np.asarray(jm)
    assert jm[:40].max() > tsppm.MAX_PER_CELL  # the over-full cell was scaled
    assert (jm > 0).mean() > 0.2
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-6)
    np.testing.assert_allclose(tt.numpy(), jt, rtol=1e-6, atol=1e-6 * np.abs(jt).max())


@pytest.fixture(scope="module")
def stored():
    return json.loads(PROBE_REF.read_text())["renders"]["sppm box"]


def _setup(stored):
    res = stored["res"]
    integ = hk.SPPM(**stored["config"])
    return integ, box_scene().build(device="cpu"), scene_camera("box", res), res * res


def test_sppm_iteration_equals_jax(stored):
    integ, sc, cam, n = _setup(stored)
    state = tsppm._sppm_iteration(integ, sc, cam, tsppm.sppm_initial_state(integ, n, "cpu"), 0)
    ref = stored["state_after_1"]
    for k in ("r2", "n"):
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(ref[k], np.float32),
                                      err_msg=k)
    for k in ("tau", "direct"):
        r = np.asarray(ref[k], np.float32)
        assert np.abs(r).max() > 0.1
        np.testing.assert_allclose(state[k].numpy(), r, rtol=0,
                                   atol=STATE_RTOL * np.abs(r).max(), err_msg=k)
    assert int(state["iters"]) == 1


def test_render_sppm_mean_equals_jax(stored):
    integ, sc, cam, _ = _setup(stored)
    img = hk.render_sppm(integ, sc, cam)
    assert img.shape == (stored["res"], stored["res"], 3) and bool(torch.isfinite(img).all())
    mean = stored["render_mean"]
    assert abs(float(img.mean()) / mean - 1) <= MEAN_RTOL, (float(img.mean()), mean)


def test_sppm_radius_shrinks(stored):
    integ, sc, cam, n = _setup(stored)
    state = tsppm.sppm_initial_state(integ, n, "cpu")
    r2_0 = state["r2"].clone()
    for it in range(3):
        state = tsppm._sppm_iteration(integ, sc, cam, state, it)
    assert bool((state["r2"] <= r2_0 + 1e-9).all())
    assert float((state["r2"] < r2_0).float().mean()) > 0.3, "radii shrink where photons land"


def test_sppm_renders_direct_and_indirect():
    cam = hk.make_perspective_camera((0, 1.0, -2.6), (0, 1.0, 1.0), (24, 24), fov_deg=50.0)
    integ = hk.SPPM(iterations=3, photons_per_iteration=8192, initial_radius=0.25,
                    max_depth=3)
    img = hk.render_sppm(integ, box_scene().build(device="cpu"), cam).numpy()
    assert img.shape == (24, 24, 3) and np.isfinite(img).all()
    assert img.max() > 0.05
    assert (img.sum(-1) > 1e-3).mean() > 0.5  # most of the closed box is lit
    assert img.mean() > 0.01


def test_sppm_photon_pass_deposits():
    """Deposits: one slot per photon and bounce from the second on, valid
    where the photon reached a diffuse surface."""
    integ = hk.SPPM(photons_per_iteration=4096, max_depth=4)
    sc = box_scene().build(device="cpu")
    p, pw, nrm, ok = tsppm._trace_photons(sc, 0, integ.photons_per_iteration, integ.max_depth,
                                          threefry.prng_key(0))
    assert p.shape == (4096 * 3, 3) and ok.shape == (4096 * 3,)
    assert 0.2 < float(ok.float().mean()) < 1.0
    assert bool((pw[ok] >= 0).all()) and bool(torch.isfinite(pw[ok]).all())
