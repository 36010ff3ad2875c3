"""Port parity: ZSobol sampling and the 64-bit hashes, bit for bit.

The JAX package emulates uint64 as (hi, lo) uint32 pairs; the port uses
native int64. Inputs come from a numpy seed and go through both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.sampling import hashes as jh
from hikari_tpu.sampling import sobol as jsb
from hikari_tpu_torch.sampling import hashes as th
from hikari_tpu_torch.sampling import sobol as tsb


def _u64_pattern(hi, lo):
    """(hi, lo) uint32 -> the same 64-bit pattern as int64."""
    u = (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)
    return u.view(np.int64)


def _random_u64(seed, n=4096):
    rng = np.random.RandomState(seed)
    hi = rng.randint(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.randint(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return hi, lo


def test_mix_bits_and_murmur_bit_exact():
    hi, lo = _random_u64(0)
    j = jh.mix_bits((jnp.asarray(hi), jnp.asarray(lo)))
    t = th.mix_bits(torch.from_numpy(_u64_pattern(hi, lo)))
    np.testing.assert_array_equal(t.numpy(), _u64_pattern(*map(np.asarray, j)))

    for n_bytes, seed in ((8, 0), (8, 1234567), (12, 0), (16, 99)):
        rng = np.random.RandomState(n_bytes + seed)
        words = [rng.randint(0, 2**32, 512, dtype=np.uint64).astype(np.uint32)
                 for _ in range(n_bytes // 4)]
        j = jh.murmur_hash_64a([jnp.asarray(w) for w in words], n_bytes, seed)
        t = th.murmur_hash_64a([torch.from_numpy(w.astype(np.int64)) for w in words],
                               n_bytes, seed)
        np.testing.assert_array_equal(t.numpy(), _u64_pattern(*map(np.asarray, j)))


def test_fast_owen_scramble_bit_exact():
    rng = np.random.RandomState(3)
    v = rng.randint(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    seed = rng.randint(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    j = np.asarray(jh.fast_owen_scramble(jnp.asarray(v), jnp.asarray(seed)))
    t = th.fast_owen_scramble(torch.from_numpy(v.astype(np.int64)),
                              torch.from_numpy(seed.astype(np.int64)))
    np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))


# (width, height, spp, seed): spp 2 and 8 take the odd-log2 (pow2) branch
CONFIGS = [(64, 64, 1, 0), (800, 800, 4, 0), (100, 60, 2, 7), (256, 256, 8, 3)]


def _lanes(w, h, n=700, seed=0):
    rng = np.random.RandomState(seed)
    px = rng.randint(0, w, n).astype(np.uint32)
    py = rng.randint(0, h, n).astype(np.uint32)
    return px, py


@pytest.mark.parametrize("w,h,spp,seed", CONFIGS)
def test_pixel_samples_bit_exact(w, h, spp, seed):
    px, py = _lanes(w, h, seed=spp)
    si = (np.arange(px.size) % spp).astype(np.uint32)
    jcfg = jsb.make_zsobol(w, h, spp, seed=seed)
    tcfg = tsb.make_zsobol(w, h, spp, seed=seed)
    j = jsb.compute_pixel_sample(jcfg, jnp.asarray(px), jnp.asarray(py), jnp.asarray(si))
    t = tsb.compute_pixel_sample(tcfg, torch.from_numpy(px.astype(np.int64)),
                                 torch.from_numpy(py.astype(np.int64)),
                                 torch.from_numpy(si.astype(np.int64)))
    for field in ("jitter", "wavelength_u", "lens", "time"):
        np.testing.assert_array_equal(getattr(t, field).numpy(),
                                      np.asarray(getattr(j, field)), err_msg=field)


@pytest.mark.parametrize("depth", [0, 4])
def test_path_samples_bit_exact(depth):
    w = h = 800
    px, py = _lanes(w, h, seed=depth)
    si = (np.arange(px.size) % 4).astype(np.uint32)
    jcfg, tcfg = jsb.make_zsobol(w, h, 4), tsb.make_zsobol(w, h, 4)
    jargs = (jnp.asarray(px), jnp.asarray(py), jnp.asarray(si))
    targs = tuple(torch.from_numpy(a.astype(np.int64)) for a in (px, py, si))
    for dim in (0, 5, 6, 9):  # light select, BSDF lobe, RR, layered walk
        np.testing.assert_array_equal(
            tsb.path_sample_1d(tcfg, *targs, depth, dim).numpy(),
            np.asarray(jsb.path_sample_1d(jcfg, *jargs, depth, dim)))
    for dim in (1, 3, 7):  # light point, BSDF direction, layered eval
        for a, b in zip(tsb.path_sample_2d(tcfg, *targs, depth, dim),
                        jsb.path_sample_2d(jcfg, *jargs, depth, dim)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
