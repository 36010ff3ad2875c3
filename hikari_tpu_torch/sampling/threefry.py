"""The counter-based generator of ``jax.random``: threefry-2x32.

SPPM's photon pass (``integrators/sppm.py``) draws its numbers as the JAX
package does, from ``jax.random.PRNGKey``, ``fold_in`` and ``uniform``
under JAX's default implementation (threefry-2x32, 20 rounds, with the
partitionable bit layout that is the default since JAX 0.5: element ``i``
of a draw is the XOR of the two words of threefry(key, (i >> 32, i &
0xFFFFFFFF))). This is a copy of that generator on int64 tensors holding
32-bit words, so both packages draw the same words bit for bit and their
photons can be compared lane for lane. A key is a pair of Python ints.
"""

from __future__ import annotations

import torch

from .hashes import MASK32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key, x0, x1):
    """Threefry-2x32 of the counter words (x0, x1) under key (k0, k1): two
    int64 tensors of 32-bit words in, two out."""
    k0, k1 = key[0] & MASK32, key[1] & MASK32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int):
    """jax.random.PRNGKey(seed) with 32-bit integers (JAX's default): the
    words (0, seed mod 2^32)."""
    return (0, int(seed) & MASK32)


def fold_in(key, data: int):
    """jax.random.fold_in(key, data): threefry of the counter (0, data)."""
    y0, y1 = threefry2x32(key, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & MASK32], dtype=torch.int64))
    return (int(y0), int(y1))


def random_bits(key, shape, device=None) -> torch.Tensor:
    """jax.random.bits(key, shape) as 32-bit words in an int64 tensor."""
    n = 1
    for s in shape:
        n *= int(s)
    i = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, i >> 32, i & MASK32)
    return (y0 ^ y1).reshape(tuple(shape))


def uniform(key, shape, device=None) -> torch.Tensor:
    """jax.random.uniform(key, shape) in float32 over [0, 1): the top 23
    bits of each word as a mantissa of [1, 2), minus 1."""
    bits = (random_bits(key, shape, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
