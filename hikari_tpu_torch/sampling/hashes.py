"""pbrt-v4 hashing on native 64-bit integers.

Port of ``hikari_tpu/sampling/hashes.py`` (which emulates uint64 as pairs
of uint32 for the TPU). torch has no usable unsigned 64-bit type, so every
64-bit value here is an ``int64`` tensor holding the same bit pattern:
multiplies wrap modulo 2^64 exactly like uint64, constants of 2^63 and
above are written as their two's-complement ``int64``, and logical right
shifts mask off the sign extension of torch's arithmetic ``>>``. 32-bit
values live in ``int64`` tensors masked to ``[0, 2^32)``. Results are bit
for bit those of the JAX package.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_R = 47


def as_i64(c: int) -> int:
    """Two's-complement int64 value of an unsigned 64-bit constant."""
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >= (1 << 63) else c


_M = as_i64(0xC6A4A7935BD1E995)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of a 64-bit pattern by a static amount."""
    if s == 0:
        return x
    if s >= 64:
        return torch.zeros_like(x)
    return (x >> s) & ((1 << (64 - s)) - 1)


def mix_bits(v: torch.Tensor) -> torch.Tensor:
    """pbrt MixBits (spectral-eval.jl:641-648)."""
    v = v ^ shr(v, 31)
    v = v * as_i64(0x7FB5D329728EA185)
    v = v ^ shr(v, 27)
    v = v * as_i64(0x81DADEF4BC2DD44D)
    return v ^ shr(v, 33)


def murmur_hash_64a(words: list, n_bytes: int, seed: int = 0) -> torch.Tensor:
    """MurmurHash64A over little-endian 32-bit words (int64 tensors holding
    values in [0, 2^32)). n_bytes must be a multiple of 4."""
    if n_bytes % 4 or len(words) * 4 < n_bytes:
        raise ValueError("murmur_hash_64a takes whole 32-bit words")
    like = words[0]
    h0 = as_i64(seed ^ ((n_bytes * 0xC6A4A7935BD1E995) & ((1 << 64) - 1)))
    h = torch.full_like(like, h0)
    for i in range(n_bytes // 8):
        k = (words[2 * i + 1] << 32) | words[2 * i]
        k = k * _M
        k = k ^ shr(k, _R)
        k = k * _M
        h = (h ^ k) * _M
    if n_bytes % 8 == 4:
        h = (h ^ words[n_bytes // 4 - 1]) * _M
    h = h ^ shr(h, _R)
    h = h * _M
    return h ^ shr(h, _R)


def hash_u32x2(a: torch.Tensor, b: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """pbrt Hash(a, b) of two 32-bit values; returns the 64-bit pattern."""
    a, b = torch.broadcast_tensors(a.long() & MASK32, b.long() & MASK32)
    return murmur_hash_64a([a, b], 8, seed)


def hash_u32x2_int(a: int, b: int, seed: int = 0) -> int:
    """hash_u32x2 of two host integers, as an int64 value."""
    return int(hash_u32x2(torch.tensor([a]), torch.tensor([b]), seed)[0])


def reverse_bits32(v: torch.Tensor) -> torch.Tensor:
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    return ((v >> 16) | (v << 16)) & MASK32


def fast_owen_scramble(v: torch.Tensor, seed) -> torch.Tensor:
    """FastOwenScrambler (sobol.jl:70-83) on 32-bit values; seed is a host
    int or a tensor of 32-bit values."""
    v = reverse_bits32(v)
    v = (v ^ (v * 0x3D20ADEA)) & MASK32
    v = (v + seed) & MASK32
    v = (v * ((seed >> 16) | 1)) & MASK32
    v = (v ^ (v * 0x05526C56)) & MASK32
    v = (v ^ (v * 0x53A22864)) & MASK32
    return reverse_bits32(v)
