"""ZSobol low-discrepancy sampler (pbrt-v4 ZSobolSampler).

Port of ``hikari_tpu/sampling/sobol.py`` on native ``int64``: Morton
indices, randomized base-4 digit permutations and generator-matrix Sobol
points with FastOwen scrambling. Every sample is a pure function of
(pixel, sample index, dimension, seed) and equals the JAX package's bit
for bit.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .._data import load_npy
from ..utils import profiling
from .hashes import MASK32, as_i64, fast_owen_scramble, hash_u32x2_int, mix_bits, shr

SOBOL_MATRIX_SIZE = 52
ONE_MINUS_EPSILON = float(np.float32(1.0 - 2**-24))
FLOAT32_SCALE = 2.3283064365386963e-10  # 2^-32

# 24 permutations of base-4 digits (sobol.jl:157-186)
_PERMUTATIONS = [
    [0, 1, 2, 3], [0, 1, 3, 2], [0, 2, 1, 3], [0, 2, 3, 1],
    [0, 3, 2, 1], [0, 3, 1, 2], [1, 0, 2, 3], [1, 0, 3, 2],
    [1, 2, 0, 3], [1, 2, 3, 0], [1, 3, 2, 0], [1, 3, 0, 2],
    [2, 1, 0, 3], [2, 1, 3, 0], [2, 0, 1, 3], [2, 0, 3, 1],
    [2, 3, 0, 1], [2, 3, 1, 0], [3, 1, 2, 0], [3, 1, 0, 2],
    [3, 2, 1, 0], [3, 2, 0, 1], [3, 0, 2, 1], [3, 0, 1, 2],
]


@functools.cache
def sobol_matrices() -> np.ndarray:
    """(1024, 52) uint32 generator matrices (Joe-Kuo via pbrt-v4)."""
    return load_npy("sobol_matrices_32.npy")


@dataclass(frozen=True)
class ZSobolConfig:
    """Sampler parameters (reference SobolRNG, sobol.jl:326-392)."""

    log2_spp: int
    n_base4_digits: int
    width: int
    seed: int


@profiling.spanned("hikari.sampler")
def make_zsobol(width: int, height: int, samples_per_pixel: int, seed: int = 0):
    """compute_zsobol_params (sobol.jl:313-323)."""
    log2_spp = int(np.ceil(np.log2(max(1, samples_per_pixel))))
    res_log2 = int(np.ceil(np.log2(max(width, height, 1))))
    log4_spp = (log2_spp + 1) // 2
    return ZSobolConfig(log2_spp=log2_spp, n_base4_digits=res_log2 + log4_spp,
                        width=width, seed=int(seed) & MASK32)


def _spread32(x: torch.Tensor) -> torch.Tensor:
    """Spread the 32 bits of x over the even bits of a 64-bit pattern."""

    def spread16(v):
        v = v & 0xFFFF
        v = (v ^ (v << 8)) & 0x00FF00FF
        v = (v ^ (v << 4)) & 0x0F0F0F0F
        v = (v ^ (v << 2)) & 0x33333333
        return (v ^ (v << 1)) & 0x55555555

    x = x.long() & MASK32
    return (spread16(x >> 16) << 32) | spread16(x)


def encode_morton2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Interleave x (even bits) and y (odd bits) (sobol.jl:54-60)."""
    return (_spread32(y) << 1) | _spread32(x)


def zsobol_get_sample_index(morton: torch.Tensor, dimension: int,
                            log2_spp: int, n_base4_digits: int) -> torch.Tensor:
    """Randomized base-4 digit permutation of the Morton index
    (sobol.jl:219-258)."""
    perms = torch.tensor(_PERMUTATIONS, dtype=torch.int64, device=morton.device)
    profiling.host_sync("sobol.perms", morton.device)
    sample_index = torch.zeros_like(morton)
    pow2 = log2_spp & 1
    dim_mix = as_i64(0x55555555 * int(dimension))
    for i in range(n_base4_digits - 1, pow2 - 1, -1):
        digit_shift = max(0, 2 * i - pow2)
        digit = shr(morton, digit_shift) & 3
        hash_val = mix_bits(shr(morton, digit_shift + 2) ^ dim_mix)
        p = shr(hash_val, 24) % 24
        sample_index = sample_index | (perms[p, digit] << digit_shift)
    if pow2:
        digit = morton & 1
        xor_bit = mix_bits(shr(morton, 1) ^ dim_mix) & 1
        sample_index = sample_index | (digit ^ xor_bit)
    return sample_index


def sobol_sample_u32(index: torch.Tensor, dimension: int, max_bits: int):
    """XOR of the generator-matrix rows selected by the bits of index
    (sobol.jl:100-129); unscrambled 32-bit result."""
    rows = sobol_matrices()[dimension, :max_bits]
    v = torch.zeros_like(index)
    for b in range(max_bits):
        v = v ^ (int(rows[b]) & -(shr(index, b) & 1))
    return v


def _finalize(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(v.to(torch.float32) * FLOAT32_SCALE, max=ONE_MINUS_EPSILON)


def morton_index(cfg: ZSobolConfig, px, py, sample_idx) -> torch.Tensor:
    """Shared per-(pixel, sample) Morton index (sobol.jl:274-276)."""
    m = encode_morton2(px, py) << cfg.log2_spp
    return m | (torch.as_tensor(sample_idx, device=m.device).long() & MASK32)


def _scrambled(cfg, mort, dim: int, sobol_dim: int, seed_hash: int):
    max_bits = min(2 * cfg.n_base4_digits, SOBOL_MATRIX_SIZE)
    idx = zsobol_get_sample_index(mort, dim, cfg.log2_spp, cfg.n_base4_digits)
    v = sobol_sample_u32(idx, sobol_dim, max_bits)
    return _finalize(fast_owen_scramble(v, seed_hash))


def sample_1d(cfg: ZSobolConfig, px, py, sample_idx, dim: int) -> torch.Tensor:
    """1D sample at dimension dim (sobol.jl:268-282)."""
    mort = morton_index(cfg, px, py, sample_idx)
    h = hash_u32x2_int(dim + 1, cfg.seed)
    return _scrambled(cfg, mort, dim, 0, h & MASK32)


def sample_2d(cfg: ZSobolConfig, px, py, sample_idx, dim: int):
    """2D sample at dimension dim (sobol.jl:289-310)."""
    mort = morton_index(cfg, px, py, sample_idx)
    h = hash_u32x2_int(dim + 2, cfg.seed)
    u1 = _scrambled(cfg, mort, dim, 0, h & MASK32)
    u2 = _scrambled(cfg, mort, dim, 1, (h >> 32) & MASK32)
    return u1, u2


@dataclass
class PixelSample:
    """Camera-stage sample values (reference PixelSample)."""

    jitter: torch.Tensor        # (..., 2)
    wavelength_u: torch.Tensor  # (...,)
    lens: torch.Tensor          # (..., 2)
    time: torch.Tensor          # (...,)


@profiling.spanned("hikari.sampler")
def compute_pixel_sample(cfg: ZSobolConfig, px, py, sample_idx) -> PixelSample:
    """Camera dims {lambda:1, jitter:3, time:4, lens:6} (sobol.jl:437-446)."""
    wavelength_u = sample_1d(cfg, px, py, sample_idx, 1)
    jx, jy = sample_2d(cfg, px, py, sample_idx, 3)
    time = sample_1d(cfg, px, py, sample_idx, 4)
    lu, lv = sample_2d(cfg, px, py, sample_idx, 6)
    return PixelSample(jitter=torch.stack([jx, jy], -1),
                       wavelength_u=wavelength_u,
                       lens=torch.stack([lu, lv], -1), time=time)


@profiling.spanned("hikari.sampler")
def path_sample_1d(cfg, px, py, sample_idx, depth: int, local_dim: int):
    """Path dims: base 6 + 11 per depth (see the JAX docstring for the
    per-depth dimension budget)."""
    return sample_1d(cfg, px, py, sample_idx, 6 + depth * 11 + local_dim)


@profiling.spanned("hikari.sampler")
def path_sample_2d(cfg, px, py, sample_idx, depth: int, local_dim: int):
    return sample_2d(cfg, px, py, sample_idx, 6 + depth * 11 + local_dim)
