"""ZSobol low-discrepancy sampler (pbrt-v4 ZSobolSampler).

Port of ``hikari_tpu/sampling/sobol.py`` on native ``int64``: Morton
indices, randomized base-4 digit permutations and generator-matrix Sobol
points with FastOwen scrambling. Every sample is a pure function of
(pixel, sample index, dimension, seed) and equals the JAX package's bit
for bit.

The entry points (``compute_pixel_sample``, ``path_sample_1d``,
``path_sample_2d``) draw every scrambled dimension of a call on CUDA
tensors in one launch of ``csrc/zsobol.cu``, which computes the Morton
index, the digit permutation, the generator-matrix product and FastOwen
in registers and equals the plain version below bit for bit; on CPU
tensors they run the plain version (``sample_1d`` / ``sample_2d``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
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


def draw_plain(cfg: ZSobolConfig, px, py, sample_idx, draws) -> list:
    """The scrambled dimensions `draws` ((dim, sobol_dim, seed_hash) triples,
    as ``_scrambled`` takes them) of every lane, one tensor each, on int64
    tensor operations: the plain version of ``draw_kernel``."""
    mort = morton_index(cfg, px, py, sample_idx)
    return [_scrambled(cfg, mort, *d) for d in draws]


def sample_1d(cfg: ZSobolConfig, px, py, sample_idx, dim: int) -> torch.Tensor:
    """1D sample at dimension dim (sobol.jl:268-282)."""
    return draw_plain(cfg, px, py, sample_idx, draws_1d(cfg, dim))[0]


def sample_2d(cfg: ZSobolConfig, px, py, sample_idx, dim: int):
    """2D sample at dimension dim (sobol.jl:289-310)."""
    return tuple(draw_plain(cfg, px, py, sample_idx, draws_2d(cfg, dim)))


def draws_1d(cfg: ZSobolConfig, dim: int) -> list:
    """The (dim, sobol_dim, seed_hash) triple of a 1D sample, on host
    integers."""
    return [(dim, 0, hash_u32x2_int(dim + 1, cfg.seed) & MASK32)]


def draws_2d(cfg: ZSobolConfig, dim: int) -> list:
    """The two triples (u1, u2) of a 2D sample."""
    h = hash_u32x2_int(dim + 2, cfg.seed)
    return [(dim, 0, h & MASK32), (dim, 1, (h >> 32) & MASK32)]


def camera_draws(cfg: ZSobolConfig) -> list:
    """The camera stage's six triples: wavelength (dim 1), jitter x and y
    (3), time (4), lens u and v (6)."""
    return [*draws_1d(cfg, 1), *draws_2d(cfg, 3), *draws_1d(cfg, 4), *draws_2d(cfg, 6)]


# --- CUDA kernel -------------------------------------------------------------------

_SOURCE = _build.CSRC / "zsobol.cu"
MAX_DRAWS = 8  # dimensions a launch draws (zsobol.cu kMaxDraws)
MAX_BASE4_DIGITS = 32  # digits the kernel's 64-bit Morton index holds
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_library = functools.partial(_build.library, "zsobol", _SOURCE, {
    "hikari_zsobol": [_P, _I64, _P, _I64, _P, _I64, _I64, _I, _I, _I, _I] + [_P] * 6,
    "hikari_zsobol_attributes": [_P]})


def kernel_attributes() -> tuple:
    """(registers a thread, spill bytes a thread, resident blocks per SM) of
    the sampler kernel, as the CUDA runtime reports them."""
    return _build.kernel_attributes(_library().hikari_zsobol_attributes, ("zsobol",))["zsobol"]


def flat_lanes(px, py, sample_idx):
    """px, py and the sample index broadcast together -> their shape and
    three 1-D int64 views of its elements; an index given as one value
    (a number, a 0-dim tensor, or one expanded over the lanes) stays one,
    with stride 0."""
    px = torch.as_tensor(px)
    if not isinstance(sample_idx, torch.Tensor):
        sample_idx = torch.full((), int(sample_idx), dtype=torch.int64, device=px.device)
    px, py, si = torch.broadcast_tensors(
        *(torch.as_tensor(t, device=px.device).long() for t in (px, py, sample_idx)))
    return px.shape, [t.reshape(-1) for t in (px, py, si)]


def draw_kernel(cfg: ZSobolConfig, lanes, draws, outs) -> None:
    """Draw the scrambled dimensions `draws` ((dim, sobol_dim, seed_hash)
    triples, as ``_scrambled`` takes them) of every lane on the card, in one
    launch: draw j into outs[j], a 1-D float32 CUDA tensor (any stride) with
    an element a lane. lanes: ``flat_lanes``' three views. Raises on what
    the kernel does not take; there is no CPU version."""
    dev = lanes[0].device
    n = lanes[0].numel()
    if dev.type != "cuda":
        raise ValueError(f"draw_kernel runs the sampler kernel on the card, got {dev}")
    for t in lanes:
        if t.device != dev or t.dtype != torch.int64 or t.shape != (n,):
            raise ValueError(f"lanes must be three int64 ({n},) tensors on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not 1 <= len(draws) == len(outs) <= MAX_DRAWS:
        raise ValueError(f"draw_kernel takes 1 to {MAX_DRAWS} draws, each with an output; "
                         f"got {len(draws)} and {len(outs)}")
    if not 0 <= cfg.n_base4_digits <= MAX_BASE4_DIGITS or not 0 <= cfg.log2_spp < 64:
        raise ValueError(f"the sampler kernel takes at most {MAX_BASE4_DIGITS} base-4 digits "
                         f"and fewer than 2^64 samples a pixel, got {cfg}")
    for o in outs:
        if o.device != dev or o.dtype != torch.float32 or o.shape != (n,):
            raise ValueError(f"an output must be a float32 ({n},) tensor on {dev}, "
                             f"got {o.dtype} {tuple(o.shape)} on {o.device}")
    k = len(draws)
    dims = (ctypes.c_uint64 * k)(*(int(d) for d, _, _ in draws))
    sdims = (ctypes.c_int * k)(*(int(s) for _, s, _ in draws))
    seeds = (ctypes.c_uint32 * k)(*(int(h) & MASK32 for _, _, h in draws))
    out_ptrs = (ctypes.c_void_p * k)(*(o.data_ptr() for o in outs))
    strides = (ctypes.c_int64 * k)(*(o.stride(0) for o in outs))
    px, py, si = lanes
    _build.launch(
        _library().hikari_zsobol,
        px.data_ptr(), px.stride(0), py.data_ptr(), py.stride(0), si.data_ptr(), si.stride(0),
        n, cfg.log2_spp, cfg.n_base4_digits, min(2 * cfg.n_base4_digits, SOBOL_MATRIX_SIZE), k,
        dims, sdims, seeds, out_ptrs, strides, _build.stream(dev))


def _path_dim(depth: int, local_dim: int) -> int:
    """Path dims: base 6 + 11 per depth (see the JAX docstring for the
    per-depth dimension budget)."""
    return 6 + depth * 11 + local_dim


# --- entry points --------------------------------------------------------------------


@dataclass
class PixelSample:
    """Camera-stage sample values (reference PixelSample)."""

    jitter: torch.Tensor        # (..., 2)
    wavelength_u: torch.Tensor  # (...,)
    lens: torch.Tensor          # (..., 2)
    time: torch.Tensor          # (...,)


def _on_card(px) -> bool:
    return isinstance(px, torch.Tensor) and px.is_cuda


@profiling.spanned("hikari.sampler")
def compute_pixel_sample(cfg: ZSobolConfig, px, py, sample_idx) -> PixelSample:
    """Camera dims {lambda:1, jitter:3, time:4, lens:6} (sobol.jl:437-446)."""
    draws = camera_draws(cfg)
    if not _on_card(px):
        wavelength_u, jx, jy, time, lu, lv = draw_plain(cfg, px, py, sample_idx, draws)
        return PixelSample(jitter=torch.stack([jx, jy], -1),
                           wavelength_u=wavelength_u,
                           lens=torch.stack([lu, lv], -1), time=time)
    shape, lanes = flat_lanes(px, py, sample_idx)
    n = shape.numel()
    jitter, lens = (torch.empty((n, 2), dtype=torch.float32, device=px.device)
                    for _ in range(2))
    wavelength_u, time = (torch.empty(n, dtype=torch.float32, device=px.device)
                          for _ in range(2))
    draw_kernel(cfg, lanes, draws,
                [wavelength_u, jitter[:, 0], jitter[:, 1], time, lens[:, 0], lens[:, 1]])
    return PixelSample(jitter=jitter.view(*shape, 2), wavelength_u=wavelength_u.view(shape),
                       lens=lens.view(*shape, 2), time=time.view(shape))


@profiling.spanned("hikari.sampler")
def path_sample_1d(cfg, px, py, sample_idx, depth: int, local_dim: int):
    """1D sample at path dimension (depth, local_dim)."""
    return _path_draws(cfg, px, py, sample_idx, draws_1d(cfg, _path_dim(depth, local_dim)))[0]


@profiling.spanned("hikari.sampler")
def path_sample_2d(cfg, px, py, sample_idx, depth: int, local_dim: int):
    """2D sample (u1, u2) at path dimension (depth, local_dim)."""
    return _path_draws(cfg, px, py, sample_idx, draws_2d(cfg, _path_dim(depth, local_dim)))


def _path_draws(cfg, px, py, sample_idx, draws) -> tuple:
    """The path dims `draws` as tensors of the lanes' shape: on the card
    rows of one (k, n) output of one launch, elsewhere the plain version."""
    if not _on_card(px):
        return tuple(draw_plain(cfg, px, py, sample_idx, draws))
    shape, lanes = flat_lanes(px, py, sample_idx)
    out = torch.empty((len(draws), shape.numel()), dtype=torch.float32, device=px.device)
    draw_kernel(cfg, lanes, draws, list(out))
    return out.view(len(draws), *shape).unbind(0)
