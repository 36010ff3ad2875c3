"""The two pair-grid treelet sweeps: wrappers, CUDA kernels, plain PyTorch
versions.

``closest_pairs`` replaces the Pallas kernel ``_closest_pairs_kernel``
(``hikari_tpu/geometry/wavefront.py:773``) and ``occlusion_pairs``
replaces ``_occlusion_pairs_kernel`` (``wavefront.py:827``), both launched
there by ``_sweep_chunks`` when ``HIKARI_SWEEP`` is not ``tile``. On a CUDA
tensor each wrapper launches its hand-written kernel from
``csrc/sweep_pairs.cu`` (built with nvcc at first use) or raises; the plain
PyTorch version beside it runs only for tensors on the CPU, and on the card
only when a caller compares it with the kernel. Launches and plain runs on
CUDA are counted in the package's launch record (``_build.launches`` and
``_build.plain_cuda_runs``).

The pair list and the signatures are the tile sweeps' (``sweep.py``). The
TPU runs one grid step per pair in list order; a pair is skipped (not a
loop break) when ``tn_bits[p] >= thr``, with thr the tile's threshold as
the pairs before it left it. Along a tile's segment the entry distances
rise and the threshold never rises, so once a pair is skipped every later
pair of the tile is skipped too: skipping is the tile sweeps' break, and
the plain versions are their walk with this module's hit test.

The hit test differs from the tile sweeps' (``_bw_block`` at
``wavefront.py:713`` against ``_bw_block_lean``): den is clamped to 1e-20
before the divide where ``|den| < 1e-20``, and a hit needs ``|den| >
1e-20``, ``u, v >= -1e-6``, ``u + v <= 1 + 1e-6`` and ``t > 1e-4``. The TPU
divides with an approximate reciprocal and one Newton step
(``RECIP="newton"``); the port divides in IEEE float32, as K1 does.

The kernels are the body of the tile kernels (``csrc/sweep_grid.cuh``) with
this hit test (``csrc/sweep_pairs.cu``): the closest result is the minimum
over every listed pair of ``(key, rank of the pair in its tile's
segment)``, which differs from the walk's only where two hits tie in the
key's upper 24 bits, and the occlusion result is the walk's. Their
pre-test is the tile kernels', whose mirror ``sweep.may_hit_plain`` takes
``_block_hit_pairs`` in ``sweep.pretest_drops``; ``key_in`` must lie in
``[0, bits(3.0e38)]`` as there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..utils import profiling
from .sweep import (CLOSEST_ARGS, EPS, OCCLUSION_ARGS, T_MIN, affine, closest_grid,
                    closest_walk, occlusion_grid, occlusion_walk)

_DEN_MIN = 1e-20

_SOURCE = _build.CSRC / "sweep_pairs.cu"


# --- plain PyTorch versions ------------------------------------------------------


def _block_hit_pairs(o, d, coef):
    """(C, L, 3) rays x (C, TT, 12) coefficients -> t and the hit mask, each
    (C, L, TT), with the pair kernels' clamped divide and predicate."""
    n, dw = coef[..., 0:3], coef[..., 3]
    au, bu = coef[..., 4:7], coef[..., 7]
    av, bv = coef[..., 8:11], coef[..., 11]
    den = affine(n, d, None)
    t = -affine(n, o, dw) / torch.where(torch.abs(den) < _DEN_MIN, _DEN_MIN, den)
    u = affine(au, o, bu) + t * affine(au, d, None)
    v = affine(av, o, bv) + t * affine(av, d, None)
    hit = ((torch.abs(den) > _DEN_MIN) & (u >= -EPS) & (v >= -EPS)
           & (u + v <= 1.0 + EPS) & (t > T_MIN))
    return t, hit


def closest_pairs_plain(o, d, key_in, tr_in, tre, tn_bits, seg, coef, stats=None):
    """Plain PyTorch pair-grid closest-hit sweep with the kernel's signature
    (stats as in sweep.closest_tiles_plain)."""
    if o.is_cuda:
        _build.plain_cuda_runs["closest_pairs"] += 1
    return closest_walk(o, d, key_in, tr_in, tre, tn_bits, seg, coef, _block_hit_pairs,
                        stats)


def occlusion_pairs_plain(o, d, tmax, occ_in, tre, tn_bits, seg, coef, stats=None):
    """Plain PyTorch pair-grid occlusion sweep with the kernel's signature."""
    if o.is_cuda:
        _build.plain_cuda_runs["occlusion_pairs"] += 1
    return occlusion_walk(o, d, tmax, occ_in, tre, tn_bits, seg, coef, _block_hit_pairs,
                          stats)


# --- CUDA kernels -------------------------------------------------------------------

_library = functools.partial(_build.library, "sweep_pairs", _SOURCE, {
    "hikari_closest_pairs": CLOSEST_ARGS, "hikari_occlusion_pairs": OCCLUSION_ARGS,
    "hikari_pairs_attributes": [ctypes.c_void_p]})


def kernel_attributes() -> dict:
    """{kernel: (registers a thread, spill bytes a thread, resident blocks
    per SM)} of the two pair-grid kernels, as the CUDA runtime reports them."""
    return _build.kernel_attributes(_library().hikari_pairs_attributes,
                                    ("closest_pairs", "occlusion_pairs"))


@profiling.spanned("hikari.sweep")
def closest_pairs(o, d, key_in, tr_in, tre, tn_bits, seg, coef):
    """Pair-grid closest-hit sweep -> (key, tr), each (n,) int32."""
    if o.device.type == "cpu":
        return closest_pairs_plain(o, d, key_in, tr_in, tre, tn_bits, seg, coef)
    return closest_grid(_library, "hikari_closest_pairs", o, d, key_in, tr_in, tre, tn_bits,
                        seg, coef)


@profiling.spanned("hikari.sweep")
def occlusion_pairs(o, d, tmax, occ_in, tre, tn_bits, seg, coef):
    """Pair-grid occlusion sweep -> occ, (n,) int32 (1 = occluded)."""
    if o.device.type == "cpu":
        return occlusion_pairs_plain(o, d, tmax, occ_in, tre, tn_bits, seg, coef)
    return occlusion_grid(_library, "hikari_occlusion_pairs", o, d, tmax, occ_in, tre,
                          tn_bits, seg, coef)
