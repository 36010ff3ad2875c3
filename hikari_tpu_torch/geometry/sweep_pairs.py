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
CUDA are counted in ``sweep.launches`` and ``sweep.plain_cuda_runs``.

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
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .._build import build_shared_library
from .sweep import (NVCC_FLAGS, _EPS, _T_MIN, _check_sweep, _nvcc, _stream,
                    affine, closest_walk, launches, occlusion_walk, plain_cuda_runs)

_DEN_MIN = 1e-20

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "sweep_pairs.cu"


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
    hit = ((torch.abs(den) > _DEN_MIN) & (u >= -_EPS) & (v >= -_EPS)
           & (u + v <= 1.0 + _EPS) & (t > _T_MIN))
    return t, hit


def closest_pairs_plain(o, d, key_in, tr_in, tre, tn_bits, seg, coef, stats=None):
    """Plain PyTorch pair-grid closest-hit sweep with the kernel's signature
    (stats as in sweep.closest_tiles_plain)."""
    if o.is_cuda:
        plain_cuda_runs["closest_pairs"] += 1
    return closest_walk(o, d, key_in, tr_in, tre, tn_bits, seg, coef, _block_hit_pairs,
                        stats)


def occlusion_pairs_plain(o, d, tmax, occ_in, tre, tn_bits, seg, coef, stats=None):
    """Plain PyTorch pair-grid occlusion sweep with the kernel's signature."""
    if o.is_cuda:
        plain_cuda_runs["occlusion_pairs"] += 1
    return occlusion_walk(o, d, tmax, occ_in, tre, tn_bits, seg, coef, _block_hit_pairs,
                          stats)


# --- CUDA kernels -------------------------------------------------------------------


@functools.cache
def pairs_library() -> ctypes.CDLL:
    """Build (at first use) and load csrc/sweep_pairs.cu."""
    import subprocess

    try:
        path = build_shared_library("sweep_pairs", _SOURCE, [_nvcc(), *NVCC_FLAGS])
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed to build {_SOURCE}:\n{e.stderr}") from e
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hikari_closest_pairs.argtypes = [p] * 12 + [i, i, p]
    lib.hikari_closest_pairs.restype = i
    lib.hikari_occlusion_pairs.argtypes = [p] * 9 + [i, i, p]
    lib.hikari_occlusion_pairs.restype = i
    return lib


def pair_schedule(seg: torch.Tensor, n_pairs: int):
    """The kernels' block order: (tile, order) of the pairs, ranked first by
    their rank within the tile's segment and then by tile, so every tile's
    nearest treelets are swept before any tile's second ones and the
    early-out sees their results. Both int32, (n_pairs,)."""
    dev = seg.device
    p = torch.arange(n_pairs, dtype=torch.int64, device=dev)
    tile = torch.searchsorted(seg[1:].long(), p, right=True)
    rank = p - seg.long()[tile]
    order = torch.argsort(rank * (seg.numel() - 1) + tile)
    return tile.to(torch.int32), order.to(torch.int32)


def closest_pairs(o, d, key_in, tr_in, tre, tn_bits, seg, coef):
    """Pair-grid closest-hit sweep -> (key, tr), each (n,) int32."""
    if o.device.type == "cpu":
        return closest_pairs_plain(o, d, key_in, tr_in, tre, tn_bits, seg, coef)
    n_tiles = _check_sweep(o, d, [("key_in", key_in, torch.int32),
                                  ("tr_in", tr_in, torch.int32)],
                           tre, tn_bits, seg, coef)
    key, tr = torch.empty_like(key_in), torch.empty_like(tr_in)
    if n_tiles == 0:
        return key, tr
    n_pairs = tre.numel()
    tile, order = pair_schedule(seg, n_pairs)
    best = torch.empty(key_in.shape, dtype=torch.int64, device=o.device)
    err = pairs_library().hikari_closest_pairs(
        o.data_ptr(), d.data_ptr(), key_in.data_ptr(), tr_in.data_ptr(),
        tre.data_ptr(), tn_bits.data_ptr(), tile.data_ptr(), order.data_ptr(),
        coef.data_ptr(), best.data_ptr(), key.data_ptr(), tr.data_ptr(),
        n_tiles, n_pairs, _stream(o.device))
    if err:
        raise RuntimeError(f"hikari_closest_pairs launch failed: cudaError {err}")
    launches["closest_pairs"] += 1
    return key, tr


def occlusion_pairs(o, d, tmax, occ_in, tre, tn_bits, seg, coef):
    """Pair-grid occlusion sweep -> occ, (n,) int32 (1 = occluded)."""
    if o.device.type == "cpu":
        return occlusion_pairs_plain(o, d, tmax, occ_in, tre, tn_bits, seg, coef)
    n_tiles = _check_sweep(o, d, [("tmax", tmax, torch.float32),
                                  ("occ_in", occ_in, torch.int32)],
                           tre, tn_bits, seg, coef)
    # the kernel updates the carry in place: tiles without a pair keep it
    occ = torch.empty_like(occ_in).copy_(occ_in)
    if n_tiles == 0:
        return occ
    n_pairs = tre.numel()
    tile, order = pair_schedule(seg, n_pairs)
    err = pairs_library().hikari_occlusion_pairs(
        o.data_ptr(), d.data_ptr(), tmax.data_ptr(), tre.data_ptr(), tn_bits.data_ptr(),
        tile.data_ptr(), order.data_ptr(), coef.data_ptr(), occ.data_ptr(),
        n_tiles, n_pairs, _stream(o.device))
    if err:
        raise RuntimeError(f"hikari_occlusion_pairs launch failed: cudaError {err}")
    launches["occlusion_pairs"] += 1
    return occ
