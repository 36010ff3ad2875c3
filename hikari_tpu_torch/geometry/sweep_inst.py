"""The two instanced treelet sweeps: wrappers, CUDA kernels, plain PyTorch
versions.

``closest_inst`` replaces the Pallas kernel ``_closest_inst_kernel``
(``hikari_tpu/geometry/instanced.py:146``) and ``occlusion_inst`` replaces
``_occlusion_inst_kernel`` (``instanced.py:194``), both launched there by
``_sweep_chunks_inst``. On a CUDA tensor each wrapper launches its
hand-written kernel from ``csrc/sweep_inst.cu`` (built with nvcc at first
use) or raises; the plain PyTorch version beside it runs only for tensors
on the CPU, and on the card only when a caller compares it with the
kernel. Launches and plain runs on CUDA are counted in ``sweep.launches``
and ``sweep.plain_cuda_runs``.

The pair list is the flat sweeps' (``sweep.py``), over world treelets:
tile i walks ``seg[i]:seg[i+1]`` while ``tn_bits[p] < thr``. World
treelet ``wt = tre[p]`` names the shared object-space coefficient block
``coef[ti_obj[wt]]`` and the instance matrix ``A = inst_a[ti_inst[wt]]``
(``[o, 1] @ A`` is the object-space origin, ``[d, 0] @ A`` the unnormalised
object-space direction, so t is the world t). Per triangle

    t = -num / (|den| < 1e-20 ? 1e-20 : den),  u = au + t bu,  v = av + t bv

with num, au, av the rows [n | dw], [a_u | b_u], [a_v | b_v] dotted with
the object-space [o, 1] and den, bu, bv with [d, 0]. A hit needs
``|den| > 1e-20``, ``u, v >= -1e-6``, ``u + v <= 1 + 1e-6`` and
``t > 1e-4``; NaN fails every compare.

* closest: the carry is exact (t, tri, b1, b2), t starting at the lane's
  reach, tri at -1. Within a treelet the smallest t wins, the lowest
  column among equal t; the treelet's best replaces the carry only if
  strictly smaller. tri = wt * 256 + column. ``thr = max(bits(t))``.
* occlusion: a lane is occluded once any hit has ``t < tmax``;
  ``thr = max(bits(tmax))`` over the tile's unoccluded lanes.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .._build import build_shared_library
from .sweep import (NVCC_FLAGS, RAY_TILE, TREELET, _check, _check_sweep, _nvcc,
                    _live_reach_bits, _reach_bits, _stream, _walk, launches,
                    plain_cuda_runs, tests_needed)

_EPS = 1e-6
_T_MIN = 1e-4
_DEN_MIN = 1e-20
_MISS_T = 3.0e38

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "sweep_inst.cu"


# --- plain PyTorch versions ------------------------------------------------------


def _to_object(o, d, a):
    """(C, L, 3) world rays x (C, 4, 4) instance matrices -> object-space
    [o, 1] @ A and [d, 0] @ A, each (C, L, 4)."""
    rows = [a[:, None, i, :] for i in range(4)]
    o4 = o[..., 0:1] * rows[0] + o[..., 1:2] * rows[1] + o[..., 2:3] * rows[2] + rows[3]
    d4 = d[..., 0:1] * rows[0] + d[..., 1:2] * rows[1] + d[..., 2:3] * rows[2]
    return o4, d4


def _block_tuv_inst(o4, d4, coef):
    """(C, L, 4) object-space rays x (C, TT, 12) coefficients -> t, u, v
    and the hit mask, each (C, L, TT)."""
    def dot4(g, x):  # g (C, TT, 4), x (C, L, 4) -> (C, L, TT)
        return (x[:, :, None, 0] * g[:, None, :, 0] + x[:, :, None, 1] * g[:, None, :, 1]
                + x[:, :, None, 2] * g[:, None, :, 2] + x[:, :, None, 3] * g[:, None, :, 3])

    pn, pu, pv = coef[..., 0:4], coef[..., 4:8], coef[..., 8:12]
    den = dot4(pn, d4)
    small = torch.abs(den) < _DEN_MIN
    t = -dot4(pn, o4) / torch.where(small, _DEN_MIN, den)
    u = dot4(pu, o4) + t * dot4(pu, d4)
    v = dot4(pv, o4) + t * dot4(pv, d4)
    hit = ((torch.abs(den) > _DEN_MIN) & (u >= -_EPS) & (v >= -_EPS)
           & (u + v <= 1.0 + _EPS) & (t > _T_MIN))
    return t, u, v, hit


def _pair_blocks(o_t, d_t, idx, p, tre, ti_obj, ti_inst, coef, inst_a):
    wt = tre[p].long()
    o4, d4 = _to_object(o_t[idx], d_t[idx], inst_a[ti_inst[wt].long()])
    return wt, _block_tuv_inst(o4, d4, coef[ti_obj[wt].long()])


def closest_inst_plain(o, d, t_in, tre, tn_bits, seg, ti_obj, ti_inst, coef, inst_a,
                       stats=None):
    """Plain PyTorch instanced closest-hit sweep with the kernel's signature.
    stats: optional dict that receives the (tile, pair) sweeps made
    ("pairs") and the ray-triangle tests they need ("tests")."""
    if o.is_cuda:
        plain_cuda_runs["closest_inst"] += 1
    n_tiles = seg.numel() - 1
    t_c = t_in.clone().view(n_tiles, RAY_TILE)
    tri = torch.full_like(t_c, -1, dtype=torch.int32)
    b1, b2 = torch.zeros_like(t_c), torch.zeros_like(t_c)
    o_t, d_t = o.view(n_tiles, RAY_TILE, 3), d.view(n_tiles, RAY_TILE, 3)
    cols = torch.arange(TREELET, dtype=torch.int32, device=o.device)
    thr = t_c.view(torch.int32).amax(1)
    tests = 0

    def step(idx, p):
        nonlocal tests
        if stats is not None:
            tests += tests_needed(t_c[idx].view(torch.int32), tn_bits[p])
        wt, (t, u, v, hit) = _pair_blocks(o_t, d_t, idx, p, tre, ti_obj, ti_inst,
                                          coef, inst_a)
        t_cand = torch.where(hit, t, _MISS_T)
        t_new = t_cand.amin(-1)
        j = torch.where(t_cand <= t_new[..., None], cols, 2 ** 30).amin(-1)
        jl = j.long()[..., None]
        better = t_new < t_c[idx]
        t_c[idx] = torch.where(better, t_new, t_c[idx])
        tri[idx] = torch.where(better, wt[:, None].to(torch.int32) * TREELET + j, tri[idx])
        b1[idx] = torch.where(better, torch.gather(u, -1, jl)[..., 0], b1[idx])
        b2[idx] = torch.where(better, torch.gather(v, -1, jl)[..., 0], b2[idx])
        return t_c[idx].view(torch.int32).amax(1)

    _walk(seg, tn_bits, thr, step, stats)
    if stats is not None:
        stats["tests"] = tests
    return t_c.view(-1), tri.view(-1), b1.view(-1), b2.view(-1)


def occlusion_inst_plain(o, d, tmax, occ_in, tre, tn_bits, seg, ti_obj, ti_inst, coef,
                         inst_a, stats=None):
    """Plain PyTorch instanced occlusion sweep with the kernel's signature
    (stats as in closest_inst_plain)."""
    if o.is_cuda:
        plain_cuda_runs["occlusion_inst"] += 1
    n_tiles = seg.numel() - 1
    occ = occ_in.clone().view(n_tiles, RAY_TILE)
    tm = tmax.view(n_tiles, RAY_TILE)
    o_t, d_t = o.view(n_tiles, RAY_TILE, 3), d.view(n_tiles, RAY_TILE, 3)
    thr = _reach_bits(occ, tm)
    tests = 0

    def step(idx, p):
        nonlocal tests
        if stats is not None:
            tests += tests_needed(_live_reach_bits(occ[idx], tm[idx]), tn_bits[p])
        _, (t, _, _, hit) = _pair_blocks(o_t, d_t, idx, p, tre, ti_obj, ti_inst,
                                         coef, inst_a)
        hit = hit & (t < tm[idx][..., None])
        occ[idx] = occ[idx] | hit.any(-1).to(torch.int32)
        return _reach_bits(occ[idx], tm[idx])

    _walk(seg, tn_bits, thr, step, stats)
    if stats is not None:
        stats["tests"] = tests
    return occ.view(-1)


# --- CUDA kernels -------------------------------------------------------------------


@functools.cache
def inst_library() -> ctypes.CDLL:
    """Build (at first use) and load csrc/sweep_inst.cu."""
    import subprocess

    try:
        path = build_shared_library("sweep_inst", _SOURCE, [_nvcc(), *NVCC_FLAGS])
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed to build {_SOURCE}:\n{e.stderr}") from e
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hikari_closest_inst.argtypes = [p] * 14 + [i, p]
    lib.hikari_closest_inst.restype = i
    lib.hikari_occlusion_inst.argtypes = [p] * 12 + [i, p]
    lib.hikari_occlusion_inst.restype = i
    return lib


def _check_inst(o, d, lane_args, tre, tn_bits, seg, ti_obj, ti_inst, coef, inst_a):
    n_tiles = _check_sweep(o, d, lane_args, tre, tn_bits, seg, coef)
    _check("ti_obj", ti_obj, torch.int32, None, o.device)
    _check("ti_inst", ti_inst, torch.int32, tuple(ti_obj.shape), o.device)
    _check("inst_a", inst_a, torch.float32, None, o.device)
    if inst_a.dim() != 3 or inst_a.shape[1:] != (4, 4):
        raise ValueError(f"inst_a: shape {tuple(inst_a.shape)}, expected (I, 4, 4)")
    return n_tiles


def closest_inst(o, d, t_in, tre, tn_bits, seg, ti_obj, ti_inst, coef, inst_a):
    """Instanced closest-hit sweep -> (t, tri, b1, b2), each (n,); t_in is
    the lanes' reach, kept as t where nothing nearer is hit (tri = -1)."""
    if o.device.type == "cpu":
        return closest_inst_plain(o, d, t_in, tre, tn_bits, seg, ti_obj, ti_inst, coef,
                                  inst_a)
    n_tiles = _check_inst(o, d, [("t_in", t_in, torch.float32)], tre, tn_bits, seg,
                          ti_obj, ti_inst, coef, inst_a)
    t, b1, b2 = (torch.empty_like(t_in) for _ in range(3))
    tri = torch.empty(t_in.shape, dtype=torch.int32, device=o.device)
    if n_tiles == 0:
        return t, tri, b1, b2
    err = inst_library().hikari_closest_inst(
        o.data_ptr(), d.data_ptr(), t_in.data_ptr(), tre.data_ptr(),
        tn_bits.data_ptr(), seg.data_ptr(), ti_obj.data_ptr(), ti_inst.data_ptr(),
        coef.data_ptr(), inst_a.data_ptr(), t.data_ptr(), tri.data_ptr(),
        b1.data_ptr(), b2.data_ptr(), n_tiles, _stream(o.device))
    if err:
        raise RuntimeError(f"hikari_closest_inst launch failed: cudaError {err}")
    launches["closest_inst"] += 1
    return t, tri, b1, b2


def occlusion_inst(o, d, tmax, occ_in, tre, tn_bits, seg, ti_obj, ti_inst, coef, inst_a):
    """Instanced occlusion sweep -> occ, (n,) int32 (1 = occluded)."""
    if o.device.type == "cpu":
        return occlusion_inst_plain(o, d, tmax, occ_in, tre, tn_bits, seg, ti_obj,
                                    ti_inst, coef, inst_a)
    n_tiles = _check_inst(o, d, [("tmax", tmax, torch.float32),
                                 ("occ_in", occ_in, torch.int32)],
                          tre, tn_bits, seg, ti_obj, ti_inst, coef, inst_a)
    occ = torch.empty_like(occ_in)
    if n_tiles == 0:
        return occ
    err = inst_library().hikari_occlusion_inst(
        o.data_ptr(), d.data_ptr(), tmax.data_ptr(), occ_in.data_ptr(), tre.data_ptr(),
        tn_bits.data_ptr(), seg.data_ptr(), ti_obj.data_ptr(), ti_inst.data_ptr(),
        coef.data_ptr(), inst_a.data_ptr(), occ.data_ptr(), n_tiles, _stream(o.device))
    if err:
        raise RuntimeError(f"hikari_occlusion_inst launch failed: cudaError {err}")
    launches["occlusion_inst"] += 1
    return occ
