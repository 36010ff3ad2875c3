"""The two treelet sweeps of the main path: wrappers, CUDA kernels, plain
PyTorch versions.

``closest_tiles`` replaces the Pallas kernel ``_closest_tiles_kernel``
(``hikari_tpu/geometry/wavefront.py:999``) and ``occlusion_tiles`` replaces
``_occlusion_tiles_kernel`` (``wavefront.py:1052``), both launched there by
``_sweep_tiles``. On a CUDA tensor each wrapper launches its hand-written
kernel from ``csrc/sweep_tiles.cu`` (built with nvcc at first use) or
raises; the plain PyTorch version beside it runs only for tensors on the
CPU, and on the card only when a caller compares it with the kernel.

The contract, for tile i (lanes i*1024 .. i*1024+1023) and its pair
segment ``seg[i]:seg[i+1]`` of treelets ``tre`` in front-to-back order:
while ``p < end`` and ``tn_bits[p] < thr`` (int32 compare of the
conservative entry distance's bits), test every lane against the 256
triangles of treelet ``tre[p]``.

* closest: ``key = (bits(t) & ~COL_MASK) | column`` is minimised per lane
  over hits; a treelet's best replaces the carried key only if strictly
  smaller (earlier treelets win ties), recording ``tr = tre[p]``;
  ``thr = max(key | COL_MASK)`` over the tile.
* occlusion: a lane is occluded once any hit has ``t < tmax``;
  ``thr = max(bits(tmax))`` over the tile's unoccluded lanes.

A hit needs ``u, v, 1 + eps - (u + v) >= -eps`` and ``t > 1e-4``, eps =
1e-6; NaN and inf from degenerate or padding triangles fail every compare.
"""

from __future__ import annotations

import ctypes
import functools
import shutil
from pathlib import Path

import torch

from .._build import build_shared_library

RAY_TILE = 1024
TREELET = 256
COL_BITS = 8
COL_MASK = (1 << COL_BITS) - 1
_EPS = 1e-6
_T_MIN = 1e-4
_MISS_T = 3.0e38
_PLAIN_TILES = 16  # tiles per step of the plain versions: (16, 1024, 256) blocks

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "sweep_tiles.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# kernel launches, counted by the wrappers where they launch and nowhere
# else (the instanced sweeps of sweep_inst.py and the pair-grid sweeps of
# sweep_pairs.py count here too)
_KERNELS = ("closest_tiles", "occlusion_tiles", "closest_inst", "occlusion_inst",
            "closest_pairs", "occlusion_pairs")
launches = dict.fromkeys(_KERNELS, 0)
# plain-version runs on CUDA tensors (comparisons with the kernels only)
plain_cuda_runs = dict.fromkeys(_KERNELS, 0)


def reset_counts() -> None:
    for counts in (launches, plain_cuda_runs):
        for k in counts:
            counts[k] = 0


# --- plain PyTorch versions ------------------------------------------------------


def affine(g, x, w):
    """(C, TT, 3) coefficient columns g and (C, TT) offsets w (or None)
    against (C, L, 3) rays x -> x . g + w of (C, L, TT)."""
    return (x[:, :, None, 0] * g[:, None, :, 0] + x[:, :, None, 1] * g[:, None, :, 1]
            + x[:, :, None, 2] * g[:, None, :, 2]) + (0.0 if w is None else w[:, None, :])


def _block_hit(o, d, coef):
    """(C, L, 3) rays x (C, TT, 12) coefficients -> t and the hit mask, each
    (C, L, TT)."""
    n, dw = coef[..., 0:3], coef[..., 3]
    au, bu = coef[..., 4:7], coef[..., 7]
    av, bv = coef[..., 8:11], coef[..., 11]
    t = -affine(n, o, dw) / affine(n, d, None)
    u = affine(au, o, bu) + t * affine(au, d, None)
    v = affine(av, o, bv) + t * affine(av, d, None)
    w = (1.0 + _EPS) - (u + v)
    return t, (u >= -_EPS) & (v >= -_EPS) & (w >= -_EPS) & (t > _T_MIN)


def _walk(seg, tn_bits, thr, step, stats=None):
    """Walk every tile's segment by pair rank k with the early-out; step(idx,
    p) sweeps tiles idx at pairs p and returns their new thresholds. stats:
    optional dict that receives the number of (tile, pair) sweeps made
    under "pairs"."""
    start = seg[:-1].long()
    length = (seg[1:] - seg[:-1]).long()
    running = length > 0
    k = swept = 0
    while True:
        p = start + k
        pc = torch.clamp(p, max=max(tn_bits.numel() - 1, 0))
        running = running & (k < length)
        if tn_bits.numel():
            running = running & (tn_bits[pc] < thr)
        idx = running.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        swept += idx.numel()
        for chunk in idx.split(_PLAIN_TILES):
            thr[chunk] = step(chunk, p[chunk])
        k += 1
    if stats is not None:
        stats["pairs"] = swept


def tests_needed(bound_bits, tn_bits_p) -> int:
    """Ray-triangle tests a step of a walk needs: TREELET for every lane of
    (C, L) bound_bits (a closest key | COL_MASK, or an unoccluded lane's
    reach bits) above its pair's entry distance tn_bits_p (C,); no other
    lane can gain from the treelet."""
    return int((bound_bits > tn_bits_p[:, None]).sum()) * TREELET


def closest_walk(o, d, key_in, tr_in, tre, tn_bits, seg, coef, block_hit, stats=None):
    """The closest-hit walk of the contract above with the hit test
    block_hit(o, d, coef) -> (t, hit): the plain version of K1 and, with
    its own hit test, of the pair-grid K5 (sweep_pairs.py)."""
    n_tiles = seg.numel() - 1
    key = key_in.clone().view(n_tiles, RAY_TILE)
    tr = tr_in.clone().view(n_tiles, RAY_TILE)
    o_t, d_t = o.view(n_tiles, RAY_TILE, 3), d.view(n_tiles, RAY_TILE, 3)
    cols = torch.arange(TREELET, dtype=torch.int32, device=o.device)
    thr = (key | COL_MASK).amax(1)
    tests = 0

    def step(idx, p):
        nonlocal tests
        tre_c = tre[p].long()
        if stats is not None:
            tests += tests_needed(key[idx] | COL_MASK, tn_bits[p])
        t, hit = block_hit(o_t[idx], d_t[idx], coef[tre_c])
        bits = torch.where(hit, t, _MISS_T).view(torch.int32)
        key_new = ((bits & ~COL_MASK) | cols).amin(-1)
        better = key_new < key[idx]
        key[idx] = torch.where(better, key_new, key[idx])
        tr[idx] = torch.where(better, tre_c[:, None].to(torch.int32), tr[idx])
        return (key[idx] | COL_MASK).amax(1)

    _walk(seg, tn_bits, thr, step, stats)
    if stats is not None:
        stats["tests"] = tests
    return key.view(-1), tr.view(-1)


def _live_reach_bits(occ, tmax):
    """Per lane: the bits of its reach while unoccluded, else 0."""
    return torch.where(occ == 0, tmax, 0.0).view(torch.int32)


def _reach_bits(occ, tmax):
    return _live_reach_bits(occ, tmax).amax(1)


def occlusion_walk(o, d, tmax, occ_in, tre, tn_bits, seg, coef, block_hit, stats=None):
    """The occlusion walk of the contract above with the hit test
    block_hit(o, d, coef) -> (t, hit): the plain version of K2 and, with
    its own hit test, of the pair-grid K6 (sweep_pairs.py)."""
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
        t, hit = block_hit(o_t[idx], d_t[idx], coef[tre[p].long()])
        hit = hit & (t < tm[idx][..., None])
        occ[idx] = occ[idx] | hit.any(-1).to(torch.int32)
        return _reach_bits(occ[idx], tm[idx])

    _walk(seg, tn_bits, thr, step, stats)
    if stats is not None:
        stats["tests"] = tests
    return occ.view(-1)


def closest_tiles_plain(o, d, key_in, tr_in, tre, tn_bits, seg, coef, stats=None):
    """Plain PyTorch closest-hit sweep with the kernel's signature. stats:
    optional dict that receives the (tile, pair) sweeps made ("pairs") and
    the ray-triangle tests they need ("tests")."""
    if o.is_cuda:
        plain_cuda_runs["closest_tiles"] += 1
    return closest_walk(o, d, key_in, tr_in, tre, tn_bits, seg, coef, _block_hit, stats)


def occlusion_tiles_plain(o, d, tmax, occ_in, tre, tn_bits, seg, coef, stats=None):
    """Plain PyTorch occlusion sweep with the kernel's signature (stats as in
    closest_tiles_plain)."""
    if o.is_cuda:
        plain_cuda_runs["occlusion_tiles"] += 1
    return occlusion_walk(o, d, tmax, occ_in, tre, tn_bits, seg, coef, _block_hit, stats)


# --- CUDA kernels -------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the sweep kernels are built with the "
                       "CUDA toolkit at first use on a CUDA tensor")


@functools.cache
def sweep_library() -> ctypes.CDLL:
    """Build (at first use) and load csrc/sweep_tiles.cu."""
    import subprocess

    try:
        path = build_shared_library("sweep_tiles", _SOURCE, [_nvcc(), *NVCC_FLAGS])
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed to build {_SOURCE}:\n{e.stderr}") from e
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hikari_closest_tiles.argtypes = [p] * 10 + [i, p]
    lib.hikari_closest_tiles.restype = i
    lib.hikari_occlusion_tiles.argtypes = [p] * 9 + [i, p]
    lib.hikari_occlusion_tiles.restype = i
    return lib


def _check(name, x, dtype, shape, device):
    if x.device != device or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {device}, "
                         f"got {x.dtype} on {x.device} (contiguous="
                         f"{x.is_contiguous()})")
    if shape is not None and tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")


def _check_sweep(o, d, lane_args, tre, tn_bits, seg, coef):
    if o.device.type != "cuda":
        raise ValueError(f"the sweep kernels take CUDA or CPU tensors, got {o.device}")
    n_tiles = seg.numel() - 1
    n = n_tiles * RAY_TILE
    dev = o.device
    _check("o", o, torch.float32, (n, 3), dev)
    _check("d", d, torch.float32, (n, 3), dev)
    for name, x, dtype in lane_args:
        _check(name, x, dtype, (n,), dev)
    _check("tre", tre, torch.int32, None, dev)
    _check("tn_bits", tn_bits, torch.int32, tuple(tre.shape), dev)
    _check("seg", seg, torch.int32, (n_tiles + 1,), dev)
    _check("coef", coef, torch.float32, None, dev)
    if coef.dim() != 3 or coef.shape[1:] != (TREELET, 12):
        raise ValueError(f"coef: shape {tuple(coef.shape)}, expected (T, {TREELET}, 12)")
    return n_tiles


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def closest_tiles(o, d, key_in, tr_in, tre, tn_bits, seg, coef):
    """Closest-hit treelet sweep -> (key, tr), each (n,) int32."""
    if o.device.type == "cpu":
        return closest_tiles_plain(o, d, key_in, tr_in, tre, tn_bits, seg, coef)
    n_tiles = _check_sweep(o, d, [("key_in", key_in, torch.int32),
                                  ("tr_in", tr_in, torch.int32)],
                           tre, tn_bits, seg, coef)
    key, tr = torch.empty_like(key_in), torch.empty_like(tr_in)
    if n_tiles == 0:
        return key, tr
    err = sweep_library().hikari_closest_tiles(
        o.data_ptr(), d.data_ptr(), key_in.data_ptr(), tr_in.data_ptr(),
        tre.data_ptr(), tn_bits.data_ptr(), seg.data_ptr(), coef.data_ptr(),
        key.data_ptr(), tr.data_ptr(), n_tiles, _stream(o.device))
    if err:
        raise RuntimeError(f"hikari_closest_tiles launch failed: cudaError {err}")
    launches["closest_tiles"] += 1
    return key, tr


def occlusion_tiles(o, d, tmax, occ_in, tre, tn_bits, seg, coef):
    """Occlusion treelet sweep -> occ, (n,) int32 (1 = occluded)."""
    if o.device.type == "cpu":
        return occlusion_tiles_plain(o, d, tmax, occ_in, tre, tn_bits, seg, coef)
    n_tiles = _check_sweep(o, d, [("tmax", tmax, torch.float32),
                                  ("occ_in", occ_in, torch.int32)],
                           tre, tn_bits, seg, coef)
    occ = torch.empty_like(occ_in)
    if n_tiles == 0:
        return occ
    err = sweep_library().hikari_occlusion_tiles(
        o.data_ptr(), d.data_ptr(), tmax.data_ptr(), occ_in.data_ptr(),
        tre.data_ptr(), tn_bits.data_ptr(), seg.data_ptr(), coef.data_ptr(),
        occ.data_ptr(), n_tiles, _stream(o.device))
    if err:
        raise RuntimeError(f"hikari_occlusion_tiles launch failed: cudaError {err}")
    launches["occlusion_tiles"] += 1
    return occ
