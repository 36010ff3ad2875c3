"""Host-side BVH construction (binned SAH) with a skip-link flat layout.

Port of ``hikari_tpu/geometry/bvh.py``. The native C++ builder is
``csrc/bvh_builder.cpp``, a byte-for-byte copy of the JAX package's
``hikari_tpu/native/bvh_builder.cpp`` (``tests/test_torch_independence.py``
checks that it does not drift), compiled with ``g++`` into this package's
build directory; the numpy builder below is the fallback where no compiler
is available. Both produce the same tree as the JAX package on the same
machine, so both packages see the same BVH leaf order and triangle indices.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
from dataclasses import dataclass

import numpy as np

from .. import _build

N_BINS = 16
DEFAULT_LEAF_SIZE = 4

_NATIVE_SOURCE = _build.CSRC / "bvh_builder.cpp"
# the JAX package's own compiler command (hikari_tpu/native/__init__.py)
_GXX = ["g++", "-O3", "-march=native", "-shared", "-fPIC"]


@dataclass
class FlatBVH:
    """Flattened BVH in DFS pre-order. count == 0 marks interior nodes."""

    lo: np.ndarray          # (N, 3) float32
    hi: np.ndarray          # (N, 3) float32
    first: np.ndarray       # (N,) int32 first primitive of a leaf
    count: np.ndarray       # (N,) int32 primitive count (0 = interior)
    skip: np.ndarray        # (N,) int32 next subtree in DFS order
    prim_order: np.ndarray  # (P,) int32 leaf order -> input primitive


@functools.cache
def _native_builder():
    """The compiled hikari_build_bvh, or None without a compiler."""
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    try:
        lib = _build.library("bvh", _NATIVE_SOURCE,
                             {"hikari_build_bvh": [p, p, i64, ctypes.c_int32] + [p] * 6 + [i64]},
                             command=_GXX, restype=i64, timeout=120)
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    return lib.hikari_build_bvh


def _build_bvh_native(prim_lo, prim_hi, leaf_size) -> FlatBVH | None:
    fn = _native_builder()
    if fn is None:
        return None
    n = prim_lo.shape[0]
    lo_c = np.ascontiguousarray(prim_lo, np.float32)
    hi_c = np.ascontiguousarray(prim_hi, np.float32)
    cap = 2 * n + 8
    out_lo = np.empty((cap, 3), np.float32)
    out_hi = np.empty((cap, 3), np.float32)
    out_first = np.empty(cap, np.int32)
    out_count = np.empty(cap, np.int32)
    out_skip = np.empty(cap, np.int32)
    out_order = np.empty(n, np.int32)
    n_nodes = fn(lo_c.ctypes.data, hi_c.ctypes.data, n, leaf_size,
                 out_lo.ctypes.data, out_hi.ctypes.data, out_first.ctypes.data,
                 out_count.ctypes.data, out_skip.ctypes.data,
                 out_order.ctypes.data, cap)
    if n_nodes <= 0:
        return None
    return FlatBVH(lo=out_lo[:n_nodes].copy(), hi=out_hi[:n_nodes].copy(),
                   first=out_first[:n_nodes].copy(),
                   count=out_count[:n_nodes].copy(),
                   skip=out_skip[:n_nodes].copy(), prim_order=out_order)


def build_bvh(prim_lo: np.ndarray, prim_hi: np.ndarray,
              leaf_size: int = DEFAULT_LEAF_SIZE, native: bool = True) -> FlatBVH:
    """Binned-SAH BVH over primitive AABBs; the flat skip-link tree."""
    n = prim_lo.shape[0]
    if n == 0:
        raise ValueError("build_bvh needs at least one primitive")
    if native:
        fb = _build_bvh_native(np.asarray(prim_lo, np.float32),
                               np.asarray(prim_hi, np.float32), leaf_size)
        if fb is not None:
            return fb
    centroids = 0.5 * (prim_lo + prim_hi)
    lo_list, hi_list, first_list, count_list, order = [], [], [], [], []
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))

    def emit(idx: np.ndarray, offset: int) -> int:
        my = len(lo_list)
        lo_list.append(prim_lo[idx].min(axis=0))
        hi_list.append(prim_hi[idx].max(axis=0))
        first_list.append(offset)
        count_list.append(0)
        if len(idx) <= leaf_size:
            count_list[my] = len(idx)
            order.append(idx)
            return 1
        cent = centroids[idx]
        c_lo = cent.min(axis=0)
        extent = cent.max(axis=0) - c_lo
        axis = int(np.argmax(extent))
        if extent[axis] < 1e-12:
            half = len(idx) // 2
            left_idx, right_idx = idx[:half], idx[half:]
        else:
            scale = N_BINS * (1.0 - 1e-6) / extent[axis]
            bins = np.clip(((cent[:, axis] - c_lo[axis]) * scale).astype(np.int32),
                           0, N_BINS - 1)
            bin_counts = np.bincount(bins, minlength=N_BINS)
            bin_lo = np.full((N_BINS, 3), np.inf, np.float64)
            bin_hi = np.full((N_BINS, 3), -np.inf, np.float64)
            for b in range(N_BINS):
                if bin_counts[b]:
                    m = bins == b
                    bin_lo[b] = prim_lo[idx[m]].min(axis=0)
                    bin_hi[b] = prim_hi[idx[m]].max(axis=0)

            def growing_area(los, his):
                d = np.maximum(np.maximum.accumulate(his, axis=0)
                               - np.minimum.accumulate(los, axis=0), 0.0)
                return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                              + d[:, 2] * d[:, 0])

            area_l = growing_area(bin_lo, bin_hi)[:-1]
            area_r = growing_area(bin_lo[::-1], bin_hi[::-1])[::-1][1:]
            n_l = np.cumsum(bin_counts)[:-1]
            n_r = len(idx) - n_l
            cost = np.where((n_l > 0) & (n_r > 0),
                            area_l * n_l + area_r * n_r, np.inf)
            split_bin = int(np.argmin(cost))
            if not np.isfinite(cost[split_bin]):
                half = len(idx) // 2
                part = np.argsort(cent[:, axis], kind="stable")
                left_idx, right_idx = idx[part[:half]], idx[part[half:]]
            else:
                go_left = bins <= split_bin
                left_idx, right_idx = idx[go_left], idx[~go_left]
        size_l = emit(left_idx, offset)
        size_r = emit(right_idx, offset + len(left_idx))
        return 1 + size_l + size_r

    emit(np.arange(n, dtype=np.int64), 0)
    n_nodes = len(lo_list)
    count = np.asarray(count_list, np.int32)
    sizes = np.ones(n_nodes, np.int64)
    for i in range(n_nodes - 1, -1, -1):
        if count[i] == 0:
            left = i + 1
            sizes[i] = 1 + sizes[left] + sizes[left + sizes[left]]
    return FlatBVH(
        lo=np.asarray(lo_list, np.float32), hi=np.asarray(hi_list, np.float32),
        first=np.asarray(first_list, np.int32), count=count,
        skip=(np.arange(n_nodes, dtype=np.int64) + sizes).astype(np.int32),
        prim_order=np.concatenate(order).astype(np.int32))
