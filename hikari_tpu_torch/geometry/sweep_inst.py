"""The two instanced treelet sweeps: wrappers, CUDA kernels, plain PyTorch
versions.

``closest_inst`` replaces the Pallas kernel ``_closest_inst_kernel``
(``hikari_tpu/geometry/instanced.py:146``) and ``occlusion_inst`` replaces
``_occlusion_inst_kernel`` (``instanced.py:194``), both launched there by
``_sweep_chunks_inst``. On a CUDA tensor each wrapper launches its
hand-written kernel from ``csrc/sweep_inst.cu`` (built with nvcc at first
use) or raises; the plain PyTorch version beside it runs only for tensors
on the CPU, and on the card only when a caller compares it with the
kernel. Launches and plain runs on CUDA are counted in the package's launch
record (``_build.launches`` and ``_build.plain_cuda_runs``).

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
  The result is therefore the minimum over every listed pair of
  (t, pair rank, column), the rank a pair's index in its tile's segment,
  the reach ranking before every pair.
* occlusion: a lane is occluded once any hit has ``t < tmax``;
  ``thr = max(bits(tmax))`` over the tile's unoccluded lanes.

The plain versions walk the pairs in that order. The kernels run one
block per pair, started in ``sweep.pair_schedule`` order, and merge
into a per-lane carry in device memory: for closest a 64-bit word
``bits(t) << 32 | rank * 256 + column + 1`` (the reach with low word 0)
under ``atomicMin``, so a segment must list fewer than 2**24 pairs, which
holds while a tile lists each world treelet at most once
(``csrc/sweep_inst.cu`` argues that the result and the early-out match the
walk, ties included).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .sweep import (PRE_MARGIN, RAY_TILE, TREELET, check_sweep, live_reach_bits, pair_schedule,
                    plain_tiles, reach_bits, scaled_test, tests_needed, walk)

_EPS = 1e-6
_T_MIN = 1e-4
_DEN_MIN = 1e-20
_MISS_T = 3.0e38

_SOURCE = _build.CSRC / "sweep_inst.cu"


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


def may_hit_plain(o, d, a, coef, t_far):
    """PyTorch mirror of the instanced kernels' pre-test (``may_hit`` in
    ``csrc/sweep_inst.cu``), for the tests and the smoke test; the sweeps
    never call it. (C, L, 3) world rays, (C, 4, 4) instance matrices, (C,
    TT, 12) coefficients and the largest t that still counts, (C, L) ->
    (C, L, TT) bool. The object-space ray is the plain version's own
    (``_to_object``, which rounds as the kernel's transform does); then the
    flat pre-test's arithmetic (``sweep.scaled_test``) on its first three
    components, o.w = 1 and d.w = 0 being exact for an affine instance, and
    this kernel's predicate, loosened by 1/64 in u, v and the far limit and
    by half at 1e-4."""
    o4, d4 = _to_object(o, d, a)
    nt, aden, su, sv, far = scaled_test(o4[..., :3], d4[..., :3], coef, t_far)
    slack = (_EPS + PRE_MARGIN) * aden
    return ((su >= -slack) & (sv >= -slack) & (su + sv <= aden + slack)
            & (nt > (0.5 * _T_MIN) * aden) & (nt < far))


def pretest_drops_inst(o, d, t_far, tre, seg, ti_obj, ti_inst, coef, inst_a):
    """(plain hits, those of them that the pre-test refuses) over every
    listed pair: the (ray, triangle) combinations that the plain instanced
    test accepts with t <= t_far (per lane: a closest carry's t, or an
    occlusion reach). The second number should be 0."""
    n_tiles = seg.numel() - 1
    tile = torch.repeat_interleave(torch.arange(n_tiles, device=o.device),
                                   (seg[1:] - seg[:-1]).long())
    o_t, d_t = o.view(n_tiles, RAY_TILE, 3), d.view(n_tiles, RAY_TILE, 3)
    far_t = t_far.view(n_tiles, RAY_TILE)
    hits = drops = 0
    for idx in torch.arange(tre.numel(), device=o.device).split(plain_tiles(o)):
        ti, wt = tile[idx], tre[idx].long()
        a, c = inst_a[ti_inst[wt].long()], coef[ti_obj[wt].long()]
        t, _, _, hit = _block_tuv_inst(*_to_object(o_t[ti], d_t[ti], a), c)
        hit = hit & (t <= far_t[ti][..., None])
        may = may_hit_plain(o_t[ti], d_t[ti], a, c, far_t[ti])
        hits += int(hit.sum())
        drops += int((hit & ~may).sum())
    return hits, drops


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
        _build.plain_cuda_runs["closest_inst"] += 1
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

    walk(seg, tn_bits, thr, step, stats)
    if stats is not None:
        stats["tests"] = tests
    return t_c.view(-1), tri.view(-1), b1.view(-1), b2.view(-1)


def occlusion_inst_plain(o, d, tmax, occ_in, tre, tn_bits, seg, ti_obj, ti_inst, coef,
                         inst_a, stats=None):
    """Plain PyTorch instanced occlusion sweep with the kernel's signature
    (stats as in closest_inst_plain)."""
    if o.is_cuda:
        _build.plain_cuda_runs["occlusion_inst"] += 1
    n_tiles = seg.numel() - 1
    occ = occ_in.clone().view(n_tiles, RAY_TILE)
    tm = tmax.view(n_tiles, RAY_TILE)
    o_t, d_t = o.view(n_tiles, RAY_TILE, 3), d.view(n_tiles, RAY_TILE, 3)
    thr = reach_bits(occ, tm)
    tests = 0

    def step(idx, p):
        nonlocal tests
        if stats is not None:
            tests += tests_needed(live_reach_bits(occ[idx], tm[idx]), tn_bits[p])
        _, (t, _, _, hit) = _pair_blocks(o_t, d_t, idx, p, tre, ti_obj, ti_inst,
                                         coef, inst_a)
        hit = hit & (t < tm[idx][..., None])
        occ[idx] = occ[idx] | hit.any(-1).to(torch.int32)
        return reach_bits(occ[idx], tm[idx])

    walk(seg, tn_bits, thr, step, stats)
    if stats is not None:
        stats["tests"] = tests
    return occ.view(-1)


# --- CUDA kernels -------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_library = functools.partial(_build.library, "sweep_inst", _SOURCE, {
    "hikari_closest_inst": [_P] * 17 + [_I, _I, _P],
    "hikari_occlusion_inst": [_P] * 12 + [_I, _P], "hikari_inst_attributes": [_P],
    "hikari_pretest_inst": [_P] * 6 + [ctypes.c_int64, _P]})


def kernel_attributes() -> dict:
    """{kernel: (registers a thread, spill bytes a thread, resident blocks
    per SM)} of the two sweep kernels, as the CUDA runtime reports them."""
    return _build.kernel_attributes(_library().hikari_inst_attributes,
                                    ("closest_inst", "occlusion_inst"))


def pretest_inst(o, d, t_far, coef, a):
    """The instanced sweeps' pre-test alone on the card (``may_hit``, after
    the kernels' move into object space): (n, 3) world rays, far limits
    t_far (n,), one object-space treelet's coefficients (256, 12) and its
    instance matrix (4, 4) -> (n, 256) uint8, 1 where a ray may hit the row.
    For the check against ``may_hit_plain``; the sweeps never call it. No
    CPU version: a CPU tensor raises."""
    if o.device.type != "cuda":
        raise ValueError(f"pretest_inst runs the kernels' pre-test on the card, got {o.device}")
    n = o.shape[0]
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)), ("t_far", t_far, (n,)),
                           ("coef", coef, (TREELET, 12)), ("a", a, (4, 4))):
        _build.check(name, x, torch.float32, shape, o.device)
    out = torch.empty((n, TREELET), dtype=torch.uint8, device=o.device)
    _build.launch(_library().hikari_pretest_inst, o.data_ptr(), d.data_ptr(),
                  t_far.data_ptr(), coef.data_ptr(), a.data_ptr(), out.data_ptr(), n,
                  _build.stream(o.device))
    return out


def _check_inst(o, d, lane_args, tre, tn_bits, seg, ti_obj, ti_inst, coef, inst_a):
    n_tiles = check_sweep(o, d, lane_args, tre, tn_bits, seg, coef)
    _build.check("ti_obj", ti_obj, torch.int32, None, o.device)
    _build.check("ti_inst", ti_inst, torch.int32, tuple(ti_obj.shape), o.device)
    _build.check("inst_a", inst_a, torch.float32, None, o.device)
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
    n_pairs = tre.numel()
    # the carry word's low half holds rank * TREELET + column + 1, rank < the
    # segment's length (checked, with a host sync, only where it could overflow)
    if n_pairs * TREELET >= 2 ** 32 and int((seg[1:] - seg[:-1]).max()) * TREELET >= 2 ** 32:
        raise ValueError("a tile's segment overflows the 32-bit (rank, column) field")
    tile, order = pair_schedule(seg, n_pairs)
    best = torch.empty(t_in.shape, dtype=torch.int64, device=o.device)
    _build.launch(
        _library().hikari_closest_inst,
        o.data_ptr(), d.data_ptr(), t_in.data_ptr(), tre.data_ptr(), tn_bits.data_ptr(),
        seg.data_ptr(), tile.data_ptr(), order.data_ptr(), ti_obj.data_ptr(),
        ti_inst.data_ptr(), coef.data_ptr(), inst_a.data_ptr(), best.data_ptr(),
        t.data_ptr(), tri.data_ptr(), b1.data_ptr(), b2.data_ptr(), n_tiles, n_pairs,
        _build.stream(o.device))
    return t, tri, b1, b2


def occlusion_inst(o, d, tmax, occ_in, tre, tn_bits, seg, ti_obj, ti_inst, coef, inst_a):
    """Instanced occlusion sweep -> occ, (n,) int32 (1 = occluded)."""
    if o.device.type == "cpu":
        return occlusion_inst_plain(o, d, tmax, occ_in, tre, tn_bits, seg, ti_obj,
                                    ti_inst, coef, inst_a)
    n_tiles = _check_inst(o, d, [("tmax", tmax, torch.float32),
                                 ("occ_in", occ_in, torch.int32)],
                          tre, tn_bits, seg, ti_obj, ti_inst, coef, inst_a)
    # the kernel updates the carry in place: tiles without a pair keep it
    occ = occ_in.clone()
    if n_tiles == 0:
        return occ
    n_pairs = tre.numel()
    tile, order = pair_schedule(seg, n_pairs)
    _build.launch(
        _library().hikari_occlusion_inst,
        o.data_ptr(), d.data_ptr(), tmax.data_ptr(), tre.data_ptr(), tn_bits.data_ptr(),
        tile.data_ptr(), order.data_ptr(), ti_obj.data_ptr(), ti_inst.data_ptr(),
        coef.data_ptr(), inst_a.data_ptr(), occ.data_ptr(), n_pairs, _build.stream(o.device))
    return occ
