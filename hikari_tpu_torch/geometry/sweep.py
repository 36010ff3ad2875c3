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

The plain versions walk the pairs in that order. The kernels run one block
per pair in ``pair_schedule`` order and merge into a per-lane carry in
device memory (``csrc/sweep_grid.cuh`` argues it): the occlusion result is
the walk's exactly; the closest result is the minimum over every listed
pair of ``(key, rank of the pair in its tile's segment)``, the carry
ranking first, which differs from the walk's only where two hits tie in
the key's upper 24 bits. ``key_in`` must lie in ``[0, bits(3.0e38)]``, the
plain version's no-hit key (``geometry/wavefront.py`` hands in 3.0e37 for a
reach that is not finite): above it the plain version writes its no-hit
value and the kernel keeps ``(key_in, tr_in)``. Each (ray, triangle) first
goes through a divide-free pre-test, mirrored here by ``may_hit_plain`` for
the tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
# the package's launch record under the names that portbench/harness.py reads
from .._build import launches, reset_counts  # noqa: F401
from ..utils import profiling

RAY_TILE = 1024
TREELET = 256
COL_BITS = 8
COL_MASK = (1 << COL_BITS) - 1
EPS = 1e-6
T_MIN = 1e-4
_MISS_T = 3.0e38
PRE_MARGIN = 1.0 / 64.0   # the kernels' pre-test: slack in u and v
_PRE_T = 1.0 + 1.0 / 64.0  # and at the far limit of t
# tiles per step of the plain versions: (16, 1024, 256) blocks on the CPU;
# on the card, where the walks run only to be compared with the kernels,
# larger steps keep the host's loop from setting their pace
_PLAIN_TILES = 16
_PLAIN_TILES_CUDA = 128

_SOURCE = _build.CSRC / "sweep_tiles.cu"


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
    w = (1.0 + EPS) - (u + v)
    return t, (u >= -EPS) & (v >= -EPS) & (w >= -EPS) & (t > T_MIN)


def plain_tiles(x) -> int:
    return _PLAIN_TILES_CUDA if x.is_cuda else _PLAIN_TILES


def walk(seg, tn_bits, thr, step, stats=None):
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
        for chunk in idx.split(plain_tiles(idx)):
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


def tests_from_final(final_bits, tn_bits, seg) -> int:
    """Ray-triangle tests a closest-hit walk needs, counted from each lane's
    final carry instead of the walk's running one: TREELET for every listed
    pair p and lane of its tile whose final bound bits (n,) (a flat key |
    COL_MASK, an instanced t's bits) lie above tn_bits[p]. The carry only
    falls along the walk, so this is at most the walk's count
    (``stats["tests"]``), and equal to it where no lane's carry crosses a
    later pair's entry distance; it needs no walk, only a sweep's output."""
    n_tiles = seg.numel() - 1
    bits = final_bits.view(n_tiles, RAY_TILE)
    tile = torch.repeat_interleave(torch.arange(n_tiles, device=seg.device),
                                   (seg[1:] - seg[:-1]).long())
    total = torch.zeros((), dtype=torch.int64, device=seg.device)
    for idx in torch.arange(tn_bits.numel(), device=seg.device).split(4096):
        total += (bits[tile[idx]] > tn_bits[idx, None]).sum()
    return int(total) * TREELET


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

    walk(seg, tn_bits, thr, step, stats)
    if stats is not None:
        stats["tests"] = tests
    return key.view(-1), tr.view(-1)


def live_reach_bits(occ, tmax):
    """Per lane: the bits of its reach while unoccluded, else 0."""
    return torch.where(occ == 0, tmax, 0.0).view(torch.int32)


def reach_bits(occ, tmax):
    return live_reach_bits(occ, tmax).amax(1)


def occlusion_walk(o, d, tmax, occ_in, tre, tn_bits, seg, coef, block_hit, stats=None):
    """The occlusion walk of the contract above with the hit test
    block_hit(o, d, coef) -> (t, hit): the plain version of K2 and, with
    its own hit test, of the pair-grid K6 (sweep_pairs.py)."""
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
        t, hit = block_hit(o_t[idx], d_t[idx], coef[tre[p].long()])
        hit = hit & (t < tm[idx][..., None])
        occ[idx] = occ[idx] | hit.any(-1).to(torch.int32)
        return reach_bits(occ[idx], tm[idx])

    walk(seg, tn_bits, thr, step, stats)
    if stats is not None:
        stats["tests"] = tests
    return occ.view(-1)


def closest_tiles_plain(o, d, key_in, tr_in, tre, tn_bits, seg, coef, stats=None):
    """Plain PyTorch closest-hit sweep with the kernel's signature. stats:
    optional dict that receives the (tile, pair) sweeps made ("pairs") and
    the ray-triangle tests they need ("tests")."""
    if o.is_cuda:
        _build.plain_cuda_runs["closest_tiles"] += 1
    return closest_walk(o, d, key_in, tr_in, tre, tn_bits, seg, coef, _block_hit, stats)


def occlusion_tiles_plain(o, d, tmax, occ_in, tre, tn_bits, seg, coef, stats=None):
    """Plain PyTorch occlusion sweep with the kernel's signature (stats as in
    closest_tiles_plain)."""
    if o.is_cuda:
        _build.plain_cuda_runs["occlusion_tiles"] += 1
    return occlusion_walk(o, d, tmax, occ_in, tre, tn_bits, seg, coef, _block_hit, stats)


# --- the kernels' pre-test, mirrored -------------------------------------------------


def _fma(a, b, c):
    """float32 a * b + c rounded once, as the card's fmaf. The product is
    exact in float64; the sum is rounded to odd there (its float64 rounding
    error by TwoSum, and the odd one of the two neighbours where it is not
    0), so that the rounding to float32 is the single rounding of the exact
    value. NaN and inf pass through."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    pv = s - p
    err = (p - (s - pv)) + (c - pv)
    inexact = (err != 0) & torch.isfinite(err)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.nextafter(s, torch.where(err > 0, float("inf"), float("-inf")))
    return torch.where(inexact & even, toward, s).float()


def scaled_test(o, d, coef, t_far):
    """The pre-test's arithmetic on (C, L, 3) rays, (C, TT, 12) coefficient
    rows and far limits (C, L): (nt = t |den|, |den|, u |den|, v |den|, the
    far limit times |den|), each (C, L, TT). den and num are rounded as the
    hit tests round them (``affine``), so that t |den| is the hit tests' t
    to an ulp; the u and v dot products are FMAs in the kernels' order."""
    def dot_o(c0):
        g = coef[:, None, :, c0:c0 + 4]
        return _fma(o[:, :, None, 0], g[..., 0],
                    _fma(o[:, :, None, 1], g[..., 1], _fma(o[:, :, None, 2], g[..., 2], g[..., 3])))

    def dot_d(c0):
        g = coef[:, None, :, c0:c0 + 3]
        return _fma(d[:, :, None, 0], g[..., 0],
                    _fma(d[:, :, None, 1], g[..., 1], d[:, :, None, 2] * g[..., 2]))

    den = affine(coef[..., 0:3], d, None)
    aden = torch.abs(den)
    num = affine(coef[..., 0:3], o, coef[..., 3])
    nt = torch.where(torch.signbit(den), num, -num)
    su = _fma(nt, dot_d(4), dot_o(4) * aden)
    sv = _fma(nt, dot_d(8), dot_o(8) * aden)
    return nt, aden, su, sv, (t_far * _PRE_T)[..., None] * aden


def may_hit_plain(o, d, coef, t_far):
    """PyTorch mirror of the kernels' pre-test (``may_hit_u`` and
    ``may_hit_vt`` in ``csrc/sweep_grid.cuh``, both stages joined), for the
    tests and the smoke test; the sweeps never call it. (C, L, 3) rays x
    (C, TT, 12) coefficients and the largest t that still counts, (C, L) ->
    (C, L, TT) bool: the hit predicate multiplied through by |den|
    (``scaled_test``), loosened by 1/64 in u, v and the far limit and by
    half at 1e-4."""
    nt, aden, su, sv, far = scaled_test(o, d, coef, t_far)
    slack = (EPS + PRE_MARGIN) * aden
    half = torch.tensor(-0.5, dtype=o.dtype, device=o.device)
    return ((torch.abs(_fma(half, aden, su)) <= (0.5 + EPS + PRE_MARGIN) * aden)
            & (sv >= -slack) & (su + sv <= aden + slack)
            & (nt > (0.5 * T_MIN) * aden) & (nt < far))


def pretest_drops(o, d, t_far, tre, seg, coef, block_hit=_block_hit):
    """(plain hits, those of them that the pre-test refuses) over every
    listed pair: the (ray, triangle) combinations that the hit test
    block_hit (``_block_hit`` of K1/K2, or the pair-grid K5/K6's
    ``sweep_pairs._block_hit_pairs``) accepts with t <= t_far (per lane: a
    closest key's t rounded up, or an occlusion reach). The second number
    should be 0."""
    n_tiles = seg.numel() - 1
    tile = torch.repeat_interleave(torch.arange(n_tiles, device=o.device),
                                   (seg[1:] - seg[:-1]).long())
    o_t, d_t = o.view(n_tiles, RAY_TILE, 3), d.view(n_tiles, RAY_TILE, 3)
    far_t = t_far.view(n_tiles, RAY_TILE)
    hits = drops = 0
    for idx in torch.arange(tre.numel(), device=o.device).split(plain_tiles(o)):
        ti, c = tile[idx], coef[tre[idx].long()]
        t, hit = block_hit(o_t[ti], d_t[ti], c)
        hit = hit & (t <= far_t[ti][..., None])
        may = may_hit_plain(o_t[ti], d_t[ti], c, far_t[ti])
        hits += int(hit.sum())
        drops += int((hit & ~may).sum())
    return hits, drops


def grazing_rays(tri, rng):
    """Rays where the pre-test is tightest, for its checks. tri: (K, 9)
    float32 [p0 | e1 | e2] per triangle; rng: a numpy RandomState. Per
    triangle: points on its edges and corners and 2e-6 of the barycentric
    range to either side (where the hit test's eps = 1e-6 decides), each
    approached once from a random direction and once at 1e-2 to 1e-6 rad
    off the triangle's plane; and rays that meet the plane at 1e-2 to 1e-4
    rad towards a point inside. -> origins and directions (K, L, 3) and the
    hit distance aimed for (K, L), float32."""
    import numpy as np

    p0, e1, e2 = tri[:, None, 0:3], tri[:, None, 3:6], tri[:, None, 6:9]
    k = tri.shape[0]
    s = rng.rand(k, 12).astype(np.float32)
    z = np.zeros_like(s)
    uv = np.concatenate([np.stack([s, z], -1), np.stack([z, s], -1),
                         np.stack([s, 1 - s], -1)], 1)          # on the three edges
    corners = np.broadcast_to(np.array([[0, 0], [1, 0], [0, 1]], np.float32), (k, 3, 2))
    uv = np.concatenate([uv, corners], 1)
    inward = np.float32(1 / 3) - uv
    uv = np.concatenate([uv + e * inward for e in (-2e-6, 0.0, 2e-6)], 1)
    target = p0 + uv[..., 0:1] * e1 + uv[..., 1:2] * e2
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    lanes = target.shape[1]
    dirs = rng.randn(k, lanes, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    # the edge points again, along the plane plus a sliver of normal
    along = dirs - (dirs * n).sum(-1, keepdims=True) * n
    along /= np.linalg.norm(along, axis=-1, keepdims=True)
    angle = 10.0 ** -(2 + 4 * rng.rand(k, lanes, 1))
    sign = np.where(rng.rand(k, lanes, 1) < 0.5, -1.0, 1.0)
    d_edge = along + sign * angle * n
    d_edge /= np.linalg.norm(d_edge, axis=-1, keepdims=True)
    dirs = np.concatenate([dirs, d_edge], 1)
    target = np.concatenate([target, target], 1)
    dist = (rng.rand(k, 2 * lanes, 1) * 4 + 0.5).astype(np.float32)
    o_edge = target - dirs * dist
    # plane-grazing: towards a point inside, along an edge plus a sliver of normal
    inside = p0 + 0.3 * e1 + 0.3 * e2
    along = e1 / np.linalg.norm(e1, axis=-1, keepdims=True)
    angle = (10.0 ** -(2 + 2 * rng.rand(k, 16, 1))).astype(np.float32)
    d_graze = along + angle * n
    d_graze /= np.linalg.norm(d_graze, axis=-1, keepdims=True)
    dist_g = (rng.rand(k, 16, 1) * 4 + 0.5).astype(np.float32)
    o_graze = inside - d_graze * dist_g
    o = np.concatenate([o_edge, o_graze], 1).astype(np.float32)
    d = np.concatenate([dirs, d_graze], 1).astype(np.float32)
    return o, d, np.concatenate([dist, dist_g], 1)[..., 0].astype(np.float32)


# --- CUDA kernels -------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C argument types of a grid closest-hit / occlusion sweep (K1/K2, K5/K6)
CLOSEST_ARGS = [_P] * 13 + [_I, _I, _P]
OCCLUSION_ARGS = [_P] * 9 + [_I, _P]

_library = functools.partial(_build.library, "sweep_tiles", _SOURCE, {
    "hikari_closest_tiles": CLOSEST_ARGS, "hikari_occlusion_tiles": OCCLUSION_ARGS,
    "hikari_tiles_attributes": [_P], "hikari_pretest_grid": [_P] * 5 + [ctypes.c_int64, _P]})


def kernel_attributes() -> dict:
    """{kernel: (registers a thread, spill bytes a thread, resident blocks
    per SM)} of the two sweep kernels, as the CUDA runtime reports them."""
    return _build.kernel_attributes(_library().hikari_tiles_attributes,
                                    ("closest_tiles", "occlusion_tiles"))


def pretest_grid(o, d, t_far, coef):
    """The grid sweeps' pre-test alone on the card (both stages, as K1/K2 and
    K5/K6 evaluate it): (n, 3) rays, far limits t_far (n,) and one treelet's
    coefficients (256, 12) -> (n, 256) uint8, 1 where a ray may hit the row.
    For the check against ``may_hit_plain``; the sweeps never call it. No
    CPU version: a CPU tensor raises."""
    if o.device.type != "cuda":
        raise ValueError(f"pretest_grid runs the kernels' pre-test on the card, got {o.device}")
    n = o.shape[0]
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)), ("t_far", t_far, (n,)),
                           ("coef", coef, (TREELET, 12))):
        _build.check(name, x, torch.float32, shape, o.device)
    out = torch.empty((n, TREELET), dtype=torch.uint8, device=o.device)
    _build.launch(_library().hikari_pretest_grid, o.data_ptr(), d.data_ptr(),
                  t_far.data_ptr(), coef.data_ptr(), out.data_ptr(), n,
                  _build.stream(o.device))
    return out


def check_sweep(o, d, lane_args, tre, tn_bits, seg, coef):
    if o.device.type != "cuda":
        raise ValueError(f"the sweep kernels take CUDA or CPU tensors, got {o.device}")
    n_tiles = seg.numel() - 1
    n = n_tiles * RAY_TILE
    dev = o.device
    _build.check("o", o, torch.float32, (n, 3), dev)
    _build.check("d", d, torch.float32, (n, 3), dev)
    for name, x, dtype in lane_args:
        _build.check(name, x, dtype, (n,), dev)
    _build.check("tre", tre, torch.int32, None, dev)
    _build.check("tn_bits", tn_bits, torch.int32, tuple(tre.shape), dev)
    _build.check("seg", seg, torch.int32, (n_tiles + 1,), dev)
    _build.check("coef", coef, torch.float32, None, dev)
    if coef.dim() != 3 or coef.shape[1:] != (TREELET, 12):
        raise ValueError(f"coef: shape {tuple(coef.shape)}, expected (T, {TREELET}, 12)")
    return n_tiles


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


def closest_grid(library, symbol, o, d, key_in, tr_in, tre, tn_bits, seg, coef):
    """A grid closest-hit sweep on the card -> (key, tr): the kernel
    `symbol` of `library` (a loader), K1 here or K5 (sweep_pairs.py)."""
    n_tiles = check_sweep(o, d, [("key_in", key_in, torch.int32),
                                 ("tr_in", tr_in, torch.int32)],
                          tre, tn_bits, seg, coef)
    key, tr = torch.empty_like(key_in), torch.empty_like(tr_in)
    if n_tiles == 0:
        return key, tr
    n_pairs = tre.numel()
    tile, order = pair_schedule(seg, n_pairs)
    best = torch.empty(key_in.shape, dtype=torch.int64, device=o.device)
    _build.launch(getattr(library(), symbol),
                  o.data_ptr(), d.data_ptr(), key_in.data_ptr(), tr_in.data_ptr(),
                  tre.data_ptr(), tn_bits.data_ptr(), seg.data_ptr(), tile.data_ptr(),
                  order.data_ptr(), coef.data_ptr(), best.data_ptr(), key.data_ptr(),
                  tr.data_ptr(), n_tiles, n_pairs, _build.stream(o.device))
    return key, tr


def occlusion_grid(library, symbol, o, d, tmax, occ_in, tre, tn_bits, seg, coef):
    """A grid occlusion sweep on the card -> occ: the kernel `symbol` of
    `library`, K2 here or K6 (sweep_pairs.py)."""
    n_tiles = check_sweep(o, d, [("tmax", tmax, torch.float32),
                                 ("occ_in", occ_in, torch.int32)],
                          tre, tn_bits, seg, coef)
    # the kernel updates the carry in place: tiles without a pair keep it
    occ = occ_in.clone()
    if n_tiles == 0:
        return occ
    n_pairs = tre.numel()
    tile, order = pair_schedule(seg, n_pairs)
    _build.launch(getattr(library(), symbol),
                  o.data_ptr(), d.data_ptr(), tmax.data_ptr(), tre.data_ptr(),
                  tn_bits.data_ptr(), tile.data_ptr(), order.data_ptr(), coef.data_ptr(),
                  occ.data_ptr(), n_pairs, _build.stream(o.device))
    return occ


@profiling.spanned("hikari.sweep")
def closest_tiles(o, d, key_in, tr_in, tre, tn_bits, seg, coef):
    """Closest-hit treelet sweep -> (key, tr), each (n,) int32."""
    if o.device.type == "cpu":
        return closest_tiles_plain(o, d, key_in, tr_in, tre, tn_bits, seg, coef)
    return closest_grid(_library, "hikari_closest_tiles", o, d, key_in, tr_in, tre, tn_bits,
                        seg, coef)


@profiling.spanned("hikari.sweep")
def occlusion_tiles(o, d, tmax, occ_in, tre, tn_bits, seg, coef):
    """Occlusion treelet sweep -> occ, (n,) int32 (1 = occluded)."""
    if o.device.type == "cpu":
        return occlusion_tiles_plain(o, d, tmax, occ_in, tre, tn_bits, seg, coef)
    return occlusion_grid(_library, "hikari_occlusion_tiles", o, d, tmax, occ_in, tre,
                          tn_bits, seg, coef)
