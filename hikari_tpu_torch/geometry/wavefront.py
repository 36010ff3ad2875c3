"""Wavefront packet traversal: sorted ray tiles swept against treelets.

Port of ``hikari_tpu/geometry/wavefront.py`` (``RAY_TILE=1024``,
``TREELET=256``, ``KEY_OBITS=6``, per-ray pre-pass on) with the reference's
three traversal switches, read from the same environment variables at
import and from the module attributes at call time:

* ``SWEEP_MODE`` (``HIKARI_SWEEP``, default ``"tile"``): ``"tile"`` sweeps
  with the tile kernels of ``sweep.py`` (K1/K2), anything else with the
  pair-grid kernels of ``sweep_pairs.py`` (K5/K6);
* ``BAND_FRAC`` (``HIKARI_BAND_FRAC``, default 0): above 0 the flat
  closest hit of ``integrators/volpath.py`` runs the banded two-pass sweep
  with a band of that fraction of the world diagonal;
* ``SHADOW_REV`` (``HIKARI_SHADOW_REV=on``, default off): shadow rays are
  traced from the far end of their segment.

The steps:

1. lanes are pre-culled against coarse BVH boxes and clamped to the world
   box, then sorted by (direction octant, origin Morton, direction Morton);
2. every 1024-ray tile is tested against every 256-triangle treelet with a
   conservative interval slab test over 8 sub-frusta;
3. the surviving (tile, treelet) pairs form one tile-major pair list,
   front to back per tile by conservative entry distance;
4. the sweep kernels walk each tile's pair segment with the
   front-to-back early-out, and the winning triangle's exact t and
   barycentrics are recomputed per lane afterwards.

Triangles are tested in the Baldwin-Weber affine form: per treelet the
coefficients are stored as (T, 256, 12) float32, one row
[n | dw | a_u | b_u | a_v | b_v] per triangle, so that

    t = -(n.o + dw) / (n.d),  u = (a_u.o + b_u) + t (a_u.d),  v likewise.

The TPU package splits these coefficients three ways into bf16 for its
matrix unit; in float32 on the card the split has no purpose.

What the TPU needed and the card does not is left out: the lax.cond
live-prefix cascade becomes an eager slice of the sorted wavefront to
ceil(live / 1024) * 1024 lanes (one host sync per sweep), the unsort is a
plain integer gather, and the pair list is two arrays instead of a packed
int32.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields

import numpy as np
import torch

from .sweep import COL_MASK, RAY_TILE, TREELET, closest_tiles, occlusion_tiles
from .sweep_pairs import closest_pairs, occlusion_pairs
from .traverse import HitRecord
from ..core.vecmath import cross

SWEEP_MODE = os.environ.get("HIKARI_SWEEP", "tile")
BAND_FRAC = float(os.environ.get("HIKARI_BAND_FRAC", "0.0"))
SHADOW_REV = os.environ.get("HIKARI_SHADOW_REV", "off") == "on"

KEY_OBITS = 6        # origin-Morton bits per axis in the sort key
SUBFRUSTA = 8        # 128-ray sub-frusta per tile in the cull
SUPER_TARGET = 48    # coarse boxes for the per-ray pre-pass
_CULL_ELEMS = 1 << 24    # (sub-frusta x treelets x 3) per cull chunk
_PREPASS_ELEMS = 1 << 25  # (lanes x boxes x 3) per pre-pass chunk


@dataclass
class Treelets:
    """Treelet-blocked triangle data, Baldwin-Weber form."""

    lo: torch.Tensor      # (T, 3) treelet AABB min
    hi: torch.Tensor      # (T, 3)
    sup_lo: torch.Tensor  # (S, 3) coarse cull boxes for the per-ray pre-pass
    sup_hi: torch.Tensor  # (S, 3)
    coef: torch.Tensor    # (T, TREELET, 12) f32 affine coefficients
    tri: torch.Tensor     # (T*TREELET, 10) f32 [p0 | e1 | e2 | face]; face
    #                     # is the leaf-order triangle index, -1 on padding

    def to(self, device) -> "Treelets":
        return Treelets(**{f.name: getattr(self, f.name).to(device)
                           for f in fields(self)})


def coef_from_m4(m4: np.ndarray) -> np.ndarray:
    """(T, 4, 3*TT) column groups [plane | u | v] with K rows [x, y, z, w]
    -> (T, TT, 12) triangle-major rows [plane xyzw | u xyzw | v xyzw]."""
    t = m4.shape[0]
    return np.ascontiguousarray(
        m4.reshape(t, 4, 3, TREELET).transpose(0, 3, 2, 1).reshape(t, TREELET, 12))


def bvh_super_boxes(fb, n_prims: int, n_target: int = SUPER_TARGET,
                    prim_lo=None, prim_hi=None):
    """Cut the BVH into ~n_target upper-node boxes for the per-ray pre-pass;
    huge leaves (room-spanning walls) contribute their per-triangle boxes."""
    first = np.asarray(fb.first, np.int64)
    skip = np.asarray(fb.skip, np.int64)
    count = np.asarray(fb.count, np.int64)
    n_nodes = len(first)
    cap = max(1, -(-n_prims // n_target))

    def sub_end(i):
        s = skip[i]
        return n_prims if s >= n_nodes else first[s]

    def area(i):
        d = np.maximum(fb.hi[i] - fb.lo[i], 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    root_area = max(area(0), 1e-12)
    lo_l, hi_l = [], []
    stack = [0]
    while stack:
        i = stack.pop()
        c = sub_end(i) - first[i]
        huge = area(i) > 0.08 * root_area
        if count[i] > 0:
            if huge and prim_lo is not None:
                for j in range(int(first[i]), int(first[i] + c)):
                    lo_l.append(prim_lo[j])
                    hi_l.append(prim_hi[j])
            else:
                lo_l.append(fb.lo[i])
                hi_l.append(fb.hi[i])
        elif c <= cap and not huge:
            lo_l.append(fb.lo[i])
            hi_l.append(fb.hi[i])
        else:
            stack.append(int(skip[i + 1]))
            stack.append(i + 1)
    return np.asarray(lo_l, np.float32), np.asarray(hi_l, np.float32)


def build_treelets(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray,
                   supers) -> Treelets:
    """Host: block the BVH-leaf-ordered triangles into fixed TREELET-stride
    treelets and precompute the affine coefficients in float64 (the same
    numpy arithmetic as the JAX package, cast to float32)."""
    p = len(p0)
    t = max(1, -(-p // TREELET))
    base = np.arange(t, dtype=np.int64) * TREELET
    cnt = np.clip(p - base, 0, TREELET)
    cols = np.arange(TREELET, dtype=np.int64)
    idx = base[:, None] + cols[None, :]
    valid = cols[None, :] < cnt[:, None]
    idx = np.where(valid, np.minimum(idx, max(p - 1, 0)), 0)
    vflat = valid.reshape(-1, 1)

    def padded(a):
        out = np.asarray(a, np.float32)[idx.reshape(-1)]
        return np.where(vflat, out, np.float32(3.0e37))

    p0p, p1p, p2p = padded(p0), padded(p1), padded(p2)
    v3 = valid[:, :, None]
    tri_lo = np.minimum(np.minimum(p0p, p1p), p2p).reshape(t, TREELET, 3)
    tri_hi = np.maximum(np.maximum(p0p, p1p), p2p).reshape(t, TREELET, 3)
    lo = np.where(v3, tri_lo, np.float32(3.0e37)).min(1)
    hi = np.where(v3, tri_hi, np.float32(-3.0e37)).max(1)

    # degenerate (incl. padding) triangles get all-zero rows: den == 0
    q0 = p0p.astype(np.float64)
    e1 = p1p.astype(np.float64) - q0
    e2 = p2p.astype(np.float64) - q0
    n = np.cross(e1, e2)
    n2 = (n * n).sum(-1)
    ok = (n2 > 1e-30) & np.isfinite(n2)
    inv_n2 = np.where(ok, 1.0 / np.where(ok, n2, 1.0), 0.0)
    a_u = np.cross(e2, n) * inv_n2[:, None]
    a_v = np.cross(n, e1) * inv_n2[:, None]
    n = np.where(ok[:, None], n, 0.0)
    dw = -(n * q0).sum(-1)
    b_u = -(a_u * q0).sum(-1)
    b_v = -(a_v * q0).sum(-1)

    def rows4(a3, w):
        return np.concatenate([a3, w[:, None]], axis=1).astype(np.float32)

    def grp(m):  # (P, 4) -> (T, 4, TT)
        return np.transpose(m.reshape(t, TREELET, 4), (0, 2, 1))

    m4 = np.concatenate([grp(rows4(n, dw)), grp(rows4(a_u, b_u)),
                         grp(rows4(a_v, b_v))], axis=2)
    face = np.where(valid, idx, -1).reshape(-1, 1).astype(np.float64)
    tri = np.concatenate(
        [p0p, p1p.astype(np.float64) - q0, p2p.astype(np.float64) - q0, face],
        axis=1).astype(np.float32)
    return Treelets(
        lo=torch.from_numpy(lo), hi=torch.from_numpy(hi),
        sup_lo=torch.from_numpy(np.asarray(supers[0], np.float32)),
        sup_hi=torch.from_numpy(np.asarray(supers[1], np.float32)),
        coef=torch.from_numpy(coef_from_m4(m4)), tri=torch.from_numpy(tri))


# --- ray sorting ----------------------------------------------------------------


def _morton10(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits -> 30."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def ray_sort_keys(o, d, world_lo, world_hi) -> torch.Tensor:
    """32-bit sort key (in int64): direction octant (3 bits), origin Morton
    (18 bits), fine direction Morton (11 bits)."""
    octant = ((d[:, 0] < 0).long() | ((d[:, 1] < 0).long() << 1)
              | ((d[:, 2] < 0).long() << 2))
    om_bits = 3 * KEY_OBITS
    dm_bits = 29 - om_bits
    di = torch.clamp(torch.abs(d) * 31.0, 0.0, 31.0).long()
    dm = (_morton10(di[:, 0]) | (_morton10(di[:, 1]) << 1)
          | (_morton10(di[:, 2]) << 2)) >> (15 - dm_bits)
    ext = torch.clamp(world_hi - world_lo, min=1e-6)
    q = torch.clamp((o - world_lo) / ext, 0.0, 1.0)
    qi = (q * float((1 << KEY_OBITS) - 1)).long()
    m = (_morton10(qi[:, 0]) | (_morton10(qi[:, 1]) << 1)
         | (_morton10(qi[:, 2]) << 2)) & ((1 << om_bits) - 1)
    return (octant << 29) | (m << dm_bits) | dm


def _pad_rays(o, d, t_max):
    n = o.shape[0]
    n_pad = -(-n // RAY_TILE) * RAY_TILE
    pad = n_pad - n
    if pad:
        o = torch.cat([o, o.new_zeros((pad, 3))])
        d = torch.cat([d, d.new_ones((pad, 3))])
        t_max = torch.cat([t_max, t_max.new_zeros((pad,))])
    return o, d, t_max, n, n_pad


def _sort_wavefront(o, d, t_max, keys):
    """Stable sort of the lanes by key: pair order decides ties between
    treelets in the closest-hit sweep, so stability matters."""
    order = torch.sort(keys, stable=True).indices
    return order, o[order], d[order], t_max[order]


def _inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return inv


# --- conservative tile x treelet culling -------------------------------------------


def tile_treelet_mask(o, d, t_max, tl: Treelets, n_tiles: int,
                      sub: int = SUBFRUSTA):
    """(n_tiles, T) bool mask + (n_tiles, T) f32 conservative entry t, from
    an interval slab test over `sub` sub-frusta per tile, the L2 entry
    bound and the segment-box cull. Processed in chunks of sub-frusta so
    the (sub-frusta, T, 3) temporaries stay bounded."""
    ns = n_tiles * sub
    br = RAY_TILE // sub
    ot = o.reshape(ns, br, 3)
    dt = d.reshape(ns, br, 3)
    tmt = t_max.reshape(ns, br)
    live = (tmt > 0.0)[..., None]
    o_lo = torch.where(live, ot, 3.0e37).amin(1)
    o_hi = torch.where(live, ot, -3.0e37).amax(1)
    d_lo = torch.where(live, dt, 3.0e37).amin(1)
    d_hi = torch.where(live, dt, -3.0e37).amax(1)
    t_hi = torch.clamp(tmt.amax(1), max=3.0e37)
    sign_uniform = (d_lo * d_hi) > 0.0
    pos = d_lo > 0.0
    inv_a = 1.0 / torch.where(pos, d_hi, d_lo)
    inv_b = 1.0 / torch.where(pos, d_lo, d_hi)
    ep = ot + dt * tmt[..., None]
    seg_lo = torch.minimum(o_lo, torch.where(live, ep, 3.0e37).amin(1))
    seg_hi = torch.maximum(o_hi, torch.where(live, ep, -3.0e37).amax(1))
    pad = 1e-3 + 1e-4 * torch.maximum(torch.abs(seg_lo), torch.abs(seg_hi))

    lo, hi = tl.lo[None], tl.hi[None]
    T = tl.lo.shape[0]
    if ns == 0:  # no live lane (every path escaped): no pairs
        return o.new_zeros((0, T), dtype=torch.bool), o.new_zeros((0, T))
    step = max(sub, (_CULL_ELEMS // (3 * T)) // sub * sub)
    masks, tnears = [], []
    for c0 in range(0, ns, step):
        s = slice(c0, min(c0 + step, ns))
        s_min = lo - o_hi[s, None, :]
        s_max = hi - o_lo[s, None, :]
        ra, rb = inv_a[s, None, :], inv_b[s, None, :]
        a, b, c, e = s_min * ra, s_min * rb, s_max * ra, s_max * rb
        t_ent_min = torch.minimum(torch.minimum(a, b), torch.minimum(c, e))
        t_ent_max = torch.maximum(torch.maximum(a, b), torch.maximum(c, e))
        su = sign_uniform[s, None, :]
        enter_lo = torch.where(su, torch.minimum(t_ent_min, t_ent_max), -3.0e37)
        exit_hi = torch.where(su, torch.maximum(t_ent_min, t_ent_max), 3.0e37)
        t_near = enter_lo.amax(-1)
        t_far = exit_hi.amin(-1)
        gap = (torch.clamp(lo - o_hi[s, None, :], min=0.0)
               + torch.clamp(o_lo[s, None, :] - hi, min=0.0))
        t_near = torch.maximum(t_near, torch.sqrt((gap * gap).sum(-1)) * 0.999)
        seg_ok = ((lo <= (seg_hi[s] + pad[s])[:, None, :])
                  & (hi >= (seg_lo[s] - pad[s])[:, None, :])).all(-1)
        th = t_hi[s, None]
        m = ((t_near <= t_far * 1.0001) & (t_far > 0.0) & (t_near <= th)
             & (th > 0.0) & seg_ok)
        m = m.reshape(-1, sub, T)
        tn = torch.where(m, t_near.reshape(m.shape), 3.0e37)
        masks.append(m.any(1))
        tnears.append(torch.clamp(tn.amin(1), min=0.0))
    return torch.cat(masks), torch.cat(tnears)


def _build_pairs(mask: torch.Tensor, tnear: torch.Tensor):
    """Compact the (n_tiles, T) cull mask into a tile-major pair list with
    treelets in exact per-tile front-to-back order.

    Returns (tre, tn_bits, seg): tre (P,) int32 treelet ids, tn_bits (P,)
    int32 bits of each pair's conservative entry distance, seg
    (n_tiles + 1,) int32: tile i owns pairs seg[i]:seg[i+1]."""
    srt = torch.argsort(torch.where(mask, tnear, 3.0e37), dim=1, stable=True)
    alive = torch.gather(mask, 1, srt)
    tn_sorted = torch.gather(tnear, 1, srt)
    tre = srt[alive].to(torch.int32)
    tn_bits = tn_sorted[alive].contiguous().view(torch.int32)
    counts = mask.sum(1)
    seg = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(torch.int32)
    return tre, tn_bits, seg


def _resolve_hits(tl: Treelets, key, tr, os_, ds):
    """Exact per-lane resolve of the winner (Moller-Trumbore on its row);
    miss lanes (tr < 0) keep the key's quantized t."""
    col = (key & COL_MASK).long()
    slot = torch.clamp(tr, min=0).long() * TREELET + col
    rows = tl.tri[slot]
    p0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    tri = torch.where(tr >= 0, rows[:, 9].to(torch.int32), -1)
    pvec = cross(ds, e2)
    det = (e1 * pvec).sum(-1)
    inv = 1.0 / torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    tvec = os_ - p0
    u = (tvec * pvec).sum(-1) * inv
    qvec = cross(tvec, e1)
    v = (ds * qvec).sum(-1) * inv
    t = (e2 * qvec).sum(-1) * inv
    t_q = (key & ~COL_MASK).view(torch.float32)
    ok = torch.isfinite(t) & (t > 0.0)
    t = torch.where(ok, t, t_q)
    u = torch.clamp(torch.where(ok, u, 0.0), 0.0, 1.0)
    v = torch.clamp(torch.where(ok, v, 0.0), 0.0, 1.0)
    return t, u, v, tri


def _ray_super_cull(tl: Treelets, o, d, t_max) -> torch.Tensor:
    """Per-ray conservative segment test against the coarse boxes; False =
    the segment [o, o + t_max d] provably meets no treelet."""
    inv = 1.0 / torch.where(torch.abs(d) < 1e-20,
                            torch.where(d < 0, -1e-20, 1e-20), d)
    ns = tl.sup_lo.shape[0]
    step = max(1, _PREPASS_ELEMS // max(3 * o.shape[0], 1))
    may = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for c0 in range(0, ns, step):
        t0 = (tl.sup_lo[None, c0:c0 + step] - o[:, None]) * inv[:, None]
        t1 = (tl.sup_hi[None, c0:c0 + step] - o[:, None]) * inv[:, None]
        tn = torch.minimum(t0, t1).amax(-1)
        tf = torch.maximum(t0, t1).amin(-1)
        ok = ((tn <= tf * 1.0001 + 1e-6) & (tf > 1e-4)
              & (tn <= t_max[:, None] * 1.0001 + 1e-4))
        may |= ok.any(1)
    return may


def _world_exit_clamp(o, d, t_max, world_lo, world_hi):
    """Cap each ray's initial best t at its world-box exit distance."""
    inv = 1.0 / torch.where(torch.abs(d) < 1e-20, 1e-20, d)
    ta = (world_lo[None] - o) * inv
    tb = (world_hi[None] - o) * inv
    t_exit = torch.maximum(ta, tb).amin(-1)
    return torch.minimum(t_max, torch.clamp(t_exit, min=0.0) * 1.0001 + 1e-3)


# --- the two sweeps -------------------------------------------------------------------


@dataclass
class PairSweep:
    """A sorted wavefront and its pair list, ready for a sweep kernel."""

    order: torch.Tensor | None  # (n_pad,) sorted lane -> input lane; None = presorted
    n: int                 # input lanes
    os: torch.Tensor       # (sz, 3) sorted live-prefix origins
    ds: torch.Tensor       # (sz, 3)
    ts: torch.Tensor       # (sz,) sorted reach (0 = dead lane)
    tre: torch.Tensor      # (P,) int32
    tn_bits: torch.Tensor  # (P,) int32
    seg: torch.Tensor      # (sz // RAY_TILE + 1,) int32
    n_pad: int             # input lanes padded to a RAY_TILE multiple


def pair_list(tl, os_, ds, ts):
    """Cull the tiles of a sorted wavefront against the treelets and
    compact the survivors into (tre, tn_bits, seg) (see _build_pairs)."""
    mask, tnear = tile_treelet_mask(os_, ds, ts, tl, os_.shape[0] // RAY_TILE)
    return _build_pairs(mask, tnear)


def _prepare(tl, o, d, t_max, keys_fn, presorted=False, band=None) -> PairSweep:
    """Sort, live-prefix slice, cull and pair a wavefront against flat
    Treelets or the instanced tables (instanced.InstancedTreelets). Only
    flat treelets run the per-ray super-box pre-pass: the instanced tables
    have no super boxes, as in the reference's instanced path.

    presorted: the caller's lanes are already in a tile-coherent order; no
    sort, and the sweep covers every lane, because the pre-pass and the
    world-exit clamp can zero the reach of lanes inside the caller's live
    prefix. band: pair the tiles for reach min(ts, band) (the first pass
    of the banded closest hit); ts stays the full reach."""
    if isinstance(tl, Treelets) and tl.lo.shape[0] > 1:
        t_max = torch.where(_ray_super_cull(tl, o, d, t_max), t_max, 0.0)
    o, d, t_max, n, n_pad = _pad_rays(o, d, t_max)
    if presorted:
        order, os_, ds, ts = None, o, d, t_max
    else:
        keys = torch.clamp(keys_fn(o, d), max=0xFFFFFFFE)
        keys = torch.where(t_max > 0.0, keys, 0xFFFFFFFF)
        order, os_, ds, ts = _sort_wavefront(o, d, t_max, keys)
        # dead lanes sort last: the live lanes are a prefix of the sorted order
        live = int((ts > 0.0).sum())
        sz = -(-live // RAY_TILE) * RAY_TILE
        os_, ds, ts = os_[:sz].contiguous(), ds[:sz].contiguous(), ts[:sz].contiguous()
    reach = ts if band is None else torch.clamp(ts, max=band)
    tre, tn_bits, seg = pair_list(tl, os_, ds, reach)
    return PairSweep(order, n, os_, ds, ts, tre, tn_bits, seg, n_pad)


def prepare_closest(tl, o, d, t_max, world_lo, world_hi, active=None, presorted=False,
                    band=None) -> PairSweep:
    """Cull, sort and pair a closest-hit wavefront."""
    t_max = torch.where(torch.isfinite(t_max), t_max, 3.0e37)
    t_max = _world_exit_clamp(o, d, t_max, world_lo, world_hi)
    if active is not None:
        t_max = torch.where(active, t_max, 0.0)
    return _prepare(tl, o, d, t_max,
                    lambda o_, d_: ray_sort_keys(o_, d_, world_lo, world_hi),
                    presorted, band)


def _keyify(t):
    """A reach as a closest-hit key rounded up, so unbeaten lanes keep a
    conservative early-out threshold."""
    return torch.clamp(t, min=0.0).view(torch.int32) | COL_MASK


def closest_carry(ps: PairSweep):
    """Initial (key, tr) carries: the lanes' reach as keys, no treelet."""
    key = _keyify(ps.ts)
    return key, torch.full_like(key, -1)


def _closest_sweep():
    """The closest-hit sweep of the current SWEEP_MODE (read at call time)."""
    return closest_tiles if SWEEP_MODE == "tile" else closest_pairs


def _occlusion_sweep():
    return occlusion_tiles if SWEEP_MODE == "tile" else occlusion_pairs


def _unsort(ps: PairSweep, *lanes):
    """Sorted-order lane values -> input order, padding stripped."""
    if ps.order is None:
        return tuple(x[:ps.n] for x in lanes)
    inv = _inverse_permutation(ps.order)[:ps.n]
    return tuple(x[inv] for x in lanes)


def closest_hit_packets(tl: Treelets, o, d, t_max, world_lo, world_hi,
                        active=None, band=None, presorted=False) -> HitRecord:
    """Sorted-packet closest hit. o/d (R, 3), t_max (R,); tri indices are in
    BVH leaf order. Inactive lanes get reach 0 and are culled.

    band: optional float32 scalar; sweep in two passes, the first with
    every reach capped at `band` (its hits and the lanes that reach no
    further are final), the second at full reach over the rest, as
    ``wavefront.py:1331-1360`` of the reference does. presorted: the lanes
    arrive in a tile-coherent order (the resident bounce loop sorts them
    with ray_sort_keys); no sort and no unsort."""
    ps = prepare_closest(tl, o, d, t_max, world_lo, world_hi, active, presorted, band)
    n_pad, sz = ps.n_pad, ps.os.shape[0]
    t_res = o.new_zeros(n_pad)
    b1 = o.new_zeros(n_pad)
    b2 = o.new_zeros(n_pad)
    tri = torch.full((n_pad,), -1, dtype=torch.int32, device=o.device)
    if sz:
        sweep = _closest_sweep()
        if band is None:
            key, tr = sweep(ps.os, ps.ds, *closest_carry(ps), ps.tre, ps.tn_bits, ps.seg,
                            tl.coef)
        else:
            ts1 = torch.clamp(ps.ts, max=band)
            key1, tr1 = sweep(ps.os, ps.ds, _keyify(ts1), torch.full_like(tri[:sz], -1),
                              ps.tre, ps.tn_bits, ps.seg, tl.coef)
            done = (tr1 >= 0) | (ps.ts <= band)
            tre2, tn2, seg2 = pair_list(tl, ps.os, ps.ds, torch.where(done, 0.0, ps.ts))
            key, tr = sweep(ps.os, ps.ds, torch.where(done, key1, _keyify(ps.ts)), tr1,
                            tre2, tn2, seg2, tl.coef)
        t_res[:sz], b1[:sz], b2[:sz], tri[:sz] = _resolve_hits(tl, key, tr, ps.os, ps.ds)
    t_res, tri, b1, b2 = _unsort(ps, t_res, tri, b1, b2)
    return HitRecord(hit=tri >= 0, t=t_res, tri=tri, b1=b1, b2=b2)


def prepare_occlusion(tl, o, d, t_max, world_lo, world_hi, active=None,
                      group=None, reverse=False) -> PairSweep:
    """Cull, sort and pair a shadow-ray wavefront. group: optional (R,) ids
    (NEE light ids) clustered ahead of the spatial key. reverse: trace each
    segment from its far end back to its origin."""
    t_max = torch.where(torch.isfinite(t_max), t_max, 3.0e37)
    if active is not None:
        t_max = torch.where(active, t_max, 0.0)
    if reverse:
        o = o + d * t_max[:, None]
        d = -d
    t_max = t_max * 0.9999
    if group is not None:
        pad = (-group.shape[0]) % RAY_TILE
        group = torch.cat([group.long(), group.new_zeros(pad, dtype=torch.int64)])

    def keys_fn(o_, d_):
        keys = ray_sort_keys(o_, d_, world_lo, world_hi)
        if group is not None:
            keys = ((group & 63) << 26) | (keys >> 6)
        return keys

    return _prepare(tl, o, d, t_max, keys_fn)


def any_hit_packets(tl: Treelets, o, d, t_max, world_lo, world_hi,
                    active=None, group=None, reverse=None) -> torch.Tensor:
    """Occlusion: True where a triangle lies within (1e-4, 0.9999 t_max).
    reverse (default SHADOW_REV): trace from the far end of each segment
    (occlusion over an open segment is symmetric), which turns NEE rays
    converging on a few light points into shared-origin packets."""
    if reverse is None:
        reverse = SHADOW_REV
    ps = prepare_occlusion(tl, o, d, t_max, world_lo, world_hi, active, group, reverse)
    sz = ps.os.shape[0]
    occ = torch.zeros(ps.n_pad, dtype=torch.int32, device=o.device)
    reach = torch.zeros(ps.n_pad, device=o.device)
    if sz:
        occ[:sz] = _occlusion_sweep()(ps.os, ps.ds, ps.ts, (ps.ts <= 0.0).to(torch.int32),
                                      ps.tre, ps.tn_bits, ps.seg, tl.coef)
        reach[:sz] = ps.ts
    occ, reach = _unsort(ps, occ, reach)
    # lanes pre-resolved with reach 0 (inactive, culled) are not occluded
    return (occ > 0) & (reach > 0.0)
