"""Brute-force traversal for the benchmark's reference: every ray against
every triangle, with no BVH, treelet or sweep kernel. The hit test keeps
the sweep contract of ``hikari_tpu_torch/geometry/sweep.py`` at commit
5d48e3d (barycentric slack 1e-6, hits beyond t 1e-4; shadow rays occluded
within (1e-4, 0.9999 t_max)), and the winner's t and barycentrics are
resolved with the Moller-Trumbore arithmetic of ``wavefront._resolve_hits``
there, so a hit on the same face gives the same numbers. A lane that hits
nothing reports its reach as the sweeps do."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.vecmath import cross

EPS = 1e-6
T_MIN = 1e-4
PAIRS = 1 << 22  # (ray, triangle) pairs a chunk
COL_MASK = (1 << 8) - 1


@dataclass
class HitRecord:
    hit: torch.Tensor  # (...,) bool
    t: torch.Tensor    # (...,)
    tri: torch.Tensor  # (...,) int32 face row; -1 if miss
    b1: torch.Tensor   # (...,) barycentric of p1
    b2: torch.Tensor   # (...,) barycentric of p2


def _pair_test(o, d, p0, e1, e2):
    """(R, 1, 3) rays x (1, T, 3) faces -> t and the hit mask, (R, T)."""
    pvec = cross(d, e2)
    det = (e1 * pvec).sum(-1)
    inv = 1.0 / torch.where(det == 0.0, 1.0, det)
    tvec = o - p0
    u = (tvec * pvec).sum(-1) * inv
    qvec = cross(tvec, e1)
    v = (d * qvec).sum(-1) * inv
    t = (e2 * qvec).sum(-1) * inv
    ok = (det != 0.0) & (u >= -EPS) & (v >= -EPS) & ((1.0 + EPS) - (u + v) >= -EPS)
    return t, ok & (t > T_MIN)


def _faces(tri_p):
    p0, p1, p2 = tri_p[:, 0:3], tri_p[:, 3:6], tri_p[:, 6:9]
    return p0, p1 - p0, p2 - p0


def _chunks(r, n_faces):
    step = max(1, PAIRS // max(n_faces, 1))
    return [slice(a, a + step) for a in range(0, r, step)]


def _reach(o, d, t_max, world_lo, world_hi):
    """The sweeps' reach: t_max (inf as 3e37) capped at the world-box exit,
    as ``wavefront._world_exit_clamp`` caps it; a lane that hits nothing
    reports it rounded up to its key (``wavefront._keyify``)."""
    t_max = torch.where(torch.isfinite(t_max), t_max, 3.0e37)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-20, 1e-20, d)
    ta = (world_lo[None] - o) * inv
    tb = (world_hi[None] - o) * inv
    t_exit = torch.maximum(ta, tb).amin(-1)
    return torch.minimum(t_max, torch.clamp(t_exit, min=0.0) * 1.0001 + 1e-3)


def brute_closest_hit(tri_p, o, d, t_max, active, world_lo, world_hi) -> HitRecord:
    """Closest hit of rays o, d (R, 3) within (T_MIN, t_max) over the faces
    tri_p (F, 9); an inactive lane finds nothing."""
    r = o.shape[0]
    t_max = torch.as_tensor(t_max, dtype=o.dtype, device=o.device).expand(r)
    if active is not None:
        t_max = torch.where(active, t_max, 0.0)
    t_max = _reach(o, d, t_max, world_lo, world_hi)
    p0, e1, e2 = _faces(tri_p)
    best = torch.full((r,), -1, dtype=torch.int64, device=o.device)
    for sl in _chunks(r, p0.shape[0]):
        t, ok = _pair_test(o[sl, None], d[sl, None], p0[None], e1[None], e2[None])
        t = torch.where(ok & (t < t_max[sl, None]), t, float("inf"))
        tb, j = t.min(1)
        best[sl] = torch.where(torch.isfinite(tb), j, -1)
    hit = best >= 0
    j = torch.clamp(best, min=0)
    a0, a1, a2 = p0[j], e1[j], e2[j]
    pvec = cross(d, a2)
    det = (a1 * pvec).sum(-1)
    inv = 1.0 / torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    tvec = o - a0
    u = (tvec * pvec).sum(-1) * inv
    qvec = cross(tvec, a1)
    v = (d * qvec).sum(-1) * inv
    t = (a2 * qvec).sum(-1) * inv
    ok = hit & torch.isfinite(t) & (t > 0.0)
    t_key = (torch.clamp(t_max, min=0.0).view(torch.int32) | COL_MASK).view(torch.float32)
    return HitRecord(hit=hit, t=torch.where(ok, t, t_key),
                     tri=torch.where(hit, best, -1).to(torch.int32),
                     b1=torch.clamp(torch.where(ok, u, 0.0), 0.0, 1.0),
                     b2=torch.clamp(torch.where(ok, v, 0.0), 0.0, 1.0))


def brute_any_hit(tri_p, o, d, t_max, active=None) -> torch.Tensor:
    """Occlusion: True where a face lies within (T_MIN, 0.9999 t_max)."""
    r = o.shape[0]
    reach = torch.as_tensor(t_max, dtype=o.dtype, device=o.device).expand(r) * 0.9999
    if active is not None:
        reach = torch.where(active, reach, 0.0)
    p0, e1, e2 = _faces(tri_p)
    occ = torch.zeros(r, dtype=torch.bool, device=o.device)
    for sl in _chunks(r, p0.shape[0]):
        t, ok = _pair_test(o[sl, None], d[sl, None], p0[None], e1[None], e2[None])
        occ[sl] = (ok & (t < reach[sl, None])).any(1)
    return occ & (reach > 0.0)
