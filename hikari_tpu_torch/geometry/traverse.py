"""The skip-link BVH walk and hit records (port of
``hikari_tpu/geometry/traverse.py``).

The walk is what ``Scene.build(traversal="skiplink")`` selects: every lane
walks the DFS-ordered flat BVH of ``bvh.py`` with a node index and its best
hit, and no stack. A box that the ray misses (or that starts beyond the
best hit) sends the lane along the node's skip link; a box it hits sends it
to the next node in DFS order, after testing the node's triangles if it is
a leaf. The reference runs the wavefront in lockstep inside one
``lax.while_loop``; here it is a Python loop over per-lane masks that asks
the host once a step whether any lane is left, and re-gathers the walk to
its live lanes once half of them have finished. Each lane's steps are the
reference's, so hits equal its hits. On the card the packet engine of
``wavefront.py`` is the traversal (``auto`` picks it on every device).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from .bvh import DEFAULT_LEAF_SIZE, FlatBVH
from .triangle import intersect_triangle

# brute_force_closest_hit's (ray, triangle) pairs a chunk of rays
BRUTE_PAIRS = 1 << 22


@dataclass
class HitRecord:
    hit: torch.Tensor  # (...,) bool
    t: torch.Tensor    # (...,)
    tri: torch.Tensor  # (...,) int32 triangle id in BVH-leaf order; -1 if miss
    b1: torch.Tensor   # (...,) barycentric of p1
    b2: torch.Tensor   # (...,) barycentric of p2


@dataclass
class DeviceBVH:
    """The flat BVH and each triangle's corners in BVH-leaf order, so that a
    hit's `tri` is the face row the scene's per-face tables use."""

    lo: torch.Tensor     # (N, 3)
    hi: torch.Tensor     # (N, 3)
    first: torch.Tensor  # (N,) int64
    count: torch.Tensor  # (N,) int64
    skip: torch.Tensor   # (N,) int64
    p0: torch.Tensor     # (P, 3)
    p1: torch.Tensor
    p2: torch.Tensor
    leaf_size: int = DEFAULT_LEAF_SIZE

    def to(self, device) -> "DeviceBVH":
        return DeviceBVH(**{f.name: getattr(self, f.name).to(device)
                            if isinstance(getattr(self, f.name), torch.Tensor)
                            else getattr(self, f.name) for f in fields(self)})


def device_bvh(fb: FlatBVH, p0, p1, p2) -> DeviceBVH:
    """DeviceBVH of a FlatBVH and the triangles' corners (numpy, input
    order; reordered to leaf order here)."""
    order = fb.prim_order

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)

    return DeviceBVH(lo=t(fb.lo), hi=t(fb.hi), first=t(fb.first, torch.int64),
                     count=t(fb.count, torch.int64), skip=t(fb.skip, torch.int64),
                     p0=t(p0[order]), p1=t(p1[order]), p2=t(p2[order]))


def _slab(lo, hi, o, inv_d, t_best):
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    t_near = torch.minimum(t0, t1).amax(-1)
    t_far = torch.maximum(t0, t1).amin(-1) * 1.0000004
    return (t_near <= t_far) & (t_far > 0.0) & (t_near < t_best)


def _walk(bvh: DeviceBVH, o, d, t_max, closest: bool):
    """The lockstep walk. Per-lane state is (node, t_best, tri, b1, b2) for
    a closest hit, (node, found) for occlusion; returns the final state."""
    n_nodes = bvh.lo.shape[0]
    n_prims = bvh.p0.shape[0]
    r = o.shape[0]
    dev = o.device
    inv_d = 1.0 / torch.where(d == 0.0, 1e-20, d)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(r)
    # the whole wavefront's results; the walk runs on `lanes` (its live
    # subset, re-gathered when half has finished) and scatters back
    out = dict(idx=torch.zeros(r, dtype=torch.int64, device=dev), t=t_max.clone(),
               tri=torch.full((r,), -1, dtype=torch.int32, device=dev),
               b1=o.new_zeros(r), b2=o.new_zeros(r),
               found=torch.zeros(r, dtype=torch.bool, device=dev))
    keys = ("idx", "t", "tri", "b1", "b2") if closest else ("idx", "found")
    lanes = torch.arange(r, device=dev)
    sub = dict(o=o, d=d, inv_d=inv_d, t=out["t"])
    sub.update((k, out[k]) for k in keys)
    while lanes.numel():
        idx = sub["idx"]
        active = idx < n_nodes
        if not closest:
            active = active & ~sub["found"]
        ii = torch.clamp(idx, max=n_nodes - 1)
        box_hit = _slab(bvh.lo[ii], bvh.hi[ii], sub["o"], sub["inv_d"], sub["t"]) & active
        count = bvh.count[ii]
        first = bvh.first[ii]
        leaf = box_hit & (count > 0)
        for k in range(bvh.leaf_size):
            j = torch.clamp(first + k, max=n_prims - 1)
            valid = leaf & (k < count)
            hit, t, b1, b2 = intersect_triangle(sub["o"], sub["d"], bvh.p0[j], bvh.p1[j],
                                                bvh.p2[j], sub["t"])
            take = valid & hit
            if closest:
                sub["t"] = torch.where(take, t, sub["t"])
                sub["tri"] = torch.where(take, j.to(torch.int32), sub["tri"])
                sub["b1"] = torch.where(take, b1, sub["b1"])
                sub["b2"] = torch.where(take, b2, sub["b2"])
            else:
                sub["found"] = sub["found"] | take
        nxt = torch.where(box_hit, idx + 1, bvh.skip[ii])
        sub["idx"] = torch.where(active, nxt, n_nodes)
        running = sub["idx"] < n_nodes
        if not closest:
            running = running & ~sub["found"]
        n_run = int(running.sum())
        if n_run == 0 or 2 * n_run <= lanes.numel():
            for k in keys:
                out[k][lanes] = sub[k]
            keep = running.nonzero().squeeze(-1)
            lanes = lanes[keep]
            sub = {k: v[keep] for k, v in sub.items()}
    return out


def closest_hit(bvh: DeviceBVH, o, d, t_max) -> HitRecord:
    """Closest intersection of a wavefront of rays: o, d (R, 3), t_max
    (R,); a lane with t_max 0 finds nothing."""
    s = _walk(bvh, o, d, t_max, closest=True)
    return HitRecord(hit=s["tri"] >= 0, t=s["t"], tri=s["tri"], b1=s["b1"], b2=s["b2"])


def any_hit(bvh: DeviceBVH, o, d, t_max) -> torch.Tensor:
    """Occlusion: True where any triangle lies within (1e-9, t_max)."""
    return _walk(bvh, o, d, t_max, closest=False)["found"]


def brute_force_closest_hit(p0, p1, p2, o, d, t_max) -> HitRecord:
    """Every ray against every triangle (for validation and tiny scenes);
    the first triangle of least t wins. Rays go in chunks of at most
    BRUTE_PAIRS (ray, triangle) pairs."""
    r = o.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(r)
    step = max(1, BRUTE_PAIRS // max(p0.shape[0], 1))
    parts = []
    for a in range(0, r, step):
        sl = slice(a, a + step)
        hit, t, b1, b2 = intersect_triangle(o[sl, None, :], d[sl, None, :], p0[None],
                                            p1[None], p2[None], t_max[sl, None])
        j = torch.where(hit, t, float("inf")).argmin(1, keepdim=True)
        any_h = hit.gather(1, j)[:, 0]
        parts.append((any_h, torch.where(any_h, t.gather(1, j)[:, 0], t_max[sl]),
                      torch.where(any_h, j[:, 0].to(torch.int32), -1),
                      b1.gather(1, j)[:, 0], b2.gather(1, j)[:, 0]))
    hit, t, tri, b1, b2 = (torch.cat(x) for x in zip(*parts))
    return HitRecord(hit=hit, t=t, tri=tri, b1=b1, b2=b2)
