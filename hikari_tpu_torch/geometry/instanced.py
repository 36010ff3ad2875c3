"""Instanced (two-level, TLAS/BLAS) packet traversal.

Port of ``hikari_tpu/geometry/instanced.py``. Each unique mesh (BLAS)
keeps one copy of its BVH-leaf-ordered triangles as object-space
treelets; a "world treelet" is one (instance, BLAS treelet) entry holding
only a world-space AABB, the BLAS treelet id and the instance id, so a
thousand placements of a mesh cost kilobytes. The tile x treelet cull and
the pair list of ``wavefront.py`` run unchanged over the world AABBs; the
sweeps of ``sweep_inst.py`` move each ray tile into the instance's object
space with ``A = inv(world_from_object)^T``.

Where the instanced path differs from the flat one, as in the reference:
no per-ray super-box pre-pass (the tables have no super boxes); no
Moller-Trumbore resolve (the sweep's exact t, u, v are the hit record and
a missed lane keeps its reach as t); hit records carry
``tri = world_treelet * 256 + column``, which ``integrators/volpath.py``
decodes into the shared face row and the instance.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from .sweep import TREELET
from .sweep_inst import closest_inst, occlusion_inst
from .traverse import HitRecord
from .wavefront import _unsort, build_treelets, prepare_closest, prepare_occlusion

# the reference packs (tile << 16 | world treelet) into one int32 per pair,
# so it accepts at most this many world treelets; the port keeps the limit
# so that both packages accept the same scenes
MAX_WORLD_TREELETS = (1 << 16) - 1


@dataclass
class InstancedTreelets:
    """Two-level treelet tables."""

    lo: torch.Tensor       # (Tw, 3) world AABB per (instance, BLAS treelet)
    hi: torch.Tensor       # (Tw, 3)
    coef: torch.Tensor     # (Tb, TREELET, 12) f32 shared object-space coefficients
    ti_obj: torch.Tensor   # (Tw,) int32 -> BLAS treelet id (row of coef)
    ti_inst: torch.Tensor  # (Tw,) int32 -> instance id
    inst_a: torch.Tensor   # (I, 4, 4) f32: [o, 1] @ A = [o_obj, 1]

    def to(self, device) -> "InstancedTreelets":
        return InstancedTreelets(**{f.name: getattr(self, f.name).to(device)
                                    for f in fields(self)})


_CORNERS = np.array([(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
                     (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)], bool)


def build_instanced_treelets(blas_tris, instances) -> InstancedTreelets:
    """blas_tris: per BLAS, leaf-ordered (p0, p1, p2), each padded to a
    multiple of TREELET with degenerate triangles so that face rows line
    up with treelet slots. instances: (blas_id, world_from_object 4x4) per
    instance."""
    no_supers = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32))
    blas, base = [], [0]
    for p0, p1, p2 in blas_tris:
        if len(p0) % TREELET:
            raise ValueError(f"BLAS of {len(p0)} triangles is not padded to a "
                             f"multiple of {TREELET}")
        blas.append(build_treelets(p0, p1, p2, no_supers))
        base.append(base[-1] + blas[-1].lo.shape[0])

    lo_l, hi_l, obj_l, inst_l, mats = [], [], [], [], []
    for ii, (bid, m) in enumerate(instances):
        m = np.asarray(m, np.float64).reshape(4, 4)
        olo, ohi = blas[bid].lo.numpy(), blas[bid].hi.numpy()
        # the 8 transformed corners of each object-space AABB, rebound
        corners = np.where(_CORNERS[None], ohi[:, None], olo[:, None])  # (T, 8, 3)
        wc = corners @ m[:3, :3].T + m[:3, 3]
        pad = olo[:, 0] > 1.0e37  # padding treelets keep their sentinel bounds
        lo_l.append(np.where(pad[:, None], olo, wc.min(axis=1)).astype(np.float32))
        hi_l.append(np.where(pad[:, None], ohi, wc.max(axis=1)).astype(np.float32))
        nt = olo.shape[0]
        obj_l.append(np.arange(nt, dtype=np.int32) + base[bid])
        inst_l.append(np.full(nt, ii, np.int32))
        mats.append(np.linalg.inv(m).T.astype(np.float32))  # last column [0,0,0,1]

    n_world = sum(len(x) for x in obj_l)
    if n_world > MAX_WORLD_TREELETS:
        raise ValueError(f"{n_world} world treelets exceed the limit of "
                         f"{MAX_WORLD_TREELETS}; reduce the instance count")
    return InstancedTreelets(
        lo=torch.from_numpy(np.concatenate(lo_l)), hi=torch.from_numpy(np.concatenate(hi_l)),
        coef=torch.cat([b.coef for b in blas]),
        ti_obj=torch.from_numpy(np.concatenate(obj_l)),
        ti_inst=torch.from_numpy(np.concatenate(inst_l)),
        inst_a=torch.from_numpy(np.ascontiguousarray(np.stack(mats))))


def _sweep_args(tl: InstancedTreelets):
    return tl.ti_obj, tl.ti_inst, tl.coef, tl.inst_a


def closest_hit_instanced(tl: InstancedTreelets, o, d, t_max, world_lo, world_hi,
                          active=None, presorted=False) -> HitRecord:
    """Two-level closest hit. o/d (R, 3), t_max (R,); returns tri =
    world_treelet * TREELET + column. Inactive lanes get reach 0.
    presorted: as in wavefront.closest_hit_packets."""
    ps = prepare_closest(tl, o, d, t_max, world_lo, world_hi, active, presorted)
    n_pad, sz = ps.n_pad, ps.os.shape[0]
    t_res = o.new_zeros(n_pad)
    b1 = o.new_zeros(n_pad)
    b2 = o.new_zeros(n_pad)
    tri = torch.full((n_pad,), -1, dtype=torch.int32, device=o.device)
    if sz:
        t_res[:sz], tri[:sz], b1[:sz], b2[:sz] = closest_inst(
            ps.os, ps.ds, ps.ts, ps.tre, ps.tn_bits, ps.seg, *_sweep_args(tl))
    t_res, tri, b1, b2 = _unsort(ps, t_res, tri, b1, b2)
    return HitRecord(hit=tri >= 0, t=t_res, tri=tri, b1=b1, b2=b2)


def any_hit_instanced(tl: InstancedTreelets, o, d, t_max, world_lo, world_hi,
                      active=None, group=None) -> torch.Tensor:
    """Two-level occlusion: True where a triangle lies within
    (1e-4, 0.9999 t_max). group: optional (R,) NEE light ids."""
    ps = prepare_occlusion(tl, o, d, t_max, world_lo, world_hi, active, group)
    sz = ps.os.shape[0]
    occ = torch.zeros(ps.n_pad, dtype=torch.int32, device=o.device)
    reach = torch.zeros(ps.n_pad, device=o.device)
    if sz:
        occ[:sz] = occlusion_inst(ps.os, ps.ds, ps.ts, (ps.ts <= 0.0).to(torch.int32),
                                  ps.tre, ps.tn_bits, ps.seg, *_sweep_args(tl))
        reach[:sz] = ps.ts
    occ, reach = _unsort(ps, occ, reach)
    # lanes with reach 0 (inactive, padding) are not occluded
    return (occ > 0) & (reach > 0.0)

