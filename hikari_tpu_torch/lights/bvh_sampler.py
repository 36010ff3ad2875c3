"""BVH light sampler: adaptive many-light sampling with bit-trail pmfs.

Port of ``hikari_tpu/lights/bvh_sampler.py`` (bvh-light-sampler.jl, a
pbrt-v4 BVHLightSampler port): per-light bounds {box, principal direction
w, power phi, cos(theta_o), cos(theta_e), two-sided}, a median-split BVH
over them built on the host, a stochastic top-down descent by node
importance, and per-light bit trails so the pmf of any light can be
replayed for MIS. Infinite lights (distant, sun, environment) are chosen
with a uniform split probability before the tree descends.

The JAX package's ``lax.while_loop`` over the descent becomes a Python loop
whose trip count is the tree's depth, fixed at build: a lane that reaches
its leaf early keeps its state through the remaining steps, so the loop
needs no host sync.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..utils import profiling
from .types import AREA, POINT, SPOT

MAX_DEPTH = 32


@dataclass
class LightBVH:
    # flat nodes in DFS order: the left child is idx + 1, the right node_right
    node_lo: torch.Tensor      # (N, 3)
    node_hi: torch.Tensor      # (N, 3)
    node_w: torch.Tensor       # (N, 3) principal emission direction
    node_phi: torch.Tensor     # (N,)
    node_cos_o: torch.Tensor   # (N,)
    node_cos_e: torch.Tensor   # (N,)
    node_two: torch.Tensor     # (N,) bool
    node_right: torch.Tensor   # (N,) int32; -1 at leaves
    node_leaf: torch.Tensor    # (N,) int32 flat light id at leaves; -1 inside
    # per-light replay of the descent, for pmf queries
    light_trail: torch.Tensor  # (NL,) int64, a bit per level (0 = left)
    light_depth: torch.Tensor  # (NL,) int32
    light_in_bvh: torch.Tensor  # (NL,) bool (False for infinite lights)
    inf_ids: torch.Tensor      # (max(n_infinite, 1),) flat ids of the infinite lights
    n_infinite: int
    n_total: int
    depth: int                 # the deepest leaf's level

    def to(self, device) -> "LightBVH":
        return LightBVH(**{f.name: getattr(self, f.name).to(device)
                           if isinstance(getattr(self, f.name), torch.Tensor)
                           else getattr(self, f.name) for f in fields(self)})


def _light_bounds_np(banks):
    """Host light bounds of every flat light (light-bounds.jl per type);
    infinite lights get finite=False."""
    n = banks.n_flat
    types = banks.light_type[:n].numpy()
    index = banks.light_idx[:n].numpy()
    lo = np.zeros((n, 3), np.float32)
    hi = np.zeros((n, 3), np.float32)
    w = np.tile(np.array([0, 0, 1.0], np.float32), (n, 1))
    phi = np.ones(n, np.float64)
    cos_o = np.full(n, -1.0, np.float32)   # emits in all directions
    cos_e = np.zeros(n, np.float32)        # theta_e = pi / 2
    two = np.zeros(n, bool)
    finite = np.ones(n, bool)
    b = {k: getattr(banks, k).numpy() for k in (
        "point_pos", "point_i", "spot_pos", "spot_dir", "spot_i", "spot_cos_total",
        "area_p0", "area_p1", "area_p2", "area_le", "area_area", "area_two_sided", "area_n")}
    for k in range(n):
        t, i = int(types[k]), int(index[k])
        if t == POINT:
            lo[k] = hi[k] = b["point_pos"][i]
            phi[k] = 4 * np.pi * b["point_i"][i].mean()
        elif t == SPOT:
            lo[k] = hi[k] = b["spot_pos"][i]
            w[k] = b["spot_dir"][i]
            phi[k] = 2 * np.pi * b["spot_i"][i].mean() * (1.0 - b["spot_cos_total"][i])
            cos_o[k] = b["spot_cos_total"][i]
        elif t == AREA:
            p = np.stack([b["area_p0"][i], b["area_p1"][i], b["area_p2"][i]])
            lo[k] = p.min(0)
            hi[k] = p.max(0)
            w[k] = b["area_n"][i]
            two[k] = bool(b["area_two_sided"][i])
            phi[k] = (np.pi * b["area_area"][i] * b["area_le"][i].mean()
                      * (2.0 if two[k] else 1.0))
            cos_o[k] = 1.0  # emits about its normal
        else:  # distant, sun, environment: infinite
            finite[k] = False
    return lo, hi, w, phi, cos_o, cos_e, two, finite


def _cone_union(w1, c1, w2, c2):
    """Union of two direction cones (DirectionCone::Union, simplified: if
    one holds the other keep it, else widen around the average)."""
    t1 = np.arccos(np.clip(c1, -1, 1))
    t2 = np.arccos(np.clip(c2, -1, 1))
    between = np.arccos(np.clip(np.dot(w1, w2), -1, 1))
    if min(between + t2, np.pi) <= t1:
        return w1, c1
    if min(between + t1, np.pi) <= t2:
        return w2, c2
    t_o = (t1 + between + t2) / 2.0
    if t_o >= np.pi:
        return w1, -1.0
    axis = np.cross(w1, w2)  # rotate w1 toward w2 by t_o - t1
    ln = np.linalg.norm(axis)
    if ln < 1e-9:
        return w1, np.cos(t_o)
    axis /= ln
    ang = t_o - t1
    c, s = np.cos(ang), np.sin(ang)
    wr = w1 * c + np.cross(axis, w1) * s + axis * np.dot(axis, w1) * (1 - c)
    return wr / np.linalg.norm(wr), np.cos(t_o)


def build_light_bvh(banks) -> LightBVH:
    """Host: median-split BVH over the finite lights' bounds, with bit
    trails for pmf replay (bvh_to_gpu + light_to_bit_trail). `banks` is
    a LightBanks on the CPU."""
    lo, hi, w, phi, cos_o, cos_e, two, finite = _light_bounds_np(banks)
    n_flat = len(lo)
    fin_ids = np.nonzero(finite)[0]
    nodes = []
    trail = np.zeros(n_flat, np.int64)
    depth = np.zeros(n_flat, np.int32)

    def emit(light_ids, bits, nbits):
        if nbits > MAX_DEPTH:
            raise ValueError(f"light BVH deeper than {MAX_DEPTH} levels")
        idx = len(nodes)
        if len(light_ids) == 1:
            li = int(light_ids[0])
            nodes.append(dict(lo=lo[li], hi=hi[li], w=w[li], phi=phi[li], cos_o=cos_o[li],
                              cos_e=cos_e[li], two=two[li], right=-1, leaf=li))
            trail[li] = bits
            depth[li] = nbits
            return idx
        cen = (lo[light_ids] + hi[light_ids]) / 2
        axis = int(np.argmax(cen.max(0) - cen.min(0)))
        order = np.argsort(cen[:, axis], kind="stable")
        half = len(light_ids) // 2
        cw, cc = w[light_ids[0]], cos_o[light_ids[0]]
        for li in light_ids[1:]:
            cw, cc = _cone_union(cw, cc, w[li], cos_o[li])
        nodes.append(dict(lo=lo[light_ids].min(0), hi=hi[light_ids].max(0), w=cw,
                          phi=phi[light_ids].sum(), cos_o=cc, cos_e=cos_e[light_ids].min(),
                          two=two[light_ids].any(), right=-2, leaf=-1))
        emit(light_ids[order[:half]], bits, nbits + 1)
        nodes[idx]["right"] = emit(light_ids[order[half:]], bits | (1 << nbits), nbits + 1)
        return idx

    if len(fin_ids):
        emit(fin_ids, 0, 0)
    else:
        nodes.append(dict(lo=np.zeros(3), hi=np.zeros(3), w=np.array([0, 0, 1.0]), phi=0.0,
                          cos_o=-1.0, cos_e=0.0, two=False, right=-1, leaf=-1))

    def arr(key, dtype):
        return torch.from_numpy(np.asarray([nd[key] for nd in nodes], dtype))

    inf_ids = np.nonzero(~finite)[0].astype(np.int32)
    return LightBVH(
        node_lo=arr("lo", np.float32), node_hi=arr("hi", np.float32),
        node_w=arr("w", np.float32), node_phi=arr("phi", np.float32),
        node_cos_o=arr("cos_o", np.float32), node_cos_e=arr("cos_e", np.float32),
        node_two=arr("two", bool), node_right=arr("right", np.int32),
        node_leaf=arr("leaf", np.int32), light_trail=torch.from_numpy(trail),
        light_depth=torch.from_numpy(depth), light_in_bvh=torch.from_numpy(finite),
        inf_ids=torch.from_numpy(inf_ids if len(inf_ids) else np.zeros(1, np.int32)),
        n_infinite=int(len(inf_ids)), n_total=n_flat,
        depth=int(depth[fin_ids].max()) if len(fin_ids) else 0)


# --- per-lane importance and descent ------------------------------------------------


def _cos_sub_clamped(sin_a, cos_a, sin_b, cos_b):
    """cos(max(a - b, 0)) (pbrt's trig-identity helper)."""
    return torch.where(cos_a > cos_b, 1.0, cos_a * cos_b + sin_a * sin_b)


def _sin_sub_clamped(sin_a, cos_a, sin_b, cos_b):
    return torch.where(cos_a > cos_b, 0.0, sin_a * cos_b - cos_a * sin_b)


def _sin_of(cos):
    return torch.sqrt(torch.clamp(1.0 - cos * cos, min=0.0))


def _node_importance(bvh: LightBVH, node, p, ns):
    """pbrt LightBounds::Importance (node_importance,
    bvh-light-sampler.jl:57-91). node (N,) int64; p, ns (N, 3)."""
    lo = bvh.node_lo[node]
    hi = bvh.node_hi[node]
    pc = 0.5 * (lo + hi)
    d2 = ((p - pc) ** 2).sum(-1)
    diag2 = ((hi - lo) ** 2).sum(-1)
    d2 = torch.maximum(d2, diag2 * 0.25)
    wi = (p - pc) / torch.sqrt(torch.clamp(d2, min=1e-12))[..., None]
    cos_t = (bvh.node_w[node] * wi).sum(-1)
    cos_t = torch.where(bvh.node_two[node], torch.abs(cos_t), cos_t)
    sin_t = _sin_of(cos_t)
    # the cluster's half-angle seen from p
    cos_u2 = torch.clamp(1.0 - diag2 * 0.25 / torch.clamp(d2, min=1e-12), 0.0, 1.0)
    cos_u = torch.sqrt(cos_u2)
    sin_u = torch.sqrt(torch.clamp(1.0 - cos_u2, min=0.0))
    cos_o = bvh.node_cos_o[node]
    sin_o = _sin_of(cos_o)
    # cos(theta') with theta' = max(theta - theta_o - theta_u, 0)
    sin_to = _sin_sub_clamped(sin_t, cos_t, sin_o, cos_o)
    cos_to = _cos_sub_clamped(sin_t, cos_t, sin_o, cos_o)
    cos_tp = _cos_sub_clamped(sin_to, cos_to, sin_u, cos_u)
    imp = bvh.node_phi[node] * cos_tp / d2
    imp = torch.where(cos_tp <= bvh.node_cos_e[node], 0.0, imp)  # outside the cone
    # the receiver's clamp where its normal is known
    cos_i = torch.abs((wi * ns).sum(-1))
    cos_ip = _cos_sub_clamped(_sin_of(cos_i), cos_i, sin_u, cos_u)
    imp = imp * torch.where((ns != 0.0).any(-1), cos_ip, 1.0)
    return torch.clamp(imp, min=0.0)


def _split_probability(bvh: LightBVH) -> tuple[float, bool]:
    """(probability of choosing an infinite light, whether a tree exists)."""
    n_inf = bvh.n_infinite
    has_tree = bvh.n_total > n_inf
    return (n_inf / (n_inf + (1.0 if has_tree else 0.0)) if n_inf else 0.0), has_tree


def _children(bvh: LightBVH, node, p, ns):
    """(left, right, importance left, importance right) of each lane's node;
    a leaf's children are clamped into the table and never taken."""
    left = torch.clamp(node + 1, max=bvh.node_leaf.shape[0] - 1)
    right = torch.clamp(bvh.node_right[node].long(), min=0)
    return left, right, _node_importance(bvh, left, p, ns), _node_importance(bvh, right, p, ns)


@profiling.spanned("hikari.lights")
def bvh_sample_light(bvh: LightBVH, p, ns, u):
    """Stochastic descent -> (flat light id, pmf) (bvh_sample_light,
    bvh-light-sampler.jl:103-200); lanes with no valid pick get pmf 0."""
    n = p.shape[0]
    dev = p.device
    n_inf = bvh.n_infinite
    p_inf, has_tree = _split_probability(bvh)

    pick_inf = u < p_inf
    # the infinite branch: uniform over the infinite lights
    u_inf = torch.where(pick_inf, u / max(p_inf, 1e-9), 0.0)
    k = torch.clamp((u_inf * max(n_inf, 1)).to(torch.int64), 0, max(n_inf - 1, 0))
    inf_light = bvh.inf_ids[k]
    inf_pmf = p_inf / max(n_inf, 1)

    # the tree branch
    u_t = torch.where(pick_inf, 0.0, (u - p_inf) / max(1.0 - p_inf, 1e-9))
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    pmf = torch.full((n,), 1.0 - p_inf, device=dev)
    done = pick_inf | (not has_tree)
    light = torch.zeros(n, dtype=torch.int32, device=dev)
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    for _ in range(bvh.depth + 1 if has_tree else 0):
        leaf = bvh.node_leaf[node]
        at_leaf = ~done & (leaf >= 0)
        light = torch.where(at_leaf, leaf, light)
        done = done | at_leaf
        left, right, i_l, i_r = _children(bvh, node, p, ns)
        tot = i_l + i_r
        dead = ~done & (tot <= 0.0)
        ok = ok & ~dead
        done = done | dead
        p_l = torch.where(tot > 0.0, i_l / torch.clamp(tot, min=1e-12), 0.5)
        go_l = u_t < p_l
        u_new = torch.where(go_l, u_t / torch.clamp(p_l, min=1e-9),
                            (u_t - p_l) / torch.clamp(1.0 - p_l, min=1e-9))
        u_new = torch.clamp(u_new, 0.0, 1.0 - 1e-7)
        pmf = torch.where(~done, pmf * torch.where(go_l, p_l, 1.0 - p_l), pmf)
        node = torch.where(~done, torch.where(go_l, left, right), node)
        u_t = torch.where(done, u_t, u_new)
    light = torch.where(pick_inf, inf_light, light)
    pmf = torch.where(pick_inf, inf_pmf, torch.where(ok, pmf, 0.0))
    return light.to(torch.int32), pmf


@profiling.spanned("hikari.lights")
def bvh_pmf(bvh: LightBVH, p, ns, flat_light):
    """Replay the pmf of a given light through its bit trail (bvh_pmf /
    light_to_bit_trail, bvh-light-sampler.jl:202-269)."""
    n = p.shape[0]
    n_inf = bvh.n_infinite
    p_inf, _ = _split_probability(bvh)
    li = torch.clamp(flat_light.long(), 0, bvh.light_trail.shape[0] - 1)
    trail = bvh.light_trail[li]
    depth = bvh.light_depth[li]
    node = torch.zeros(n, dtype=torch.int64, device=p.device)
    pmf = torch.full((n,), 1.0 - p_inf, device=p.device)
    for lvl in range(bvh.depth):
        active = lvl < depth
        left, right, i_l, i_r = _children(bvh, node, p, ns)
        tot = torch.clamp(i_l + i_r, min=1e-12)
        bit = (trail >> lvl) & 1
        pmf = torch.where(active, pmf * torch.where(bit == 0, i_l / tot, i_r / tot), pmf)
        node = torch.where(active, torch.where(bit == 0, left, right), node)
    pmf_inf = p_inf / max(n_inf, 1) if n_inf else 0.0
    return torch.where(bvh.light_in_bvh[li], pmf, pmf_inf)
