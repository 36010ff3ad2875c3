"""Medium sampling: delta tracking, ratio tracking and the HG phase function.

Port of ``hikari_tpu/media/sample.py``. Free flights are sampled against
a per-cell majorant (a stateless DDA over the medium's MAJORANT_RES^3
cells: dense grids' voxel maxima, sparse brick grids' brick maxima); each
event is an absorption, a real scatter or a null scatter, with pbrt-v4's
rescaled path probabilities (r_u, r_l). Every lane draws from its own
64-bit LCG seeded from the bits of its ray, so a lane's result depends on
its own state only.

The reference's lockstep ``lax.while_loop`` (run while any lane tracks, at
most MAX_TRACK_STEPS steps) becomes a Python loop with one host sync a
step, the count of lanes still tracking. Its body runs on a working set
of lanes (``_lockstep``): the whole wavefront at first, re-gathered to the
lanes still tracking whenever half of the set has finished, so the dense
tail of a cloud costs what its live lanes cost. Finished lanes are frozen
(every update is masked by the lane's own status; only the LCG they no
longer read moves), so both schedules give every lane the same result.

The reference's environment switch HIKARI_STOCH_TRILERP is fixed at its
default: the tracking loops read the density at one trilinear corner
picked with the corner's weight as probability (``_stoch_corner``); the
exact eight-corner read is used where ``u3`` is None.

HG convention (pbrt-v4): the scattering angle is measured from the
propagation direction -wo, p = hg(dot(-wo, wi), g).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core.lookup import bank_lookup as _bl
from ..core.vecmath import coordinate_system, normalize
from ..sampling.hashes import f32_bits, mix_bits, shr
from ..spectral.rgb2spec import coeff4_eval, rgb_unbounded_eval
from .types import BRICK, BRICK_DIM, GRID, HOMOGENEOUS, MAJORANT_RES, RGBGRID, MediumBanks

# lockstep step cap (global steps, as in the reference): a step is one free
# flight or one majorant-cell crossing
MAX_TRACK_STEPS = 512
ONE_MINUS_EPS = 1.0 - 2.0 ** -24
# working sets are whole multiples of this many lanes (see _lockstep)
LANE_QUANTUM = 64

# delta-tracking lane status
TRACKING = 0
PASSED = 1      # reached t_max (the surface, or escape)
SCATTERED = 2   # real scatter event
ABSORBED = 3

_LCG_MUL = 0x5DEECE66D
_U32_UNIT = 2.0 ** -32


# --- per-ray LCG ------------------------------------------------------------------


def lcg_init(o, d, t_max):
    """64-bit LCG state (int64 bit pattern) seeded from the bits of the ray
    o, d and t_max (inf seeds as 1e30)."""
    ob = [f32_bits(o[..., i]) for i in range(3)]
    db = [f32_bits(d[..., i]) for i in range(3)]
    tm = f32_bits(torch.where(torch.isfinite(t_max), t_max, 1e30).float())
    s1 = mix_bits((ob[0] ^ (ob[1] << 16)) ^ ((ob[2] << 32) ^ tm))
    s2 = mix_bits((db[0] ^ (db[1] << 16)) ^ (db[2] << 32))
    return s1 ^ s2


def lcg_next(state):
    """(new state, uniform float32 in [0, 1)): state * 0x5DEECE66D + 11
    mod 2^64, top 32 bits."""
    new = state * _LCG_MUL + 11
    u = shr(new, 32).float() * _U32_UNIT
    return new, torch.clamp(u, max=ONE_MINUS_EPS)


# --- HG phase function ----------------------------------------------------------


def hg_phase(g, cos_theta_scatter):
    """p(cos), cos measured between the propagation direction -wo and wi."""
    g = torch.clamp(g, -0.99, 0.99)
    g2 = g * g
    denom = torch.clamp(1.0 + g2 - 2.0 * g * cos_theta_scatter, min=1e-7)
    return (1.0 - g2) / (4.0 * math.pi * denom * torch.sqrt(denom))


def hg_eval(g, wo, wi):
    """Phase value (= pdf) for wo, wi pointing away from the scatter point."""
    return hg_phase(g, (-wo * wi).sum(-1))


def hg_sample(g, wo, u2):
    """wi from the HG lobe around -wo; returns (wi, pdf)."""
    g = torch.clamp(g, -0.99, 0.99)
    iso = g.abs() < 1e-3
    g_safe = torch.where(iso, 0.5, g)
    g2 = g_safe * g_safe
    sqr = (1.0 - g2) / (1.0 - g_safe + 2.0 * g_safe * u2[..., 0])
    cos_aniso = torch.clamp((1.0 + g2 - sqr * sqr) / (2.0 * g_safe), -1.0, 1.0)
    cos_t = torch.where(iso, 1.0 - 2.0 * u2[..., 0], cos_aniso)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u2[..., 1]
    fwd = -wo
    t1, t2 = coordinate_system(fwd)
    wi = normalize((sin_t * torch.cos(phi))[..., None] * t1
                   + (sin_t * torch.sin(phi))[..., None] * t2
                   + cos_t[..., None] * fwd)
    return wi, hg_phase(g, cos_t)


# --- medium properties ------------------------------------------------------------


def _stoch_corner(x0, x1, y0, y1, z0, z1, dx, dy, dz, u3):
    """One trilinear corner, each axis taking its upper corner with
    probability d{x,y,z}: P(corner) is the corner's weight, so the read is
    an unbiased estimate of the interpolated value wherever it enters
    linearly (the tracking loops' accept probabilities and null weights)."""
    return (torch.where(u3[..., 0] < dx, x1, x0), torch.where(u3[..., 1] < dy, y1, y0),
            torch.where(u3[..., 2] < dz, z1, z0))


def _voxels(banks: MediumBanks, midx, p):
    """Voxel-centred trilinear setup of p in medium midx's grid: (inside,
    resolution (..., 3) int64, corners x0, x1, y0, y1, z0, z1, weights dx,
    dy, dz)."""
    lo = _bl(banks.bounds_lo, midx)
    hi = _bl(banks.bounds_hi, midx)
    res = _bl(banks.grid_res, midx).long()
    ext = torch.clamp(hi - lo, min=1e-12)
    q = (p - lo) / ext
    inside = ((q >= 0.0) & (q <= 1.0)).all(-1)
    nf = res.float()
    f = torch.minimum(torch.clamp(q * nf - 0.5, min=0.0), nf - 1.0)
    i0 = torch.floor(f).long()
    w = f - i0.float()
    i1 = torch.minimum(i0 + 1, res - 1)
    return (inside, res, i0[..., 0], i1[..., 0], i0[..., 1], i1[..., 1], i0[..., 2],
            i1[..., 2], w[..., 0], w[..., 1], w[..., 2])


def _flat_reader(buffer, off, res):
    """at(x, y, z) of a dense grid stored from voxel off of a flat buffer."""
    nx, ny = res[..., 0], res[..., 1]

    def at(xi, yi, zi):
        lin = off + (zi * ny + yi) * nx + xi
        return buffer[torch.clamp(lin, 0, buffer.shape[0] - 1)]
    return at


def _trilinear(at, x0, x1, y0, y1, z0, z1, dx, dy, dz):
    c00 = at(x0, y0, z0) * (1 - dx) + at(x1, y0, z0) * dx
    c10 = at(x0, y1, z0) * (1 - dx) + at(x1, y1, z0) * dx
    c01 = at(x0, y0, z1) * (1 - dx) + at(x1, y0, z1) * dx
    c11 = at(x0, y1, z1) * (1 - dx) + at(x1, y1, z1) * dx
    c0 = c00 * (1 - dy) + c10 * dy
    c1 = c01 * (1 - dy) + c11 * dy
    return c0 * (1 - dz) + c1 * dz


def _grid_density(banks: MediumBanks, midx, p, u3=None):
    """Density of grid medium midx at world points p: trilinear over voxel
    centres, 0 outside its box; u3 (..., 3) uniforms give the stochastic
    one-corner estimate instead."""
    inside, res, x0, x1, y0, y1, z0, z1, dx, dy, dz = _voxels(banks, midx, p)
    at = _flat_reader(banks.density, _bl(banks.grid_offset, midx).long(), res)
    if u3 is not None:
        d = at(*_stoch_corner(x0, x1, y0, y1, z0, z1, dx, dy, dz, u3))
    else:
        d = _trilinear(at, x0, x1, y0, y1, z0, z1, dx, dy, dz)
    return torch.where(inside, d, 0.0)


def _brick_density(banks: MediumBanks, midx, p, u3=None):
    """Density of brick medium midx at world points p, as _grid_density
    reads a dense grid: per corner voxel one page-table read picks the
    brick (or the background) and one pool read gives the voxel.

    The pool index (base + brick) * 512 + voxel is int64: the JAX
    package's int32 index wraps past 2^22 bricks (8.6 GB of pool, which
    one card can hold); below that the two are equal."""
    inside, res, x0, x1, y0, y1, z0, z1, dx, dy, dz = _voxels(banks, midx, p)
    tab_off = _bl(banks.brick_tab_off, midx).long()
    base = _bl(banks.brick_base, midx).long()
    bg = _bl(banks.brick_bg, midx)
    tbx, tby = res[..., 0] // BRICK_DIM, res[..., 1] // BRICK_DIM
    table, vals = banks.brick_table, banks.brick_vals

    def at(xi, yi, zi):
        cell = tab_off + ((zi >> 3) * tby + (yi >> 3)) * tbx + (xi >> 3)
        bid = table[torch.clamp(cell, 0, table.shape[0] - 1)].long()
        lin = (base + bid) * 512 + (((zi & 7) * 8 + (yi & 7)) * 8 + (xi & 7))
        return torch.where(bid >= 0, vals[torch.clamp(lin, 0, vals.shape[0] - 1)], bg)

    if u3 is not None:
        d = at(*_stoch_corner(x0, x1, y0, y1, z0, z1, dx, dy, dz, u3))
    else:
        d = _trilinear(at, x0, x1, y0, y1, z0, z1, dx, dy, dz)
    return torch.where(inside, d, 0.0)


def _rgb_grid_trilinear(banks: MediumBanks, midx, p, buffer, u3=None):
    """RGB value of an RGBGridMedium buffer (rgb_sa, rgb_ss or rgb_le) at p."""
    inside, res, x0, x1, y0, y1, z0, z1, dx, dy, dz = _voxels(banks, midx, p)
    at = _flat_reader(buffer, _bl(banks.rgb_offset, midx).long(), res)
    if u3 is not None:
        v = at(*_stoch_corner(x0, x1, y0, y1, z0, z1, dx, dy, dz, u3))
    else:
        v = _trilinear(at, x0, x1, y0, y1, z0, z1, dx[..., None], dy[..., None],
                       dz[..., None])
    return torch.where(inside[..., None], v, 0.0)


def _lane_media(banks: MediumBanks, midx, lam) -> dict:
    """Per-lane constants of medium_properties: the bank spectra at lam,
    g and the medium type."""
    return dict(sa=coeff4_eval(_bl(banks.sigma_a_c4, midx), lam),
                ss=coeff4_eval(_bl(banks.sigma_s_c4, midx), lam),
                le=coeff4_eval(_bl(banks.le_c4, midx), lam),
                g=_bl(banks.g, midx), mtype=_bl(banks.med_type, midx))


def _properties(banks: MediumBanks, table, lane: dict, midx, p, lam, u3=None):
    sa, ss, le = lane["sa"], lane["ss"], lane["le"]
    mtype = lane["mtype"]
    if banks.has_brick:
        scale = torch.where(mtype == BRICK, _brick_density(banks, midx, p, u3), 1.0)
        sa = sa * scale[..., None]
        ss = ss * scale[..., None]
    if banks.has_grid:
        scale = torch.where(mtype == GRID, _grid_density(banks, midx, p, u3), 1.0)
        sa = sa * scale[..., None]
        ss = ss * scale[..., None]
        if banks.has_rgb:
            is_rgb = (mtype == RGBGRID)[..., None]

            def rgb(buffer):
                return rgb_unbounded_eval(
                    table, _rgb_grid_trilinear(banks, midx, p, buffer, u3), lam)

            sa = torch.where(is_rgb, rgb(banks.rgb_sa), sa)
            ss = torch.where(is_rgb, rgb(banks.rgb_ss), ss)
            le = torch.where(is_rgb, rgb(banks.rgb_le), le)
    return sa, ss, le, lane["g"]


def medium_properties(banks: MediumBanks, table, midx, p, lam, u3=None):
    """sigma_a, sigma_s, Le (..., 4) at wavelengths lam and HG g (...,) of
    medium midx at p. u3: stochastic one-corner grid reads (see
    _stoch_corner); exact trilinear when None. A medium without an RGB
    grid skips the RGB reads, whose result it would discard."""
    return _properties(banks, table, _lane_media(banks, midx, lam), midx, p, lam, u3)


def _deflect(banks: MediumBanks, mi, p, d, dt):
    """Gravitational bending toward defl_center with the medium's strength;
    the identity where the strength is 0."""
    c = _bl(banks.defl_center, mi)
    s = _bl(banks.defl_strength, mi)
    r = c - p
    rn2 = (r * r).sum(-1, keepdim=True)
    accel = r / torch.clamp(rn2 * torch.sqrt(rn2), min=1e-9)
    d_new = d + dt[..., None] * s[..., None] * accel
    norm = torch.sqrt(torch.clamp((d_new * d_new).sum(-1, keepdim=True), min=1e-20))
    return torch.where((s > 0.0)[..., None], d_new / norm, d)


# --- majorants ------------------------------------------------------------------


def _spectral_majorant_base(banks: MediumBanks, midx, lam):
    """Per-lane spectral factor that the cell's scalar majorant multiplies:
    uplift(sigma_a + sigma_s), or 1.15 for RGB grids (their cells hold an
    absolute max-component sigma_t; the uplift can exceed it a little)."""
    base = (coeff4_eval(_bl(banks.sigma_a_c4, midx), lam)
            + coeff4_eval(_bl(banks.sigma_s_c4, midx), lam))
    is_rgb = _bl(banks.med_type, midx) == RGBGRID
    return torch.where(is_rgb[..., None], 1.15, base)


def majorant_cell(banks: MediumBanks, midx, p):
    """Scalar majorant of the cell holding p; homogeneous media use their
    (possibly inflated) max_density."""
    lo = _bl(banks.bounds_lo, midx)
    hi = _bl(banks.bounds_hi, midx)
    ext = torch.clamp(hi - lo, min=1e-12)
    is_spatial = _bl(banks.med_type, midx) != HOMOGENEOUS
    q = torch.clamp((p - lo) / ext, 0.0, 1.0 - 1e-6)
    c = (q * MAJORANT_RES).long()
    cell = banks.maj[midx.long(), c[..., 2], c[..., 1], c[..., 0]]
    return torch.where(is_spatial, cell, _bl(banks.max_density, midx))


def majorant_cell_exit(banks: MediumBanks, midx, o, d, t, t1):
    """Ray parameter where the ray leaves its current majorant cell, pushed
    just past the boundary (the DDA step, recomputed from the position)."""
    lo = _bl(banks.bounds_lo, midx)
    hi = _bl(banks.bounds_hi, midx)
    ext = torch.clamp(hi - lo, min=1e-12)
    is_spatial = _bl(banks.med_type, midx) != HOMOGENEOUS
    p = o + t[..., None] * d
    q = torch.clamp((p - lo) / ext, 0.0, 1.0 - 1e-6)
    c = torch.floor(q * MAJORANT_RES)
    cell_size = ext / MAJORANT_RES
    cell_lo = lo + c * cell_size
    cell_hi = cell_lo + cell_size
    inv_d = 1.0 / torch.where(d == 0.0, 1e-20, d)
    t_far = torch.where(d >= 0.0, (cell_hi - o) * inv_d, (cell_lo - o) * inv_d)
    t_exit = t_far.amin(-1)
    t_exit = torch.maximum(t_exit, t + 1e-5) + 1e-4 * cell_size.amax(-1) / 4.0
    return torch.where(is_spatial, torch.minimum(t_exit, t1), t1)


def majorant(banks: MediumBanks, table, midx, lam):
    """Global spectral majorant of medium midx."""
    return _spectral_majorant_base(banks, midx, lam) * _bl(banks.max_density, midx)[..., None]


def medium_segment(banks: MediumBanks, midx, o, d, t_max):
    """Ray-medium overlap [t0, t1] clipped to [0, t_max]: the whole ray for
    homogeneous and RGB-grid media, the box's slab for density grids."""
    mtype = _bl(banks.med_type, midx)
    is_grid = (mtype == GRID) | (mtype == BRICK)
    lo = _bl(banks.bounds_lo, midx)
    hi = _bl(banks.bounds_hi, midx)
    inv_d = 1.0 / torch.where(d == 0.0, 1e-20, d)
    ta = (lo - o) * inv_d
    tb = (hi - o) * inv_d
    t_near = torch.minimum(ta, tb).amax(-1)
    t_far = torch.maximum(ta, tb).amin(-1)
    t0 = torch.where(is_grid, torch.clamp(t_near, min=0.0), 0.0)
    t1 = torch.where(is_grid, torch.minimum(t_far, t_max), t_max)
    t1 = torch.where(t1 < t0, t0, t1)
    return t0, t1


# --- the lockstep loop ------------------------------------------------------------


def _lockstep(step, state: dict, const: dict, running, cap: int, compact: bool,
              stats: dict | None):
    """Run step(state, const) -> state while any lane runs, at most cap
    steps. state and const hold per-lane tensors with one extra frozen lane
    (index n, which never runs) at the end; returns state without it.

    The body runs on a working set of lane indices: all lanes, then (when
    compact) the running ones, re-gathered whenever half of the set has
    stopped. Sets are padded with the frozen lane to whole multiples of
    LANE_QUANTUM, so every elementwise op of the body covers whole vectors
    in either schedule and a lane's arithmetic does not depend on where it
    sits in the set. stats: when a dict, gets "steps" (the loop's global
    steps) and "lane_steps" (n,) (the steps each lane ran)."""
    n = state["t"].shape[0] - 1
    dev = state["t"].device

    def padded(lanes):
        pad = -lanes.numel() % LANE_QUANTUM
        return torch.cat([lanes, lanes.new_full((pad,), n)]) if pad else lanes

    ws = padded(torch.arange(n, device=dev))
    sub = {k: v[ws] for k, v in state.items()}
    sub_c = {k: v[ws] for k, v in const.items()}
    lane_steps = torch.zeros(n + 1, dtype=torch.int64, device=dev) if stats is not None else None
    steps = 0
    while steps < cap:
        run = running(sub)
        live = int(run.sum())  # the one host sync a step
        if live == 0:
            break
        if compact and ws.numel() > LANE_QUANTUM and 2 * live <= ws.numel():
            for k, v in sub.items():
                state[k][ws] = v
            ws = padded(ws[run])
            sub = {k: v[ws] for k, v in state.items()}
            sub_c = {k: v[ws] for k, v in const.items()}
            run = running(sub)
        if lane_steps is not None:
            lane_steps.index_add_(0, ws, run.long())
        sub = step(sub, sub_c)
        steps += 1
    for k, v in sub.items():
        state[k][ws] = v
    if stats is not None:
        stats["steps"] = steps
        stats["lane_steps"] = lane_steps[:n]
    return {k: v[:n] for k, v in state.items()}


def _with_frozen_lane(tensors: dict) -> dict:
    """Each tensor with a copy of its lane 0 appended (the frozen lane)."""
    return {k: torch.cat([v, v[:1]]) for k, v in tensors.items()}


def _stoch_u3(rng):
    rng, ua = lcg_next(rng)
    rng, ub = lcg_next(rng)
    rng, uc = lcg_next(rng)
    return rng, torch.stack([ua, ub, uc], -1)


def _free_flight(banks: MediumBanks, s: dict, c: dict, p_cur, d_cur):
    """Shared head of both tracking steps: the current cell's majorant,
    its far side, and a free flight against it."""
    cell = majorant_cell(banks, c["mi"], p_cur)
    if "dv" in s:
        t_loc = majorant_cell_exit(banks, c["mi"], p_cur, d_cur, torch.zeros_like(s["t"]),
                                   torch.clamp(c["t1"] - s["t"], min=0.0))
        t_cell_end = s["t"] + t_loc
    else:
        t_cell_end = majorant_cell_exit(banks, c["mi"], c["o"], c["d"], s["t"], c["t1"])
    sig_maj = c["sig_base"] * cell[..., None]
    sig_maj0 = sig_maj[..., 0]
    rng, u = lcg_next(s["rng"])
    dt = -torch.log(torch.clamp(1.0 - u, min=1e-10)) / torch.clamp(sig_maj0, min=1e-10)
    t_new = torch.where(sig_maj0 < 1e-10, t_cell_end, s["t"] + dt)
    past = t_new >= t_cell_end
    at_seg_end = t_cell_end >= c["t1"] * (1.0 - 1e-7)
    # the spectral ratio left for the distance covered in this cell
    t_rem = torch.exp(-torch.clamp(t_cell_end - s["t"], min=0.0)[..., None] * sig_maj)
    rem0 = torch.clamp(t_rem[..., 0:1], min=1e-10)
    return rng, sig_maj, dt, t_new, t_cell_end, past, at_seg_end, t_rem, rem0


@dataclass
class DeltaTrackResult:
    status: torch.Tensor     # (N,) PASSED / SCATTERED / ABSORBED
    t_scatter: torch.Tensor  # (N,)
    p_scatter: torch.Tensor  # (N, 3)
    beta: torch.Tensor       # (N, 4)
    r_u: torch.Tensor        # (N, 4)
    r_l: torch.Tensor        # (N, 4)
    L_emit: torch.Tensor     # (N, 4) volumetric emission gathered on the way
    g: torch.Tensor          # (N,) HG g at the scatter point
    d_out: torch.Tensor      # (N, 3) direction after tracking (bent by deflection)


def _delta_step(banks: MediumBanks, table, s: dict, c: dict) -> dict:
    tracking = s["status"] == TRACKING
    if "dv" in s:
        p_cur, d_cur = s["p"], s["dv"]
    else:
        p_cur, d_cur = c["o"] + s["t"][..., None] * c["d"], c["d"]
    rng, sig_maj, dt, t_new, t_cell_end, past, at_seg_end, t_rem, rem0 = _free_flight(
        banks, s, c, p_cur, d_cur)
    sig_maj0 = sig_maj[..., 0]
    pass_scale = t_rem / rem0

    # past the cell (or the segment's end): the residual majorant ratio,
    # then go on from the cell's far side or pass
    upd = (tracking & past)[..., None]
    beta = torch.where(upd, s["beta"] * pass_scale, s["beta"])
    r_u = torch.where(upd, s["r_u"] * pass_scale, s["r_u"])
    r_l = torch.where(upd, s["r_l"] * pass_scale, s["r_l"])
    status = torch.where(upd[..., 0] & at_seg_end, PASSED, s["status"])

    # an interaction candidate
    inter = tracking & ~past
    t_maj = torch.exp(-dt[..., None] * sig_maj)
    p = p_cur + dt[..., None] * d_cur
    rng, u3 = _stoch_u3(rng)
    sa, ss, le, _ = _properties(banks, table, c, c["mi"], p, c["lam"], u3)
    # imperfect majorants (RGB uplift overshoot) are clamped, as pbrt does
    sa = torch.minimum(sa, sig_maj)
    ss = torch.minimum(ss, torch.clamp(sig_maj - sa, min=0.0))

    # volumetric emission
    pr = sig_maj0 * t_maj[..., 0]
    r_e = s["r_u"] * sig_maj * t_maj / torch.clamp(pr[..., None], min=1e-10)
    r_e_avg = r_e.mean(-1)
    le_ok = inter & (pr > 1e-10) & (r_e_avg > 0.0) & (le > 0.0).any(-1)
    le_contrib = s["beta"] * sa * t_maj * le / torch.clamp((pr * r_e_avg)[..., None],
                                                           min=1e-10)
    L = s["L"] + torch.where(le_ok[..., None], le_contrib, 0.0)

    p_absorb = sa[..., 0] / torch.clamp(sig_maj0, min=1e-10)
    p_scat = ss[..., 0] / torch.clamp(sig_maj0, min=1e-10)
    rng, u_ev = lcg_next(rng)
    absorb = inter & (u_ev < p_absorb)
    real = inter & ~absorb & (u_ev < p_absorb + p_scat)
    scatter = real & ~c["mdh"]
    depth_kill = real & c["mdh"]
    null = inter & (u_ev >= p_absorb + p_scat)

    status = torch.where(absorb | depth_kill, ABSORBED, status)
    beta = torch.where(absorb[..., None], 0.0, beta)

    # real scatter: rescale beta and r_u
    pdf_s = torch.clamp(t_maj[..., 0] * ss[..., 0], min=1e-10)
    scale_s = t_maj * ss / pdf_s[..., None]
    beta = torch.where(scatter[..., None], beta * scale_s, beta)
    r_u = torch.where(scatter[..., None], r_u * scale_s, r_u)
    status = torch.where(scatter, SCATTERED, status)

    # null scatter: go on
    sig_n = torch.clamp(sig_maj - sa - ss, min=0.0)
    pdf_n = t_maj[..., 0] * sig_n[..., 0]
    ok_n = pdf_n > 1e-10
    scale_nu = t_maj * sig_n / torch.clamp(pdf_n[..., None], min=1e-10)
    scale_nl = t_maj * sig_maj / torch.clamp(pdf_n[..., None], min=1e-10)
    go = (null & ok_n)[..., None]
    beta = torch.where(go, beta * scale_nu, beta)
    r_u = torch.where(go, r_u * scale_nu, r_u)
    r_l = torch.where(go, r_l * scale_nl, r_l)
    status = torch.where(null & ~ok_n, ABSORBED, status)
    beta = torch.where((null & ~ok_n)[..., None], 0.0, beta)
    dead = (beta == 0.0).all(-1) | (r_u == 0.0).all(-1)
    status = torch.where((status == TRACKING) & dead, ABSORBED, status)

    t = torch.where(upd[..., 0], t_cell_end, s["t"])
    t = torch.where(null | scatter, t_new, t)
    out = dict(status=status, t=t, beta=beta, r_u=r_u, r_l=r_l, L=L, rng=rng)
    if "dv" in s:
        rem = torch.clamp(t_cell_end - s["t"], min=0.0)[..., None]
        p_next = torch.where(upd, p_cur + rem * d_cur, p_cur)
        out["p"] = torch.where((null | scatter)[..., None], p, p_next)
        out["dv"] = torch.where(null[..., None], _deflect(banks, c["mi"], p, d_cur, dt), d_cur)
    return out


def delta_track(banks: MediumBanks, table, midx, o, d, t_max, lam, beta, r_u, r_l,
                active, max_depth_hit, max_steps: int | None = None, compact: bool = True,
                stats: dict | None = None) -> DeltaTrackResult:
    """Delta tracking from o along d up to t_max through medium midx (lanes
    with active False pass unchanged with status PASSED). max_depth_hit:
    (N,) lanes at the depth limit, whose real scatters absorb instead.
    compact=False runs every step on the whole wavefront (same result);
    stats: see _lockstep."""
    mi = torch.clamp(midx, min=0).long()
    lane = _lane_media(banks, mi, lam)
    sig_base = _spectral_majorant_base(banks, mi, lam)
    t0, t1 = medium_segment(banks, mi, o, d, t_max)
    empty = sig_base[..., 0] * _bl(banks.max_density, mi) < 1e-10
    status = torch.where(active & ~empty & (t1 > t0), TRACKING, PASSED).to(torch.int32)
    state = dict(status=status, t=t0, beta=beta, r_u=r_u, r_l=r_l,
                 L=torch.zeros_like(beta), rng=lcg_init(o, d, t_max))
    if banks.has_deflection:
        state.update(p=o + t0[..., None] * d, dv=d)
    state = _with_frozen_lane(state)
    state["status"][-1] = PASSED
    const = _with_frozen_lane(dict(mi=mi, o=o, d=d, t1=t1, lam=lam, sig_base=sig_base,
                                   mdh=max_depth_hit, **lane))
    state = _lockstep(lambda s, c: _delta_step(banks, table, s, c), state, const,
                      lambda s: s["status"] == TRACKING,
                      MAX_TRACK_STEPS if max_steps is None else max_steps, compact, stats)
    status = torch.where(state["status"] == TRACKING, PASSED, state["status"])
    t_sc = state["t"]
    a3 = active[..., None]
    if banks.has_deflection:
        p_sc = state["p"]
        d_out = torch.where(a3, state["dv"], d)
    else:
        p_sc = o + t_sc[..., None] * d
        d_out = d
    return DeltaTrackResult(
        status=torch.where(active, status, PASSED), t_scatter=t_sc, p_scatter=p_sc,
        beta=torch.where(a3, state["beta"], beta), r_u=torch.where(a3, state["r_u"], r_u),
        r_l=torch.where(a3, state["r_l"], r_l), L_emit=torch.where(a3, state["L"], 0.0),
        g=lane["g"], d_out=d_out)


def _ratio_step(banks: MediumBanks, table, s: dict, c: dict) -> dict:
    rng, sig_maj, dt, t_new, t_cell_end, past, at_seg_end, t_rem, rem0 = _free_flight(
        banks, s, c, c["o"] + s["t"][..., None] * c["d"], c["d"])
    fin = (s["running"] & past)[..., None]
    T = torch.where(fin, s["T"] * t_rem / rem0, s["T"])
    r_l = torch.where(fin, s["r_l"] * t_rem / rem0, s["r_l"])
    r_u = torch.where(fin, s["r_u"] * t_rem / rem0, s["r_u"])
    running = s["running"] & ~(past & at_seg_end)

    # a null collision: multiply by the sigma_n / sigma_maj ratios
    inter = (running & ~past)[..., None]
    t_maj = torch.exp(-dt[..., None] * sig_maj)
    p = c["o"] + t_new[..., None] * c["d"]
    rng, u3 = _stoch_u3(rng)
    sa, ss, _, _ = _properties(banks, table, c, c["mi"], p, c["lam"], u3)
    sa = torch.minimum(sa, sig_maj)
    ss = torch.minimum(ss, torch.clamp(sig_maj - sa, min=0.0))
    sig_n = torch.clamp(sig_maj - sa - ss, min=0.0)
    pdf = torch.clamp(t_maj[..., 0] * sig_maj[..., 0], min=1e-10)[..., None]
    T = torch.where(inter, T * t_maj * sig_n / pdf, T)
    r_l = torch.where(inter, r_l * t_maj * sig_maj / pdf, r_l)
    r_u = torch.where(inter, r_u * t_maj * sig_n / pdf, r_u)

    # Russian roulette on a low T (pbrt: q = 0.75 below 0.05)
    low = (T / torch.clamp(r_l, min=1e-10)).amax(-1) < 0.05
    rng, u_rr = lcg_next(rng)
    killed = running & low & (u_rr < 0.75)
    T = torch.where(killed[..., None], 0.0, T)
    T = torch.where((running & low & ~killed)[..., None], T / 0.25, T)
    running = running & ~killed & ~(T == 0.0).all(-1)
    t = torch.where(past, t_cell_end, t_new)
    return dict(running=running, t=torch.where(s["running"], t, s["t"]), T=T, r_l=r_l,
                r_u=r_u, rng=rng)


def ratio_track_tr(banks: MediumBanks, table, midx, o, d, t_max, lam, active,
                   max_steps: int | None = None, compact: bool = True,
                   stats: dict | None = None):
    """Ratio-tracked transmittance of one shadow segment through medium
    midx. Returns (T_ray, r_l, r_u) multipliers, each (N, 4), ones where
    inactive. compact and stats as in delta_track."""
    mi = torch.clamp(midx, min=0).long()
    sig_base = _spectral_majorant_base(banks, mi, lam)
    t0, t1 = medium_segment(banks, mi, o, d, t_max)
    ones4 = torch.ones_like(lam)
    run = active & (sig_base[..., 0] * _bl(banks.max_density, mi) >= 1e-10) & (t1 > t0)
    # seeded apart from the camera path's stream
    state = _with_frozen_lane(dict(running=run, t=t0, T=ones4, r_l=ones4, r_u=ones4,
                                   rng=lcg_init(o, d, t_max * 0.731 + 1.0)))
    state["running"][-1] = False
    const = _with_frozen_lane(dict(mi=mi, o=o, d=d, t1=t1, lam=lam, sig_base=sig_base,
                                   **_lane_media(banks, mi, lam)))
    state = _lockstep(lambda s, c: _ratio_step(banks, table, s, c), state, const,
                      lambda s: s["running"],
                      MAX_TRACK_STEPS if max_steps is None else max_steps, compact, stats)
    a4 = active[..., None]
    return (torch.where(a4, state["T"], ones4), torch.where(a4, state["r_l"], ones4),
            torch.where(a4, state["r_u"], ones4))
