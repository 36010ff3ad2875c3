"""SPPM: stochastic progressive photon mapping.

Port of ``hikari_tpu/integrators/sppm.py``. One iteration:

- camera pass (``_visible_points``): one visible point per pixel, the
  first non-specular hit reached through at most max_depth mirror
  bounces, and its direct light (the preview integrators' hard-shadow NEE);
- photon pass (``_trace_photons``): a wavefront of photons from the point
  and area lights, bouncing through the real BSDF samplers at the preview
  wavelengths with Russian roulette; every diffuse hit from the second on
  deposits the photon's power as RGB. Its random numbers are
  ``jax.random``'s threefry words (``sampling/threefry.py``), so the photons
  are the JAX package's, lane for lane;
- gather: the deposits sorted by the cell of a 64^3 grid over the world box
  (a stable sort, ``_sort_photons``); each visible point reads at most
  MAX_PER_CELL photons of each of its 27 neighbour cells from the sorted
  list (searchsorted ranges), scaling an over-full cell by count /
  MAX_PER_CELL (``_gather_sorted``);
- the per-pixel state (radius^2, N, tau, direct) takes the alpha = 2/3
  shrink rule.

The reference's gather is a 27 x 64-step ``lax.fori_loop``; here each
neighbour cell reads its photons in blocks of GATHER_BLOCK, and the
contributions are summed into the accumulators one step at a time, in the
reference's order. RGB transport, as the reference's SPPM.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..camera.camera import PerspectiveCamera
from ..core.ray import spawn_ray
from ..core.vecmath import dot, make_frame, reflect, to_world
from ..geometry.triangle import sample_triangle
from ..lights import types as lt
from ..materials import types as mt
from ..sampling import sobol as sb
from ..sampling import threefry
from ..sampling.distributions import cosine_sample_hemisphere, uniform_sample_sphere
from ..scene.scene import SceneData
from .preview import (_camera_lanes, _direct_light_rgb, _is_specular_type, _preview_lam,
                      _rows, preview_spec_to_rgb)
from .volpath import (_albedo_rgb_dispatch, _sample_bsdf_dispatch, _surface_data,
                      scene_closest_hit)

MAX_PER_CELL = 64  # photons a visible point reads per neighbour cell
GRID_RES = 64
GATHER_BLOCK = 16  # photon slots of a cell read at once


@dataclass(frozen=True)
class SPPM:
    """The reference's SPPM keywords (sppm.jl:1-60)."""

    iterations: int = 8
    photons_per_iteration: int = 65536
    initial_radius: float = 0.1
    alpha: float = 2.0 / 3.0
    max_depth: int = 5
    seed: int = 0


def _visible_points(scene: SceneData, camera: PerspectiveCamera, zcfg, sample_idx: int,
                    max_depth: int):
    """Camera pass: (p, ns, beta_rgb, valid, direct_rgb) per pixel."""
    dev = scene.device
    w, h = camera.resolution
    n = w * h
    px, py, si, _, _, o, d = _camera_lanes(camera, zcfg, sample_idx, dev)
    beta = torch.ones((n, 3), device=dev)
    searching = torch.ones(n, dtype=torch.bool, device=dev)
    vp_p = torch.zeros((n, 3), device=dev)
    vp_ns = torch.zeros((n, 3), device=dev)
    vp_valid = torch.zeros(n, dtype=torch.bool, device=dev)
    direct = torch.zeros((n, 3), device=dev)
    for depth in range(max_depth):
        rec = scene_closest_hit(scene, o, d, torch.full((n,), float("inf"), device=dev),
                                active=searching)
        hit = searching & rec.hit
        sd = _surface_data(scene, rec, o, d)
        flip = dot(sd["ns"], d) > 0.0
        ns = torch.where(flip[..., None], -sd["ns"], sd["ns"])
        albedo = _albedo_rgb_dispatch(scene, sd["mat_type"], sd["mat_idx"], sd["tex"])

        spec = _is_specular_type(sd["mat_type"])
        diffuse = hit & ~spec & (sd["mat_type"] != mt.EMISSIVE)
        vp_p = torch.where(diffuse[..., None], sd["p"], vp_p)
        vp_ns = torch.where(diffuse[..., None], ns, vp_ns)
        vp_valid = vp_valid | diffuse

        u2 = torch.stack(sb.path_sample_2d(zcfg, px, py, si, depth, 0), -1)
        ul = sb.path_sample_1d(zcfg, px, py, si, depth, 10)
        direct = direct + beta * _direct_light_rgb(scene, sd["p"], ns, albedo, ul, u2, diffuse)

        cont = hit & spec
        wi = reflect(-d, ns)
        o = torch.where(cont[..., None], spawn_ray(sd["p"], sd["ng"], wi), o)
        d = torch.where(cont[..., None], wi, d)
        beta = torch.where(cont[..., None], beta * torch.clamp(albedo, 0.0, 1.0), beta)
        searching = cont
    return vp_p, vp_ns, beta, vp_valid, direct


def _trace_photons(scene: SceneData, it: int, n_photons: int, max_depth: int, key):
    """Photon pass: (pos (P, 3), power_rgb (P, 3), normal (P, 3), valid
    (P,)) of the deposits, P = n_photons x (max_depth - 1): one per photon
    and bounce from the second on, valid where it landed on a diffuse
    surface. Point lights emit uniformly, area lights cosine-weighted about
    their normal; other lights emit no photons."""
    dev = scene.device
    kp = threefry.fold_in(key, it)

    def uniform(salt, *shape):
        return threefry.uniform(threefry.fold_in(kp, salt), (n_photons,) + shape, dev)

    banks = scene.lights
    li_flat, pmf = lt.sample_light_index(banks, uniform(0))
    ltype = _rows(banks.light_type, li_flat)
    lidx = _rows(banks.light_idx, li_flat).long()
    lam4 = _preview_lam(n_photons, dev)
    u2a = uniform(1, 2)
    u2b = uniform(2, 2)

    # point: uniform sphere
    p_pt = banks.point_pos[lidx % banks.point_pos.shape[0]]
    d_pt = uniform_sample_sphere(u2a)
    pow_pt = lt.illuminant(scene.rgb2spec, banks.point_i[lidx % banks.point_i.shape[0]],
                           lam4) * (4.0 * math.pi)
    # area: cosine hemisphere about the face normal
    ai = lidx % banks.area_p0.shape[0]
    p_ar, _, _ = sample_triangle(u2a[:, 0], u2a[:, 1], banks.area_p0[ai], banks.area_p1[ai],
                                 banks.area_p2[ai])
    t, b, nrm = make_frame(banks.area_n[ai])
    d_ar = to_world(t, b, nrm, cosine_sample_hemisphere(u2b))
    pow_ar = lt.illuminant(scene.rgb2spec, banks.area_le[ai], lam4) * (
        math.pi * banks.area_area[ai])[..., None]

    is_area = (ltype == lt.AREA)[..., None]
    p0 = torch.where(is_area, p_ar, p_pt)
    d0 = torch.where(is_area, d_ar, d_pt)
    power = torch.where(is_area, pow_ar, pow_pt)
    power = power / torch.clamp(pmf, min=1e-9)[..., None] / n_photons
    alive = (ltype == lt.POINT) | (ltype == lt.AREA)

    deposits = []
    o = spawn_ray(p0, d0, d0)
    d = d0
    for depth in range(max_depth):
        rec = scene_closest_hit(scene, o, d, torch.full((n_photons,), float("inf"), device=dev),
                                active=alive)
        hit = alive & rec.hit
        sd = _surface_data(scene, rec, o, d)
        flip = dot(sd["ns"], d) > 0.0
        ns = torch.where(flip[..., None], -sd["ns"], sd["ns"])
        spec = _is_specular_type(sd["mat_type"])
        diffuse = hit & ~spec & (sd["mat_type"] != mt.EMISSIVE)
        # deposits from the second hit on (NEE lights the first); the
        # least-squares map can give small negative components, clamped
        if depth > 0:
            deposits.append((sd["p"], torch.clamp(preview_spec_to_rgb(power), min=0.0), ns,
                             diffuse))

        # on through the BSDF's sample at the photon's wavelengths
        u2 = uniform(10 + depth, 2)
        uc = uniform(70 + depth)
        u_rr = uniform(40 + depth)
        t, b, nrm = make_frame(ns)
        wo_l = -torch.stack([dot(d, t), dot(d, b), dot(d, nrm)], -1)
        bs = _sample_bsdf_dispatch(scene, sd["mat_type"], sd["mat_idx"], wo_l, lam4, u2, uc,
                                   None, tex=sd["tex"])
        wi = to_world(t, b, nrm, bs.wi)
        thr = bs.f * (torch.abs(bs.wi[..., 2]) / torch.clamp(bs.pdf, min=1e-9))[..., None]
        thr = torch.where(bs.valid[..., None], thr, 0.0)
        # Russian roulette on the throughput's mean
        q = torch.clamp(thr.mean(-1), 0.05, 1.0)
        survive = u_rr < q
        power = power * thr / torch.clamp(q, min=1e-6)[..., None]
        o = torch.where(hit[..., None], spawn_ray(sd["p"], sd["ng"], wi), o)
        d = torch.where(hit[..., None], wi, d)
        alive = hit & survive & (thr > 0.0).any(-1)
    if not deposits:
        z3 = torch.zeros((0, 3), device=dev)
        return z3, z3, z3, torch.zeros(0, dtype=torch.bool, device=dev)
    return tuple(torch.cat(x) for x in zip(*deposits))


def _cell_of(p, world_lo, cell_size, grid_res):
    c = torch.nan_to_num(torch.floor((p - world_lo) / cell_size), nan=0.0)
    return torch.clamp(c, 0, grid_res - 1).to(torch.int64)


def _cell_id(c, grid_res):
    return (c[..., 2] * grid_res + c[..., 1]) * grid_res + c[..., 0]


def _sort_photons(ph_p, ph_pow, ph_n, ph_ok, world_lo, cell_size, grid_res):
    """The deposits in the order of their cells (a stable sort, as
    jnp.argsort's), invalid ones parked past the last cell: (cell id, p,
    power, n)."""
    ph_cid = _cell_id(_cell_of(ph_p, world_lo, cell_size, grid_res), grid_res)
    ph_cid = torch.where(ph_ok, ph_cid, grid_res ** 3)
    order = torch.sort(ph_cid, stable=True).indices
    return ph_cid[order], ph_p[order], ph_pow[order], ph_n[order]


def _gather_sorted(vp_p, vp_ns, vp_valid, r2, ph_cid_s, ph_p_s, ph_pow_s, ph_n_s, world_lo,
                   cell_size, grid_res):
    """(tau_add (n, 3), m_add (n,)): each visible point's sum of the
    photon power within its radius, on its side, over the first
    MAX_PER_CELL photons of each of its 27 neighbour cells, and their count,
    an over-full cell's scaled by count / MAX_PER_CELL."""
    dev = vp_p.device
    n = vp_p.shape[0]
    tau_add = torch.zeros_like(vp_p)
    m_add = torch.zeros(n, device=dev)
    n_ph = ph_cid_s.shape[0]
    if n_ph == 0:
        return tau_add, m_add
    vp_c = _cell_of(vp_p, world_lo, cell_size, grid_res)
    ks = torch.arange(GATHER_BLOCK, device=dev)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nc = torch.clamp(vp_c + torch.tensor([dx, dy, dz], device=dev), 0, grid_res - 1)
                cid = _cell_id(nc, grid_res)
                start = torch.searchsorted(ph_cid_s, cid)
                count = torch.searchsorted(ph_cid_s, cid, right=True) - start
                scale = torch.clamp(count.to(torch.float32) / MAX_PER_CELL, min=1.0)
                for k0 in range(0, MAX_PER_CELL, GATHER_BLOCK):
                    j = torch.clamp(start[:, None] + (k0 + ks), max=n_ph - 1)
                    in_cell = ph_cid_s[j] == cid[:, None]
                    dist2 = ((ph_p_s[j] - vp_p[:, None]) ** 2).sum(-1)
                    same_side = (ph_n_s[j] * vp_ns[:, None]).sum(-1) > 0.0
                    ok = vp_valid[:, None] & in_cell & (dist2 <= r2[:, None]) & same_side
                    add = torch.where(ok[..., None], ph_pow_s[j] * scale[:, None, None], 0.0)
                    m = ok.to(torch.float32) * scale[:, None]
                    for k in range(GATHER_BLOCK):
                        tau_add = tau_add + add[:, k]
                        m_add = m_add + m[:, k]
    return tau_add, m_add


def _gather(vp_p, vp_ns, vp_valid, r2, ph_p, ph_pow, ph_n, ph_ok, world_lo, cell_size,
            grid_res):
    """Sorted-grid photon gather: _sort_photons, then _gather_sorted."""
    return _gather_sorted(vp_p, vp_ns, vp_valid, r2,
                          *_sort_photons(ph_p, ph_pow, ph_n, ph_ok, world_lo, cell_size,
                                         grid_res),
                          world_lo, cell_size, grid_res)


def _sppm_update(integ: SPPM, state: dict, vp_beta, direct, tau_add, m) -> dict:
    """The progressive radius and flux update (sppm.jl's pixel updates);
    the visible point's albedo / pi folds into beta at display time."""
    n_old = state["n"]
    has = m > 0.0
    n_new = torch.where(has, n_old + integ.alpha * m, n_old)
    ratio = torch.where(has, n_new / torch.clamp(n_old + m, min=1e-6), 1.0)
    return dict(r2=state["r2"] * ratio, n=n_new,
                tau=(state["tau"] + vp_beta * tau_add) * ratio[..., None],
                direct=state["direct"] + direct, iters=state["iters"] + 1)


def _sppm_iteration(integ: SPPM, scene: SceneData, camera: PerspectiveCamera, state: dict,
                    it: int) -> dict:
    w, h = camera.resolution
    zcfg = sb.make_zsobol(w, h, max(integ.iterations, 1), seed=integ.seed)
    key = threefry.prng_key(integ.seed)
    vp_p, vp_ns, vp_beta, vp_valid, direct = _visible_points(scene, camera, zcfg, int(it),
                                                             integ.max_depth)
    ph_p, ph_pow, ph_n, ph_ok = _trace_photons(scene, int(it), integ.photons_per_iteration,
                                               integ.max_depth, key)
    ext = torch.clamp(scene.world_hi - scene.world_lo, min=1e-6)
    cell = torch.clamp(torch.sqrt(state["r2"]).max(), min=1e-4)
    cell_size = torch.maximum(ext.max() / GRID_RES, cell)
    tau_add, m = _gather(vp_p, vp_ns, vp_valid, state["r2"], ph_p, ph_pow, ph_n, ph_ok,
                         scene.world_lo, cell_size, GRID_RES)
    return _sppm_update(integ, state, vp_beta, direct, tau_add, m)


def sppm_initial_state(integ: SPPM, n: int, device) -> dict:
    return dict(r2=torch.full((n,), integ.initial_radius ** 2, device=device),
                n=torch.zeros(n, device=device), tau=torch.zeros((n, 3), device=device),
                direct=torch.zeros((n, 3), device=device),
                iters=torch.zeros((), dtype=torch.int32, device=device))


def sppm_image(integ: SPPM, state: dict, h: int, w: int) -> torch.Tensor:
    """(H, W, 3) linear RGB of a state: direct light over the iterations
    plus tau / (iterations pi r^2) (the photon power is already divided by
    the photons of one iteration)."""
    n_iter = integ.iterations
    indirect = state["tau"] / (n_iter * math.pi * torch.clamp(state["r2"], min=1e-12))[..., None]
    return (state["direct"] / n_iter + indirect).reshape(h, w, 3)


def render_sppm(integ: SPPM, scene: SceneData, camera: PerspectiveCamera) -> torch.Tensor:
    """Full SPPM render -> (H, W, 3) linear RGB on the scene's device."""
    w, h = camera.resolution
    state = sppm_initial_state(integ, w * h, scene.device)
    for it in range(integ.iterations):
        state = _sppm_iteration(integ, scene, camera, state, it)
    return sppm_image(integ, state, h, w)
