"""VolPath: spectral wavefront path tracer, surface-only main path.

Port of ``hikari_tpu/integrators/volpath.py`` along the path the benchmark
renders: non-resident bounce loop, dense material dispatch
(``material_coherence="none"``), power light sampler, NEE through the
occlusion sweep, emission MIS, Russian roulette and glass dispersion.
The whole wavefront is a structure-of-arrays of one path per lane with
masked lanes; ``lax.fori_loop`` becomes a Python loop over depth and
``where``-selects stay ``torch.where``. Every ``path_sample_*`` dimension
index (0, 1, 3, 5, 6) is the JAX package's, so both draw the same samples.

Instanced scenes (``SceneData.has_instances``) trace through the
two-level traversal of ``geometry/instanced.py``; their hit records name a
world treelet and column, decoded into the shared face row and the
instance (``_face_decode``), whose normal transform and material override
apply at the hit. The reference's instanced shadow-transmittance hook
(``volpath.py:807-828``) belongs to media and is not ported with them.

Participating media, textures, alpha, Mix and layered materials, other
lights, the resident loop and the sorted/gated material dispatch are not
ported; scenes and configurations that need them raise
``NotImplementedError`` instead of rendering a wrong image.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..camera.camera import CameraSample, PerspectiveCamera
from ..core.lookup import bank_lookup as _bl
from ..core.ray import spawn_ray
from ..core.vecmath import dot, face_forward, make_frame, normalize, to_local, to_world
from ..film.film import Film, film_add_weighted, make_film
from ..film.filters import FilterSampler, filter_sample, make_filter
from ..geometry.triangle import interpolate
from ..geometry.instanced import any_hit_instanced, closest_hit_instanced
from ..geometry.sweep import TREELET
from ..geometry.wavefront import any_hit_packets, closest_hit_packets
from ..lights import types as lt
from ..materials import bsdf as mb
from ..materials import types as mt
from ..sampling import sobol as sb
from ..scene.scene import SceneData
from ..spectral import spectrum as sp
from ..spectral.cie import spectral_to_xyz, xyz_to_linear_srgb


def scene_closest_hit(scene: SceneData, o, d, t_max, active=None):
    if scene.has_instances:
        return closest_hit_instanced(scene.inst, o, d, t_max, scene.world_lo,
                                     scene.world_hi, active=active)
    return closest_hit_packets(scene.treelets, o, d, t_max, scene.world_lo,
                               scene.world_hi, active=active)


def scene_any_hit(scene: SceneData, o, d, t_max, active=None, group=None):
    if scene.has_instances:
        return any_hit_instanced(scene.inst, o, d, t_max, scene.world_lo,
                                 scene.world_hi, active=active, group=group)
    return any_hit_packets(scene.treelets, o, d, t_max, scene.world_lo,
                           scene.world_hi, active=active, group=group)


@dataclass(frozen=True)
class VolPath:
    """Config mirrors the JAX VolPath. sample_batch = K dispatches K
    consecutive samples of the frame as one K*w*h-lane wavefront."""

    max_depth: int = 5
    samples_per_pixel: int = 16
    russian_roulette_depth: int = 3
    regularize: bool = False
    max_component_value: float = 1e6  # firefly clamp
    seed: int = 0
    material_coherence: str = "none"
    sample_batch: int = 4
    resident: str = "auto"  # 'auto' resolves off, as in the JAX package
    nee: bool = True


def _check_supported(vp: VolPath):
    if vp.resident == "on":
        raise NotImplementedError("the resident bounce loop is not ported yet")
    if vp.material_coherence != "none":
        raise NotImplementedError(
            f"material_coherence={vp.material_coherence!r} is not ported yet; "
            "use 'none'")


def _sample_bsdf_dispatch(scene, mat_type, mat_idx, wo, lam, u2, uc, regularize):
    """Dense per-type BSDF sampling, selected by tag."""
    banks = scene.materials
    out = mb.invalid_sample(tuple(mat_type.shape), mat_type.device)
    samplers = [
        (mt.MATTE, lambda: mb.sample_matte(banks, mat_idx, wo, lam, u2, uc)),
        (mt.MIRROR, lambda: mb.sample_mirror(banks, mat_idx, wo, lam, u2, uc)),
        (mt.GLASS, lambda: mb.sample_glass(banks, mat_idx, wo, lam, u2, uc, regularize)),
        (mt.CONDUCTOR, lambda: mb.sample_conductor(banks, mat_idx, wo, lam, u2, uc,
                                                   regularize)),
    ]
    for tag, fn in samplers:
        if tag not in scene.present_materials:
            continue
        s = fn()
        m = mat_type == tag
        m3 = m[..., None]
        out = mb.BSDFSample(
            wi=torch.where(m3, s.wi, out.wi), f=torch.where(m3, s.f, out.f),
            pdf=torch.where(m, s.pdf, out.pdf),
            specular=torch.where(m, s.specular, out.specular),
            transmission=torch.where(m, s.transmission, out.transmission),
            eta_scale=torch.where(m, s.eta_scale, out.eta_scale),
            valid=torch.where(m, s.valid, out.valid))
    return out


def _eval_bsdf_dispatch(scene, mat_type, mat_idx, wo, wi, lam, regularize):
    """(f, pdf) for NEE MIS; zero for specular-only materials."""
    banks = scene.materials
    f = torch.zeros_like(lam)
    pdf = torch.zeros(mat_type.shape, device=lam.device)
    evals = [
        (mt.MATTE, lambda: mb.eval_matte(banks, mat_idx, wo, wi, lam)),
        (mt.CONDUCTOR, lambda: mb.eval_conductor(banks, mat_idx, wo, wi, lam, regularize)),
        (mt.GLASS, lambda: mb.eval_glass(banks, mat_idx, wo, wi, lam, regularize)),
    ]
    for tag, fn in evals:
        if tag in scene.present_materials:
            fe, pe = fn()
            m = mat_type == tag
            f = torch.where(m[..., None], fe, f)
            pdf = torch.where(m, pe, pdf)
    return f, pdf


def _face_decode(scene: SceneData, tri_raw):
    """Hit-record tri -> (face row, instance id or None). An instanced hit
    names world treelet wt and column j; its shared object-space face row
    is ti_obj[wt] * TREELET + j."""
    tri = torch.clamp(tri_raw, min=0).long()
    if not scene.has_instances:
        return tri, None
    wt = tri // TREELET
    obj = scene.inst.ti_obj[wt].long() * TREELET + (tri - wt * TREELET)
    return obj, scene.inst.ti_inst[wt].long()


def _inst_xform_normal(scene: SceneData, inst, n_obj):
    """Object -> world normal: rows of the instance's inverse transpose."""
    return (scene.inst_nrm[inst] * n_obj[..., None, :]).sum(-1)


def _surface_data(scene: SceneData, rec, o, d):
    """Hit-point attributes from one (F, 17) face-row gather."""
    tri, inst = _face_decode(scene, rec.tri)
    rows = scene.face_rows[tri]
    ng_raw = rows[..., 0:3]
    ns = normalize(interpolate(rec.b1, rec.b2, rows[..., 3:6], rows[..., 6:9],
                               rows[..., 9:12]))
    ns = torch.where((ns * ns).sum(-1, keepdim=True) > 0.5, ns, ng_raw)
    packed = (rows[..., 12].to(torch.int32) << 16) | rows[..., 13].to(torch.int32)
    if inst is not None:
        ng_raw = normalize(_inst_xform_normal(scene, inst, ng_raw))
        ns = normalize(_inst_xform_normal(scene, inst, ns))
        override = scene.inst_mat_packed[inst]  # per-instance material
        packed = torch.where(override >= 0, override, packed)
    if mt.EMISSIVE in scene.present_materials:
        arealight = rows[..., 14].to(torch.int32) - 1
    else:
        arealight = torch.full_like(packed, -1)
    return dict(p=o + rec.t[..., None] * d, ng=face_forward(ng_raw, ns), ns=ns,
                mat_type=packed >> 24, mat_idx=packed & 0xFFFFFF,
                arealight=arealight)


def render_lanes(vp: VolPath, scene: SceneData, camera: PerspectiveCamera,
                 filt: FilterSampler, sample_idx, px, py):
    """Trace one path per lane (px, py). Returns (rgb (n, 3), filter weight
    (n,), stats) with stats 'rays_traced' and 'nonfinite_lanes' as 0-dim
    tensors on the scene's device."""
    _check_supported(vp)
    dev = scene.device
    w, h = camera.resolution
    px = torch.as_tensor(px, device=dev).long()
    py = torch.as_tensor(py, device=dev).long()
    n = px.shape[0]
    si = torch.as_tensor(sample_idx, device=dev).long().expand(n)
    zcfg = sb.make_zsobol(w, h, max(vp.samples_per_pixel, 1), seed=vp.seed)

    # camera stage (volpath.jl:125-205)
    ps = sb.compute_pixel_sample(zcfg, px, py, si)
    offset, filter_w = filter_sample(filt, ps.jitter)
    p_film = torch.stack([px.float(), py.float()], -1) + 0.5 + offset
    wl = sp.sample_wavelengths_visible(ps.wavelength_u)
    o, d = camera.generate_rays(CameraSample(p_film=p_film, lens=ps.lens,
                                             time=ps.time, filter_weight=filter_w))

    lam = wl.lam
    lights = scene.lights
    beta = torch.ones_like(lam)
    r_u = torch.ones_like(lam)
    r_l = torch.ones_like(lam)
    L = torch.zeros_like(lam)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    specular = torch.ones_like(alive)  # camera rays count as specular for MIS
    any_nonspec = torch.zeros_like(alive)
    disp_term = torch.zeros_like(alive)
    eta_scale = torch.ones(n, device=dev)
    prev_p = o
    rays_traced = torch.zeros((), device=dev)
    t_inf = torch.full((n,), float("inf"), device=dev)

    for depth in range(vp.max_depth):
        rays_traced = rays_traced + alive.float().sum()
        rec = scene_closest_hit(scene, o, d, t_inf, active=alive)
        alive = alive & rec.hit
        sd = _surface_data(scene, rec, o, d)
        hit = alive
        wo = -d
        frame = make_frame(sd["ns"])
        wo_l = to_local(*frame, wo)
        reg = any_nonspec if vp.regularize else None

        # area-light emission with MIS (surface-eval.jl:147-237)
        if mt.EMISSIVE in scene.present_materials:
            is_emitter = hit & (sd["arealight"] >= 0)
            le = mb.emitted_radiance(scene.materials, torch.clamp(sd["mat_idx"], min=0),
                                     lam, dot(sd["ng"], wo))
            area_flat = torch.clamp(lights.area_flat_base + sd["arealight"], 0,
                                    lights.pmf.shape[0] - 1)
            pdf_light = lt.area_light_pdf(
                lights, torch.clamp(sd["arealight"], min=0), prev_p, sd["p"],
                sd["ng"]) * _bl(lights.pmf, area_flat)
            if vp.nee:
                denom = torch.where(specular, r_u.mean(-1),
                                    (r_u + r_l * pdf_light[..., None]).mean(-1))
            else:
                denom = r_u.mean(-1)
            contrib = beta * le / torch.clamp(denom[..., None], min=1e-12)
            L = L + torch.where((is_emitter & (denom > 0.0))[..., None], contrib, 0.0)

        # NEE (surface_direct_lighting_inner!)
        if scene.n_lights > 0 and vp.nee:
            ul = sb.path_sample_1d(zcfg, px, py, si, depth, 0)
            ul2 = torch.stack(sb.path_sample_2d(zcfg, px, py, si, depth, 1), -1)
            li_flat, pmf_sel = lt.sample_light_index(lights, ul)
            ls = lt.sample_li(lights, _bl(lights.light_type, li_flat),
                              _bl(lights.light_idx, li_flat), sd["p"], lam, ul2)
            wi_l = to_local(*frame, ls.wi)
            f_s, pdf_b = _eval_bsdf_dispatch(scene, sd["mat_type"], sd["mat_idx"],
                                             wo_l, wi_l, lam, reg)
            f_hat = f_s * torch.abs(wi_l[..., 2])[..., None]
            pdf_l = ls.pdf * pmf_sel
            contrib_ok = hit & ls.valid & (pdf_l > 0.0) & (f_hat > 0.0).any(-1)
            o_sh = spawn_ray(sd["p"], sd["ng"], ls.wi)
            rays_traced = rays_traced + contrib_ok.float().sum()
            occluded = scene_any_hit(scene, o_sh, ls.wi, ls.t_max, active=contrib_ok,
                                     group=li_flat)
            r_l_sh = r_u * pdf_l[..., None]
            r_u_sh = r_u * pdf_b[..., None]
            denom = torch.where(ls.is_delta, r_l_sh.mean(-1), (r_l_sh + r_u_sh).mean(-1))
            ld = beta * f_hat * ls.li / torch.clamp(denom[..., None], min=1e-12)
            ok = contrib_ok & (denom > 0.0) & ~occluded
            L = L + torch.where(ok[..., None], ld, 0.0)

        # continuation: BSDF sample (evaluate_material_inner!)
        ub = torch.stack(sb.path_sample_2d(zcfg, px, py, si, depth, 3), -1)
        uc = sb.path_sample_1d(zcfg, px, py, si, depth, 5)
        bs = _sample_bsdf_dispatch(scene, sd["mat_type"], sd["mat_idx"], wo_l, lam,
                                   ub, uc, reg)
        wi_surf = to_world(*frame, bs.wi)
        thr = bs.f * (torch.abs(bs.wi[..., 2]) / torch.clamp(bs.pdf, min=1e-12))[..., None]
        go = hit & bs.valid & (bs.pdf > 0.0) & (thr > 0.0).any(-1)
        go3 = go[..., None]
        beta = torch.where(go3, beta * thr, beta)
        r_l = torch.where(go3, r_u / torch.clamp(bs.pdf, min=1e-12)[..., None], r_l)
        eta_scale = torch.where(go, eta_scale * bs.eta_scale, eta_scale)
        if mt.GLASS in scene.present_materials:
            gi = torch.clamp(sd["mat_idx"], 0, scene.materials.glass_cauchy.shape[0] - 1).long()
            dispersive = (sd["mat_type"] == mt.GLASS) & (
                (scene.materials.glass_cauchy[gi] > 0.0)
                | (scene.materials.glass_sell[gi, 0] > 0.0))
            disp_term = disp_term | (go & bs.transmission & dispersive)
        specular = torch.where(go, bs.specular, specular)
        any_nonspec = any_nonspec | (go & ~bs.specular)
        o = torch.where(go3, spawn_ray(sd["p"], sd["ng"], wi_surf), o)
        d = torch.where(go3, wi_surf, d)
        prev_p = torch.where(go3, o, prev_p)
        alive = alive & go

        # Russian roulette (russian_roulette_spectral); q = 1 below rr depth
        u_rr = sb.path_sample_1d(zcfg, px, py, si, depth, 6)
        if depth >= vp.russian_roulette_depth:
            rr_beta = sp.max_component(beta) * eta_scale / torch.clamp(r_u.mean(-1), min=1e-12)
            q = torch.clamp(rr_beta, 0.0, 0.95)
        else:
            q = torch.ones_like(u_rr)
        survive = u_rr < q
        beta = torch.where((alive & survive & (q < 1.0))[..., None],
                           beta / torch.clamp(q, min=1e-6)[..., None], beta)
        alive = alive & survive

    # film accumulation (vp_accumulate_to_rgb_kernel!, volpath.jl:326-375);
    # dispersion keeps the hero wavelength only, at 4x weight
    hero_only = torch.zeros_like(wl.pdf)
    hero_only[..., 0] = 0.25
    pdf_eff = torch.where(disp_term[..., None], wl.pdf * hero_only, wl.pdf)
    rgb = xyz_to_linear_srgb(spectral_to_xyz(L, lam, pdf_eff))
    mx = rgb.amax(-1)
    scale = torch.where(mx > vp.max_component_value,
                        vp.max_component_value / torch.clamp(mx, min=1e-12), 1.0)
    rgb = rgb * scale[..., None]
    bad = ~torch.isfinite(rgb).all(-1)
    rgb = torch.nan_to_num(rgb, nan=0.0, posinf=0.0, neginf=0.0)
    return rgb, filter_w, {"rays_traced": rays_traced,
                           "nonfinite_lanes": bad.float().sum()}


def render_sample(vp: VolPath, scene: SceneData, camera: PerspectiveCamera,
                  film: Film, filt: FilterSampler, sample_idx: int) -> Film:
    """Trace sample_batch consecutive samples (from sample_idx) of every
    pixel as one wavefront and accumulate them into the film."""
    w, h = film.width, film.height
    n = w * h
    k = max(1, int(vp.sample_batch))
    lanes = torch.arange(n, device=scene.device)
    px = (lanes % w).repeat(k)
    py = (lanes // w).repeat(k)
    si = sample_idx + torch.arange(k, device=scene.device).repeat_interleave(n)
    rgb, filter_w, _ = render_lanes(vp, scene, camera, filt, si, px, py)
    rgbw = (rgb * filter_w[:, None]).reshape(k, h, w, 3).sum(0)
    return film_add_weighted(film, rgbw, filter_w.reshape(k, h, w).sum(0), n_samples=k)


def render(vp: VolPath, scene: SceneData, camera: PerspectiveCamera,
           film: Film | None = None, filt: FilterSampler | None = None) -> Film:
    """Full render: samples_per_pixel progressive passes (volpath.jl:655-670)."""
    import dataclasses

    if film is None:
        film = make_film(*camera.resolution, device=scene.device)
    if filt is None:
        filt = make_filter()
    k = max(1, int(vp.sample_batch))
    for s in range(vp.samples_per_pixel // k):
        film = render_sample(vp, scene, camera, film, filt, s * k)
    rem = vp.samples_per_pixel % k
    if rem:
        film = render_sample(dataclasses.replace(vp, sample_batch=rem), scene, camera,
                             film, filt, vp.samples_per_pixel - rem)
    return film
