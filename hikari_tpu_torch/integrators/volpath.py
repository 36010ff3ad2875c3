"""VolPath: spectral volumetric wavefront path tracer.

Port of ``hikari_tpu/integrators/volpath.py``: NEE through the power,
uniform or BVH light sampler, emission MIS against area and environment
lights, escaped rays' environment and ambient radiance, Russian roulette
and glass dispersion, with the reference's
bounce-loop modes: material coherence 'none' / 'gated' / 'sorted', the
resident loop (``resident='on'``) and depth segments
(``render_lanes_segmented``). The path state is a dict of per-lane tensors
(the reference's state dict, with the medium channel ``med``), advanced by
``_bounce_core`` one bounce at a time; ``lax.fori_loop`` becomes a Python
loop over depth and ``where``-selects stay ``torch.where``. Every
``path_sample_*`` dimension index (0, 1, 3, 5, 6, 7, 9) is the JAX
package's, so both draw the same samples.

Participating media (``media/``): a lane inside a medium is delta-tracked
up to its surface hit, and may scatter (HG phase function, with NEE from
the scatter point), be absorbed, or reach the surface. ``Interface``
faces bound media without a BSDF: camera paths pass through them and
switch medium, and so do shadow rays, which on such scenes walk up to
MAX_INTERFACE_CROSSINGS closest hits (``_trace_shadow``) instead of one
occlusion test, ratio-tracking each segment's transmittance.

Instanced scenes (``SceneData.has_instances``) trace through the
two-level traversal of ``geometry/instanced.py``; their hit records name a
world treelet and column, decoded into the shared face row and the
instance (``_face_decode``), whose normal transform and material override
apply at the hit, in shadow walks too.

Every material of the JAX package shades here, under each
material_coherence mode: the layered ones through the random walks of
``materials/layered.py``, whose NEE evaluation draws ZSobol dimensions 7
and 9, and Mix resolved per hit to one of its children (``mix_u``).

Textures (``textures/atlas.py``): in a scene whose material banks have
textures, each hit gathers its uv and vertex colour from one ``tex_rows``
row and its uv screen derivatives from the camera's pixel footprint
(``_uv_screen_derivatives``); every BSDF sample and evaluation then takes
``tex`` = (atlas, TexCtx, RGB-to-spectrum table), permuted with the lanes
under 'sorted' dispatch. A scene without textures passes ``tex=None`` and
runs the constant-colour code alone. Stochastic alpha (``has_alpha``):
camera paths re-trace past hits whose hashed alpha test fails, for at most
ALPHA_ROUNDS rounds (``_closest_hit_surface``), and shadow rays walk
closest hits, passing alpha-failed occluders. ``render_aux`` gives the
denoiser's albedo, normal and depth images.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields

import torch

from ..camera.camera import CameraSample, PerspectiveCamera
from ..core.lookup import bank_lookup as _bl
from ..core.ray import spawn_ray
from ..core.vecmath import dot, face_forward, make_frame, normalize, to_local, to_world
from ..film.film import Film, film_add_weighted, make_film
from ..film.filters import FilterSampler, filter_sample, make_filter
from ..geometry import wavefront as wf
from ..geometry.traverse import HitRecord, any_hit, closest_hit
from ..geometry.triangle import interpolate
from ..geometry.instanced import any_hit_instanced, closest_hit_instanced
from ..geometry.sweep import RAY_TILE, TREELET
from ..geometry.wavefront import _inverse_permutation, ray_sort_keys
from ..lights import types as lt
from ..lights.bvh_sampler import bvh_pmf, bvh_sample_light
from ..materials import bsdf as mb
from ..materials import layered as ml
from ..materials import types as mt
from ..media import sample as ms
from ..sampling import sobol as sb
from ..sampling.hashes import MASK32, f32_bits, hash_u32x2, shr
from ..scene.scene import SceneData
from ..spectral import spectrum as sp
from ..spectral.cie import spectral_to_xyz, xyz_to_linear_srgb
from ..textures.atlas import TexCtx, eval_scalar
from ..utils import profiling

MAX_INTERFACE_CROSSINGS = 10  # shadow-ray boundary chain cap
# stochastic alpha re-trace cap (intersection.jl:223): each round clears one
# rejected hit per lane, so a deeper alpha stack renders opaque
ALPHA_ROUNDS = 16


@profiling.spanned("hikari.traversal")
def scene_closest_hit(scene: SceneData, o, d, t_max, active=None, presorted=False):
    """The scene's closest hit through its traversal engine: the skip-link
    walk (inactive lanes get reach 0), or the sweeps, where flat scenes
    take the banded two-pass sweep when wavefront.BAND_FRAC > 0 (band =
    BAND_FRAC x the world diagonal), as the reference does. presorted: see
    wavefront.closest_hit_packets."""
    if scene.has_instances:
        return closest_hit_instanced(scene.inst, o, d, t_max, scene.world_lo,
                                     scene.world_hi, active=active, presorted=presorted)
    if scene.traversal == "skiplink":
        if active is not None:
            t_max = torch.where(active, t_max, 0.0)
        return closest_hit(scene.bvh, o, d, t_max)
    band = None
    if wf.BAND_FRAC > 0.0:
        band = wf.BAND_FRAC * torch.linalg.vector_norm(scene.world_hi - scene.world_lo)
    return wf.closest_hit_packets(scene.treelets, o, d, t_max, scene.world_lo,
                                  scene.world_hi, active=active, band=band,
                                  presorted=presorted)


@profiling.spanned("hikari.traversal")
def scene_any_hit(scene: SceneData, o, d, t_max, active=None, group=None):
    if scene.has_instances:
        return any_hit_instanced(scene.inst, o, d, t_max, scene.world_lo,
                                 scene.world_hi, active=active, group=group)
    if scene.traversal == "skiplink":
        if active is not None:
            t_max = torch.where(active, t_max, 0.0)
        return any_hit(scene.bvh, o, d, t_max)
    return wf.any_hit_packets(scene.treelets, o, d, t_max, scene.world_lo,
                              scene.world_hi, active=active, group=group)


@dataclass(frozen=True)
class VolPath:
    """Config mirrors the JAX VolPath. sample_batch = K dispatches K
    consecutive samples of the frame as one K*w*h-lane wavefront (default
    4, or HIKARI_SAMPLE_BATCH).

    material_coherence: 'none' evaluates every present material type over
    all lanes; 'gated' skips a type that no lane has; 'sorted' stable-sorts
    the lanes by material tag and evaluates each present type on its run
    only. All three give the same result per lane.

    resident: 'on' keeps the path state in sorted order: each bounce sorts
    the lanes once by ray_sort_keys (dead lanes last), runs the whole
    bounce on the live prefix rounded up to a whole ray tile, with the
    closest hit presorted, and lane order is restored once at the end.
    'off' and 'auto' (which resolves off, as in the JAX package) run the
    bounce over every lane with the traversal's own sort. resident_levels
    is the reference's prefix-ladder depth; the port sizes the prefix to
    the live count itself, so the field is accepted and changes nothing."""

    max_depth: int = 5
    samples_per_pixel: int = 16
    russian_roulette_depth: int = 3
    regularize: bool = False
    max_component_value: float = 1e6  # firefly clamp
    seed: int = 0
    material_coherence: str = "none"  # 'none' | 'gated' | 'sorted'
    sample_batch: int = int(os.environ.get("HIKARI_SAMPLE_BATCH", "4"))
    resident: str = "auto"  # 'on' | 'off' | 'auto'
    resident_levels: int = 0
    nee: bool = True


def _check_supported(vp: VolPath):
    if vp.material_coherence not in ("none", "gated", "sorted"):
        raise ValueError(f"material_coherence={vp.material_coherence!r}: expected "
                         "'none', 'gated' or 'sorted'")
    if vp.resident not in ("on", "off", "auto"):
        raise ValueError(f"resident={vp.resident!r}: expected 'on', 'off' or 'auto'")


# --- material dispatch ------------------------------------------------------------


def _masked(m, new, old):
    """where(m, new, old) with m broadcast over new's trailing axes."""
    return torch.where(m.view(m.shape + (1,) * (new.dim() - m.dim())), new, old)


def _take(v, ix):
    """Lanes `ix` of a per-lane input: a tensor, a TexCtx or None."""
    if v is None:
        return None
    return v.take(ix) if isinstance(v, TexCtx) else v[ix]


def _sorted_type_dispatch(mat_type, per_lane, out_init, present, run_type):
    """Material-sorted shading (the reference's _sorted_type_dispatch,
    ``volpath.py:192``): one stable sort of the lanes by tag, each present
    type evaluated on its contiguous run only, one scatter back to lane
    order. The reference's window ladder and clamped dynamic_slice give
    XLA static shapes; eager PyTorch slices the run exactly.

    per_lane: dict of (N, ...) inputs (TexCtx entries are permuted field by
    field; None entries pass through);
    out_init: list of (N, ...) outputs for lanes of no listed type;
    run_type(tag, sliced per_lane) -> list matching out_init."""
    order = torch.sort(mat_type, stable=True).indices
    mt_s = mat_type[order]
    pl_s = {k: _take(v, order) for k, v in per_lane.items()}
    out = [x[order] for x in out_init]
    tags = torch.tensor(present, dtype=mt_s.dtype, device=mt_s.device)
    profiling.host_sync("dispatch.sorted_tags", mt_s.device)
    starts = torch.searchsorted(mt_s, tags).tolist()
    profiling.host_sync("dispatch.sorted_starts")
    ends = torch.searchsorted(mt_s, tags, right=True).tolist()
    profiling.host_sync("dispatch.sorted_ends")
    for tag, a, b in zip(present, starts, ends):
        if b > a:
            res = run_type(tag, {k: _take(v, slice(a, b)) for k, v in pl_s.items()})
            for o, r in zip(out, res):
                o[a:b] = r
    back = [torch.empty_like(x) for x in out]
    for dst, src in zip(back, out):
        dst[order] = src
    return back


_LAYERED_TAGS = (mt.COATED_DIFFUSE, mt.COATED_CONDUCTOR, mt.COATED_DIFFUSE_TRANSMISSION)


def _no_reg(fn):
    """A lobe that takes no regularize mask, under the dispatch's signature."""
    return lambda banks, idx, wo, lam, u2, uc, reg, tex: fn(banks, idx, wo, lam, u2, uc,
                                                            tex=tex)


def _walk_eval(fn):
    """A layered lobe's evaluation: no regularize mask, the walk's u2 / uc."""
    return lambda banks, idx, wo, wi, lam, reg, u2, uc, tex: fn(banks, idx, wo, wi, lam, u2,
                                                                uc, tex=tex)


# per BSDF-bearing tag: sample(banks, idx, wo, lam, u2, uc, reg, tex)
_SAMPLERS = {
    mt.MATTE: _no_reg(mb.sample_matte), mt.MIRROR: _no_reg(mb.sample_mirror),
    mt.GLASS: lambda b, i, wo, lam, u2, uc, reg, tex: mb.sample_glass(
        b, i, wo, lam, u2, uc, reg, tex=tex),
    mt.CONDUCTOR: lambda b, i, wo, lam, u2, uc, reg, tex: mb.sample_conductor(
        b, i, wo, lam, u2, uc, reg, tex=tex),
    mt.THIN_DIELECTRIC: _no_reg(mb.sample_thin_dielectric),
    mt.DIFFUSE_TRANSMISSION: _no_reg(mb.sample_diffuse_transmission),
    mt.COATED_DIFFUSE: _no_reg(ml.sample_coated_diffuse),
    mt.COATED_CONDUCTOR: _no_reg(ml.sample_coated_conductor),
    mt.COATED_DIFFUSE_TRANSMISSION: _no_reg(ml.sample_coated_diffuse_transmission),
}
# per tag with a non-delta lobe: eval(banks, idx, wo, wi, lam, reg, u2, uc, tex) ->
# (f, pdf); u2 / uc drive the layered walks
_EVALUATORS = {
    mt.MATTE: lambda b, i, wo, wi, lam, reg, u2, uc, tex: mb.eval_matte(
        b, i, wo, wi, lam, tex=tex),
    mt.CONDUCTOR: lambda b, i, wo, wi, lam, reg, u2, uc, tex: mb.eval_conductor(
        b, i, wo, wi, lam, reg, tex=tex),
    mt.GLASS: lambda b, i, wo, wi, lam, reg, u2, uc, tex: mb.eval_glass(
        b, i, wo, wi, lam, reg, tex=tex),
    mt.DIFFUSE_TRANSMISSION: lambda b, i, wo, wi, lam, reg, u2, uc, tex: (
        mb.eval_diffuse_transmission(b, i, wo, wi, lam, tex=tex)),
    mt.COATED_DIFFUSE: _walk_eval(ml.eval_coated_diffuse),
    mt.COATED_CONDUCTOR: _walk_eval(ml.eval_coated_conductor),
    mt.COATED_DIFFUSE_TRANSMISSION: _walk_eval(ml.eval_coated_diffuse_transmission),
}
_SAMPLE_FIELDS = tuple(f.name for f in fields(mb.BSDFSample))


def _any_synced(m, site: str) -> bool:
    """bool(m.any()), a host sync counted at `site`."""
    profiling.host_sync(site)
    return bool(m.any())


def _dispatch(mat_type, tags, per_lane, out, run_type, coherence):
    """Evaluate run_type per tag and merge by mat_type: densely ('none'),
    skipping tags no lane has ('gated'), or on sorted runs ('sorted')."""
    if coherence == "sorted":
        return _sorted_type_dispatch(mat_type, per_lane, out, list(tags), run_type)
    for tag in tags:
        m = mat_type == tag
        if coherence == "gated" and not _any_synced(m, "dispatch.gated"):
            continue
        out = [_masked(m, new, old) for new, old in zip(run_type(tag, per_lane), out)]
    return out


def _lane_tex(tex, ctx):
    """The (atlas, lanes' TexCtx, table) of a dispatch run; None without
    textures."""
    return None if ctx is None else (tex[0], ctx, tex[2])


@profiling.spanned("hikari.shading")
def _sample_bsdf_dispatch(scene, mat_type, mat_idx, wo, lam, u2, uc, regularize,
                          coherence="none", tex=None):
    """Per-type BSDF sampling, selected by tag. tex: the surface's (atlas,
    TexCtx, table), or None in a scene without textures."""
    banks = scene.materials
    init = mb.invalid_sample(tuple(mat_type.shape), mat_type.device)
    tags = [t for t in _SAMPLERS if t in scene.present_materials]

    def run(tag, pl):
        s = _SAMPLERS[tag](banks, pl["idx"], pl["wo"], pl["lam"], pl["u2"], pl["uc"],
                           pl["reg"], _lane_tex(tex, pl["ctx"]))
        return [getattr(s, f) for f in _SAMPLE_FIELDS]

    out = _dispatch(mat_type, tags,
                    dict(idx=mat_idx, wo=wo, lam=lam, u2=u2, uc=uc, reg=regularize,
                         ctx=None if tex is None else tex[1]),
                    [getattr(init, f) for f in _SAMPLE_FIELDS], run, coherence)
    return mb.BSDFSample(**dict(zip(_SAMPLE_FIELDS, out)))


@profiling.spanned("hikari.shading")
def _eval_bsdf_dispatch(scene, mat_type, mat_idx, wo, wi, lam, regularize, coherence,
                        eval_u2, eval_uc, tex=None):
    """(f, pdf) for NEE MIS; zero for specular-only materials. eval_u2 /
    eval_uc (the ZSobol dimensions 7 and 9) drive the layered walks (None
    in a scene without layered materials); tex as in _sample_bsdf_dispatch."""
    banks = scene.materials
    tags = [t for t in _EVALUATORS if t in scene.present_materials]

    def run(tag, pl):
        return _EVALUATORS[tag](banks, pl["idx"], pl["wo"], pl["wi"], pl["lam"], pl["reg"],
                                pl["u2"], pl["uc"], _lane_tex(tex, pl["ctx"]))

    f, pdf = _dispatch(mat_type, tags,
                       dict(idx=mat_idx, wo=wo, wi=wi, lam=lam, reg=regularize, u2=eval_u2,
                            uc=eval_uc, ctx=None if tex is None else tex[1]),
                       [torch.zeros_like(lam), torch.zeros(mat_type.shape, device=lam.device)],
                       run, coherence)
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


def _inst_xform_point(scene: SceneData, inst, p_obj):
    """Object -> world point by the instance's [linear | translation] rows."""
    m = scene.inst_l2w[inst]
    return (m[..., :3] * p_obj[..., None, :]).sum(-1) + m[..., 3]


def _uv_screen_derivatives(camera: PerspectiveCamera, p, p0, p1, p2, uv0, uv1, uv2):
    """Texture-filter derivatives from the camera: pbrt's Approximate_dp_dxy
    (a one-pixel footprint scaled by the hit's camera depth) solved against
    the triangle's dp/duv (surface-eval.jl:32-141). The world-to-camera
    matrix is the camera's stored inverse, computed once with it."""
    w2c = camera.camera_to_world.inverse()
    z = torch.abs(w2c.apply_point(p)[..., 2:3])
    c2w = camera.camera_to_world
    dpdx = c2w.apply_vector(camera.dx_camera.to(p.device))[None, :] * z
    dpdy = c2w.apply_vector(camera.dy_camera.to(p.device))[None, :] * z
    return _solve_duv(p0, p1, p2, uv0, uv1, uv2, dpdx, dpdy)


def _uv_diff_derivatives(diff, p, ng, p0, p1, p2, uv0, uv1, uv2):
    """Ray-differential texture derivatives: the +x / +y auxiliary camera
    rays (diff.rx_o, rx_d, ry_o, ry_d) moved to the hit plane (p, ng), their
    offsets solved against the triangle's dp/duv
    (surface_interaction.jl:136-174)."""

    def transfer(ro, rd):
        den = (ng * rd).sum(-1)
        ok = torch.abs(den) > 1e-12
        t = ((p - ro) * ng).sum(-1) / torch.where(ok, den, 1.0)
        dp = ro + t[..., None] * rd - p
        return torch.where((ok & torch.isfinite(t))[..., None], dp, 0.0)

    return _solve_duv(p0, p1, p2, uv0, uv1, uv2, transfer(diff.rx_o, diff.rx_d),
                      transfer(diff.ry_o, diff.ry_d))


def _solve_duv(p0, p1, p2, uv0, uv1, uv2, dpdx, dpdy):
    """Least-squares (duvdx, duvdy) of world-space footprint vectors against
    the triangle's dp/duv (pbrt-v4 SurfaceInteraction::ComputeDifferentials);
    zero where the uv or the normal equations are degenerate."""
    dp1, dp2 = p1 - p0, p2 - p0
    duv1, duv2 = uv1 - uv0, uv2 - uv0
    det = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
    ok_uv = torch.abs(det) > 1e-12
    inv = 1.0 / torch.where(ok_uv, det, 1.0)
    dpdu = (duv2[..., 1:2] * dp1 - duv1[..., 1:2] * dp2) * inv[..., None]
    dpdv = (-duv2[..., 0:1] * dp1 + duv1[..., 0:1] * dp2) * inv[..., None]
    a00 = (dpdu * dpdu).sum(-1)
    a01 = (dpdu * dpdv).sum(-1)
    a11 = (dpdv * dpdv).sum(-1)
    det_a = a00 * a11 - a01 * a01
    ok = ok_uv & (torch.abs(det_a) > 1e-20)
    inv_a = 1.0 / torch.where(ok, det_a, 1.0)

    def solve(dp):
        b0 = (dpdu * dp).sum(-1)
        b1 = (dpdv * dp).sum(-1)
        duv = torch.stack([(a11 * b0 - a01 * b1) * inv_a, (a00 * b1 - a01 * b0) * inv_a], -1)
        return torch.where(ok[..., None], duv, 0.0)

    return solve(dpdx), solve(dpdy)


def _volumetric(scene: SceneData) -> bool:
    """The scene has media or Interface faces: paths carry a medium and
    shadow rays walk through interfaces."""
    return scene.has_media or mt.INTERFACE in scene.present_materials


def mix_u(b1, b2, tri):
    """The Mix choice's uniform of each hit: a hash of its barycentrics'
    bits and its face row (mix-material.jl:39-57), stable across samples
    so that the material does not flicker."""
    h = hash_u32x2(f32_bits(b1 + 0.123) ^ (tri & MASK32), f32_bits(b2 + 0.456))
    return shr(h, 32).to(torch.float32) * 2.0 ** -32


def _resolve_mix(scene: SceneData, mat_type, mat_idx, tri, rec, uv, vcol):
    """Mix lanes -> the child that the hit's mix_u picks (the first where
    mix_u < amount; a textured amount reads its texture at the hit's uv,
    level 0)."""
    banks = scene.materials
    # other tags' indices may pass the Mix rows: clamped, as XLA's gather does
    mi = torch.clamp(mat_idx, 0, banks.mix_amount.shape[0] - 1).long()
    amount = banks.mix_amount[mi]
    if banks.has_textures:
        amount = eval_scalar(scene.atlas, banks.mix_amount_tex[mi], amount,
                             TexCtx(uv=uv, vcolor=vcol))
    use1 = mix_u(rec.b1, rec.b2, tri) < amount
    is_mix = mat_type == mt.MIX
    child_t = torch.where(use1, banks.mix_m1_type[mi], banks.mix_m2_type[mi])
    child_i = torch.where(use1, banks.mix_m1_idx[mi], banks.mix_m2_idx[mi])
    return torch.where(is_mix, child_t, mat_type), torch.where(is_mix, child_i, mat_idx)


@profiling.spanned("hikari.shading")
def _surface_data(scene: SceneData, rec, o, d, camera=None, diff=None):
    """Hit-point attributes from one (F, 17) face-row gather; in a scene
    with textures also uv and vertex colour from one tex_rows gather and,
    given the camera, the uv screen derivatives, or given true ray
    differentials `diff` (rx_o, rx_d, ry_o, ry_d: Whitted's primary hits in
    the JAX package) the derivatives they transfer (entry "tex": (atlas,
    TexCtx, table), else None)."""
    tri, inst = _face_decode(scene, rec.tri)
    p_hit = o + rec.t[..., None] * d
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
    tex = uv = vcol = None
    if scene.materials.has_textures:
        trows = scene.tex_rows[tri]
        uvs = trows[..., 0:2], trows[..., 2:4], trows[..., 4:6]
        uv = interpolate(rec.b1, rec.b2, *uvs)
        vcol = interpolate(rec.b1, rec.b2, trows[..., 6:9], trows[..., 9:12],
                           trows[..., 12:15])
        duvdx = duvdy = None
        if camera is not None or diff is not None:
            corners = scene.tri_p[tri]
            q = [corners[..., 3 * k:3 * k + 3] for k in range(3)]
            if inst is not None:
                q = [_inst_xform_point(scene, inst, c) for c in q]
            if diff is not None:
                duvdx, duvdy = _uv_diff_derivatives(diff, p_hit, ng_raw, *q, *uvs)
            else:
                duvdx, duvdy = _uv_screen_derivatives(camera, p_hit, *q, *uvs)
        tex = (scene.atlas, TexCtx(uv=uv, vcolor=vcol, duvdx=duvdx, duvdy=duvdy),
               scene.rgb2spec)
    mat_type, mat_idx = packed >> 24, packed & 0xFFFFFF
    if mt.MIX in scene.present_materials:
        mat_type, mat_idx = _resolve_mix(scene, mat_type, mat_idx, tri, rec, uv, vcol)
    if mt.EMISSIVE in scene.present_materials:
        arealight = rows[..., 14].to(torch.int32) - 1
    else:
        arealight = torch.full_like(packed, -1)
    sd = dict(p=p_hit, ng=face_forward(ng_raw, ns), ng_raw=ng_raw, ns=ns, mat_type=mat_type,
              mat_idx=mat_idx, arealight=arealight, tex=tex)
    if _volumetric(scene):
        sd.update(inside_med=rows[..., 15].to(torch.int32) - 1,
                  outside_med=rows[..., 16].to(torch.int32) - 1)
    return sd


def _crossing_medium(sd, direction):
    """Medium entered when crossing the surface along `direction`: inside
    against the winding normal, outside along it."""
    entering_inside = dot(direction, sd["ng_raw"]) < 0.0
    return torch.where(entering_inside, sd["inside_med"], sd["outside_med"])


def _alpha_keep(scene: SceneData, rec, p_hit, u_salt: int = 0):
    """Stochastic alpha test of a hit: kept with probability alpha (the
    face's constant, or its alpha texture at the hit's uv), by a hash of the
    bits of the world hit point and the face row, salted per round, so the
    decision is stable per point and independent across the lanes of a
    packet (intersection.jl:223-252). Misses are kept."""
    tri, _ = _face_decode(scene, rec.tri)
    trows = scene.tex_rows[tri]
    uv = interpolate(rec.b1, rec.b2, trows[..., 0:2], trows[..., 2:4], trows[..., 4:6])
    ctx = TexCtx(uv=uv, vcolor=torch.ones(uv.shape[:-1] + (3,), device=uv.device))
    a = eval_scalar(scene.atlas, trows[..., 16].to(torch.int32) - 1, trows[..., 15], ctx)
    hx, hy, hz = (f32_bits(p_hit[..., k]) for k in range(3))
    salt = (0x9E3779B9 * (u_salt + 1)) & MASK32
    h = hash_u32x2(hx ^ (((hy << 16) & MASK32) | (hy >> 16)), hz ^ (tri & MASK32) ^ salt)
    u = shr(h, 32).to(torch.float32) * 2.0 ** -32
    return ~rec.hit | (u < a)


def _closest_hit_surface(scene: SceneData, o, d, t_max, active, presorted=False):
    """The closest hit that passes the stochastic alpha test: lanes whose
    hit fails it re-trace past it, for at most ALPHA_ROUNDS rounds, and then
    keep whatever they stand on (the reference's 16-try cap). A round in
    which no lane re-traces ends the loop: every later round would change
    nothing. The returned t is from the original origin."""
    rec = scene_closest_hit(scene, o, d, t_max, active=active, presorted=presorted)
    if not scene.has_alpha:
        return rec
    o_cur, t_off, live = o, torch.zeros_like(rec.t), active
    for k in range(ALPHA_ROUNDS):
        keep = _alpha_keep(scene, rec, o_cur + rec.t[..., None] * d, u_salt=k)
        retrace = live & rec.hit & ~keep
        if not _any_synced(retrace, "alpha.retrace"):
            break
        t_adv = rec.t + 1e-4
        o_cur = torch.where(retrace[..., None], o_cur + t_adv[..., None] * d, o_cur)
        t_off = torch.where(retrace, t_off + t_adv, t_off)
        rec2 = scene_closest_hit(scene, o_cur, d, torch.clamp(t_max - t_off, min=0.0),
                                 active=retrace, presorted=presorted)
        rec = HitRecord(*(torch.where(retrace, new, old) for new, old in (
            (rec2.hit, rec.hit), (rec2.t, rec.t), (rec2.tri, rec.tri), (rec2.b1, rec.b1),
            (rec2.b2, rec.b2))))
        live = retrace
    return HitRecord(hit=rec.hit, t=rec.t + t_off, tri=rec.tri, b1=rec.b1, b2=rec.b2)


def _trace_shadow(scene: SceneData, o_sh, wi, t_max, medium_sh, lam, active,
                  light_group=None):
    """Shadow transmittance (T_ray, r_l multiplier, r_u multiplier), each
    (N, 4); T_ray 0 where blocked. Without media, interfaces and alpha one
    occlusion sweep decides. Otherwise the ray walks up to
    MAX_INTERFACE_CROSSINGS closest hits: Interface faces and alpha-failed
    hits are crossed (an interface switching medium), any other face
    blocks, and each segment inside a medium is ratio-tracked. The walk
    stops early once no lane runs."""
    ones4 = torch.ones_like(lam)
    if not _volumetric(scene) and not scene.has_alpha:
        occluded = scene_any_hit(scene, o_sh, wi, t_max, active=active, group=light_group)
        return torch.where(occluded[..., None], 0.0, ones4), ones4, ones4
    T_ray = r_l_m = r_u_m = ones4
    running, o_cur, t_rem, med = active, o_sh, t_max, medium_sh
    for _ in range(MAX_INTERFACE_CROSSINGS):
        if not _any_synced(running, "shadow_walk.running"):
            break
        rec = scene_closest_hit(scene, o_cur, wi, t_rem, active=running)
        if scene.has_media:
            T_seg, rl_seg, ru_seg = ms.ratio_track_tr(
                scene.media, scene.rgb2spec, med, o_cur, wi,
                torch.where(rec.hit, rec.t, t_rem), lam, running & (med >= 0))
            T_ray, r_l_m, r_u_m = T_ray * T_seg, r_l_m * rl_seg, r_u_m * ru_seg
        hit_something = running & rec.hit
        tri, inst = _face_decode(scene, rec.tri)
        rows = scene.face_rows[tri]
        packed = (rows[..., 12].to(torch.int32) << 16) | rows[..., 13].to(torch.int32)
        ng_raw = rows[..., 0:3]
        if inst is not None:
            override = scene.inst_mat_packed[inst]
            packed = torch.where(override >= 0, override, packed)
            ng_raw = _inst_xform_normal(scene, inst, ng_raw)
        passthrough = (packed >> 24) == mt.INTERFACE
        if scene.has_alpha:
            passthrough = passthrough | ~_alpha_keep(scene, rec, o_cur + rec.t[..., None] * wi,
                                                     u_salt=7)
        T_ray = torch.where((hit_something & ~passthrough)[..., None], 0.0, T_ray)
        crossing = hit_something & passthrough
        if med is not None:  # an alpha-only scene's shadow rays carry no medium
            entering_inside = (wi * ng_raw).sum(-1) < 0.0
            new_med = torch.where(entering_inside, rows[..., 15].to(torch.int32) - 1,
                                  rows[..., 16].to(torch.int32) - 1)
            med = torch.where(crossing, new_med, med)
        p_hit = o_cur + rec.t[..., None] * wi
        o_cur = torch.where(crossing[..., None], p_hit + 1e-4 * wi, o_cur)
        t_rem = torch.where(crossing, t_rem - rec.t - 1e-4, t_rem)
        running = crossing & (t_rem > 0.0)
    return T_ray, r_l_m, r_u_m


# --- the bounce loop ----------------------------------------------------------------


def _mis_denominator(vp: VolPath, specular, r_u, r_l_hat):
    """The spectral MIS denominator of emission reached by a path: the
    light's rescaled pdf r_l_hat counts unless the last bounce was specular
    or NEE is off."""
    if not vp.nee:
        return r_u.mean(-1)
    return torch.where(specular, r_u.mean(-1), (r_u + r_l_hat).mean(-1))


@profiling.spanned("hikari.bounce", attrs=("depth",))
def _bounce_core(vp: VolPath, scene: SceneData, zcfg, depth: int, st: dict, rays_traced,
                 presorted: bool = False, camera: PerspectiveCamera | None = None):
    """One bounce over an arbitrary lane subset: the state dict `st` of
    render_lanes (the whole wavefront, or the resident loop's sorted live
    prefix) -> (new state, rays_traced). px, py and si ride in the state,
    so permuted lanes draw their own ZSobol samples. camera: the texture
    filter footprints' (JAX volpath.py:1236)."""
    o, d, beta, r_u, r_l, L = st["o"], st["d"], st["beta"], st["r_u"], st["r_l"], st["L"]
    alive, specular, eta_scale = st["alive"], st["spec"], st["eta"]
    any_nonspec, disp_term = st["anyns"], st["disp"]
    prev_p, prev_ns = st["prev_p"], st["prev_ns"]
    lam, px, py, si, med = st["lam"], st["px"], st["py"], st["si"], st["med"]
    lights = scene.lights
    coherence = vp.material_coherence
    vol = _volumetric(scene)

    rays_traced = rays_traced + alive.float().sum()
    t_inf = torch.full((o.shape[0],), float("inf"), device=o.device)
    rec = _closest_hit_surface(scene, o, d, t_inf, alive, presorted=presorted)

    # the medium segment up to the surface: delta tracking
    scattered = torch.zeros_like(alive)
    p_scatter, g_scatter, d_med = o, torch.zeros_like(t_inf), d
    if scene.has_media:
        in_medium = alive & (med >= 0)
        dtr = ms.delta_track(
            scene.media, scene.rgb2spec, med, o, d, torch.where(rec.hit, rec.t, t_inf), lam,
            beta, r_u, r_l, in_medium,
            torch.full_like(alive, depth >= vp.max_depth - 1))
        L = L + dtr.L_emit
        beta, r_u, r_l = dtr.beta, dtr.r_u, dtr.r_l
        scattered = in_medium & (dtr.status == ms.SCATTERED)
        alive = alive & ~(in_medium & (dtr.status == ms.ABSORBED))
        p_scatter, g_scatter = dtr.p_scatter, dtr.g
        # a deflected medium bends the ray at null events; the phase frame
        # takes the bent direction
        d_med = torch.where(in_medium[..., None], dtr.d_out, d)
    reach = alive & ~scattered  # lanes that reach a surface or escape
    hit = reach & rec.hit
    escaped = reach & ~rec.hit
    alive = alive & (rec.hit | scattered)
    bvh = scene.light_sampler == "bvh"

    # escaped rays: environment radiance with MIS against sampling the
    # environment light (the flat list's last), and ambient radiance
    # (intersection.jl:622-677); media bend the ray at null events, so the
    # lookup takes the bent direction
    if lights.has_env:
        le_env, pdf_env = lt.env_radiance(lights, scene.rgb2spec, d_med, lam)
        if bvh:
            pmf_env = bvh_pmf(scene.light_bvh, prev_p, prev_ns,
                              torch.full_like(med, lights.n_flat - 1))
        else:
            pmf_env = lights.pmf[lights.n_flat - 1]
        denom = _mis_denominator(vp, specular, r_u, r_l * (pdf_env * pmf_env)[..., None])
        contrib = beta * le_env / torch.clamp(denom[..., None], min=1e-12)
        L = L + torch.where((escaped & (denom > 0.0))[..., None], contrib, 0.0)
    if lights.has_ambient:
        le_amb = lt.illuminant(scene.rgb2spec, lights.ambient_l.sum(0), lam)
        contrib = beta * le_amb / torch.clamp(r_u.mean(-1)[..., None], min=1e-12)
        L = L + torch.where(escaped[..., None], contrib, 0.0)
    sd = _surface_data(scene, rec, o, d, camera)
    wo = -d
    frame = make_frame(sd["ns"])
    wo_l = to_local(*frame, wo)
    reg = any_nonspec if vp.regularize else None
    is_interface = sd["mat_type"] == mt.INTERFACE if vol else None

    # area-light emission with MIS (surface-eval.jl:147-237)
    if mt.EMISSIVE in scene.present_materials:
        is_emitter = hit & (sd["arealight"] >= 0)
        le = mb.emitted_radiance(scene.materials, torch.clamp(sd["mat_idx"], min=0),
                                 lam, dot(sd["ng"], wo), tex=sd["tex"])
        area_flat = torch.clamp(lights.area_flat_base + sd["arealight"], 0,
                                lights.pmf.shape[0] - 1)
        pmf_area = (bvh_pmf(scene.light_bvh, prev_p, prev_ns, area_flat) if bvh
                    else _bl(lights.pmf, area_flat))
        pdf_light = lt.area_light_pdf(
            lights, torch.clamp(sd["arealight"], min=0), prev_p, sd["p"], sd["ng"]) * pmf_area
        denom = _mis_denominator(vp, specular, r_u, r_l * pdf_light[..., None])
        contrib = beta * le / torch.clamp(denom[..., None], min=1e-12)
        L = L + torch.where((is_emitter & (denom > 0.0))[..., None], contrib, 0.0)

    # NEE from surfaces (surface_direct_lighting_inner!) and from medium
    # scatter points (medium_direct_lighting_inner!, the phase function as
    # f and pdf)
    if scene.n_lights > 0 and vp.nee:
        ul = sb.path_sample_1d(zcfg, px, py, si, depth, 0)
        ul2 = torch.stack(sb.path_sample_2d(zcfg, px, py, si, depth, 1), -1)
        p_ref = torch.where(scattered[..., None], p_scatter, sd["p"]) if vol else sd["p"]
        if bvh:  # medium lanes have no normal
            ns_ref = torch.where(scattered[..., None], 0.0, sd["ns"]) if vol else sd["ns"]
            li_flat, pmf_sel = bvh_sample_light(scene.light_bvh, p_ref, ns_ref, ul)
        else:
            li_flat, pmf_sel = lt.sample_light_index(lights, ul)
        ls = lt.sample_li(lights, scene.rgb2spec, _bl(lights.light_type, li_flat),
                          _bl(lights.light_idx, li_flat), p_ref, lam, ul2, scene.scene_radius)
        wi_l = to_local(*frame, ls.wi)
        u2e = uce = None
        if any(t in scene.present_materials for t in _LAYERED_TAGS):
            u2e = torch.stack(sb.path_sample_2d(zcfg, px, py, si, depth, 7), -1)
            uce = sb.path_sample_1d(zcfg, px, py, si, depth, 9)
        f_s, pdf_b = _eval_bsdf_dispatch(scene, sd["mat_type"], sd["mat_idx"],
                                         wo_l, wi_l, lam, reg, coherence, u2e, uce,
                                         tex=sd["tex"])
        f_hat = f_s * torch.abs(wi_l[..., 2])[..., None]
        nee_lanes = hit
        o_sh = spawn_ray(sd["p"], sd["ng"], ls.wi)
        med_sh = None
        if vol:
            nee_lanes = (hit & ~is_interface) | scattered
            ph = ms.hg_eval(g_scatter, -torch.where(scattered[..., None], d_med, d), ls.wi)
            f_hat = torch.where(scattered[..., None], ph[..., None], f_hat)
            pdf_b = torch.where(scattered, ph, pdf_b)
            o_sh = torch.where(scattered[..., None], p_scatter, o_sh)
            med_sh = torch.where(scattered, med, _crossing_medium(sd, ls.wi))
        pdf_l = ls.pdf * pmf_sel
        contrib_ok = nee_lanes & ls.valid & (pdf_l > 0.0) & (f_hat > 0.0).any(-1)
        rays_traced = rays_traced + contrib_ok.float().sum()
        T_ray, rl_m, ru_m = _trace_shadow(scene, o_sh, ls.wi, ls.t_max, med_sh, lam,
                                          contrib_ok, light_group=li_flat)
        # pbrt SampleLd: r_l' = r_u pdf_l rl_m, r_u' = r_u pdf_b ru_m
        r_l_sh = r_u * pdf_l[..., None] * rl_m
        r_u_sh = r_u * pdf_b[..., None] * ru_m
        denom = torch.where(ls.is_delta, r_l_sh.mean(-1), (r_l_sh + r_u_sh).mean(-1))
        ld = beta * f_hat * T_ray * ls.li / torch.clamp(denom[..., None], min=1e-12)
        ok = contrib_ok & (denom > 0.0) & (T_ray > 0.0).any(-1)
        L = L + torch.where(ok[..., None], ld, 0.0)

    # continuation: BSDF sample (evaluate_material_inner!), HG sample at
    # medium scatters, straight on through interfaces
    ub = torch.stack(sb.path_sample_2d(zcfg, px, py, si, depth, 3), -1)
    uc = sb.path_sample_1d(zcfg, px, py, si, depth, 5)
    bs = _sample_bsdf_dispatch(scene, sd["mat_type"], sd["mat_idx"], wo_l, lam,
                               ub, uc, reg, coherence, tex=sd["tex"])
    wi_surf = to_world(*frame, bs.wi)
    thr = bs.f * (torch.abs(bs.wi[..., 2]) / torch.clamp(bs.pdf, min=1e-12))[..., None]
    go = hit & bs.valid & (bs.pdf > 0.0) & (thr > 0.0).any(-1)
    if vol:
        go = go & ~is_interface
        wi_med, pdf_med = ms.hg_sample(
            g_scatter, -torch.where(scattered[..., None], d_med, d), ub)
        med_go = scattered & (pdf_med > 0.0)
        iface_go = hit & is_interface
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
    o_new = torch.where(go3, spawn_ray(sd["p"], sd["ng"], wi_surf), o)
    d = torch.where(go3, wi_surf, d)
    moved = go
    if vol:
        # phase sampling: f / pdf = 1, r_l = r_u / pdf; never specular
        m3 = med_go[..., None]
        r_l = torch.where(m3, r_u / torch.clamp(pdf_med, min=1e-12)[..., None], r_l)
        specular = specular & ~med_go
        any_nonspec = any_nonspec | med_go
        # medium transitions: transmission through a surface, interfaces
        new_med_surf = torch.where(bs.transmission, _crossing_medium(sd, wi_surf), med)
        med = torch.where(go, new_med_surf,
                          torch.where(iface_go, _crossing_medium(sd, st["d"]), med))
        o_new = torch.where(m3, p_scatter, o_new)
        o_new = torch.where(iface_go[..., None], sd["p"] + 1e-4 * st["d"], o_new)
        d = torch.where(m3, wi_med, d)
        moved = go | med_go
        alive = alive & (go | med_go | iface_go)
    else:
        alive = alive & go
    prev_p = torch.where(moved[..., None], o_new, prev_p)
    prev_ns = torch.where(go[..., None], sd["ns"], prev_ns)
    if vol:
        prev_ns = torch.where(med_go[..., None], 0.0, prev_ns)
    o = o_new

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

    out = dict(st)
    out.update(o=o, d=d, beta=beta, r_u=r_u, r_l=r_l, L=L, alive=alive, spec=specular,
               eta=eta_scale, anyns=any_nonspec, prev_p=prev_p, prev_ns=prev_ns,
               disp=disp_term, med=med)
    return out, rays_traced


def _resident_bounce_loop(vp: VolPath, scene: SceneData, st: dict, rays_traced, bounce,
                          n: int):
    """The reference's _resident_bounce_loop (``volpath.py:1011``): each
    bounce sorts the lanes once by ray_sort_keys (dead lanes keyed
    0xFFFFFFFF, so they sort last), gathers the state once, and runs the
    bounce on the live prefix rounded up to a whole ray tile with the
    closest hit presorted; the lanes past the prefix are dead and keep
    their state. The carried lane ids restore lane order once at the end.
    The reference packs the state into one f32 row gather because a TPU
    gather costs per address; here each field is gathered on its own.
    Returns (L, disp, rays_traced) in lane order."""
    n_pad = -(-n // RAY_TILE) * RAY_TILE
    if n_pad > n:
        # pad lanes are dead, with unit directions for the sort key and
        # their own lane ids so the final permutation is a bijection
        st = {k: torch.cat([v, v.new_zeros((n_pad - n,) + v.shape[1:])])
              for k, v in st.items()}
        st["d"][n:] = 1.0
        st["lane"][n:] = torch.arange(n, n_pad, device=st["lane"].device)
        st["med"][n:] = -1
    for depth in range(vp.max_depth):
        keys = torch.clamp(ray_sort_keys(st["o"], st["d"], scene.world_lo, scene.world_hi),
                           max=0xFFFFFFFE)
        keys = torch.where(st["alive"], keys, 0xFFFFFFFF)
        order = torch.sort(keys, stable=True).indices
        st = {k: v[order] for k, v in st.items()}
        sz = -(-int(st["alive"].sum()) // RAY_TILE) * RAY_TILE
        profiling.host_sync("resident.live")
        if sz == 0:
            break
        out, rays_traced = bounce(depth, {k: v[:sz] for k, v in st.items()}, rays_traced)
        st = {k: torch.cat([out[k], st[k][sz:]]) for k in st}
    inv = _inverse_permutation(st["lane"])[:n]
    return st["L"][inv], st["disp"][inv], rays_traced


@profiling.spanned("hikari.lanes")
def render_lanes(vp: VolPath, scene: SceneData, camera: PerspectiveCamera,
                 filt: FilterSampler, sample_idx, px, py, depth_lo=None, depth_hi=None,
                 carry_in=None, return_carry: bool = False):
    """Trace one path per lane (px, py). Returns (rgb (n, 3), filter weight
    (n,), stats) with stats 'rays_traced' and 'nonfinite_lanes' as 0-dim
    tensors on the scene's device.

    depth_lo / depth_hi / carry_in / return_carry run bounces [depth_lo,
    depth_hi) only (render_lanes_segmented): carry_in is the (state,
    rays_traced) a previous call returned with return_carry=True, which
    returns that pair instead of the image. Not with resident='on'."""
    _check_supported(vp)
    segmented = (depth_lo is not None or depth_hi is not None or carry_in is not None
                 or return_carry)
    resident = vp.resident == "on"
    if resident and segmented:
        raise ValueError("depth segments need resident='off'")
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

    # path state (the reference's st0, volpath.py:1126-1146; prev_p and
    # prev_ns, the last scattering vertex and its shading normal, replay the
    # light pmfs of emission MIS); camera rays count as specular and start
    # in the camera's medium
    lam = wl.lam
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    st = dict(o=o, d=d, beta=torch.ones_like(lam), r_u=torch.ones_like(lam),
              r_l=torch.ones_like(lam), L=torch.zeros_like(lam), alive=ones, spec=ones,
              eta=torch.ones(n, device=dev), anyns=~ones, prev_p=o,
              prev_ns=torch.zeros_like(o), disp=~ones, lam=lam,
              px=px, py=py, si=si, lane=torch.arange(n, device=dev),
              med=torch.full((n,), scene.camera_medium, dtype=torch.int32, device=dev))
    rays_traced = torch.zeros((), device=dev)

    def bounce(depth, st_, rays):
        return _bounce_core(vp, scene, zcfg, depth, st_, rays, presorted=resident,
                            camera=camera)

    if resident:
        L, disp_term, rays_traced = _resident_bounce_loop(vp, scene, st, rays_traced,
                                                          bounce, n)
    else:
        if carry_in is not None:
            st, rays_traced = carry_in
        lo = 0 if depth_lo is None else depth_lo
        hi = vp.max_depth if depth_hi is None else depth_hi
        for depth in range(lo, hi):
            st, rays_traced = bounce(depth, st, rays_traced)
        if return_carry:
            return st, rays_traced
        L, disp_term = st["L"], st["disp"]
    profiling.count("rays_traced", rays_traced, "render_lanes")

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


@profiling.spanned("hikari.shading")
def _albedo_rgb_dispatch(scene: SceneData, mat_type, mat_idx, tex):
    """Approximate RGB albedo per lane (get_albedo_spectral's analogue) for
    the denoiser's aux buffers: textured where the field is; 0.5 for tags
    without one."""
    b = scene.materials
    idx = torch.clamp(mat_idx, min=0).long()
    out = torch.full(mat_type.shape + (3,), 0.5, device=mat_type.device)
    present = scene.present_materials

    def rgb(field, tex_field):
        return mb._tex_rgb(field, tex_field, idx, tex)

    def put(tag, value):
        nonlocal out
        out = torch.where((mat_type == tag)[..., None], value, out)

    if mt.MATTE in present:
        put(mt.MATTE, rgb(b.matte_kd, b.matte_kd_tex))
    if mt.MIRROR in present:
        put(mt.MIRROR, rgb(b.mirror_kr, b.mirror_kr_tex))
    if mt.GLASS in present:
        put(mt.GLASS, torch.ones_like(out))
    if mt.CONDUCTOR in present:
        # normal-incidence Fresnel at ~(610, 550, 465) nm
        li = torch.tensor([250, 190, 105], device=idx.device)  # offsets from 360 nm
        profiling.host_sync("albedo.conductor_lam", idx.device)
        ci = torch.clamp(idx, max=b.cond_eta.shape[0] - 1)  # other tags' rows clamp, as XLA's
        eta = _bl(b.cond_eta[:, li], ci)  # the three columns first, then per lane
        k = _bl(b.cond_k[:, li], ci)
        put(mt.CONDUCTOR, ((eta - 1.0) ** 2 + k * k) / ((eta + 1.0) ** 2 + k * k))
    if mt.COATED_DIFFUSE in present:
        put(mt.COATED_DIFFUSE, rgb(b.cd_refl, b.cd_refl_tex))
    if mt.COATED_DIFFUSE_TRANSMISSION in present:
        put(mt.COATED_DIFFUSE_TRANSMISSION,
            rgb(b.cdt_refl, b.cdt_refl_tex) + rgb(b.cdt_trans, b.cdt_trans_tex))
    if mt.DIFFUSE_TRANSMISSION in present:
        put(mt.DIFFUSE_TRANSMISSION,
            rgb(b.dt_refl, b.dt_refl_tex) + rgb(b.dt_trans, b.dt_trans_tex))
    if mt.EMISSIVE in present:
        put(mt.EMISSIVE, rgb(b.emissive_le, b.emissive_le_tex))
    return out


def pixel_centre_rays(camera: PerspectiveCamera, device):
    """(o, d), each (H * W, 3): the camera ray through the centre of every
    pixel, row by row, with the lens at its centre (render_aux's rays)."""
    w, h = camera.resolution
    n = w * h
    lanes = torch.arange(n, device=device)
    p_film = torch.stack([(lanes % w).float(), (lanes // w).float()], -1) + 0.5
    return camera.generate_rays(CameraSample(
        p_film=p_film, lens=torch.zeros((n, 2), device=device),
        time=torch.zeros(n, device=device), filter_weight=torch.ones(n, device=device)))


def render_aux(scene: SceneData, camera: PerspectiveCamera):
    """Primary-visibility pass for the denoiser (fill_aux_buffers!,
    film.jl:410-483): (albedo (H, W, 3), shading normal (H, W, 3), depth
    (H, W)) at each pixel's centre, zero where the ray escapes. As in the
    JAX package, the pass takes the plain closest hit (no alpha test) and
    reads textures at level 0."""
    w, h = camera.resolution
    o, d = pixel_centre_rays(camera, scene.device)
    rec = scene_closest_hit(scene, o, d, torch.full((w * h,), float("inf"), device=scene.device))
    sd = _surface_data(scene, rec, o, d)
    albedo = _albedo_rgb_dispatch(scene, sd["mat_type"], sd["mat_idx"], sd["tex"])
    hit = rec.hit
    albedo = torch.where(hit[..., None], albedo, 0.0)
    normal = torch.where(hit[..., None], sd["ns"], 0.0)
    depth = torch.where(hit, rec.t, 0.0)
    return albedo.reshape(h, w, 3), normal.reshape(h, w, 3), depth.reshape(h, w)


def render_lanes_segmented(vp: VolPath, scene: SceneData, camera: PerspectiveCamera,
                           filt: FilterSampler, sample_idx, px, py, n_segments: int):
    """render_lanes split into n_segments calls over the depth axis, each
    of ceil(max_depth / n_segments) bounces, handing the path state on;
    the last call finishes the image. Bit-identical to render_lanes (the
    reference's, ``volpath.py:1491``, bounds each dispatch's wall time)."""
    if vp.resident == "on":
        raise ValueError("depth segments need resident='off'")
    seg = max(1, -(-vp.max_depth // max(n_segments, 1)))
    carry = None
    d0 = 0
    while d0 + seg < vp.max_depth:
        carry = render_lanes(vp, scene, camera, filt, sample_idx, px, py, depth_lo=d0,
                             depth_hi=d0 + seg, carry_in=carry, return_carry=True)
        d0 += seg
    return render_lanes(vp, scene, camera, filt, sample_idx, px, py, depth_lo=d0,
                        depth_hi=vp.max_depth, carry_in=carry)


@profiling.spanned("hikari.render")
def render_sample(vp: VolPath, scene: SceneData, camera: PerspectiveCamera,
                  film: Film, filt: FilterSampler, sample_idx: int) -> Film:
    """Trace sample_batch consecutive samples (from sample_idx) of every
    pixel of the film's window as one wavefront and accumulate them into
    the film. Lanes carry full-image pixels, so a window's pixels draw the
    samples of the same pixels of the full render."""
    w, h = film.width, film.height
    n = w * h
    k = max(1, int(vp.sample_batch))
    lanes = torch.arange(n, device=scene.device)
    px = (film.crop_x0 + lanes % w).repeat(k)
    py = (film.crop_y0 + lanes // w).repeat(k)
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
