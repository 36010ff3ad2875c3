"""Fast preview integrators: FastWavefront and Whitted.

Port of ``hikari_tpu/integrators/preview.py``. Both trace one sample of
every pixel as a wavefront of w * h lanes, a few bounces deep, through the
building blocks of ``volpath.py``:

- Whitted shades through the spectral BSDF stack at four fixed preview
  wavelengths: NEE evaluates the material's f (the layered coats through
  their random walks), and the path follows the sampled lobe while it is
  specular. Its primary hits take true ray differentials (the +1-pixel
  camera rays, scaled by 1 / sqrt(spp)) for texture filtering.
- FastWavefront is the albedo-weighted preview: hard-shadow direct light
  on diffuse hits, and mirror / Fresnel-split glass bounces on specular
  ones (smooth conductors included), two bounces.

Spectral radiance at the preview wavelengths becomes linear sRGB through a
3x4 map fitted once by least squares (``_fit_preview_rgb_m``), as the JAX
package fits it. ``stats`` (a dict, optional) collects the rays traced and
the lanes alive at each bounce without a host sync.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..camera.camera import CameraSample, PerspectiveCamera
from ..core.ray import RayDifferentials, spawn_ray
from ..core.vecmath import dot, make_frame, reflect, refract, to_local, to_world
from ..film.film import Film, film_add_sample, make_film
from ..lights import types as lt
from ..materials import bsdf as mb
from ..materials import types as mt
from ..materials.fresnel import fresnel_dielectric
from ..sampling import sobol as sb
from ..scene.scene import SceneData
from ..utils import profiling
from .volpath import (_albedo_rgb_dispatch, _eval_bsdf_dispatch, _sample_bsdf_dispatch,
                      _surface_data, scene_any_hit, scene_closest_hit)

# fixed hero wavelengths for preview shading
PREVIEW_LAM = (470.0, 540.0, 600.0, 660.0)


@functools.cache
def _fit_preview_rgb_m() -> np.ndarray:
    """The (3, 4) map from radiance at PREVIEW_LAM to linear sRGB: each of
    a broad sample of illuminant colours (white weighted 8x, the primaries,
    96 random ones), uplifted to a spectrum, must map to the XYZ of its
    whole spectrum (least squares; the uplift is not linear in RGB), then
    XYZ -> sRGB. A naive spectral_to_xyz at four fixed wavelengths reads
    about 2x hot."""
    from ..spectral.cie import _SRGB_FROM_XYZ, sample_cie_xyz
    from ..spectral.rgb2spec import srgb_table

    table = srgb_table()
    lam_g = torch.linspace(360.0, 830.0, 471)[None, :]
    cmf_g = sample_cie_xyz(lam_g)[0].numpy()                     # (471, 3)
    lam4 = torch.tensor([list(PREVIEW_LAM)], dtype=torch.float32)
    rng = np.random.RandomState(0)
    rgbs = torch.from_numpy(np.concatenate([
        np.ones((8, 3), np.float32),
        np.eye(3, dtype=np.float32),
        rng.rand(96, 3).astype(np.float32) * 0.95 + 0.05,
    ]))
    spec_g = lt.illuminant(table, rgbs, lam_g).numpy()          # (N, 471)
    spec4 = lt.illuminant(table, rgbs, lam4).numpy()            # (N, 4)
    targets = spec_g @ cmf_g                                    # (N, 3)
    m_xyz, *_ = np.linalg.lstsq(spec4, targets, rcond=None)     # (4, 3)
    return np.asarray(np.asarray(_SRGB_FROM_XYZ, np.float32) @ m_xyz.T, np.float32)


def preview_spec_to_rgb(L4: torch.Tensor) -> torch.Tensor:
    """(..., 4) radiance at PREVIEW_LAM -> (..., 3) linear sRGB."""
    m = torch.from_numpy(_fit_preview_rgb_m()).to(L4.device)
    profiling.host_sync("preview.rgb_map", L4.device)
    return (L4[..., None, :] * m).sum(-1)


def _preview_lam(n: int, device) -> torch.Tensor:
    profiling.host_sync("preview.lam", device)
    return torch.tensor(PREVIEW_LAM, dtype=torch.float32, device=device).expand(n, 4)


def _rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[idx] with XLA's gather clamp, as the JAX package indexes banks."""
    return arr[idx.clamp(0, arr.shape[0] - 1)]


def _pick_lights(scene: SceneData, ul):
    """(type, bank index, selection pmf) of a light drawn from the alias
    table by ul."""
    lights = scene.lights
    li_flat, pmf = lt.sample_light_index(lights, ul)
    return _rows(lights.light_type, li_flat), _rows(lights.light_idx, li_flat), pmf


def _direct_light_rgb(scene: SceneData, p, ns, albedo, ul, u2, active, stats=None):
    """One-sample direct light with hard shadows, (n, 3) RGB: the light's
    spectral sample at the preview wavelengths through the preview map,
    times albedo / pi. ul selects the light; u2 samples its position."""
    n = p.shape[0]
    if scene.n_lights == 0:
        return torch.zeros((n, 3), device=p.device)
    ltype, lidx, pmf = _pick_lights(scene, ul)
    ls = lt.sample_li(scene.lights, scene.rgb2spec, ltype, lidx, p, _preview_lam(n, p.device),
                      u2, scene.scene_radius)
    cos_i = torch.clamp(dot(ns, ls.wi), min=0.0)
    o_sh = spawn_ray(p, ns, ls.wi)
    shadow = active & ls.valid
    occluded = scene_any_hit(scene, o_sh, ls.wi, ls.t_max, active=shadow)
    if stats is not None:
        stats["rays"] = stats["rays"] + shadow.sum()
    l_spec = ls.li * (cos_i / torch.clamp(ls.pdf * pmf, min=1e-9))[..., None]
    contrib = albedo / math.pi * torch.clamp(preview_spec_to_rgb(l_spec), min=0.0)
    ok = active & ls.valid & (cos_i > 0.0) & ~occluded
    return torch.where(ok[..., None], contrib, 0.0)


def _direct_light_bsdf(scene: SceneData, sd, wo, ul, u2, u2e, uce, active, stats=None):
    """Direct light through the material's f at the preview wavelengths,
    (n, 4) spectral. ul selects the light, u2 samples it; u2e / uce drive
    a layered material's evaluation walk."""
    n = wo.shape[0]
    lam4 = _preview_lam(n, wo.device)
    if scene.n_lights == 0:
        return torch.zeros_like(lam4)
    ltype, lidx, pmf = _pick_lights(scene, ul)
    ls = lt.sample_li(scene.lights, scene.rgb2spec, ltype, lidx, sd["p"], lam4, u2,
                      scene.scene_radius)
    t, b, nrm = make_frame(sd["ns"])
    wo_l = to_local(t, b, nrm, wo)
    wi_l = to_local(t, b, nrm, ls.wi)
    f, _ = _eval_bsdf_dispatch(scene, sd["mat_type"], sd["mat_idx"], wo_l, wi_l, lam4, None,
                               "none", u2e, uce, tex=sd["tex"])
    cos_i = torch.abs(wi_l[..., 2])
    o_sh = spawn_ray(sd["p"], sd["ng"], ls.wi)
    ok = active & ls.valid & (f > 0.0).any(-1)
    occluded = scene_any_hit(scene, o_sh, ls.wi, ls.t_max, active=ok)
    if stats is not None:
        stats["rays"] = stats["rays"] + ok.sum()
    contrib = f * ls.li * (cos_i / torch.clamp(ls.pdf * pmf, min=1e-9))[..., None]
    return torch.where((ok & ~occluded)[..., None], contrib, 0.0)


@dataclass(frozen=True)
class FastWavefront:
    """Interactive preview: primary hit, hard-shadow direct light, one
    mirror-reflection level."""

    samples_per_pixel: int = 1
    seed: int = 0


@dataclass(frozen=True)
class Whitted:
    """Direct light + specular recursion to max_depth, shading through the
    spectral BSDF stack at the preview wavelengths. No diffuse indirect."""

    max_depth: int = 5
    samples_per_pixel: int = 4
    seed: int = 0


def _is_specular_type(mat_type):
    return (mat_type == mt.MIRROR) | (mat_type == mt.GLASS) | (mat_type == mt.THIN_DIELECTRIC)


def _face_viewer(sd, d):
    """Two-sided shading, as VolPath: the shading and geometric normals
    turned towards the viewer."""
    flip = (dot(sd["ns"], d) > 0.0)[..., None]
    sd["ns"] = torch.where(flip, -sd["ns"], sd["ns"])
    sd["ng"] = torch.where(flip, -sd["ng"], sd["ng"])


def _camera_lanes(camera: PerspectiveCamera, zcfg, sample_idx, device):
    """(px, py, sample index, pixel sample, film position, o, d) of one
    sample of every pixel, lane = py * w + px."""
    w, h = camera.resolution
    n = w * h
    lanes = torch.arange(n, device=device)
    px, py = lanes % w, lanes // w
    if not isinstance(sample_idx, torch.Tensor) or sample_idx.device.type == "cpu":
        profiling.host_sync("preview.sample_index", device)
    si = torch.as_tensor(sample_idx, device=device).long().expand(n)
    ps = sb.compute_pixel_sample(zcfg, px, py, si)
    p_film = torch.stack([px.float(), py.float()], -1) + 0.5 + (ps.jitter - 0.5)
    o, d = camera.generate_rays(CameraSample(p_film=p_film, lens=ps.lens, time=ps.time,
                                             filter_weight=torch.ones(n, device=device)))
    return px, py, si, ps, p_film, o, d


def _count_bounce(stats, alive):
    if stats is not None:
        stats["rays"] = stats["rays"] + alive.sum()
        stats["alive"].append(alive.sum())


@profiling.spanned("hikari.lanes")
def _whitted_lanes(scene: SceneData, camera: PerspectiveCamera, sample_idx, spp: int,
                   seed: int, n_bounces: int, stats=None):
    """Whitted through the BSDF stack: (w * h, 3) linear RGB of one sample."""
    dev = scene.device
    w, h = camera.resolution
    n = w * h
    zcfg = sb.make_zsobol(w, h, max(spp, 1), seed=seed)
    px, py, si, ps, p_film, o, d = _camera_lanes(camera, zcfg, sample_idx, dev)
    # true ray differentials: the +1-pixel film samples (same lens and
    # time), contracted by 1 / sqrt(spp); only the primary hit reads them
    diff = None
    if scene.materials.has_textures:
        fw = torch.ones(n, device=dev)
        sc = 1.0 / float(max(spp, 1)) ** 0.5
        shift = torch.tensor([[1.0, 0.0], [0.0, 1.0]], device=dev)
        (rx_o, rx_d), (ry_o, ry_d) = (camera.generate_rays(CameraSample(
            p_film=p_film + shift[k:k + 1], lens=ps.lens, time=ps.time, filter_weight=fw))
            for k in range(2))
        diff = RayDifferentials(rx_o=o + (rx_o - o) * sc, rx_d=d + (rx_d - d) * sc,
                                ry_o=o + (ry_o - o) * sc, ry_d=d + (ry_d - d) * sc)

    lam4 = _preview_lam(n, dev)
    L4 = torch.zeros((n, 4), device=dev)
    beta4 = torch.ones((n, 4), device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    for depth in range(n_bounces):
        _count_bounce(stats, alive)
        rec = scene_closest_hit(scene, o, d, torch.full((n,), float("inf"), device=dev),
                                active=alive)
        hit = alive & rec.hit
        sd = _surface_data(scene, rec, o, d, diff=diff if depth == 0 else None)
        wo = -d
        _face_viewer(sd, d)

        # emissive surfaces: their emitted radiance
        is_emit = hit & (sd["mat_type"] == mt.EMISSIVE)
        le = mb.emitted_radiance(scene.materials, torch.clamp(sd["mat_idx"], min=0), lam4,
                                 dot(sd["ng"], wo), tex=sd["tex"])
        L4 = L4 + torch.where(is_emit[..., None], beta4 * le, 0.0)

        # NEE through the BSDF's f (zero for pure-specular lobes)
        shade = hit & ~is_emit & (sd["mat_type"] != mt.INTERFACE)
        u2 = torch.stack(sb.path_sample_2d(zcfg, px, py, si, depth, 0), -1)
        u2e = torch.stack(sb.path_sample_2d(zcfg, px, py, si, depth, 7), -1)
        uce = sb.path_sample_1d(zcfg, px, py, si, depth, 9)
        ul = sb.path_sample_1d(zcfg, px, py, si, depth, 10)
        L4 = L4 + beta4 * _direct_light_bsdf(scene, sd, wo, ul, u2, u2e, uce, shade, stats)

        # specular recursion: sample the BSDF, go on only along delta lobes
        t, b, nrm = make_frame(sd["ns"])
        wo_l = to_local(t, b, nrm, wo)
        ub = torch.stack(sb.path_sample_2d(zcfg, px, py, si, depth, 3), -1)
        uc = sb.path_sample_1d(zcfg, px, py, si, depth, 5)
        bs = _sample_bsdf_dispatch(scene, sd["mat_type"], sd["mat_idx"], wo_l, lam4, ub, uc,
                                   None, tex=sd["tex"])
        wi = to_world(t, b, nrm, bs.wi)
        thr = bs.f * (torch.abs(bs.wi[..., 2]) / torch.clamp(bs.pdf, min=1e-9))[..., None]
        cont = shade & bs.valid & bs.specular & (thr > 0.0).any(-1)
        o = torch.where(cont[..., None], spawn_ray(sd["p"], sd["ng"], wi), o)
        d = torch.where(cont[..., None], wi, d)
        beta4 = torch.where(cont[..., None], beta4 * thr, beta4)
        alive = cont
    # the least-squares map can give small negative components
    return torch.clamp(preview_spec_to_rgb(L4), min=0.0)


@profiling.spanned("hikari.lanes")
def _preview_lanes(scene: SceneData, camera: PerspectiveCamera, sample_idx, spp: int,
                   seed: int, n_bounces: int, stats=None):
    """FastWavefront: (w * h, 3) RGB of one sample, albedo-weighted direct
    light and Fresnel-split mirror bounces."""
    dev = scene.device
    w, h = camera.resolution
    n = w * h
    zcfg = sb.make_zsobol(w, h, max(spp, 1), seed=seed)
    px, py, si, _, _, o, d = _camera_lanes(camera, zcfg, sample_idx, dev)
    b = scene.materials
    rgb = torch.zeros((n, 3), device=dev)
    tint = torch.ones((n, 3), device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    for depth in range(n_bounces):
        _count_bounce(stats, alive)
        rec = scene_closest_hit(scene, o, d, torch.full((n,), float("inf"), device=dev),
                                active=alive)
        hit = alive & rec.hit
        sd = _surface_data(scene, rec, o, d)
        albedo = _albedo_rgb_dispatch(scene, sd["mat_type"], sd["mat_idx"], sd["tex"])
        _face_viewer(sd, d)

        # emissive surfaces: added directly
        is_emit = hit & (sd["mat_type"] == mt.EMISSIVE)
        rgb = rgb + torch.where(is_emit[..., None], tint * albedo * 5.0, 0.0)

        # smooth conductors join the specular set with Fresnel-tinted
        # mirror bounces
        idx = torch.clamp(sd["mat_idx"], min=0)
        cond_smooth = (sd["mat_type"] == mt.CONDUCTOR) & (
            torch.maximum(_rows(b.cond_ax, idx), _rows(b.cond_ay, idx)) < 0.01)
        spec = _is_specular_type(sd["mat_type"]) | cond_smooth
        diffuse_hit = hit & ~spec & ~is_emit
        u2 = torch.stack(sb.path_sample_2d(zcfg, px, py, si, depth, 0), -1)
        ul = sb.path_sample_1d(zcfg, px, py, si, depth, 10)
        rgb = rgb + tint * _direct_light_rgb(scene, sd["p"], sd["ns"], albedo, ul, u2,
                                             diffuse_hit, stats)

        # specular continuation, one-sample Fresnel branch selection
        wo = -d
        ci = torch.clamp(dot(sd["ns"], wo), min=1e-6)
        entering = dot(d, sd["ng_raw"]) < 0.0
        is_glass = sd["mat_type"] == mt.GLASS
        is_thin = sd["mat_type"] == mt.THIN_DIELECTRIC
        eta_mat = torch.where(is_thin, _rows(b.thin_eta, idx), _rows(b.glass_eta, idx))
        eta_rel = torch.where(entering | is_thin, eta_mat, 1.0 / eta_mat)
        F = fresnel_dielectric(ci, eta_rel)
        # a thin surface: the interreflection-summed reflectance 2F / (1 + F)
        F = torch.where(is_thin, 2.0 * F / (1.0 + F), F)
        ok_t, wt = refract(wo, sd["ns"], eta_rel)
        u_spec = sb.path_sample_1d(zcfg, px, py, si, depth, 2)
        choose_refl = (u_spec < F) | (~ok_t & ~is_thin)
        choose_refl = choose_refl | (sd["mat_type"] == mt.MIRROR) | cond_smooth

        wi_r = reflect(wo, sd["ns"])
        wi_t = torch.where(is_thin[..., None], d, wt)  # thin: passes straight on
        wi = torch.where(choose_refl[..., None], wi_r, wi_t)

        schlick = albedo + (1.0 - albedo) * ((1.0 - ci) ** 5)[..., None]
        tint_refl = torch.where(
            cond_smooth[..., None], schlick,
            torch.where(is_glass[..., None], _rows(b.glass_kr, idx),
                        torch.where(is_thin[..., None], _rows(b.thin_kr, idx), albedo)))
        tint_trans = torch.where(is_thin[..., None], _rows(b.thin_kt, idx),
                                 _rows(b.glass_kt, idx))
        t_mul = torch.where(choose_refl[..., None], tint_refl, tint_trans)

        cont = hit & spec
        o = torch.where(cont[..., None], spawn_ray(sd["p"], sd["ng"], wi), o)
        d = torch.where(cont[..., None], wi, d)
        tint = torch.where(cont[..., None], tint * torch.clamp(t_mul, 0.0, 1.0), tint)
        alive = cont
    return rgb


def preview_lanes(integ, scene: SceneData, camera: PerspectiveCamera, sample_idx: int,
                  stats=None) -> torch.Tensor:
    """One sample of every pixel under a preview integrator, (h, w, 3).
    While the profiler records, its rays count as ``rays_traced``."""
    if stats is None and profiling.recording():
        stats = {"rays": torch.zeros((), device=scene.device), "alive": []}
    rays0 = None if stats is None else stats["rays"]
    if isinstance(integ, FastWavefront):
        rgb = _preview_lanes(scene, camera, sample_idx, integ.samples_per_pixel, integ.seed,
                             2, stats)
    elif isinstance(integ, Whitted):
        rgb = _whitted_lanes(scene, camera, sample_idx, integ.samples_per_pixel, integ.seed,
                             integ.max_depth, stats)
    else:
        raise TypeError(f"render_preview takes Whitted or FastWavefront, not "
                        f"{type(integ).__name__}")
    if stats is not None and profiling.recording():
        profiling.count("rays_traced", stats["rays"] - rays0, "preview_lanes")
    w, h = camera.resolution
    return rgb.reshape(h, w, 3)


@profiling.spanned("hikari.render")
def render_preview(integ, scene: SceneData, camera: PerspectiveCamera) -> Film:
    """Run a preview integrator over its samples_per_pixel; the same call
    shape as volpath.render. The film lives on the scene's device."""
    w, h = camera.resolution
    film = make_film(w, h, device=scene.device)
    ones = torch.ones((h, w), device=scene.device)
    for s in range(integ.samples_per_pixel):
        film = film_add_sample(film, preview_lanes(integ, scene, camera, s), ones)
    return film
