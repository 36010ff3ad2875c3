"""Spectral BSDF sampling and evaluation per material type.

Port of ``hikari_tpu/materials/bsdf.py``: the Matte, Mirror, Glass,
Conductor, ThinDielectric and DiffuseTransmission lobes, the colourless
dielectric interface that the layered walk (``layered.py``) samples, and
the emission. Everything runs on whole wavefronts in the local shading
frame (z = shading normal); spectra are (..., 4) hero-wavelength tensors.
Constant colours evaluate their precomputed sigmoid coefficients (textures
are not ported).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core.lookup import bank_lookup as _bl
from ..core.vecmath import (
    abs_cos_theta, cos_phi, reflect, refract, same_hemisphere, sin_phi, sin_theta,
)
from ..sampling.distributions import cosine_sample_hemisphere
from ..spectral.cie import D65_PHOTOMETRIC
from ..spectral.piecewise_poly import piecewise_eval_banked
from ..spectral.rgb2spec import coeff4_eval, coeff4_illuminant_eval
from .fresnel import fresnel_conductor, fresnel_dielectric
from .microfacet import effectively_smooth, regularize_alpha, tr_d, tr_g, tr_pdf, tr_sample_wm
from .types import MaterialBanks

INV_PI = 1.0 / math.pi


@dataclass
class BSDFSample:
    """Reference SpectralBSDFSample (spectral-eval.jl:18-28)."""

    wi: torch.Tensor            # (..., 3) local
    f: torch.Tensor             # (..., 4)
    pdf: torch.Tensor           # (...,)
    specular: torch.Tensor      # (...,) bool
    transmission: torch.Tensor  # (...,) bool
    eta_scale: torch.Tensor     # (...,)
    valid: torch.Tensor         # (...,) bool


def invalid_sample(shape, device) -> BSDFSample:
    z = torch.zeros(shape, device=device)
    wi = torch.zeros(shape + (3,), device=device)
    wi[..., 2] = 1.0
    no = torch.zeros(shape, dtype=torch.bool, device=device)
    return BSDFSample(wi=wi, f=torch.zeros(shape + (4,), device=device), pdf=z,
                      specular=no, transmission=no.clone(),
                      eta_scale=torch.ones(shape, device=device), valid=no.clone())


def _spec(c4_field, idx, lam):
    return coeff4_eval(_bl(c4_field, idx), lam)


# --- Matte (Lambert / Oren-Nayar) --------------------------------------------------


def _oren_nayar_factor(sigma, wo, wi):
    sigma_r = sigma * math.pi / 180.0
    s2 = sigma_r * sigma_r
    a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b = 0.45 * s2 / (s2 + 0.09)
    sin_ti, sin_to = sin_theta(wi), sin_theta(wo)
    cos_dphi = torch.clamp(cos_phi(wi) * cos_phi(wo) + sin_phi(wi) * sin_phi(wo),
                           min=0.0)
    abs_ci = torch.clamp(abs_cos_theta(wi), min=1e-6)
    abs_co = torch.clamp(abs_cos_theta(wo), min=1e-6)
    sin_alpha = torch.where(abs_ci > abs_co, sin_to, sin_ti)
    tan_beta = torch.where(abs_ci > abs_co, sin_ti / abs_ci, sin_to / abs_co)
    return a + b * cos_dphi * sin_alpha * tan_beta


def _matte_f(banks, idx, wo, wi, lam):
    f = _spec(banks.matte_kd_c4, idx, lam) * INV_PI
    sigma = _bl(banks.matte_sigma, idx)
    return f * torch.where(sigma > 0.0, _oren_nayar_factor(sigma, wo, wi), 1.0)[..., None]


def sample_matte(banks: MaterialBanks, idx, wo, lam, u2, uc) -> BSDFSample:
    wi = cosine_sample_hemisphere(u2)
    flip = torch.tensor([1.0, 1.0, -1.0], device=wi.device)
    wi = torch.where(wo[..., 2:3] < 0.0, wi * flip, wi)
    pdf = abs_cos_theta(wi) * INV_PI
    f = _matte_f(banks, idx, wo, wi, lam)
    no = torch.zeros_like(pdf, dtype=torch.bool)
    return BSDFSample(wi=wi, f=f, pdf=pdf, specular=no, transmission=no,
                      eta_scale=torch.ones_like(pdf),
                      valid=(pdf > 0.0) & (torch.abs(wo[..., 2]) > 1e-6))


def eval_matte(banks, idx, wo, wi, lam):
    same = same_hemisphere(wo, wi)
    f = torch.where(same[..., None], _matte_f(banks, idx, wo, wi, lam), 0.0)
    pdf = torch.where(same, abs_cos_theta(wi) * INV_PI, 0.0)
    return f, pdf


# --- Mirror ---------------------------------------------------------------------------


def _mirror_dir(wo):
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)


def sample_mirror(banks, idx, wo, lam, u2, uc) -> BSDFSample:
    wi = _mirror_dir(wo)
    cos_i = torch.clamp(abs_cos_theta(wi), min=1e-6)
    f = _spec(banks.mirror_kr_c4, idx, lam) / cos_i[..., None]
    yes = torch.ones_like(cos_i, dtype=torch.bool)
    return BSDFSample(wi=wi, f=f, pdf=torch.ones_like(cos_i), specular=yes,
                      transmission=~yes, eta_scale=torch.ones_like(cos_i),
                      valid=torch.abs(wo[..., 2]) > 1e-6)


# --- Glass: smooth + rough dielectric ---------------------------------------------------


def _glass_alpha(banks, idx, regularize):
    ax, ay = _bl(banks.glass_ax, idx), _bl(banks.glass_ay, idx)
    if regularize is not None:
        ax = torch.where(regularize, regularize_alpha(ax), ax)
        ay = torch.where(regularize, regularize_alpha(ay), ay)
    return ax, ay


def glass_eta_hero(banks, idx, lam):
    """Dispersive IOR at the hero wavelength: Sellmeier when B1 > 0, else
    Cauchy eta + B / lambda_um^2 (spectral-eval.jl:207-221)."""
    L = torch.clamp((lam[..., 0] * 1e-3) ** 2, min=1e-6)
    cauchy = _bl(banks.glass_eta, idx) + _bl(banks.glass_cauchy, idx) / L
    sell = _bl(banks.glass_sell, idx)
    b, c = sell[..., 0:3], sell[..., 3:6]
    Le = L[..., None]
    n2 = 1.0 + (b * Le / torch.where(torch.abs(Le - c) < 1e-9, 1e-9, Le - c)).sum(-1)
    eta_sell = torch.sqrt(torch.clamp(n2, min=1.0))
    return torch.where(sell[..., 0] > 0.0, eta_sell, cauchy)


def sample_glass(banks, idx, wo, lam, u2, uc, regularize=None) -> BSDFSample:
    kr = _spec(banks.glass_kr_c4, idx, lam)
    kt = _spec(banks.glass_kt_c4, idx, lam)
    eta = glass_eta_hero(banks, idx, lam)
    ax, ay = _glass_alpha(banks, idx, regularize)
    smooth = effectively_smooth(ax, ay)
    cos_o = wo[..., 2]
    eta_p = torch.where(cos_o > 0.0, eta, 1.0 / eta)

    # smooth branch (delta lobes)
    fr_s = fresnel_dielectric(cos_o, eta)
    wi_rs = _mirror_dir(wo)
    n = torch.zeros_like(wo)
    n[..., 2] = 1.0
    n = torch.where(cos_o[..., None] < 0.0, -n, n)
    ok_ts, wi_ts = refract(wo, n, eta_p)

    # rough branch: a visible microfacet normal
    wm = tr_sample_wm(wo, u2, ax, ay)
    dot_om = (wo * wm).sum(-1)
    fr_m = fresnel_dielectric(dot_om, eta)
    wi_rm = reflect(wo, wm)
    ok_rm = same_hemisphere(wo, wi_rm)
    wm_o = torch.where(dot_om[..., None] < 0.0, -wm, wm)
    ok_tm, wi_tm = refract(wo, wm_o, eta_p)
    ok_tm = ok_tm & ~same_hemisphere(wo, wi_tm)

    fr = torch.where(smooth, fr_s, fr_m)
    choose_r = uc < fr
    cr = choose_r[..., None]
    wi = torch.where(smooth[..., None], torch.where(cr, wi_rs, wi_ts),
                     torch.where(cr, wi_rm, wi_tm))
    cos_i = torch.clamp(abs_cos_theta(wi), min=1e-6)
    cos_oa = torch.clamp(torch.abs(cos_o), min=1e-6)

    f_rs = kr * (fr_s / cos_i)[..., None]
    f_ts = kt * ((1.0 - fr_s) / cos_i / (eta_p * eta_p))[..., None]
    pdf_s = torch.where(choose_r, fr_s, 1.0 - fr_s)

    d = tr_d(wm, ax, ay)
    g = tr_g(wo, wi, ax, ay)
    abs_dot_om = torch.clamp(torch.abs(dot_om), min=1e-8)
    f_rm = kr * (d * g * fr_m / (4.0 * cos_oa * cos_i))[..., None]
    pdf_rm = tr_pdf(wo, wm, ax, ay) / (4.0 * abs_dot_om) * fr_m
    dot_im = (wi * wm).sum(-1)
    denom_t = (dot_im + dot_om / eta_p) ** 2
    dwm_dwi = torch.abs(dot_im) / torch.clamp(denom_t, min=1e-12)
    ft_scale = (d * g * (1.0 - fr_m)
                * torch.abs(dot_im * dot_om / torch.clamp(cos_i * cos_oa * denom_t, min=1e-12))
                / (eta_p * eta_p))
    f_tm = kt * ft_scale[..., None]
    pdf_tm = tr_pdf(wo, wm, ax, ay) * dwm_dwi * (1.0 - fr_m)

    f = torch.where(smooth[..., None], torch.where(cr, f_rs, f_ts),
                    torch.where(cr, f_rm, f_tm))
    pdf = torch.where(smooth, pdf_s, torch.where(choose_r, pdf_rm, pdf_tm))
    ok_branch = torch.where(smooth, choose_r | ok_ts,
                            torch.where(choose_r, ok_rm, ok_tm))
    valid = (torch.abs(cos_o) > 1e-6) & ok_branch & (pdf > 1e-12)
    return BSDFSample(wi=wi, f=f, pdf=pdf, specular=smooth,
                      transmission=~choose_r,
                      eta_scale=torch.where(choose_r, 1.0, eta_p * eta_p),
                      valid=valid)


def eval_glass(banks, idx, wo, wi, lam, regularize=None):
    """(f, pdf) of the rough dielectric lobe; zero where effectively smooth."""
    kr = _spec(banks.glass_kr_c4, idx, lam)
    kt = _spec(banks.glass_kt_c4, idx, lam)
    eta = glass_eta_hero(banks, idx, lam)
    ax, ay = _glass_alpha(banks, idx, regularize)
    smooth = effectively_smooth(ax, ay)
    cos_o, cos_i = wo[..., 2], wi[..., 2]
    is_reflect = cos_o * cos_i > 0.0
    eta_p = torch.where(is_reflect, 1.0, torch.where(cos_o > 0.0, eta, 1.0 / eta))
    wm_raw = wi * eta_p[..., None] + wo
    wm_len = torch.linalg.norm(wm_raw, dim=-1, keepdim=True)
    wm = wm_raw / torch.clamp(wm_len, min=1e-12)
    wm = torch.where(wm[..., 2:3] < 0.0, -wm, wm)
    dot_om = (wo * wm).sum(-1)
    dot_im = (wi * wm).sum(-1)
    backface = (dot_im * cos_i < 0.0) | (dot_om * cos_o < 0.0)
    fr = fresnel_dielectric(dot_om, eta)
    d = tr_d(wm, ax, ay)
    g = tr_g(wo, wi, ax, ay)
    cos_oa = torch.clamp(torch.abs(cos_o), min=1e-6)
    cos_ia = torch.clamp(torch.abs(cos_i), min=1e-6)
    abs_dot_om = torch.clamp(torch.abs(dot_om), min=1e-8)
    f_r = kr * (d * g * fr / (4.0 * cos_oa * cos_ia))[..., None]
    pdf_r = tr_pdf(wo, wm, ax, ay) / (4.0 * abs_dot_om) * fr
    denom_t = (dot_im + dot_om / eta_p) ** 2
    dwm_dwi = torch.abs(dot_im) / torch.clamp(denom_t, min=1e-12)
    ft_scale = (d * g * (1.0 - fr)
                * torch.abs(dot_im * dot_om / torch.clamp(cos_ia * cos_oa * denom_t, min=1e-12))
                / (eta_p * eta_p))
    f_t = kt * ft_scale[..., None]
    pdf_t = tr_pdf(wo, wm, ax, ay) * dwm_dwi * (1.0 - fr)
    f = torch.where(is_reflect[..., None], f_r, f_t)
    pdf = torch.where(is_reflect, pdf_r, pdf_t)
    ok = (~smooth & ~backface & (wm_len[..., 0] > 1e-9)
          & (torch.abs(cos_o) > 1e-6) & (torch.abs(cos_i) > 1e-6))
    return torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)


# --- Conductor ---------------------------------------------------------------------------


def _conductor_alpha(banks, idx, regularize):
    ax, ay = _bl(banks.cond_ax, idx), _bl(banks.cond_ay, idx)
    if regularize is not None:
        ax = torch.where(regularize, regularize_alpha(ax), ax)
        ay = torch.where(regularize, regularize_alpha(ay), ay)
    return ax, ay


def _cond_eta_k(banks, idx, lam):
    eta = piecewise_eval_banked(banks.cond_eta_pw, idx[..., None], lam)
    k = piecewise_eval_banked(banks.cond_k_pw, idx[..., None], lam)
    return eta, k


def sample_conductor(banks, idx, wo, lam, u2, uc, regularize=None) -> BSDFSample:
    eta, k = _cond_eta_k(banks, idx, lam)
    ax, ay = _conductor_alpha(banks, idx, regularize)
    smooth = effectively_smooth(ax, ay)
    wi_s = _mirror_dir(wo)
    cos_s = torch.clamp(abs_cos_theta(wi_s), min=1e-6)
    f_s = fresnel_conductor(cos_s, eta, k) / cos_s[..., None]
    wm = tr_sample_wm(wo, u2, ax, ay)
    wi_m = reflect(wo, wm)
    same = same_hemisphere(wo, wi_m)
    cos_o = torch.clamp(abs_cos_theta(wo), min=1e-6)
    cos_i = torch.clamp(abs_cos_theta(wi_m), min=1e-6)
    dot_om = torch.abs((wo * wm).sum(-1))
    fr = fresnel_conductor(dot_om, eta, k)
    f_m = fr * (tr_d(wm, ax, ay) * tr_g(wo, wi_m, ax, ay) / (4.0 * cos_o * cos_i))[..., None]
    pdf_m = tr_pdf(wo, wm, ax, ay) / (4.0 * torch.clamp(dot_om, min=1e-8))
    wi = torch.where(smooth[..., None], wi_s, wi_m)
    f = torch.where(smooth[..., None], f_s, f_m)
    pdf = torch.where(smooth, 1.0, pdf_m)
    valid = (torch.abs(wo[..., 2]) > 1e-6) & (smooth | (same & (pdf_m > 0.0)))
    return BSDFSample(wi=wi, f=f, pdf=pdf, specular=smooth,
                      transmission=torch.zeros_like(smooth),
                      eta_scale=torch.ones_like(pdf), valid=valid)


def eval_conductor(banks, idx, wo, wi, lam, regularize=None):
    eta, k = _cond_eta_k(banks, idx, lam)
    ax, ay = _conductor_alpha(banks, idx, regularize)
    smooth = effectively_smooth(ax, ay)
    same = same_hemisphere(wo, wi)
    wm = wo + wi
    wm_len = torch.linalg.norm(wm, dim=-1, keepdim=True)
    wm = torch.where(wm_len > 1e-9, wm / torch.clamp(wm_len, min=1e-9), 0.0)
    wm = torch.where(wm[..., 2:3] < 0.0, -wm, wm)
    cos_o = torch.clamp(abs_cos_theta(wo), min=1e-6)
    cos_i = torch.clamp(abs_cos_theta(wi), min=1e-6)
    dot_om = torch.abs((wo * wm).sum(-1))
    fr = fresnel_conductor(dot_om, eta, k)
    f = fr * (tr_d(wm, ax, ay) * tr_g(wo, wi, ax, ay) / (4.0 * cos_o * cos_i))[..., None]
    pdf = tr_pdf(wo, wm, ax, ay) / (4.0 * torch.clamp(dot_om, min=1e-8))
    ok = same & ~smooth & (wm_len[..., 0] > 1e-9)
    return torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)


# --- bare dielectric interface (the layered walk's coat) -----------------------------


def dielectric_interface_sample(wo, eta, ax, ay, u2, uc) -> dict:
    """Sample the colourless dielectric interface, smooth or rough. Returns
    dict(wi, weight (f cos / pdf), pdf, is_trans, specular, valid); rough
    transmission keeps eta'^2 in its weight, since the walk crosses the
    interface again on its way out."""
    smooth = effectively_smooth(ax, ay)
    cos_o = wo[..., 2]
    eta_p = torch.where(cos_o > 0.0, eta, 1.0 / eta)

    fr_s = fresnel_dielectric(cos_o, eta)
    wi_rs = _mirror_dir(wo)
    n = torch.zeros_like(wo)
    n[..., 2] = 1.0
    n = torch.where(cos_o[..., None] < 0.0, -n, n)
    ok_ts, wi_ts = refract(wo, n, eta_p)

    wm = tr_sample_wm(wo, u2, ax, ay)
    dot_om = (wo * wm).sum(-1)
    fr_m = fresnel_dielectric(dot_om, eta)
    wi_rm = reflect(wo, wm)
    ok_rm = same_hemisphere(wo, wi_rm)
    wm_o = torch.where(dot_om[..., None] < 0.0, -wm, wm)
    ok_tm, wi_tm = refract(wo, wm_o, eta_p)
    ok_tm = ok_tm & ~same_hemisphere(wo, wi_tm)

    fr = torch.where(smooth, fr_s, fr_m)
    choose_r = uc < fr
    cr = choose_r[..., None]
    wi = torch.where(smooth[..., None], torch.where(cr, wi_rs, wi_ts),
                     torch.where(cr, wi_rm, wi_tm))
    cos_i = torch.clamp(abs_cos_theta(wi), min=1e-6)
    cos_oa = torch.clamp(torch.abs(cos_o), min=1e-6)

    d = tr_d(wm, ax, ay)
    g = tr_g(wo, wi, ax, ay)
    abs_dot_om = torch.clamp(torch.abs(dot_om), min=1e-8)
    pdf_rm = tr_pdf(wo, wm, ax, ay) / (4.0 * abs_dot_om) * fr_m
    w_rm = torch.where(
        pdf_rm > 1e-12,
        (d * g * fr_m / (4.0 * cos_oa * cos_i)) * cos_i / torch.clamp(pdf_rm, min=1e-12),
        0.0)
    dot_im = (wi * wm).sum(-1)
    denom_t = (dot_im + dot_om / eta_p) ** 2
    dwm_dwi = torch.abs(dot_im) / torch.clamp(denom_t, min=1e-12)
    pdf_tm = tr_pdf(wo, wm, ax, ay) * dwm_dwi * (1.0 - fr_m)
    ft = (d * g * (1.0 - fr_m)
          * torch.abs(dot_im * dot_om / torch.clamp(cos_i * cos_oa * denom_t, min=1e-12))
          / (eta_p * eta_p))
    w_tm = torch.where(pdf_tm > 1e-12, ft * cos_i / torch.clamp(pdf_tm, min=1e-12), 0.0)

    weight = torch.where(smooth, 1.0, torch.where(choose_r, w_rm, w_tm))
    weight = torch.where(~smooth & ~choose_r, weight * eta_p * eta_p, weight)
    pdf = torch.where(smooth, torch.where(choose_r, fr_s, 1.0 - fr_s),
                      torch.where(choose_r, pdf_rm, pdf_tm))
    ok = torch.where(smooth, choose_r | ok_ts, torch.where(choose_r, ok_rm, ok_tm))
    return dict(wi=wi, weight=weight, pdf=pdf, is_trans=~choose_r, specular=smooth,
                valid=ok & (torch.abs(cos_o) > 1e-6))


def dielectric_interface_f(wo, wi, eta, ax, ay):
    """(f, pdf) of the rough interface; zero where effectively smooth."""
    smooth = effectively_smooth(ax, ay)
    cos_o, cos_i = wo[..., 2], wi[..., 2]
    is_reflect = cos_o * cos_i > 0.0
    eta_p = torch.where(is_reflect, 1.0, torch.where(cos_o > 0.0, eta, 1.0 / eta))
    wm_raw = wi * eta_p[..., None] + wo
    wm_len = torch.linalg.norm(wm_raw, dim=-1, keepdim=True)
    wm = wm_raw / torch.clamp(wm_len, min=1e-12)
    wm = torch.where(wm[..., 2:3] < 0.0, -wm, wm)
    dot_om = (wo * wm).sum(-1)
    dot_im = (wi * wm).sum(-1)
    backface = (dot_im * cos_i < 0.0) | (dot_om * cos_o < 0.0)
    fr = fresnel_dielectric(dot_om, eta)
    d = tr_d(wm, ax, ay)
    g = tr_g(wo, wi, ax, ay)
    cos_oa = torch.clamp(torch.abs(cos_o), min=1e-6)
    cos_ia = torch.clamp(torch.abs(cos_i), min=1e-6)
    f_r = d * g * fr / (4.0 * cos_oa * cos_ia)
    pdf_r = tr_pdf(wo, wm, ax, ay) / (4.0 * torch.clamp(torch.abs(dot_om), min=1e-8)) * fr
    denom_t = (dot_im + dot_om / eta_p) ** 2
    f_t = (d * g * (1.0 - fr)
           * torch.abs(dot_im * dot_om / torch.clamp(cos_ia * cos_oa * denom_t, min=1e-12)))
    pdf_t = (tr_pdf(wo, wm, ax, ay)
             * torch.abs(dot_im) / torch.clamp(denom_t, min=1e-12) * (1.0 - fr))
    f = torch.where(is_reflect, f_r, f_t)
    pdf = torch.where(is_reflect, pdf_r, pdf_t)
    ok = ~smooth & ~backface & (wm_len[..., 0] > 1e-9)
    return torch.where(ok, f, 0.0), torch.where(ok, pdf, 0.0)


# --- ThinDielectric (thin-dielectric.jl:45) ----------------------------------------------


def sample_thin_dielectric(banks, idx, wo, lam, u2, uc) -> BSDFSample:
    """Reflect with R' = 2R / (1 + R), else pass straight through: both
    faces of the slab are crossed, so the ray stays in its medium."""
    kr = _spec(banks.thin_kr_c4, idx, lam)
    kt = _spec(banks.thin_kt_c4, idx, lam)
    eta = _bl(banks.thin_eta, idx)
    cos_o = wo[..., 2]
    r0 = fresnel_dielectric(torch.abs(cos_o), eta)
    r = torch.where(r0 < 1.0, 2.0 * r0 / (1.0 + r0), 1.0)
    t = 1.0 - r
    choose_r = uc < r
    wi = torch.where(choose_r[..., None], _mirror_dir(wo), -wo)
    cos_i = torch.clamp(abs_cos_theta(wi), min=1e-6)
    f = torch.where(choose_r[..., None], kr * (r / cos_i)[..., None],
                    kt * (t / cos_i)[..., None])
    pdf = torch.where(choose_r, r, t)
    yes = torch.ones_like(choose_r)
    return BSDFSample(wi=wi, f=f, pdf=pdf, specular=yes, transmission=~yes,
                      eta_scale=torch.ones_like(pdf),
                      valid=(torch.abs(cos_o) > 1e-6) & (pdf > 1e-9))


# --- DiffuseTransmission (diffuse-transmission.jl:39) -------------------------------------


def _dt_albedos(banks, idx, lam):
    """(reflectance, transmittance, probability of the reflection lobe)."""
    r = _spec(banks.dt_refl_c4, idx, lam)
    t = _spec(banks.dt_trans_c4, idx, lam)
    pr = torch.clamp(r.amax(-1), min=1e-9)
    pt = torch.clamp(t.amax(-1), min=0.0)
    return r, t, pr / (pr + pt)


def sample_diffuse_transmission(banks, idx, wo, lam, u2, uc) -> BSDFSample:
    r, t, p_refl = _dt_albedos(banks, idx, lam)
    choose_r = uc < p_refl
    wi = cosine_sample_hemisphere(u2)
    # reflection stays on wo's side; transmission flips
    side = torch.where(choose_r, torch.sign(wo[..., 2]), -torch.sign(wo[..., 2]))
    wi = wi * torch.stack([torch.ones_like(side), torch.ones_like(side), side], -1)
    f = torch.where(choose_r[..., None], r, t) * INV_PI
    pdf = abs_cos_theta(wi) * INV_PI * torch.where(choose_r, p_refl, 1.0 - p_refl)
    return BSDFSample(wi=wi, f=f, pdf=pdf, specular=torch.zeros_like(choose_r),
                      transmission=~choose_r, eta_scale=torch.ones_like(pdf),
                      valid=(pdf > 1e-9) & (torch.abs(wo[..., 2]) > 1e-6))


def eval_diffuse_transmission(banks, idx, wo, wi, lam):
    r, t, p_refl = _dt_albedos(banks, idx, lam)
    same = same_hemisphere(wo, wi)
    f = torch.where(same[..., None], r, t) * INV_PI
    pdf = abs_cos_theta(wi) * INV_PI * torch.where(same, p_refl, 1.0 - p_refl)
    return f, pdf


# --- emission ------------------------------------------------------------------------------


def emitted_radiance(banks, idx, lam, cos_wo):
    """Le(lambda) of emissive faces; zero on the back unless two-sided."""
    le = coeff4_illuminant_eval(_bl(banks.emissive_le_c4, idx), lam)
    le = le * (_bl(banks.emissive_scale, idx) / D65_PHOTOMETRIC)[..., None]
    front = (cos_wo > 0.0) | _bl(banks.emissive_two_sided, idx)
    return torch.where(front[..., None], le, 0.0)
