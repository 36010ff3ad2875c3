"""Layered materials: the stochastic random walk of CoatedDiffuse,
CoatedConductor and CoatedDiffuseTransmission.

Port of ``hikari_tpu/materials/layered.py`` (pbrt-v4's LayeredBxDF, as the
reference's spectral-eval.jl:827-3448 implements it): a dielectric
interface above an opaque bottom (diffuse or conductor) or a transmitting
one (diffuse transmission), with an optional absorbing / scattering slab
of optical ``thickness``, HG asymmetry ``g`` and single-scattering
``albedo`` between them. Sampling simulates the transport between the two
layers by a bounded per-lane walk; evaluation runs the same walk and
connects to the query direction at every bottom vertex.

The walk is a Python loop of exactly MAX_WALK steps over per-lane masks,
as the JAX package's ``lax.fori_loop``: every lane advances its RNG at
every step whether it is alive or not, and nothing inside syncs with the
host, so a lane draws the same numbers in both packages. The RNG is a
per-lane PCG32 seeded from the sampler's u2 / uc; its 32-bit words live in
int64 tensors masked to [0, 2^32).

Samples are premultiplied, like pbrt's: BSDFSample.f = weight * pdf / cos,
so the integrator's f cos / pdf gives back the walk's weight, and pdf (an
approximate stochastic estimate) serves MIS only.
"""

from __future__ import annotations

import math

import torch

from ..core.lookup import bank_lookup as _bl
from ..core.vecmath import abs_cos_theta, coordinate_system, normalize, reflect, same_hemisphere
from ..sampling.distributions import cosine_sample_hemisphere
from ..sampling.hashes import MASK32, f32_bits
from ..spectral.piecewise_poly import piecewise_eval_banked
from ..spectral.rgb2spec import coeff4_eval
from .bsdf import (INV_PI, BSDFSample, _albedo_spec, dielectric_interface_f,
                   dielectric_interface_sample)
from .fresnel import fresnel_conductor
from .microfacet import effectively_smooth, tr_d, tr_g, tr_pdf, tr_sample_wm

MAX_WALK = 10  # pbrt LayeredBxDF maxDepth default
_U_MAX = 1.0 - 2.0 ** -24


# --- per-lane PCG32 ----------------------------------------------------------------


def _rng_init(u2, uc):
    a = f32_bits(u2[..., 0] + 1.0)
    b = f32_bits(u2[..., 1] + 2.0)
    c = f32_bits(uc + 3.0)
    s = ((a * 0x9E3779B9) & MASK32) ^ ((b * 0x85EBCA6B) & MASK32) ^ c
    return s | 1


def _rng_next(s):
    """(next state, uniform float32 in [0, 1 - 2^-24])."""
    s = (s * 747796405 + 2891336453) & MASK32
    word = (((s >> ((s >> 28) + 4)) ^ s) * 277803737) & MASK32
    word = (word >> 22) ^ word
    u = word.to(torch.float32) * 2.0 ** -32
    return s, torch.clamp(u, max=_U_MAX)


def _rng_next2(s):
    s, a = _rng_next(s)
    s, b = _rng_next(s)
    return s, torch.stack([a, b], -1)


# --- HG phase in the slab ----------------------------------------------------------


def _hg_sample_dir(g, w, u2):
    """A new propagation direction around w."""
    g = torch.clamp(g, -0.99, 0.99)
    iso = torch.abs(g) < 1e-3
    gs = torch.where(iso, 0.5, g)
    g2 = gs * gs
    sqr = (1.0 - g2) / (1.0 - gs + 2.0 * gs * u2[..., 0])
    cos_t = torch.where(iso, 1.0 - 2.0 * u2[..., 0],
                        torch.clamp((1.0 + g2 - sqr * sqr) / (2.0 * gs), -1.0, 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u2[..., 1]
    t1, t2 = coordinate_system(w)
    return normalize((sin_t * torch.cos(phi))[..., None] * t1
                     + (sin_t * torch.sin(phi))[..., None] * t2 + cos_t[..., None] * w)


# --- bottom layers -------------------------------------------------------------------


def _lanes_true(w):
    return torch.ones(w.shape[:-1], dtype=torch.bool, device=w.device)


def _bottom_diffuse_pdf(w_down, wi):
    return torch.clamp(wi[..., 2], min=0.0) * INV_PI


def _bottom_conductor_sample(eta4, k4, ax, ay, w_down, u2):
    """Microfacet conductor bottom: (w_up, weight4, valid)."""
    wo = -w_down  # away from the bottom, z > 0
    smooth = effectively_smooth(ax, ay)
    wi_s = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
    f_s = fresnel_conductor(torch.abs(wo[..., 2]), eta4, k4)
    wm = tr_sample_wm(wo, u2, ax, ay)
    wi_m = reflect(wo, wm)
    ok_m = same_hemisphere(wo, wi_m)
    cos_o = torch.clamp(abs_cos_theta(wo), min=1e-6)
    cos_i = torch.clamp(abs_cos_theta(wi_m), min=1e-6)
    dot_om = torch.abs((wo * wm).sum(-1))
    fr = fresnel_conductor(dot_om, eta4, k4)
    d = tr_d(wm, ax, ay)
    g_ = tr_g(wo, wi_m, ax, ay)
    pdf_m = tr_pdf(wo, wm, ax, ay) / (4.0 * torch.clamp(dot_om, min=1e-8))
    w_m = fr * (d * g_ / (4.0 * cos_o * cos_i) * cos_i / torch.clamp(pdf_m, min=1e-12))[..., None]
    wi = torch.where(smooth[..., None], wi_s, wi_m)
    weight = torch.where(smooth[..., None], f_s, w_m)
    valid = torch.where(smooth, wo[..., 2] > 1e-6, ok_m & (pdf_m > 1e-12))
    return wi, torch.where(valid[..., None], weight, 0.0), valid


def _conductor_half(w_down, wi):
    """(wo, half vector flipped up, its unnormalised length) of a bottom
    query."""
    wo = -w_down
    wm_raw = wo + wi
    ln = torch.linalg.norm(wm_raw, dim=-1, keepdim=True)
    wm = wm_raw / torch.clamp(ln, min=1e-9)
    return wo, torch.where(wm[..., 2:3] < 0.0, -wm, wm), ln[..., 0]


def _bottom_conductor_pdf(ax, ay, w_down, wi):
    """pdf of the microfacet conductor bottom (zero when smooth: a delta)."""
    wo, wm, ln = _conductor_half(w_down, wi)
    pdf = tr_pdf(wo, wm, ax, ay) / (4.0 * torch.clamp(torch.abs((wo * wm).sum(-1)), min=1e-8))
    ok = ~effectively_smooth(ax, ay) & (ln > 1e-9) & (wo[..., 2] > 0) & (wi[..., 2] > 0)
    return torch.where(ok, pdf, 0.0)


def _bottom_conductor_f(eta4, k4, ax, ay, w_down, wi_up):
    """f of the conductor bottom for the NEE connections (zero when smooth)."""
    wo, wm, ln = _conductor_half(w_down, wi_up)
    cos_o = torch.clamp(abs_cos_theta(wo), min=1e-6)
    cos_i = torch.clamp(abs_cos_theta(wi_up), min=1e-6)
    fr = fresnel_conductor(torch.abs((wo * wm).sum(-1)), eta4, k4)
    f = fr * (tr_d(wm, ax, ay) * tr_g(wo, wi_up, ax, ay) / (4.0 * cos_o * cos_i))[..., None]
    ok = ~effectively_smooth(ax, ay) & (ln > 1e-9) & (wo[..., 2] > 0) & (wi_up[..., 2] > 0)
    return torch.where(ok[..., None], f, 0.0)


def _dt_p_refl(refl4, trans4):
    pr = torch.clamp(refl4.amax(-1), min=1e-9)
    pt = torch.clamp(trans4.amax(-1), min=0.0)
    return pr / (pr + pt)


def _bottom_dt_sample(refl4, trans4, w_down, u2, uc):
    """Diffuse-transmission bottom: reflect up with probability p_refl,
    else transmit down through the bottom (the walk then leaves the
    material); weight = f cos / pdf of the chosen lobe."""
    p_refl = _dt_p_refl(refl4, trans4)
    choose_r = uc < p_refl
    wi = cosine_sample_hemisphere(u2)
    sgn_z = torch.where(choose_r, 1.0, -1.0)
    wi = wi * torch.stack([torch.ones_like(sgn_z), torch.ones_like(sgn_z), sgn_z], -1)
    weight = torch.where(choose_r[..., None], refl4 / p_refl[..., None],
                         trans4 / torch.clamp(1.0 - p_refl, min=1e-9)[..., None])
    return wi, weight, _lanes_true(w_down)


def _bottom_dt_f(refl4, trans4, w_down, wi):
    """wi up: the Lambertian reflection lobe; down: the transmission lobe."""
    return torch.where((wi[..., 2] > 0.0)[..., None], refl4, trans4) * INV_PI


def _bottom_dt_pdf(refl4, trans4, w_down, wi):
    p_refl = _dt_p_refl(refl4, trans4)
    cos_pdf = torch.abs(wi[..., 2]) * INV_PI
    return torch.where(wi[..., 2] > 0.0, p_refl * cos_pdf, (1.0 - p_refl) * cos_pdf)


# --- the layered walk ----------------------------------------------------------------


def _slab_transit(rng, w, thick, albedo4, g, beta):
    """Cross the slab to the other interface or scatter inside it (sigma_t
    = 1 in optical units, a crossing covers tau = thick / |w_z|); without a
    scattering medium the slab only absorbs. Returns (rng, w, beta,
    crossed)."""
    has_med = (albedo4 > 0.0).any(-1)
    tau = thick / torch.clamp(torch.abs(w[..., 2]), min=1e-6)
    rng, u = _rng_next(rng)
    t_free = -torch.log1p(-u)
    scatter = has_med & (t_free < tau)
    rng, u2 = _rng_next2(rng)
    w_new = _hg_sample_dir(g, w, u2)
    w = torch.where(scatter[..., None], w_new, w)
    beta = torch.where(scatter[..., None], beta * albedo4, beta)
    beta = torch.where((~has_med)[..., None], beta * torch.exp(-tau)[..., None], beta)
    return rng, w, beta, ~scatter


def _z_sign(wo):
    """(+-1 per lane, the (..., 3) multiplier flipping wo into z > 0)."""
    sgn = torch.where(wo[..., 2] < 0.0, -1.0, 1.0)
    return sgn, torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], -1)


def layered_sample(wo, lam, u2, uc, top_eta, top_ax, top_ay, thick, albedo4, g,
                   bottom_sample, bottom_pdf, bottom_smooth=None,
                   bottom_exits: bool = False) -> BSDFSample:
    """Stochastic LayeredBxDF sample (pbrt Sample_f). bottom_sample(w_down,
    u2, uc) -> (w_new, weight4, valid); bottom_pdf(w_down, wi) -> pdf;
    bottom_smooth: per-lane delta bottoms; bottom_exits: the bottom
    transmits, and a bottom sample that continues down leaves the material
    as a transmission."""
    n = wo.shape[0]
    dev = wo.device
    _, mul = _z_sign(wo)
    wo_l = wo * mul

    s_top = dielectric_interface_sample(wo_l, top_eta, top_ax, top_ay, u2, uc)
    refl_exit = s_top["valid"] & ~s_top["is_trans"]
    rng = _rng_init(u2, uc)
    w = s_top["wi"]  # pointing down
    beta = torch.ones_like(lam) * s_top["weight"][..., None]
    alive = s_top["valid"] & s_top["is_trans"]
    exited = torch.zeros(n, dtype=torch.bool, device=dev)
    trans_out = exited
    wi_out = torch.zeros_like(wo)
    wi_out[..., 2] = 1.0
    w_out = torch.zeros_like(lam)

    for _ in range(MAX_WALK):
        rng, w, beta, crossed = _slab_transit(rng, w, thick, albedo4, g, beta)
        at_iface = alive & crossed
        going_down = w[..., 2] < 0.0

        # bottom event
        rng, ub2 = _rng_next2(rng)
        rng, ubc = _rng_next(rng)
        w_b, bw, b_ok = bottom_sample(w, ub2, ubc)
        hit_bottom = at_iface & going_down
        beta = torch.where(hit_bottom[..., None], beta * bw, beta)
        w = torch.where(hit_bottom[..., None], w_b, w)
        dead_b = hit_bottom & ~b_ok
        escape_b = (hit_bottom & b_ok & (w_b[..., 2] < 0.0) if bottom_exits
                    else torch.zeros_like(hit_bottom))

        # top event from inside: the query direction points away from the
        # interface, against the propagation (pbrt interface.Sample_f(-w))
        rng, ut2 = _rng_next2(rng)
        rng, utc = _rng_next(rng)
        s = dielectric_interface_sample(-w, top_eta, top_ax, top_ay, ut2, utc)
        hit_top = at_iface & ~going_down & ~hit_bottom
        escape = hit_top & s["valid"] & s["is_trans"]
        bounce = hit_top & s["valid"] & ~s["is_trans"]
        dead_t = hit_top & ~s["valid"]

        wi_out = torch.where(escape[..., None], s["wi"], wi_out)
        wi_out = torch.where(escape_b[..., None], w, wi_out)
        w_out = torch.where(escape[..., None], beta * s["weight"][..., None], w_out)
        w_out = torch.where(escape_b[..., None], beta, w_out)
        beta = torch.where(bounce[..., None], beta * s["weight"][..., None], beta)
        w = torch.where(bounce[..., None], s["wi"], w)

        alive = alive & ~escape & ~escape_b & ~dead_b & ~dead_t
        alive = alive & (beta > 1e-9).any(-1)  # fully absorbed lanes stop
        exited = exited | escape | escape_b
        trans_out = trans_out | escape_b

    # a reflection exit at the entry interface, or the walk's exit
    wi_l = torch.where(refl_exit[..., None], s_top["wi"], wi_out)
    wi = wi_l * mul
    cos_i = torch.clamp(abs_cos_theta(wi_l), min=1e-6)
    pdf_a = layered_pdf_stochastic(wo_l, wi_l, rng, top_eta, top_ax, top_ay, bottom_pdf,
                                   bottom_sample, bottom_smooth, two_sided=bottom_exits)
    weight4 = torch.where(refl_exit[..., None],
                          torch.ones_like(w_out) * s_top["weight"][..., None], w_out)
    f = weight4 * (pdf_a / cos_i)[..., None]  # premultiplied: f cos / pdf_a = weight
    valid = refl_exit | (exited & (w_out > 0.0).any(-1))
    spec = refl_exit & s_top["specular"]  # the smooth coat's mirror exit
    return BSDFSample(wi=wi, f=f, pdf=torch.where(spec, 1.0, pdf_a), specular=spec,
                      transmission=trans_out, eta_scale=torch.ones_like(pdf_a),
                      valid=valid & (pdf_a > 1e-9))


def _power_heuristic(pf, pg):
    f2 = pf * pf
    return torch.where(f2 > 0.0, f2 / torch.clamp(f2 + pg * pg, min=1e-30), 0.0)


def layered_pdf_stochastic(wo_l, wi_l, rng, top_eta, top_ax, top_ay, bottom_pdf,
                           bottom_sample, bottom_smooth=None, two_sided=False):
    """Stochastic solid-angle pdf for MIS (pbrt LayeredBxDF::PDF): the
    top's own reflection pdf plus a one-sample TRT estimate, blended
    0.9 / 0.1 with the uniform sphere's pdf. TRT refracts wo and wi into
    the slab (the lobe forced to transmission) and combines the bottom pdf
    between them with the top-exit pdf of a sampled bottom bounce by the
    power heuristic; a smooth top uses the bottom pdf alone, a delta bottom
    the top-exit pdf alone. two_sided (a transmitting bottom): a query
    below adds the bottom lobe's pdf from the entry-refracted direction."""
    same = wo_l[..., 2] * wi_l[..., 2] > 0.0
    _, pdf_top = dielectric_interface_f(wo_l, wi_l, top_eta, top_ax, top_ay)
    pdf_sum = torch.where(same, pdf_top, 0.0)

    force_t = torch.full(same.shape, 0.999999, device=same.device)
    rng, uo2 = _rng_next2(rng)
    so = dielectric_interface_sample(wo_l, top_eta, top_ax, top_ay, uo2, force_t)
    o_ok = so["valid"] & so["is_trans"]
    w_o = so["wi"]  # down into the slab
    # wo_l is up, so a same-hemisphere wi is up too; a query below never
    # reads si
    wi_q = torch.where((wi_l[..., 2] < 0.0)[..., None], -wi_l, wi_l)
    rng, ui2 = _rng_next2(rng)
    si = dielectric_interface_sample(wi_q, top_eta, top_ax, top_ay, ui2, force_t)
    i_ok = si["valid"] & si["is_trans"]
    w_i = si["wi"]

    r_pdf = bottom_pdf(w_o, -w_i)
    rng, ub2 = _rng_next2(rng)
    rng, ubc = _rng_next(rng)
    w_b, _, b_ok = bottom_sample(w_o, ub2, ubc)
    rs_pdf = bottom_pdf(w_o, w_b)
    _, t_pdf = dielectric_interface_f(-w_b, wi_q, top_eta, top_ax, top_ay)
    if bottom_smooth is None:
        bottom_smooth = torch.zeros_like(same)
    trt = torch.where(
        effectively_smooth(top_ax, top_ay), r_pdf,
        torch.where(bottom_smooth, torch.where(b_ok, t_pdf, 0.0),
                    _power_heuristic(si["pdf"], r_pdf) * r_pdf
                    + torch.where(b_ok, _power_heuristic(rs_pdf, t_pdf) * t_pdf, 0.0)))
    pdf_sum = pdf_sum + torch.where(same & o_ok & i_ok, trt, 0.0)
    if two_sided:
        tt = torch.where(o_ok, bottom_pdf(w_o, wi_l), 0.0)
        pdf_sum = pdf_sum + torch.where(~same, tt, 0.0)
    out = 0.9 * pdf_sum + 0.1 / (4.0 * math.pi)
    return out if two_sided else torch.where(same, out, 0.0)


def layered_f(wo, wi, lam, u2, uc, top_eta, top_ax, top_ay, thick, albedo4, g,
              bottom_sample, bottom_f, bottom_pdf, bottom_smooth=None,
              bottom_exits: bool = False):
    """Stochastic (f, pdf) for NEE MIS (pbrt LayeredBxDF::f): the rough
    top's single-scatter reflection, plus an entry walk from wo that
    connects at every bottom vertex up through the slab to an exit channel
    sampled from the wi side (pbrt's `wis`; its weight applies to the exit
    crossing by reciprocity). The entry crossing compresses radiance by
    1 / eta^2, which the importance-mode exit channel does not undo, so
    each connection carries it. bottom_exits: for a wi opposite wo the
    bottom is the exit interface, and every bottom vertex connects through
    its transmission lobe (pbrt's z == exitZ branch)."""
    _, mul = _z_sign(wo)
    wo_l = wo * mul
    wi_l = wi * mul
    same = wo_l[..., 2] * wi_l[..., 2] > 0.0

    f_top, _ = dielectric_interface_f(wo_l, wi_l, top_eta, top_ax, top_ay)
    f_sum = f_top[..., None] * torch.ones_like(lam)

    rng = _rng_init(u2, uc + 0.5)
    rng, ue2 = _rng_next2(rng)
    rng, uec = _rng_next(rng)
    s_exit = dielectric_interface_sample(wi_l, top_eta, top_ax, top_ay, ue2, uec)
    exit_ok = s_exit["valid"] & s_exit["is_trans"]
    w_exit_in = s_exit["wi"]  # down inside the slab
    exit_w = s_exit["weight"]

    s_top = dielectric_interface_sample(wo_l, top_eta, top_ax, top_ay, u2, uc)
    w = s_top["wi"]
    beta = torch.ones_like(lam) * s_top["weight"][..., None]
    alive = s_top["valid"] & s_top["is_trans"] & (same | bottom_exits)
    f_acc = torch.zeros_like(lam)
    inv_eta2 = 1.0 / torch.clamp(top_eta * top_eta, min=1e-6)
    # the upward crossing's transmittance and the exit weight, per lane
    tr_up = torch.exp(-(thick / torch.clamp(torch.abs(w_exit_in[..., 2]), min=1e-6)))
    link = (tr_up * exit_w * inv_eta2)[..., None]

    for _ in range(MAX_WALK):
        rng, w, beta, crossed = _slab_transit(rng, w, thick, albedo4, g, beta)
        at_iface = alive & crossed
        going_down = w[..., 2] < 0.0
        hit_bottom = at_iface & going_down

        # the NEE connection (a reflection query): bottom vertex, up
        # through the slab, out through the exit channel to wi
        contrib = beta * bottom_f(w, -w_exit_in) * link
        f_acc = f_acc + torch.where((hit_bottom & exit_ok & same)[..., None], contrib, 0.0)
        if bottom_exits:
            # a transmission query: out through the bottom (wi_l is down)
            f_acc = f_acc + torch.where((hit_bottom & ~same)[..., None],
                                        beta * bottom_f(w, wi_l), 0.0)

        rng, ub2 = _rng_next2(rng)
        rng, ubc = _rng_next(rng)
        w_b, bw, b_ok = bottom_sample(w, ub2, ubc)
        beta = torch.where(hit_bottom[..., None], beta * bw, beta)
        w = torch.where(hit_bottom[..., None], w_b, w)
        dead_b = hit_bottom & ~b_ok
        exit_b = (hit_bottom & (w_b[..., 2] < 0.0) if bottom_exits
                  else torch.zeros_like(hit_bottom))

        rng, ut2 = _rng_next2(rng)
        rng, utc = _rng_next(rng)
        s = dielectric_interface_sample(-w, top_eta, top_ax, top_ay, ut2, utc)
        hit_top = at_iface & ~going_down & ~hit_bottom
        escape = hit_top & s["valid"] & s["is_trans"]  # the walk leaves: stop
        bounce = hit_top & s["valid"] & ~s["is_trans"]
        beta = torch.where(bounce[..., None], beta * s["weight"][..., None], beta)
        w = torch.where(bounce[..., None], s["wi"], w)
        alive = alive & ~escape & ~exit_b & ~dead_b & ~(hit_top & ~s["valid"])
        alive = alive & (beta > 1e-9).any(-1)

    f_sum = f_sum + torch.where(same[..., None], f_acc, 0.0)
    if bottom_exits:
        f_sum = torch.where(same[..., None], f_sum, f_acc)
    pdf = layered_pdf_stochastic(wo_l, wi_l, rng, top_eta, top_ax, top_ay, bottom_pdf,
                                 bottom_sample, bottom_smooth, two_sided=bottom_exits)
    valid_q = same | bottom_exits
    return torch.where(valid_q[..., None], f_sum, 0.0), pdf


# --- material-bank entry points --------------------------------------------------------


def _coated_diffuse(banks, idx, lam, tex):
    """Walk arguments and bottom of a CoatedDiffuse row; a texture enters
    the walk through the base's albedo only."""
    refl = _albedo_spec(banks, banks.cd_refl_c4, banks.cd_refl, banks.cd_refl_tex, idx, tex,
                        lam)
    top = (_bl(banks.cd_eta, idx), _bl(banks.cd_ax, idx), _bl(banks.cd_ay, idx),
           _bl(banks.cd_thick, idx), coeff4_eval(_bl(banks.cd_albedo_c4, idx), lam),
           _bl(banks.cd_g, idx))

    def bottom(w_down, ub2, ubc):
        """Cosine-sample the diffuse base: weight f cos / pdf = refl."""
        return cosine_sample_hemisphere(ub2), refl, _lanes_true(w_down)

    return top, refl, bottom


def sample_coated_diffuse(banks, idx, wo, lam, u2, uc, tex=None) -> BSDFSample:
    top, _, bottom = _coated_diffuse(banks, idx, lam, tex)
    return layered_sample(wo, lam, u2, uc, *top, bottom, _bottom_diffuse_pdf)


def eval_coated_diffuse(banks, idx, wo, wi, lam, u2, uc, tex=None):
    top, refl, bottom = _coated_diffuse(banks, idx, lam, tex)
    return layered_f(wo, wi, lam, u2, uc, *top, bottom,
                     lambda w_down, wi_up: refl * INV_PI, _bottom_diffuse_pdf)


def _coated_conductor(banks, idx, lam):
    """Walk arguments, the conductor's spectra and alphas, and its bottom
    sample and pdf of a CoatedConductor row."""
    eta4 = piecewise_eval_banked(banks.cc_cond_eta_pw, idx[..., None], lam)
    k4 = piecewise_eval_banked(banks.cc_cond_k_pw, idx[..., None], lam)
    cax, cay = _bl(banks.cc_cax, idx), _bl(banks.cc_cay, idx)
    top = (_bl(banks.cc_eta, idx), _bl(banks.cc_iax, idx), _bl(banks.cc_iay, idx),
           _bl(banks.cc_thick, idx), coeff4_eval(_bl(banks.cc_albedo_c4, idx), lam),
           _bl(banks.cc_g, idx))

    def bottom(w_down, ub2, ubc):
        return _bottom_conductor_sample(eta4, k4, cax, cay, w_down, ub2)

    def bottom_pdf(w_down, wi_q):
        return _bottom_conductor_pdf(cax, cay, w_down, wi_q)

    return top, (eta4, k4, cax, cay), bottom, bottom_pdf


def sample_coated_conductor(banks, idx, wo, lam, u2, uc, tex=None) -> BSDFSample:
    """tex is accepted and unused: no field of the coat is textured."""
    top, (_, _, cax, cay), bottom, bottom_pdf = _coated_conductor(banks, idx, lam)
    return layered_sample(wo, lam, u2, uc, *top, bottom, bottom_pdf,
                          bottom_smooth=effectively_smooth(cax, cay))


def eval_coated_conductor(banks, idx, wo, wi, lam, u2, uc, tex=None):
    top, (eta4, k4, cax, cay), bottom, bottom_pdf = _coated_conductor(banks, idx, lam)

    def bottom_f(w_down, wi_up):
        return _bottom_conductor_f(eta4, k4, cax, cay, w_down, wi_up)

    return layered_f(wo, wi, lam, u2, uc, *top, bottom, bottom_f, bottom_pdf,
                     bottom_smooth=effectively_smooth(cax, cay))


def _coated_dt(banks, idx, lam, tex):
    """Walk arguments and the diffuse-transmission bottom of a
    CoatedDiffuseTransmission row: (top, bottom, bottom_f, bottom_pdf)."""
    refl = _albedo_spec(banks, banks.cdt_refl_c4, banks.cdt_refl, banks.cdt_refl_tex, idx,
                        tex, lam)
    trans = _albedo_spec(banks, banks.cdt_trans_c4, banks.cdt_trans, banks.cdt_trans_tex, idx,
                         tex, lam)
    top = (_bl(banks.cdt_eta, idx), _bl(banks.cdt_ax, idx), _bl(banks.cdt_ay, idx),
           _bl(banks.cdt_thick, idx), coeff4_eval(_bl(banks.cdt_albedo_c4, idx), lam),
           _bl(banks.cdt_g, idx))
    return (top,
            lambda w_down, ub2, ubc: _bottom_dt_sample(refl, trans, w_down, ub2, ubc),
            lambda w_down, wi_q: _bottom_dt_f(refl, trans, w_down, wi_q),
            lambda w_down, wi_q: _bottom_dt_pdf(refl, trans, w_down, wi_q))


def sample_coated_diffuse_transmission(banks, idx, wo, lam, u2, uc,
                                       tex=None) -> BSDFSample:
    """The walk may leave through the transmitting bottom
    (coated-diffuse-transmission.jl:12)."""
    top, bottom, _, bottom_pdf = _coated_dt(banks, idx, lam, tex)
    return layered_sample(wo, lam, u2, uc, *top, bottom, bottom_pdf, bottom_exits=True)


def eval_coated_diffuse_transmission(banks, idx, wo, wi, lam, u2, uc, tex=None):
    top, bottom, bottom_f, bottom_pdf = _coated_dt(banks, idx, lam, tex)
    return layered_f(wo, wi, lam, u2, uc, *top, bottom, bottom_f, bottom_pdf,
                     bottom_exits=True)
