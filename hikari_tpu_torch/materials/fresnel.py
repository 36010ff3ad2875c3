"""Fresnel reflectance (port of ``hikari_tpu/materials/fresnel.py``)."""

from __future__ import annotations

import torch


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized dielectric Fresnel; cos_theta_i < 0 means inside."""
    cos_theta_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    eta_eff = torch.where(cos_theta_i > 0.0, eta, 1.0 / eta)
    ci = torch.abs(cos_theta_i)
    sin2_t = (1.0 - ci * ci) / (eta_eff * eta_eff)
    ct = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_par = (eta_eff * ci - ct) / (eta_eff * ci + ct)
    r_perp = (ci - eta_eff * ct) / (ci + eta_eff * ct)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(sin2_t >= 1.0, 1.0, f)


def fresnel_conductor(cos_theta_i, eta, k):
    """Exact conductor Fresnel; cos_theta_i (...,), eta/k (..., S)."""
    ci = torch.clamp(torch.abs(cos_theta_i), 0.0, 1.0)[..., None]
    cos2 = ci * ci
    sin2 = 1.0 - cos2
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - sin2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * eta2 * k2, min=0.0))
    t1 = a2b2 + cos2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / (t1 + t2)
    t3 = cos2 * a2b2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / (t3 + t4)
    return torch.clamp(0.5 * (rp + rs), 0.0, 1.0)
