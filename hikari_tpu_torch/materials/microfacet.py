"""Trowbridge-Reitz (GGX) microfacet distribution, pbrt-v4 forms (port of
``hikari_tpu/materials/microfacet.py``). Local shading frame, z = n."""

from __future__ import annotations

import math

import torch

from ..core.vecmath import cross, normalize
from ..sampling.distributions import concentric_sample_disk

SMOOTH_ALPHA = 1e-3  # pbrt EffectivelySmooth cutoff


def effectively_smooth(alpha_x, alpha_y):
    return torch.maximum(alpha_x, alpha_y) < SMOOTH_ALPHA


def regularize_alpha(alpha):
    return torch.where(alpha < 0.3, torch.clamp(2.0 * alpha, 0.1, 0.3), alpha)


def tr_d(wm, ax, ay):
    t = wm[..., 0] ** 2 / (ax * ax) + wm[..., 1] ** 2 / (ay * ay) + wm[..., 2] ** 2
    return 1.0 / torch.clamp(math.pi * ax * ay * t * t, min=1e-20)


def tr_lambda(w, ax, ay):
    cos2 = w[..., 2] ** 2
    a2 = (ax * w[..., 0]) ** 2 + (ay * w[..., 1]) ** 2
    return 0.5 * (-1.0 + torch.sqrt(1.0 + a2 / torch.clamp(cos2, min=1e-12)))


def tr_g1(w, ax, ay):
    return 1.0 / (1.0 + tr_lambda(w, ax, ay))


def tr_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay))


def tr_pdf(wo, wm, ax, ay):
    """pdf of sampling wm with tr_sample_wm (visible normals)."""
    cos_o = torch.abs(wo[..., 2])
    dot_om = torch.abs((wo * wm).sum(-1))
    return tr_g1(wo, ax, ay) / torch.clamp(cos_o, min=1e-12) * tr_d(wm, ax, ay) * dot_om


def tr_sample_wm(wo, u, ax, ay):
    """Sample a visible microfacet normal (pbrt-v4 ellipsoid method)."""
    wh = normalize(torch.stack([ax * wo[..., 0], ay * wo[..., 1], wo[..., 2]], -1))
    wh = torch.where(wh[..., 2:3] < 0.0, -wh, wh)
    z = torch.zeros_like(wh)
    z[..., 2] = 1.0
    t1_raw = cross(z, wh)
    t1_len = torch.linalg.norm(t1_raw, dim=-1, keepdim=True)
    x_axis = torch.zeros_like(wh)
    x_axis[..., 0] = 1.0
    t1 = torch.where(wh[..., 2:3] < 0.999,
                     t1_raw / torch.clamp(t1_len, min=1e-12), x_axis)
    t2 = cross(wh, t1)
    p = concentric_sample_disk(u)
    h = torch.sqrt(torch.clamp(1.0 - p[..., 0] ** 2, min=0.0))
    lerp_t = (1.0 + wh[..., 2]) / 2.0
    py = h + lerp_t * (p[..., 1] - h)
    pz = torch.sqrt(torch.clamp(1.0 - p[..., 0] ** 2 - py * py, min=0.0))
    nh = p[..., 0:1] * t1 + py[..., None] * t2 + pz[..., None] * wh
    return normalize(torch.stack(
        [ax * nh[..., 0], ay * nh[..., 1], torch.clamp(nh[..., 2], min=1e-6)], -1))
