"""Triangle helpers and the ray-triangle test (port of
``hikari_tpu/geometry/triangle.py``)."""

from __future__ import annotations

import torch

from ..core.vecmath import cross, dot, normalize


def triangle_normal(p0, p1, p2):
    return normalize(cross(p1 - p0, p2 - p0))


def triangle_area(p0, p1, p2):
    return 0.5 * torch.linalg.norm(cross(p1 - p0, p2 - p0), dim=-1)


def interpolate(b1, b2, a0, a1, a2):
    """Barycentric interpolation of per-vertex attributes."""
    b0 = (1.0 - b1 - b2)[..., None]
    return b0 * a0 + b1[..., None] * a1 + b2[..., None] * a2


def sample_triangle(u1, u2, p0, p1, p2):
    """Uniform area sampling; returns (p, b1, b2)."""
    su = torch.sqrt(torch.clamp(u1, min=0.0))
    b1 = 1.0 - su
    b2 = u2 * su
    return interpolate(b1, b2, p0, p1, p2), b1, b2


TRI_EPS = 1e-9


def intersect_triangle(o, d, p0, p1, p2, t_max):
    """Moller-Trumbore; every input (..., 3) / (...,), broadcast. Returns
    (hit, t, b1, b2) with (b1, b2) the barycentrics of p1 / p2."""
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = torch.abs(det) > TRI_EPS
    inv_det = torch.where(ok, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    tvec = o - p0
    b1 = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    b2 = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ok & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0) & (t > TRI_EPS) & (t < t_max)
    return hit, t, b1, b2
