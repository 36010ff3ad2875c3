"""Triangle helpers (port of ``hikari_tpu/geometry/triangle.py``)."""

from __future__ import annotations

import torch

from ..core.vecmath import cross, normalize


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
