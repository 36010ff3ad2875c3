"""Batched 3-vector math on ``(..., 3)`` float32 tensors.

Port of ``hikari_tpu/core/vecmath.py``: every helper broadcasts over the
leading axes, and a "vector" is the last axis of a structure-of-arrays
tensor.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Safe normalize: v/|v|, or 0 where |v| ~ 0."""
    len2 = dot(v, v)
    inv = torch.where(len2 > EPS * EPS,
                      1.0 / torch.sqrt(torch.clamp(len2, min=EPS * EPS)), 0.0)
    return v * inv[..., None]


def face_forward(n: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flip n into the hemisphere of v."""
    return torch.where(dot(n, v)[..., None] < 0.0, -n, n)


def reflect(wo: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def refract(wi: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """Refract wi (pointing away from the surface) about n with relative IOR
    eta. Returns (valid_mask, wt)."""
    cos_theta_i = dot(n, wi)
    sin2_theta_i = torch.clamp(1.0 - cos_theta_i * cos_theta_i, min=0.0)
    sin2_theta_t = sin2_theta_i / (eta * eta)
    valid = sin2_theta_t < 1.0
    cos_theta_t = torch.sqrt(torch.clamp(1.0 - sin2_theta_t, min=0.0))
    wt = -wi / eta[..., None] + (cos_theta_i / eta - cos_theta_t)[..., None] * n
    return valid, wt


def coordinate_system(v1: torch.Tensor):
    """Orthonormal basis around unit v1 (branchless, Duff et al.)."""
    sign = torch.where(v1[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + v1[..., 2])
    b = v1[..., 0] * v1[..., 1] * a
    v2 = torch.stack(
        [1.0 + sign * v1[..., 0] * v1[..., 0] * a, sign * b, -sign * v1[..., 0]],
        dim=-1)
    v3 = torch.stack([b, sign + v1[..., 1] * v1[..., 1] * a, -v1[..., 1]],
                     dim=-1)
    return v2, v3


# --- local shading frame helpers (z = normal), pbrt style -------------------


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def sin_theta(w):
    return torch.sqrt(torch.clamp(1.0 - w[..., 2] * w[..., 2], min=0.0))


def cos_phi(w):
    s = sin_theta(w)
    return torch.where(s == 0.0, 1.0,
                       torch.clamp(w[..., 0] / torch.clamp(s, min=EPS), -1.0, 1.0))


def sin_phi(w):
    s = sin_theta(w)
    return torch.where(s == 0.0, 0.0,
                       torch.clamp(w[..., 1] / torch.clamp(s, min=EPS), -1.0, 1.0))


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


def make_frame(n: torch.Tensor):
    """Orthonormal frame with z-axis = n. Returns (t, b, n)."""
    t, b = coordinate_system(n)
    return t, b, n


def to_local(t, b, n, v):
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def to_world(t, b, n, v):
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n
