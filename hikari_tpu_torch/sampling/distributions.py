"""Sampling warps (port of part of ``hikari_tpu/sampling/distributions.py``)."""

from __future__ import annotations

import math

import torch


def concentric_sample_disk(u: torch.Tensor) -> torch.Tensor:
    """Map [0,1)^2 to the unit disk, low distortion (sampling.jl:5-30)."""
    off = 2.0 * u - 1.0
    ox, oy = off[..., 0], off[..., 1]
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(
        use_x,
        (math.pi / 4.0) * (oy / torch.where(ox == 0.0, 1.0, ox)),
        (math.pi / 2.0) - (math.pi / 4.0) * (ox / torch.where(oy == 0.0, 1.0, oy)),
    )
    p = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    return torch.where(zero[..., None], 0.0, p)


def cosine_sample_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere around +z; pdf = cos(theta)/pi."""
    d = concentric_sample_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.cat([d, z[..., None]], -1)
