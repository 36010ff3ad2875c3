"""Ray helpers (port of ``hikari_tpu/core/ray.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

RAY_EPS = 1e-4  # self-intersection offset


def spawn_ray(p: torch.Tensor, n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Offset the origin along the normal, to the side d leaves on."""
    sign = torch.where((n * d).sum(-1) >= 0.0, 1.0, -1.0)
    return p + sign[..., None] * RAY_EPS * n


@dataclass
class RayDifferentials:
    """The +x / +y camera-offset rays of texture filtering, (..., 3) each
    (Whitted's primary hits; ``volpath._uv_diff_derivatives``)."""

    rx_o: torch.Tensor
    rx_d: torch.Tensor
    ry_o: torch.Tensor
    ry_d: torch.Tensor
