"""Ray helpers (port of ``hikari_tpu/core/ray.py``)."""

from __future__ import annotations

import torch

RAY_EPS = 1e-4  # self-intersection offset


def spawn_ray(p: torch.Tensor, n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Offset the origin along the normal, to the side d leaves on."""
    sign = torch.where((n * d).sum(-1) >= 0.0, 1.0, -1.0)
    return p + sign[..., None] * RAY_EPS * n
