"""Axis-aligned bounding boxes as (lo, hi) tensor pairs.

Port of ``hikari_tpu/core/bounds.py`` (Raycore's Bounds3). Batched:
(..., 3).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .vecmath import dot


@dataclass
class Bounds3:
    lo: torch.Tensor  # (..., 3)
    hi: torch.Tensor  # (..., 3)

    def union(self, other: "Bounds3") -> "Bounds3":
        return Bounds3(torch.minimum(self.lo, other.lo), torch.maximum(self.hi, other.hi))

    def union_point(self, p: torch.Tensor) -> "Bounds3":
        return Bounds3(torch.minimum(self.lo, p), torch.maximum(self.hi, p))

    def expand(self, delta) -> "Bounds3":
        return Bounds3(self.lo - delta, self.hi + delta)

    def diagonal(self) -> torch.Tensor:
        return self.hi - self.lo

    def centroid(self) -> torch.Tensor:
        return 0.5 * (self.lo + self.hi)

    def surface_area(self) -> torch.Tensor:
        d = torch.clamp(self.diagonal(), min=0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])

    def contains(self, p: torch.Tensor) -> torch.Tensor:
        return ((p >= self.lo) & (p <= self.hi)).all(-1)

    def offset(self, p: torch.Tensor) -> torch.Tensor:
        """Relative [0,1]^3 position of p within the bounds."""
        d = self.diagonal()
        return (p - self.lo) / torch.where(d > 0.0, d, 1.0)

    def bounding_sphere(self):
        c = self.centroid()
        r = self.hi - c
        return c, torch.sqrt(dot(r, r))

    def intersect_p(self, o, inv_d, t_max):
        """Slab test. o / inv_d: (..., 3); returns (hit mask, t_near, t_far)."""
        t0 = (self.lo - o) * inv_d
        t1 = (self.hi - o) * inv_d
        t_near = torch.minimum(t0, t1).amax(-1)
        # pbrt's robustness factor on t_far
        t_far = torch.maximum(t0, t1).amin(-1) * 1.0000004
        hit = (t_near <= t_far) & (t_far > 0.0) & (t_near < t_max)
        return hit, t_near, t_far


def empty_bounds3() -> Bounds3:
    return Bounds3(torch.full((3,), float("inf")), torch.full((3,), float("-inf")))


def bounds_from_points(pts) -> Bounds3:
    """Bounds of an (N, 3) point cloud."""
    pts = torch.as_tensor(pts, dtype=torch.float32)
    return Bounds3(pts.amin(0), pts.amax(0))
