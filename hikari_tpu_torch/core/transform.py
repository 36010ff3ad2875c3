"""Affine transforms as paired 4x4 float32 matrices (m, m_inv).

Port of the parts of ``hikari_tpu/core/transform.py`` the camera needs:
``look_at`` and ``perspective``. Matrices are small CPU tensors; callers
move them to the device of the data they transform.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .vecmath import cross, normalize


@dataclass(frozen=True)
class Transform:
    m: torch.Tensor      # (4, 4)
    m_inv: torch.Tensor  # (4, 4)

    def inverse(self) -> "Transform":
        return Transform(self.m_inv, self.m)

    def compose(self, other: "Transform") -> "Transform":
        """self o other (apply other first)."""
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)

    def apply_point(self, p: torch.Tensor) -> torch.Tensor:
        m = self.m.to(p.device)
        r = (m[:3, :3] * p[..., None, :]).sum(-1) + m[:3, 3]
        w = (m[3, :3] * p).sum(-1) + m[3, 3]
        return r / w[..., None]

    def apply_vector(self, v: torch.Tensor) -> torch.Tensor:
        m = self.m.to(v.device)
        return (m[:3, :3] * v[..., None, :]).sum(-1)


def from_matrix(m: torch.Tensor) -> Transform:
    m = torch.as_tensor(m, dtype=torch.float32)
    return Transform(m, torch.linalg.inv(m))


def scale(s) -> Transform:
    s = torch.as_tensor(s, dtype=torch.float32).expand(3)
    one = torch.ones(1)
    return Transform(torch.diag(torch.cat([s, one])),
                     torch.diag(torch.cat([1.0 / s, one])))


def look_at(eye, target, up) -> Transform:
    """Camera-to-world transform (pbrt convention: camera looks down +z)."""
    eye = torch.as_tensor(eye, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    up = torch.as_tensor(up, dtype=torch.float32)
    d = normalize(target - eye)
    right = normalize(cross(normalize(up), d))
    new_up = cross(d, right)
    z1, o1 = torch.zeros(1), torch.ones(1)
    m = torch.stack([torch.cat([right, z1]), torch.cat([new_up, z1]),
                     torch.cat([d, z1]), torch.cat([eye, o1])], dim=1)
    return Transform(m, torch.linalg.inv(m))


def perspective(fov_rad: float, near: float = 1e-2, far: float = 1000.0) -> Transform:
    """Perspective projection, pbrt style (z mapped to [0, 1])."""
    inv_tan = 1.0 / torch.tan(torch.tensor(fov_rad, dtype=torch.float32) / 2.0)
    persp = torch.tensor(
        [[1.0, 0.0, 0.0, 0.0],
         [0.0, 1.0, 0.0, 0.0],
         [0.0, 0.0, far / (far - near), -far * near / (far - near)],
         [0.0, 0.0, 1.0, 0.0]], dtype=torch.float32)
    s = scale(torch.stack([inv_tan, inv_tan, torch.tensor(1.0)]))
    return s.compose(from_matrix(persp))


def deg2rad(deg: float) -> float:
    return float(torch.tensor(deg, dtype=torch.float32) * (math.pi / 180.0))
