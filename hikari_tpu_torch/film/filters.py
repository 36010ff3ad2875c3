"""Reconstruction filters with closed-form importance sampling.

Port of the box / triangle / Gaussian branches of
``hikari_tpu/film/filters.py``. The tabulated Mitchell and Lanczos filters
(negative lobes, 2D-CDF sampling) are outside the ported slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

BOX = 0
TRIANGLE = 1
GAUSSIAN = 2

_DEFAULT_RADIUS = {BOX: (0.5, 0.5), TRIANGLE: (2.0, 2.0), GAUSSIAN: (1.5, 1.5)}


@dataclass(frozen=True)
class FilterSampler:
    ftype: int
    radius: tuple  # (rx, ry)
    sigma: float   # Gaussian sigma (unused by the other types)


def make_filter(ftype: int = GAUSSIAN, radius=None, **params) -> FilterSampler:
    if ftype not in _DEFAULT_RADIUS:
        raise NotImplementedError(
            "hikari_tpu_torch ports the box, triangle and Gaussian filters; "
            "the tabulated Mitchell/Lanczos filters are not ported yet")
    if radius is None:
        radius = _DEFAULT_RADIUS[ftype]
    return FilterSampler(ftype=ftype, radius=(float(radius[0]), float(radius[1])),
                         sigma=float(params.get("sigma", 0.5)))


def _gauss1d(x, sigma, r):
    return torch.clamp(torch.exp(-(x * x) / (2.0 * sigma * sigma))
                       - math.exp(-(r * r) / (2.0 * sigma * sigma)), min=0.0)


def filter_sample(fs: FilterSampler, u: torch.Tensor):
    """Importance-sample a film-plane offset. u: (..., 2).
    Returns (offset (..., 2), weight = f/pdf)."""
    rad = torch.tensor(fs.radius, dtype=torch.float32, device=u.device)
    if fs.ftype == BOX:
        w = torch.full(u.shape[:-1], 4.0 * fs.radius[0] * fs.radius[1],
                       device=u.device)
        return (u * 2.0 - 1.0) * rad, w
    if fs.ftype == TRIANGLE:
        s = torch.where(u < 0.5, torch.sqrt(2.0 * u) - 1.0,
                        1.0 - torch.sqrt(2.0 - 2.0 * u))
        w = torch.full(u.shape[:-1], (fs.radius[0] * fs.radius[1]) ** 2,
                       device=u.device)
        return s * rad, w
    # Gaussian: exact truncated-normal inverse CDF per axis as the proposal
    sig = fs.sigma
    root2 = math.sqrt(2.0)
    cap = torch.erf(rad / (sig * root2))
    x = sig * root2 * torch.erfinv((u * 2.0 - 1.0) * cap)
    x = torch.minimum(torch.maximum(x, -rad), rad)
    norm = 1.0 / (sig * math.sqrt(2.0 * math.pi))
    pdf = norm * torch.exp(-(x * x) / (2.0 * sig * sig)) / cap
    f = (_gauss1d(x[..., 0], sig, fs.radius[0])
         * _gauss1d(x[..., 1], sig, fs.radius[1]))
    w = f / torch.clamp(pdf[..., 0] * pdf[..., 1], min=1e-20)
    return x, w
