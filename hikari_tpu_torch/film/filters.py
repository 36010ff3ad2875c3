"""Reconstruction filters with importance sampling.

Port of ``hikari_tpu/film/filters.py``: box, triangle, Gaussian, Mitchell
and Lanczos (windowed sinc). Box, triangle and Gaussian sample their
offsets in closed form; Mitchell and Lanczos, whose negative lobes give
negative weights, sample |f| through a 64 x 64 table and its 2D
distribution (``sampling/distributions.py``), as the JAX package does.
The tables are built on the host in numpy, exactly as the JAX package
builds them; ``filter_sample`` and ``filter_eval`` read them on the device
of their argument.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..sampling.distributions import (Distribution2D, make_distribution_2d,
                                      sample_distribution_2d)
from ..utils import profiling

BOX = 0
TRIANGLE = 1
GAUSSIAN = 2
MITCHELL = 3
LANCZOS = 4

_TABLE_RES = 64
_DEFAULT_RADIUS = {BOX: (0.5, 0.5), TRIANGLE: (2.0, 2.0), GAUSSIAN: (1.5, 1.5),
                   MITCHELL: (2.0, 2.0), LANCZOS: (4.0, 4.0)}


def _filter_eval_np(ftype, radius, params, x, y):
    rx, ry = radius
    ax, ay = np.abs(x), np.abs(y)
    inside = (ax <= rx) & (ay <= ry)
    if ftype == BOX:
        f = np.ones_like(x)
    elif ftype == TRIANGLE:
        f = np.maximum(0.0, rx - ax) * np.maximum(0.0, ry - ay)
    elif ftype == GAUSSIAN:
        sigma = params.get("sigma", 0.5)
        expx = np.exp(-(x * x) / (2 * sigma**2)) - np.exp(-(rx * rx) / (2 * sigma**2))
        expy = np.exp(-(y * y) / (2 * sigma**2)) - np.exp(-(ry * ry) / (2 * sigma**2))
        f = np.maximum(0.0, expx) * np.maximum(0.0, expy)
    elif ftype == MITCHELL:
        b = params.get("b", 1.0 / 3.0)
        c = params.get("c", 1.0 / 3.0)

        def m1d(v):
            v = np.abs(2.0 * v)
            out = np.where(
                v > 1.0,
                (-b - 6 * c) * v**3 + (6 * b + 30 * c) * v**2 + (-12 * b - 48 * c) * v
                + (8 * b + 24 * c),
                (12 - 9 * b - 6 * c) * v**3 + (-18 + 12 * b + 6 * c) * v**2 + (6 - 2 * b),
            ) * (1.0 / 6.0)
            return np.where(v > 2.0, 0.0, out)

        f = m1d(x / rx) * m1d(y / ry)
    elif ftype == LANCZOS:
        tau = params.get("tau", 3.0)

        def sinc(v):
            v = np.abs(v)
            return np.where(v < 1e-5, 1.0, np.sin(np.pi * v) / (np.pi * v))

        def wsinc(v, r):
            return np.where(np.abs(v) > r, 0.0, sinc(v) * sinc(v / tau))

        f = wsinc(x, rx) * wsinc(y, ry)
    else:
        raise ValueError(f"unknown filter type {ftype}")
    return np.where(inside, f, 0.0)


@dataclass(frozen=True)
class FilterSampler:
    """A filter: its type, radius and Gaussian sigma, and its tabulated
    values (R, R) with the distribution over |f| (sampled by Mitchell and
    Lanczos only) and the table's integral of f, all on the CPU."""

    ftype: int
    radius: tuple          # (rx, ry)
    sigma: float           # Gaussian sigma (unused by the other types)
    table: torch.Tensor    # (R, R) signed f values
    dist: Distribution2D   # over |f|
    integral: float        # of f over the filter's support


def make_filter(ftype: int = GAUSSIAN, radius=None, **params) -> FilterSampler:
    if ftype not in _DEFAULT_RADIUS:
        raise ValueError(f"unknown filter type {ftype}")
    if radius is None:
        radius = _DEFAULT_RADIUS[ftype]
    rx, ry = float(radius[0]), float(radius[1])
    r = _TABLE_RES
    xs = (np.arange(r) + 0.5) / r * 2 * rx - rx
    ys = (np.arange(r) + 0.5) / r * 2 * ry - ry
    X, Y = np.meshgrid(xs, ys)
    f = _filter_eval_np(ftype, (rx, ry), params, X, Y).astype(np.float32)
    return FilterSampler(ftype=ftype, radius=(rx, ry), sigma=float(params.get("sigma", 0.5)),
                         table=torch.from_numpy(f),
                         dist=make_distribution_2d(torch.from_numpy(np.abs(f))),
                         integral=float(np.float32(f.mean() * (4 * rx * ry))))


def _gauss1d(x, sigma, r):
    return torch.clamp(torch.exp(-(x * x) / (2.0 * sigma * sigma))
                       - math.exp(-(r * r) / (2.0 * sigma * sigma)), min=0.0)


def _table_at(fs: FilterSampler, uv: torch.Tensor) -> torch.Tensor:
    """Table value of the cell holding uv (..., 2) in [0, 1]^2."""
    r = fs.table.shape[0]
    xi = torch.clamp((uv[..., 0] * r).to(torch.int64), 0, r - 1)
    yi = torch.clamp((uv[..., 1] * r).to(torch.int64), 0, r - 1)
    return fs.table.to(uv.device)[yi, xi]


def filter_sample(fs: FilterSampler, u: torch.Tensor):
    """Importance-sample a film-plane offset. u: (..., 2).
    Returns (offset (..., 2), weight = f/pdf)."""
    rad = torch.tensor(fs.radius, dtype=torch.float32, device=u.device)
    profiling.host_sync("filter.radius", u.device)
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
    if fs.ftype == GAUSSIAN:
        # exact truncated-normal inverse CDF per axis as the proposal
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
    # Mitchell / Lanczos: the table's |f| distribution; negative lobes
    # give negative weights
    uv, pdf_uv = sample_distribution_2d(fs.dist.to(u.device), u)
    pdf_area = pdf_uv / (4.0 * rad[0] * rad[1])
    w = torch.where(pdf_area > 0.0,
                    _table_at(fs, uv) / torch.where(pdf_area == 0.0, 1.0, pdf_area), 0.0)
    return (uv * 2.0 - 1.0) * rad, w


def filter_eval(fs: FilterSampler, p: torch.Tensor):
    """The filter's table value at offsets p (..., 2), 0 outside its radius."""
    rad = torch.tensor(fs.radius, dtype=torch.float32, device=p.device)
    inside = (torch.abs(p) <= rad).all(-1)
    return torch.where(inside, _table_at(fs, (p / rad + 1.0) * 0.5), 0.0)
