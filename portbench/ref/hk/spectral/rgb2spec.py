"""RGB -> spectrum uplifting via sigmoid polynomials (pbrt-v4 style).

Port of ``hikari_tpu/spectral/rgb2spec.py``: the trilinear lookup in the
sRGB coefficient table (this package's copy in ``data/``), and the albedo,
unbounded and illuminant spectrum wrappers. Scene banks store the
coefficients of constant colours as ``[c0, c1, c2, scale]`` so the render
path evaluates one polynomial per lane.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .._data import load_npz
from .cie import sample_d65


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 0.5 + x / (2.0 * torch.sqrt(1.0 + x * x))


def eval_sigmoid_poly(coeffs: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """sigmoid(c0 l^2 + c1 l + c2); coeffs (..., 3), lam (..., S)."""
    c0, c1, c2 = coeffs[..., 0:1], coeffs[..., 1:2], coeffs[..., 2:3]
    return sigmoid(c0 * lam * lam + c1 * lam + c2)


@dataclass(frozen=True)
class RGBToSpectrumTable:
    res: int
    scale: torch.Tensor   # (res,)
    coeffs: torch.Tensor  # (3, res, res, res, 3): [maxc, z, y, x, coeff]

    def to(self, device) -> "RGBToSpectrumTable":
        return RGBToSpectrumTable(self.res, self.scale.to(device), self.coeffs.to(device))


@functools.cache
def srgb_table() -> RGBToSpectrumTable:
    z = load_npz("srgb_spectrum_table.npz")
    return RGBToSpectrumTable(int(z["res"]), torch.from_numpy(z["scale"]),
                              torch.from_numpy(z["coeffs"]))


def rgb_to_coeffs(table: RGBToSpectrumTable, rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0,1] -> sigmoid polynomial coefficients (rgb2spec.jl:82-172)."""
    rgb = torch.clamp(rgb, 0.0, 1.0)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    res = table.res
    scale = table.scale.to(rgb.device)
    coeffs = table.coeffs.to(rgb.device)
    maxc = torch.where(r > g, torch.where(r > b, 0, 2), torch.where(g > b, 1, 2))
    z = torch.gather(rgb, -1, maxc[..., None])[..., 0]
    x_comp = torch.gather(rgb, -1, ((maxc + 1) % 3)[..., None])[..., 0]
    y_comp = torch.gather(rgb, -1, ((maxc + 2) % 3)[..., None])[..., 0]
    zsafe = torch.where(z == 0.0, 1.0, z)
    x = x_comp * (res - 1) / zsafe
    y = y_comp * (res - 1) / zsafe
    zi = torch.clamp(torch.searchsorted(scale, z.contiguous()) - 1, 0, res - 2)
    xi = torch.clamp(torch.floor(x).long(), 0, res - 2)
    yi = torch.clamp(torch.floor(y).long(), 0, res - 2)
    dx = (x - xi.float())[..., None]
    dy = (y - yi.float())[..., None]
    s0, s1 = scale[zi], scale[zi + 1]
    dz = ((z - s0) / torch.where(s1 == s0, 1.0, s1 - s0))[..., None]

    def corner(di, dj, dk):
        return coeffs[maxc, zi + dk, yi + dj, xi + di]

    c = (1 - dz) * (
        (1 - dy) * ((1 - dx) * corner(0, 0, 0) + dx * corner(1, 0, 0))
        + dy * ((1 - dx) * corner(0, 1, 0) + dx * corner(1, 1, 0))
    ) + dz * (
        (1 - dy) * ((1 - dx) * corner(0, 0, 1) + dx * corner(1, 0, 1))
        + dy * ((1 - dx) * corner(0, 1, 1) + dx * corner(1, 1, 1))
    )
    # gray: constant sigmoid(c2) = r (rgb2spec.jl:89-105)
    is_gray = (r == g) & (g == b)
    denom = torch.sqrt(torch.clamp(r * (1.0 - r), min=1e-12))
    c2_gray = torch.where((r > 0.0) & (r < 1.0), (r - 0.5) / denom,
                          torch.where(r <= 0.0, -1e10, 1e10))
    zero = torch.zeros_like(c2_gray)
    gray = torch.stack([zero, zero, c2_gray], -1)
    return torch.where(is_gray[..., None], gray, c)


def _unbounded_parts(table, rgb):
    m = rgb.amax(-1)
    scale = 2.0 * m
    ssafe = torch.where(scale == 0.0, 1.0, scale)
    coeffs = rgb_to_coeffs(table, rgb / ssafe[..., None])
    black = torch.tensor([0.0, 0.0, -1e10], device=rgb.device)
    return torch.where((m <= 0.0)[..., None], black, coeffs), scale


def rgb_albedo_eval(table, rgb, lam):
    """Reflectance spectrum of an RGB albedo in [0,1]."""
    return eval_sigmoid_poly(rgb_to_coeffs(table, rgb), lam)


def rgb_unbounded_eval(table, rgb, lam):
    """Spectrum of an unbounded positive RGB."""
    coeffs, scale = _unbounded_parts(table, rgb)
    return scale[..., None] * eval_sigmoid_poly(coeffs, lam)


def rgb_illuminant_eval(table, rgb, lam):
    """Emission spectrum of an RGB light colour: unbounded x D65(lam)."""
    return rgb_unbounded_eval(table, rgb, lam) * sample_d65(lam)


def unbounded_coeff4(table, rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) unbounded RGB -> (..., 4) [c0, c1, c2, scale]."""
    coeffs, scale = _unbounded_parts(table, torch.clamp(rgb, min=0.0))
    return torch.cat([coeffs, scale[..., None]], -1)


def albedo_coeff4(table, rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) reflectance RGB in [0,1] -> (..., 4) with scale 1."""
    coeffs = rgb_to_coeffs(table, rgb)
    return torch.cat([coeffs, torch.ones_like(coeffs[..., :1])], -1)


def coeff4_eval(coeff4: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Evaluate a precomputed [c0, c1, c2, scale] at wavelengths lam."""
    return coeff4[..., 3:4] * eval_sigmoid_poly(coeff4[..., :3], lam)


def coeff4_illuminant_eval(coeff4, lam):
    return coeff4_eval(coeff4, lam) * sample_d65(lam)
