"""CIE colorimetry: XYZ matching functions, D65, XYZ -> linear sRGB.

Port of the parts of ``hikari_tpu/spectral/cie.py`` on the render path. The
matching functions and D65 are evaluated through the same piecewise-cubic
fits as the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._data import load_npz
from .piecewise_poly import fit_piecewise_poly, piecewise_eval

CIE_LAMBDA_MIN = 360.0
CIE_LAMBDA_MAX = 830.0
D65_PHOTOMETRIC = 10567.0  # photometric normalization of D65 (color.jl:16)


@functools.cache
def cie_tables() -> np.ndarray:
    """(3, 471) xbar/ybar/zbar at 1 nm from 360 to 830."""
    z = load_npz("cie_xyz.npz")
    return np.stack([z["x"], z["y"], z["z"]]).astype(np.float32)


@functools.cache
def d65_table() -> np.ndarray:
    """D65 resampled to 1 nm over [360, 830]."""
    z = load_npz("illuminant_d65.npz")
    lam_grid = np.arange(360, 831, dtype=np.float64)
    return np.interp(lam_grid, z["lam"].astype(np.float64),
                     z["val"].astype(np.float64)).astype(np.float32)


@functools.cache
def _cie_fits_np():
    t = cie_tables()
    return (np.stack([fit_piecewise_poly(t[i], 32) for i in range(3)]),
            fit_piecewise_poly(d65_table(), 64))


@functools.cache
def _cie_fits(device: torch.device):
    xyz, d65 = _cie_fits_np()
    return (torch.from_numpy(xyz).to(device), torch.from_numpy(d65).to(device))


def _in_range(lam):
    return (lam >= CIE_LAMBDA_MIN) & (lam <= CIE_LAMBDA_MAX)


def sample_cie_xyz(lam: torch.Tensor) -> torch.Tensor:
    """xbar/ybar/zbar at wavelengths lam (..., 4) -> (..., 4, 3)."""
    xyz, _ = _cie_fits(lam.device)
    out = torch.stack([piecewise_eval(xyz[i], lam) for i in range(3)], dim=-1)
    return torch.where(_in_range(lam)[..., None], out, 0.0)


def sample_d65(lam: torch.Tensor) -> torch.Tensor:
    _, d65 = _cie_fits(lam.device)
    return torch.where(_in_range(lam), piecewise_eval(d65, lam), 0.0)


def spectral_to_xyz(L: torch.Tensor, lam: torch.Tensor, pdf: torch.Tensor):
    """Monte-Carlo XYZ from hero samples (color.jl:415-439); like the
    reference, not divided by CIE_Y_INTEGRAL."""
    cmf = sample_cie_xyz(lam)
    w = torch.where(pdf != 0.0, 1.0 / torch.where(pdf == 0.0, 1.0, pdf), 0.0)
    return (cmf * (L * w)[..., None]).mean(-2)


_SRGB_FROM_XYZ = (
    (3.2404542, -1.5371385, -0.4985314),
    (-0.9692660, 1.8760108, 0.0415560),
    (0.0556434, -0.2040259, 1.0572252),
)


def xyz_to_linear_srgb(xyz: torch.Tensor) -> torch.Tensor:
    m = torch.tensor(_SRGB_FROM_XYZ, dtype=torch.float32, device=xyz.device)
    return (m * xyz[..., None, :]).sum(-1)
