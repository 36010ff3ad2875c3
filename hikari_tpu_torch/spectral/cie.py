"""CIE colorimetry: XYZ matching functions, D65, XYZ <-> linear sRGB, the
sRGB gamma and Bradford white balance.

Port of ``hikari_tpu/spectral/cie.py`` on the render and postprocess
paths. The matching functions and D65 are evaluated through the same
piecewise-cubic fits as the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._data import load_npz
from ..utils import profiling
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
    return _apply(_SRGB_FROM_XYZ, xyz)


_XYZ_FROM_SRGB = (
    (0.4124564, 0.3575761, 0.1804375),
    (0.2126729, 0.7151522, 0.0721750),
    (0.0193339, 0.1191920, 0.9503041),
)


def _apply(m, v: torch.Tensor) -> torch.Tensor:
    """(..., 3) vectors through a 3x3 matrix."""
    m = torch.as_tensor(m, dtype=torch.float32, device=v.device)
    profiling.host_sync("cie.matrix", v.device)
    return (m * v[..., None, :]).sum(-1)


def linear_srgb_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
    return _apply(_XYZ_FROM_SRGB, rgb)



def linear_to_srgb_gamma(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, min=0.0)
    return torch.where(c <= 0.0031308, 12.92 * c, 1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


# Bradford chromatic adaptation (color.jl:448-553)
_LMS_FROM_XYZ = np.array([[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367],
                          [0.0389, -0.0685, 1.0296]], np.float32)
_XYZ_FROM_LMS = np.array([[0.9869929, -0.1470543, 0.1599627],
                          [0.4323053, 0.5183603, 0.0492912],
                          [-0.0085287, 0.0400428, 0.9684867]], np.float32)
D65_WHITE_XY = (0.31272, 0.32903)


def _xy_to_xyz(x, y) -> np.ndarray:
    x, y = np.float32(x), np.float32(y)
    return np.array([x / y, 1.0, (np.float32(1.0) - x - y) / y], np.float32)


def planckian_xy(temp: float):
    """CIE xy of a blackbody radiator, 1667 K - 25000 K (color.jl:470-520)."""
    t = np.float32(temp)
    t2, t3 = t * t, t * t * t
    if t < 4000.0:
        x = -0.2661239e9 / t3 - 0.2343589e6 / t2 + 0.8776956e3 / t + 0.179910
    else:
        x = -3.0258469e9 / t3 + 2.1070379e6 / t2 + 0.2226347e3 / t + 0.240390
    x = np.float32(x)
    x2, x3 = x * x, x * x * x
    if t < 2222.0:
        y = -1.1063814 * x3 - 1.34811020 * x2 + 2.18555832 * x - 0.20219683
    elif t < 4000.0:
        y = -0.9549476 * x3 - 1.37418593 * x2 + 2.09137015 * x - 0.16748867
    else:
        y = 3.0817580 * x3 - 5.87338670 * x2 + 3.75112997 * x - 0.37001483
    return x, np.float32(y)


def _fma_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 a @ b with each dot product a chain of fused multiply-adds
    in column order, as XLA computes the JAX package's 3x3 products on the
    CPU (a float64 product of two float32 values is exact)."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    acc = (a64[:, :1] * b64[:1]).astype(np.float32)
    for k in range(1, a.shape[1]):
        acc = (a64[:, k:k + 1] * b64[k:k + 1] + acc).astype(np.float32)
    return acc


def compute_white_balance_matrix(src_temp: float) -> torch.Tensor:
    """Bradford matrix from a source colour temperature's white to D65
    (color.jl:522-553), (3, 3) on the CPU."""
    src = _fma_matmul(_LMS_FROM_XYZ, _xy_to_xyz(*planckian_xy(src_temp))[:, None])[:, 0]
    dst = _fma_matmul(_LMS_FROM_XYZ, _xy_to_xyz(*D65_WHITE_XY)[:, None])[:, 0]
    scale = np.diag((dst / src).astype(np.float32))
    return torch.from_numpy(_fma_matmul(_fma_matmul(_XYZ_FROM_LMS, scale), _LMS_FROM_XYZ))
