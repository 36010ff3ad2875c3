"""Piecewise-cubic spectra (port of ``hikari_tpu/spectral/piecewise_poly.py``).

Dense 1 nm tables over [360, 830] nm are fit once on the host (the same
numpy least squares as the JAX package, so the coefficients are identical)
and evaluated per lane with one coefficient gather and Horner's rule.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.lookup import gather_rows

LAM0 = 360.0
LAM1 = 830.0


def fit_piecewise_poly(vals: np.ndarray, nseg: int, deg: int = 3) -> np.ndarray:
    """Least-squares fit of a 1 nm [360, 830] table to nseg uniform segments
    of degree-deg polynomials in t in [0, 1). Returns (nseg, deg+1)
    highest-power-first coefficients."""
    vals = np.asarray(vals, np.float64)
    n = len(vals)
    xs = np.arange(n)
    bounds = np.linspace(0, n - 1, nseg + 1)
    out = np.zeros((nseg, deg + 1), np.float64)
    for s in range(nseg):
        a = int(np.floor(bounds[s]))
        b = int(np.ceil(bounds[s + 1])) + 1
        t = (xs[a:b] - bounds[s]) / (bounds[s + 1] - bounds[s])
        out[s] = np.polyfit(t, vals[a:b], deg)
    return out.astype(np.float32)


def piecewise_eval(coeffs: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Evaluate a (S, D) piecewise polynomial at wavelengths lam (...,)."""
    S, D = coeffs.shape
    x = torch.clamp((lam - LAM0) / (LAM1 - LAM0), 0.0, 1.0 - 1e-7) * S
    seg = x.to(torch.int64)
    t = x - seg.to(torch.float32)
    c = gather_rows(coeffs.to(lam.device), seg)  # (..., D)
    acc = c[..., 0]
    for d in range(1, D):
        acc = acc * t + c[..., d]
    return acc


def piecewise_eval_banked(coeffs: torch.Tensor, idx: torch.Tensor,
                          lam: torch.Tensor) -> torch.Tensor:
    """(M, S, D) per-bank-row piecewise polynomials, row idx (...,) selected
    per lane, evaluated at lam (...,). Rows outside [0, M) read row 0, as in
    the JAX where-chain."""
    M, S, D = coeffs.shape
    idx = torch.where((idx >= 0) & (idx < M), idx, 0).long()
    x = torch.clamp((lam - LAM0) / (LAM1 - LAM0), 0.0, 1.0 - 1e-7) * S
    seg = x.to(torch.int64)
    t = x - seg.to(torch.float32)
    c = gather_rows(coeffs.reshape(M * S, D), torch.add(seg, idx, alpha=S))  # (..., D)
    acc = c[..., 0]
    for d in range(1, D):
        acc = acc * t + c[..., d]
    return acc
