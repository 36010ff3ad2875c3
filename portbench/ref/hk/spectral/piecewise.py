"""Measured metal spectra (port of ``hikari_tpu/spectral/piecewise.py``).

``metal_eta_k`` returns callables that interpolate the measured eta/k knots
in float32 with the same arithmetic as ``jnp.interp``, so the conductor
banks built from them match the JAX package's.
"""

from __future__ import annotations

import numpy as np

from .._data import load_npz


def interp_f32(x: np.ndarray, xp: np.ndarray, fp: np.ndarray) -> np.ndarray:
    """``jnp.interp`` in float32 numpy: constant extrapolation, the same
    searchsorted bracket and the same operation order."""
    x = np.asarray(x, np.float32)
    xp = np.asarray(xp, np.float32)
    fp = np.asarray(fp, np.float32)
    i = np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = np.abs(dx) <= np.spacing(np.finfo(np.float32).eps)
    q = (delta / np.where(dx0, np.float32(1), dx)).astype(np.float32)
    # XLA contracts fp + q * df into one fused multiply-add: the float32
    # product is exact in float64, so the sum rounds once, as an FMA does
    fma = (fp[i - 1].astype(np.float64)
           + q.astype(np.float64) * df.astype(np.float64)).astype(np.float32)
    f = np.where(dx0, fp[i - 1], fma)
    f = np.where(x < xp[0], fp[0], f)
    return np.where(x > xp[-1], fp[-1], f).astype(np.float32)


def metal_eta_k(metal: str):
    """(eta, k) interpolators for a metal key like 'AU'."""
    d = load_npz("metal_spectra.npz")

    def spectrum(name):
        lam, val = d[f"{name}_lam"], d[f"{name}_val"]
        return lambda x: interp_f32(x, lam, val)

    return spectrum(f"{metal}_ETA"), spectrum(f"{metal}_K")
