"""sRGB -> spectrum table generator: a batched float64 Gauss-Newton solve.

Port of ``hikari_tpu/spectral/rgb2spec_gen.py`` (pbrt-v4's rgb2spec_opt
pipeline). For each of the 3 * res^2 cells (l, j, i) of the table, the
sigmoid-polynomial coefficients are fitted so that the spectrum's sRGB,
integrated against CIE 1931 under D65, matches the target in Lab; the
brightness axis z is walked sequentially with warm starts from
``res // 5``, forward to ``res - 1`` and backward to 0. All cells go
through each Gauss-Newton iteration as one batch on the device, in
float64; the 3x3 Jacobian is written out (the JAX package takes it by
forward-mode autodiff).

``generate_table`` returns ``(scale, coeffs)`` in the layout
``rgb2spec.RGBToSpectrumTable`` reads and saves them to an ``.npz``; the
render path reads the shipped table ``data/srgb_spectrum_table.npz``,
never this module's output. ``compare_tables`` and ``lab_round_trip``
hold a generated table against another and against its own grid.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from .._data import DATA_DIR, data_path
from ..core.device import resolve_device

CIE_LAMBDA_MIN = 360.0
CIE_LAMBDA_MAX = 830.0

XYZ_TO_SRGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ]
)
SRGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)
COEFF_LIMIT = 200.0  # a step's largest coefficient is scaled back to this
LAB_DELTA = 6.0 / 29.0
# the wavelengths at which compare_tables evaluates two tables' spectra
COMPARE_LAMBDA = np.linspace(CIE_LAMBDA_MIN, CIE_LAMBDA_MAX, 95)


def _init_tables():
    """Simpson-3/8 integration weights against CMF * D65 (rgb2spec_gen.jl:171-212)."""
    cie = np.load(data_path("cie_xyz.npz"))
    d65 = np.load(data_path("illuminant_d65.npz"))
    n_fine = 94 * 3 + 1
    h = (CIE_LAMBDA_MAX - CIE_LAMBDA_MIN) / (n_fine - 1)
    lam = CIE_LAMBDA_MIN + np.arange(n_fine) * h

    grid = np.arange(360, 831, dtype=np.float64)
    xyz = np.stack(
        [np.interp(lam, grid, cie[k].astype(np.float64)) for k in ("x", "y", "z")]
    )  # (3, n)
    illum = np.interp(lam, d65["lam"].astype(np.float64), d65["val"].astype(np.float64))

    w = np.full(n_fine, 3.0 / 8.0 * h)
    idx = np.arange(n_fine)
    inner = (idx != 0) & (idx != n_fine - 1)
    w = np.where(inner & ((idx - 2) % 3 == 2), w * 2.0, np.where(inner, w * 3.0, w))

    rgb_weights = XYZ_TO_SRGB @ (xyz * illum * w)  # (3, n)
    xyz_whitepoint = (xyz * illum * w).sum(axis=1)  # (3,)
    # normalize so the whitepoint has unit luminance (the reference bakes this
    # into CIE_D65 via CIE_D65_NORM)
    norm = xyz_whitepoint[1]
    return lam, rgb_weights / norm, xyz_whitepoint / norm


def device_tables(device) -> dict:
    """_init_tables() as float64 tensors on `device`: the normalised
    wavelengths' powers (3, n) (lambda^2, lambda, 1), the RGB weights
    (3, n), the white point (3,) and SRGB_TO_XYZ."""
    lam, rgb_weights, whitepoint = _init_tables()
    f64 = dict(dtype=torch.float64, device=device)
    ln = torch.tensor((lam - CIE_LAMBDA_MIN) / (CIE_LAMBDA_MAX - CIE_LAMBDA_MIN), **f64)
    return {"powers": torch.stack([ln ** 2, ln, torch.ones_like(ln)]),
            "rgb_w": torch.tensor(rgb_weights, **f64), "wp": torch.tensor(whitepoint, **f64),
            "to_xyz": torch.tensor(SRGB_TO_XYZ, **f64)}


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    """The real cube root, as XLA computes jnp.cbrt: copysign(|t|^(1/3), t)."""
    return torch.copysign(t.abs().pow(1.0 / 3.0), t)


def _lab_f(t: torch.Tensor):
    """CIE Lab's f(t) and f'(t); both branches are evaluated and one is
    selected per element (at t = 0 the cube root's derivative is inf)."""
    d = LAB_DELTA
    cube = t > d ** 3
    c = _cbrt(t)
    f = torch.where(cube, c, t / (3 * d * d) + 4.0 / 29.0)
    df = torch.where(cube, 1.0 / (3.0 * c * c), torch.full_like(t, 1.0 / (3 * d * d)))
    return f, df


def rgb_to_lab(rgb: torch.Tensor, tables: dict, jacobian: torch.Tensor | None = None):
    """Lab of linear sRGB (N, 3); with `jacobian` (N, 3, K), the RGB's
    derivatives, also Lab's (N, 3, K) by the chain rule."""
    xyz = rgb @ tables["to_xyz"].T / tables["wp"]
    f, df = _lab_f(xyz)
    fx, fy, fz = f.unbind(-1)
    lab = torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], -1)
    if jacobian is None:
        return lab
    dxyz = tables["to_xyz"] @ jacobian / tables["wp"][:, None]  # (N, 3, K)
    dfx, dfy, dfz = (df[:, k, None] * dxyz[:, k] for k in range(3))
    return lab, torch.stack([116.0 * dfy, 500.0 * (dfx - dfy), 200.0 * (dfy - dfz)], 1)


def residual_and_jacobian(coeffs: torch.Tensor, target_lab: torch.Tensor, tables: dict):
    """Lab(target) - Lab(spectrum's RGB) of normalised-lambda coefficients
    (N, 3), and its Jacobian with respect to them (N, 3, 3)."""
    x = coeffs @ tables["powers"]  # (N, n)
    q = torch.sqrt(1.0 + x * x)
    s = 0.5 + x / (2.0 * q)
    ds = 1.0 / (2.0 * q * q * q)
    rgb = s @ tables["rgb_w"].T  # (N, 3)
    # d rgb_r / d c_k = sum_n rgb_w[r, n] ds[n] powers[k, n]
    drgb = torch.einsum("rn,Nn,kn->Nrk", tables["rgb_w"], ds, tables["powers"])
    lab, dlab = rgb_to_lab(rgb, tables, drgb)
    return target_lab - lab, -dlab


def gn_step(coeffs: torch.Tensor, target_lab: torch.Tensor, tables: dict) -> torch.Tensor:
    """One Gauss-Newton iteration of every cell: solve J step = r, take
    coeffs - step scaled back to COEFF_LIMIT; a cell whose Jacobian is
    singular or whose step is not finite keeps its coefficients (the JAX
    package's solve returns inf / nan there, which it rejects)."""
    r, jac = residual_and_jacobian(coeffs, target_lab, tables)
    step, info = torch.linalg.solve_ex(jac, r[..., None], check_errors=False)
    new = coeffs - step[..., 0]
    m = new.abs().amax(-1, keepdim=True)
    new = torch.where(m > COEFF_LIMIT, new * (COEFF_LIMIT / m), new)
    ok = (info == 0) & torch.isfinite(new).all(-1)
    return torch.where(ok[:, None], new, coeffs)


def remap(c: torch.Tensor) -> torch.Tensor:
    """Normalised-lambda coefficients (..., 3) -> absolute-nm (rgb2spec_gen.jl:372-377)."""
    c0n = CIE_LAMBDA_MIN
    c1n = 1.0 / (CIE_LAMBDA_MAX - CIE_LAMBDA_MIN)
    a, b, c = c.unbind(-1)
    return torch.stack([a * c1n ** 2, b * c1n - 2 * a * c0n * c1n ** 2,
                        c - b * c0n * c1n + a * (c0n * c1n) ** 2], -1)


def scale_axis(res: int) -> np.ndarray:
    """The brightness axis: a double smoothstep of k / (res - 1) (rgb2spec_gen.jl:336)."""
    def smoothstep(x):
        return x * x * (3.0 - 2.0 * x)

    return smoothstep(smoothstep(np.arange(res) / (res - 1)))


def cell_targets(res: int, device) -> tuple:
    """(l, x, y) of the 3 * res^2 cells in (l, j, i) order, x = i / (res - 1)
    and y = j / (res - 1), and the gather index (N, 3) that places b, x * b
    and y * b at RGB positions l, l + 1 and l + 2 (mod 3)."""
    l_idx, j_idx, i_idx = np.meshgrid(np.arange(3), np.arange(res), np.arange(res),
                                      indexing="ij")
    f64 = dict(dtype=torch.float64, device=device)
    l_ = torch.tensor(l_idx.reshape(-1), device=device)
    x = torch.tensor(i_idx.reshape(-1) / (res - 1), **f64)
    y = torch.tensor(j_idx.reshape(-1) / (res - 1), **f64)
    # RGB channel p holds value (p - l) mod 3 of (b, x * b, y * b)
    order = (torch.arange(3, device=device)[None, :] - l_[:, None]) % 3
    return l_, x, y, order


def target_rgb(x: torch.Tensor, y: torch.Tensor, order: torch.Tensor, b: float):
    """Each cell's target RGB at brightness b (cell_targets' gather)."""
    vals = torch.stack([torch.full_like(x, b), x * b, y * b], -1)
    return torch.gather(vals, 1, order)


def generate_table(res: int = 64, max_iter: int = 15, verbose: bool = True, device=None,
                   path=None):
    """The sRGB -> spectrum table at `res`: (scale (res,) float64, coeffs
    (3, res, res, res, 3) float32 in (l, z, j, i, c) order), computed on
    `device` (the card unless given) and saved as res / scale (float32) /
    coeffs to `path` (this package's data/srgb_spectrum_table.npz when
    None, as the JAX package writes its own)."""
    dev = resolve_device(device)
    tables = device_tables(dev)
    scale = scale_axis(res)
    _, x, y, order = cell_targets(res, dev)
    n = x.shape[0]
    start_k = res // 5
    t0 = time.perf_counter()
    if verbose:
        print(f"optimizing {n} cells x {res} z-steps on {dev} ...", flush=True)
    out = torch.zeros((res, n, 3), dtype=torch.float64, device=dev)
    # forward pass k = start_k .. res-1, then backward k = start_k .. 0, each
    # from zero coefficients with warm starts; the backward pass overwrites
    # k = start_k (as the reference does)
    for ks in (range(start_k, res), range(start_k, -1, -1)):
        coeffs = torch.zeros((n, 3), dtype=torch.float64, device=dev)
        for k in ks:
            target_lab = rgb_to_lab(target_rgb(x, y, order, float(scale[k])), tables)
            for _ in range(max_iter):
                coeffs = gn_step(coeffs, target_lab, tables)
            out[k] = remap(coeffs)
    coeffs = (out.reshape(res, 3, res, res, 3).permute(1, 0, 2, 3, 4)
              .to(torch.float32).cpu().numpy())  # (l, z, j, i, c)
    path = DATA_DIR / "srgb_spectrum_table.npz" if path is None else Path(path)
    np.savez(path, res=np.int32(res), scale=scale.astype(np.float32), coeffs=coeffs)
    if verbose:
        print(f"saved {path} ({time.perf_counter() - t0:.2f} s)", flush=True)
    return scale, coeffs


def table_spectra(coeffs, lam_nm=COMPARE_LAMBDA, device=None) -> torch.Tensor:
    """sigmoid(c0 lambda^2 + c1 lambda + c2) of every cell's absolute-nm
    coefficients (..., 3) at the wavelengths lam_nm, in float64:
    (..., len(lam_nm)), on `device` (the card unless given)."""
    c = torch.as_tensor(coeffs, device=resolve_device(device)).to(torch.float64)
    lam = torch.as_tensor(np.asarray(lam_nm, np.float64), device=c.device)
    x = c[..., 0:1] * lam * lam + c[..., 1:2] * lam + c[..., 2:3]
    return 0.5 + x / (2.0 * torch.sqrt(1.0 + x * x))


def compare_tables(coeffs, reference, device=None) -> dict:
    """Two tables' coefficients (3, res, res, res, 3) against each other:
    the largest difference of their spectra (table_spectra at
    COMPARE_LAMBDA) over every cell, the cells whose spectra differ by
    more than 1e-4, the shares of float32 coefficients that are bit-equal
    and that are within one float32 ulp of each other, and the largest
    coefficient difference. The spectra are computed on `device` (the card
    unless given)."""
    dev = resolve_device(device)
    a, b = np.asarray(coeffs, np.float32), np.asarray(reference, np.float32)
    if a.shape != b.shape:
        raise ValueError(f"tables of shapes {a.shape} and {b.shape}")
    diff = (table_spectra(a, device=dev) - table_spectra(b, device=dev)).abs().amax(-1)
    return {"cells": int(diff.numel()), "max_spectrum_diff": float(diff.max()),
            "cells_over_1e-4": int((diff > 1e-4).sum()),
            "bit_equal_share": float((a.view(np.int32) == b.view(np.int32)).mean()),
            "ulp_equal_share": float((np.abs(a - b) <= np.spacing(np.maximum(np.abs(a),
                                                                               np.abs(b))))
                                     .mean()),
            "max_coeff_diff": float(np.abs(a.astype(np.float64) - b).max())}


def lab_round_trip(scale, coeffs, device=None) -> torch.Tensor:
    """The Lab distance (Delta E 1976) of every cell of a table
    (3, res, res, res, 3), (l, z, j, i) order: its absolute-nm spectrum
    integrated against CIE 1931 under D65 (the generator's weights) back
    to sRGB, against the cell's grid RGB, computed on `device` (the card
    unless given)."""
    dev = resolve_device(device)
    tables = device_tables(dev)
    c = torch.as_tensor(coeffs, device=dev).to(torch.float64)
    res = c.shape[1]
    lam, _, _ = _init_tables()
    s = table_spectra(c.permute(0, 2, 3, 1, 4).reshape(-1, res, 3), lam, dev)  # (N, z, n)
    rgb = s @ tables["rgb_w"].T  # (N, z, 3), cells in (l, j, i) order
    _, x, y, order = cell_targets(res, dev)
    target = torch.stack([target_rgb(x, y, order, float(b)) for b in np.asarray(scale)], 1)
    lab_out = rgb_to_lab(rgb.reshape(-1, 3), tables)
    lab_ref = rgb_to_lab(target.reshape(-1, 3), tables)
    return (lab_out - lab_ref).norm(dim=-1).reshape(3, res, res, res).permute(0, 3, 1, 2)


if __name__ == "__main__":
    generate_table()
