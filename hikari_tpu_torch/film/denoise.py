"""Edge-avoiding a-trous wavelet denoiser (SVGF-style).

Port of ``hikari_tpu/film/denoise.py`` (the reference's denoise.jl):
DenoiseConfig (iterations, sigma_color / normal / depth, use_variance,
albedo demodulation), a 3x3 luminance-variance estimate, and a 5x5
B3-spline kernel dilated 2^i at pass i, weighted by luminance, normal and
depth edges. Each tap is an edge-clamped shift of the whole image.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_B3 = np.array([1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16], np.float32)


@dataclass(frozen=True)
class DenoiseConfig:
    iterations: int = 4
    sigma_color: float = 4.0
    sigma_normal: float = 128.0
    sigma_depth: float = 1.0
    use_variance: bool = True
    demodulate_albedo: bool = True


def _shift2d(img, dy: int, dx: int):
    """img[y - dy, x - dx] with edges clamped; img (H, W, C) or (H, W)."""
    h, w = img.shape[:2]
    ys = torch.clamp(torch.arange(h, device=img.device) - dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) - dx, 0, w - 1)
    return img[ys][:, xs]


def _luminance(rgb):
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def estimate_variance(color):
    """Local 3x3 luminance variance (denoise.jl's variance estimate)."""
    lum = _luminance(color)
    s = torch.zeros_like(lum)
    s2 = torch.zeros_like(lum)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            v = _shift2d(lum, dy, dx)
            s = s + v
            s2 = s2 + v * v
    mean = s / 9.0
    return torch.clamp(s2 / 9.0 - mean * mean, min=0.0)


def atrous_pass(color, variance, normal, depth, step: int, cfg: DenoiseConfig):
    """One edge-avoiding a-trous pass at dilation `step`: (color, variance)."""
    lum_c = _luminance(color)
    acc = torch.zeros_like(color)
    acc_v = torch.zeros_like(lum_c)
    wsum = torch.zeros_like(lum_c)
    sig_c2 = cfg.sigma_color ** 2
    eps = 1e-6
    var_term = torch.sqrt(variance + eps) if cfg.use_variance else 1.0
    bg_c = (normal * normal).sum(-1) < 1e-6
    for iy in range(5):
        for ix in range(5):
            dy, dx = (iy - 2) * step, (ix - 2) * step
            k = float(_B3[iy] * _B3[ix])
            c_q = _shift2d(color, dy, dx)
            v_q = _shift2d(variance, dy, dx)
            n_q = _shift2d(normal, dy, dx)
            z_q = _shift2d(depth, dy, dx)
            # colour: the variance-normalised luminance difference
            w_c = torch.exp(-torch.abs(_luminance(c_q) - lum_c) / (sig_c2 * var_term + eps))
            # normal: background pixels (no hit, zero normal) blend only with
            # each other, and never vanish to zero weight
            ndot = torch.clamp((n_q * normal).sum(-1), min=0.0)
            bg_q = (n_q * n_q).sum(-1) < 1e-6
            w_n = torch.where(bg_c | bg_q, (bg_c & bg_q).to(ndot.dtype),
                              ndot ** cfg.sigma_normal)
            w_z = torch.exp(-torch.abs(z_q - depth)
                            / (cfg.sigma_depth * (abs(dy) + abs(dx) + eps)))
            wgt = k * w_c * w_n * w_z
            acc = acc + c_q * wgt[..., None]
            acc_v = acc_v + v_q * wgt * wgt
            wsum = wsum + wgt
    return (acc / torch.clamp(wsum, min=eps)[..., None],
            acc_v / torch.clamp(wsum * wsum, min=eps))


def denoise(color, albedo, normal, depth, cfg: DenoiseConfig = DenoiseConfig()):
    """Full denoise (denoise!, denoise.jl:301-384) of linear-RGB images
    (H, W, 3) with the aux buffers (H, W, 3), (H, W, 3), (H, W); returns the
    filtered colour."""
    eps = 1e-3
    work = color / torch.clamp(albedo, min=eps) if cfg.demodulate_albedo else color
    var = (estimate_variance(work) if cfg.use_variance
           else torch.zeros(color.shape[:2], device=color.device))
    for i in range(cfg.iterations):
        work, var = atrous_pass(work, var, normal, depth, 1 << i, cfg)
    if cfg.demodulate_albedo:
        work = work * torch.clamp(albedo, min=eps)
    return work
