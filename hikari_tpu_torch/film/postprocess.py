"""Postprocessing: exposure, white balance, tonemapping, gamma, PNG output.

Port of ``hikari_tpu/film/postprocess.py`` (the reference's
postprocess.jl): FilmSensor (ISO, exposure time, white balance), the
tonemaps (reinhard, reinhard_extended, aces, uncharted2, filmic), one
non-destructive postprocess pass, and a dependency-free PNG writer whose
bytes equal the JAX package's (the same filter rows and zlib level).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from ..spectral.cie import (compute_white_balance_matrix, linear_srgb_to_xyz,
                            linear_to_srgb_gamma, xyz_to_linear_srgb)


@dataclass(frozen=True)
class FilmSensor:
    """Imaging ratio = exposure_time * iso / 100 (postprocess.jl:37-47)."""

    iso: float = 100.0
    exposure_time: float = 1.0
    white_balance_temp: float | None = None  # Kelvin; None = no white balance

    @property
    def imaging_ratio(self) -> float:
        return self.exposure_time * self.iso / 100.0


def tonemap_reinhard(c):
    return c / (1.0 + c)


def tonemap_reinhard_extended(c, white=4.0):
    return c * (1.0 + c / (white * white)) / (1.0 + c)


def tonemap_aces(c):
    """Narkowicz's ACES approximation (postprocess.jl)."""
    a, b, cc, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((c * (a * c + b)) / (c * (cc * c + d) + e), 0.0, 1.0)


def _uncharted2_curve(c):
    a, b, cc, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((c * (a * c + cc * b) + d * e) / (c * (a * c + b) + d * f)) - e / f


def tonemap_uncharted2(c, exposure_bias=2.0, w=11.2):
    white_scale = 1.0 / _uncharted2_curve(torch.tensor(w, dtype=torch.float32))
    return _uncharted2_curve(c * exposure_bias) * white_scale.to(c.device)


def tonemap_filmic(c):
    c = torch.clamp(c - 0.004, min=0.0)
    return (c * (6.2 * c + 0.5)) / (c * (6.2 * c + 1.7) + 0.06)


_TONEMAPS = {
    "none": lambda c: c,
    "clamp": lambda c: torch.clamp(c, 0.0, 1.0),
    "reinhard": tonemap_reinhard,
    "reinhard_extended": tonemap_reinhard_extended,
    "aces": tonemap_aces,
    "uncharted2": tonemap_uncharted2,
    "filmic": tonemap_filmic,
}


def postprocess(rgb: torch.Tensor, exposure: float = 1.0, tonemap: str = "aces",
                gamma: bool = True, sensor: FilmSensor | None = None) -> torch.Tensor:
    """Exposure -> white balance -> tonemap -> sRGB gamma, into a new image
    clipped to [0, 1] (postprocess_kernel!, postprocess.jl:187-357)."""
    if tonemap not in _TONEMAPS:
        raise ValueError(f"tonemap {tonemap!r}: expected one of {sorted(_TONEMAPS)}")
    out = rgb * exposure
    if sensor is not None:
        out = out * sensor.imaging_ratio
        if sensor.white_balance_temp is not None:
            wb = compute_white_balance_matrix(sensor.white_balance_temp).to(out.device)
            xyz = linear_srgb_to_xyz(out)
            out = xyz_to_linear_srgb((wb * xyz[..., None, :]).sum(-1))
    out = _TONEMAPS[tonemap](torch.clamp(out, min=0.0))
    if gamma:
        out = linear_to_srgb_gamma(out)
    return torch.clamp(out, 0.0, 1.0)


def write_png(path, rgb) -> None:
    """Save an (H, W, 3) float image in [0, 1] (a tensor on any device, or
    an array) as an 8-bit RGB PNG."""
    if isinstance(rgb, torch.Tensor):
        rgb = rgb.detach().cpu().numpy()
    arr = (np.clip(np.asarray(rgb), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
