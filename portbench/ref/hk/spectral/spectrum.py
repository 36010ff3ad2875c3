"""Hero-wavelength sampling (port of ``hikari_tpu/spectral/spectrum.py``).

A sampled spectrum is a ``(..., 4)`` float32 tensor, one value per hero
wavelength.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

LAMBDA_MIN_VISIBLE = 360.0
LAMBDA_MAX_VISIBLE = 830.0


@dataclass
class SampledWavelengths:
    lam: torch.Tensor  # (..., 4) wavelengths in nm
    pdf: torch.Tensor  # (..., 4) per-wavelength sampling pdf


def visible_wavelengths_pdf(lam: torch.Tensor) -> torch.Tensor:
    """sech^2 pdf centred at 538 nm (spectral.jl:192-201)."""
    pdf = 0.0039398042 / torch.square(torch.cosh(0.0072 * (lam - 538.0)))
    in_range = (lam >= LAMBDA_MIN_VISIBLE) & (lam <= LAMBDA_MAX_VISIBLE)
    return torch.where(in_range, pdf, 0.0)


def sample_visible_wavelength(u: torch.Tensor) -> torch.Tensor:
    """Inverse CDF of the sech^2 distribution (spectral.jl:210-213)."""
    return 538.0 - 138.888889 * torch.atanh(0.85691062 - 1.82750197 * u)


def sample_wavelengths_visible(u: torch.Tensor) -> SampledWavelengths:
    """4 hero wavelengths by visible importance sampling (spectral.jl:221-249)."""
    offs = torch.arange(4, dtype=torch.float32, device=u.device) * 0.25
    ui = u[..., None] + offs
    ui = torch.where(ui >= 1.0, ui - 1.0, ui)
    lam = sample_visible_wavelength(ui)
    return SampledWavelengths(lam, visible_wavelengths_pdf(lam))


def max_component(s: torch.Tensor) -> torch.Tensor:
    return s.amax(-1)
