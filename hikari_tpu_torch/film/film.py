"""Film: progressive per-pixel radiance accumulation.

Port of the accumulation part of ``hikari_tpu/film/film.py``, with its
crop windows. Each lane owns one pixel per sample pass, so accumulation is
an elementwise add; the port updates the film's buffers in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core.device import resolve_device


@dataclass
class Film:
    width: int                # crop-window width == buffer width
    height: int
    full_width: int           # full image resolution (== width uncropped)
    full_height: int
    crop_x0: int              # crop-window origin, full-image pixels
    crop_y0: int
    rgb_sum: torch.Tensor     # (H, W, 3) weighted linear RGB sum
    weight_sum: torch.Tensor  # (H, W) filter weight sum
    iteration: int = 0        # progressive sample counter


def _crop_span(res: int, lo: float, hi: float, axis: str) -> tuple[int, int]:
    """[ceil(res * lo), ceil(res * hi)) of one axis, as (origin, size)."""
    if not (0.0 <= lo <= 1.0 and 0.0 <= hi <= 1.0):
        raise ValueError(f"crop_bounds {axis}: [{lo}, {hi}] is not inside [0, 1]")
    p0, p1 = math.ceil(res * lo), math.ceil(res * hi)
    if p1 <= p0:
        raise ValueError(f"crop_bounds {axis}: [{lo}, {hi}] of {res} pixels covers no pixel")
    return p0, p1 - p0


def make_film(width: int, height: int, device=None, crop_bounds=None) -> Film:
    """An empty film on `device` (default: the first CUDA device; without
    one this raises, and device="cpu" makes the film on the CPU).

    crop_bounds: optional normalised ((x0, y0), (x1, y1)) render window in
    [0, 1]: only its pixels are rendered and stored, and ``framebuffer``
    returns the window's image. Pixel bounds follow pbrt, [ceil(res * lo),
    ceil(res * hi)), so adjacent crops tile exactly. A window that covers
    no pixel raises ValueError (the JAX package renders one pixel)."""
    device = resolve_device(device)
    x0 = y0 = 0
    w, h = width, height
    if crop_bounds is not None:
        (bx0, by0), (bx1, by1) = crop_bounds
        x0, w = _crop_span(width, float(bx0), float(bx1), "x")
        y0, h = _crop_span(height, float(by0), float(by1), "y")
    return Film(width=w, height=h, full_width=width, full_height=height, crop_x0=x0,
                crop_y0=y0, rgb_sum=torch.zeros((h, w, 3), device=device),
                weight_sum=torch.zeros((h, w), device=device))


def film_add_weighted(film: Film, rgb_weighted: torch.Tensor,
                      weight: torch.Tensor, n_samples: int = 1) -> Film:
    """Accumulate pre-weighted contributions (sum of rgb_i * w_i and of w_i
    over a batch of n_samples samples), in place."""
    film.rgb_sum += rgb_weighted
    film.weight_sum += weight
    film.iteration += n_samples
    return film


def film_add_sample(film: Film, rgb: torch.Tensor, weight: torch.Tensor) -> Film:
    """Accumulate one sample per pixel. rgb: (H, W, 3), weight: (H, W)."""
    return film_add_weighted(film, rgb * weight[..., None], weight)


def framebuffer(film: Film) -> torch.Tensor:
    """Weighted-average linear RGB image (H, W, 3) (film.jl:355-387)."""
    return film.rgb_sum / torch.clamp(film.weight_sum, min=1e-8)[..., None]
