"""Film: progressive per-pixel radiance accumulation.

Port of the accumulation part of ``hikari_tpu/film/film.py``. Each lane owns
one pixel per sample pass, so accumulation is an elementwise add; the port
updates the film's buffers in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.device import resolve_device


@dataclass
class Film:
    width: int
    height: int
    rgb_sum: torch.Tensor     # (H, W, 3) weighted linear RGB sum
    weight_sum: torch.Tensor  # (H, W) filter weight sum
    iteration: int = 0        # progressive sample counter


def make_film(width: int, height: int, device=None, crop_bounds=None) -> Film:
    """An empty film on `device` (default: the first CUDA device; without
    one this raises, and device="cpu" makes the film on the CPU)."""
    if crop_bounds is not None:
        raise NotImplementedError("film crop windows are not ported yet")
    device = resolve_device(device)
    return Film(width=width, height=height,
                rgb_sum=torch.zeros((height, width, 3), device=device),
                weight_sum=torch.zeros((height, width), device=device))


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
