"""Film: progressive per-pixel radiance accumulation and the aux buffers.

Port of ``hikari_tpu/film/film.py``, with its crop windows, the
denoiser's albedo / normal / depth buffers and the ``.npz`` checkpoint
(the JAX package's keys, so a film saved by either package loads in the
other and a render resumes from it). Each lane owns one pixel per sample
pass, so accumulation is an elementwise add; the port updates the film's
buffers in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device
from ..utils import profiling


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
    # aux buffers for denoising (film.jl:410-483)
    albedo: torch.Tensor      # (H, W, 3)
    normal: torch.Tensor      # (H, W, 3)
    depth: torch.Tensor       # (H, W)
    aux_weight: torch.Tensor  # (H, W)
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

    def z(*c):
        return torch.zeros((h, w) + c, device=device)

    return Film(width=w, height=h, full_width=width, full_height=height, crop_x0=x0,
                crop_y0=y0, rgb_sum=z(3), weight_sum=z(), albedo=z(3), normal=z(3),
                depth=z(), aux_weight=z())


@profiling.spanned("hikari.film")
def film_add_weighted(film: Film, rgb_weighted: torch.Tensor,
                      weight: torch.Tensor, n_samples: int = 1) -> Film:
    """Accumulate pre-weighted contributions (sum of rgb_i * w_i and of w_i
    over a batch of n_samples samples), in place."""
    film.rgb_sum += rgb_weighted
    film.weight_sum += weight
    film.iteration += n_samples
    return film


@profiling.spanned("hikari.film")
def film_add_sample(film: Film, rgb: torch.Tensor, weight: torch.Tensor) -> Film:
    """Accumulate one sample per pixel. rgb: (H, W, 3), weight: (H, W)."""
    return film_add_weighted(film, rgb * weight[..., None], weight)


def film_add_aux(film: Film, albedo, normal, depth, weight) -> Film:
    """Accumulate aux samples (H, W, 3), (H, W, 3), (H, W) with weights (H,
    W), in place."""
    film.albedo += albedo * weight[..., None]
    film.normal += normal * weight[..., None]
    film.depth += depth * weight
    film.aux_weight += weight
    return film


@profiling.spanned("hikari.film")
def framebuffer(film: Film) -> torch.Tensor:
    """Weighted-average linear RGB image (H, W, 3) (film.jl:355-387)."""
    return film.rgb_sum / torch.clamp(film.weight_sum, min=1e-8)[..., None]


def aux_buffers(film: Film):
    """(albedo, normal, depth) weighted averages of the aux buffers."""
    w = torch.clamp(film.aux_weight, min=1e-8)
    return film.albedo / w[..., None], film.normal / w[..., None], film.depth / w


_ARRAYS = ("rgb_sum", "weight_sum", "albedo", "normal", "depth", "aux_weight")
_WINDOW = ("full_width", "full_height", "crop_x0", "crop_y0")


def film_save(path, film: Film) -> None:
    """Checkpoint the film as .npz (the JAX package's keys): progressive
    accumulation is the resume mechanism, so a restored film continues
    where it stopped."""
    np.savez(path, width=film.width, height=film.height,
             **{k: getattr(film, k) for k in _WINDOW},
             **{k: getattr(film, k).detach().cpu().numpy() for k in _ARRAYS},
             iteration=np.int32(film.iteration))


def film_load(path, device=None) -> Film:
    """Restore a checkpointed film on `device` (default: the first CUDA
    device; without one this raises, and device="cpu" loads it on the CPU).
    Checkpoints without the window fields are uncropped."""
    device = resolve_device(device)
    with np.load(path) as z:
        w, h = int(z["width"]), int(z["height"])
        window = dict(full_width=w, full_height=h, crop_x0=0, crop_y0=0)
        window.update({k: int(z[k]) for k in _WINDOW if k in z})
        return Film(width=w, height=h, **window,
                    **{k: torch.from_numpy(np.asarray(z[k], np.float32)).to(device)
                       for k in _ARRAYS},
                    iteration=int(z["iteration"]))
