"""Lights of the main path: point lights and per-face area lights.

Port of the point and area parts of ``hikari_tpu/lights/types.py``: host
definitions, the packed banks with the power sampler's alias table, and
the dense spectral ``sample_li``. Spot, distant, sun, ambient and
environment lights are not ported yet and raise at ``pack_lights``.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..core.lookup import bank_lookup as _bl
from ..core.vecmath import dot
from ..geometry.triangle import sample_triangle, triangle_area, triangle_normal
from ..spectral.cie import D65_PHOTOMETRIC
from ..spectral.rgb2spec import coeff4_illuminant_eval, srgb_table, unbounded_coeff4
from .sampler import build_alias_table, light_powers

POINT = 0
AREA = 4


@dataclass
class PointLight:
    position: tuple = (0.0, 0.0, 0.0)
    intensity: tuple = (1.0, 1.0, 1.0)  # RGB radiant intensity
    scale: float = 1.0


@dataclass
class LightBanks:
    point_pos: torch.Tensor       # (Np, 3)
    point_i: torch.Tensor         # (Np, 3)
    point_i_c4: torch.Tensor      # (Np, 4) illuminant coefficients / D65_PHOTOMETRIC
    area_p0: torch.Tensor         # (Na, 3)
    area_p1: torch.Tensor
    area_p2: torch.Tensor
    area_le: torch.Tensor         # (Na, 3)
    area_two_sided: torch.Tensor  # (Na,) bool
    area_n: torch.Tensor          # (Na, 3)
    area_area: torch.Tensor       # (Na,)
    area_le_c4: torch.Tensor      # (Na, 4)
    light_type: torch.Tensor      # (NL,) int32 flat light list
    light_idx: torch.Tensor       # (NL,) int32
    pmf: torch.Tensor             # (NL,) power-sampler pmf
    alias_q: torch.Tensor         # (NL,)
    alias_j: torch.Tensor         # (NL,) int32
    area_flat_base: int = 0       # flat index of the first area light
    n_flat: int = 0               # true flat-light count (arrays are padded)

    def to(self, device) -> "LightBanks":
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.to(device) if isinstance(v, torch.Tensor) else v
        return LightBanks(**out)


def pack_lights(lights: list, area_tris=None, sampler: str = "power") -> LightBanks:
    """area_tris: optional (p0, p1, p2, le, two_sided) numpy arrays of the
    emissive faces collected at scene build."""
    if sampler != "power":
        raise NotImplementedError(f"light sampler {sampler!r} is not ported yet")
    pp, pi = [], []
    for light in lights:
        if not isinstance(light, PointLight):
            raise NotImplementedError(
                f"{type(light).__name__} is not ported to hikari_tpu_torch yet; "
                "the port has PointLight and emissive area lights")
        pp.append(light.position)
        pi.append(np.asarray(light.intensity) * light.scale)
    if area_tris is not None and len(area_tris[0]):
        a_p0, a_p1, a_p2, a_le, a_two = area_tris
    else:
        a_p0 = a_p1 = a_p2 = np.zeros((0, 3), np.float32)
        a_le = np.zeros((0, 3), np.float32)
        a_two = np.zeros((0,), bool)

    types = [POINT] * len(pp) + [AREA] * len(a_p0)
    idxs = list(range(len(pp))) + list(range(len(a_p0)))

    def pad3(rows, default=(0.0, 0.0, 0.0)):
        arr = (np.asarray(rows, np.float32).reshape(-1, 3) if len(rows)
               else np.array([default], np.float32))
        return torch.from_numpy(arr)

    if len(a_p0):
        a_p0t, a_p1t, a_p2t = (torch.from_numpy(np.asarray(a, np.float32))
                               for a in (a_p0, a_p1, a_p2))
    else:
        a_p0t = torch.zeros((1, 3))
        a_p1t = torch.tensor([[1.0, 0.0, 0.0]])
        a_p2t = torch.tensor([[0.0, 1.0, 0.0]])
    a_area = triangle_area(a_p0t, a_p1t, a_p2t)

    if types:
        phi = light_powers(np.asarray(types), np.asarray(idxs),
                           point_i=np.asarray(pi, np.float32).reshape(-1, 3),
                           area_le=np.asarray(a_le, np.float32).reshape(-1, 3),
                           area_area=a_area.numpy(),
                           area_two_sided=np.asarray(a_two, bool))
    else:
        phi = np.zeros(0)
    pmf, q, j = build_alias_table(phi)
    if len(pmf) == 0:
        pmf, q, j = np.ones(1, np.float32), np.ones(1, np.float32), np.zeros(1, np.int32)

    table = srgb_table()

    def illum_c4(rows3):
        c4 = unbounded_coeff4(table, rows3)
        c4[..., 3] *= 1.0 / D65_PHOTOMETRIC
        return c4

    return LightBanks(
        point_pos=pad3(pp), point_i=pad3(pi), point_i_c4=illum_c4(pad3(pi)),
        area_p0=a_p0t, area_p1=a_p1t, area_p2=a_p2t, area_le=pad3(a_le),
        area_two_sided=torch.tensor(np.asarray(a_two, bool) if len(a_two) else [False]),
        area_n=triangle_normal(a_p0t, a_p1t, a_p2t), area_area=a_area,
        area_le_c4=illum_c4(pad3(a_le)),
        light_type=torch.tensor(types or [POINT], dtype=torch.int32),
        light_idx=torch.tensor(idxs or [0], dtype=torch.int32),
        pmf=torch.from_numpy(pmf), alias_q=torch.from_numpy(q),
        alias_j=torch.from_numpy(np.asarray(j, np.int32)),
        area_flat_base=len(pp), n_flat=len(types))


def sample_light_index(banks: LightBanks, u: torch.Tensor):
    """Draw a flat light index ~ pmf via the alias table; (idx, pmf). The
    fractional part of u n is reused as the alias coin."""
    n = banks.pmf.shape[0]
    su = u * n
    i = torch.clamp(su.to(torch.int32), 0, n - 1)
    f = su - i.to(torch.float32)
    idx = torch.where(f < _bl(banks.alias_q, i), i, _bl(banks.alias_j, i))
    return idx, _bl(banks.pmf, idx)


@dataclass
class LightSample:
    wi: torch.Tensor        # (..., 3) world
    li: torch.Tensor        # (..., 4) spectral radiance
    pdf: torch.Tensor       # (...,) solid-angle pdf (1 for deltas)
    t_max: torch.Tensor     # (...,) shadow-ray extent
    is_delta: torch.Tensor  # (...,) bool
    valid: torch.Tensor     # (...,) bool


def sample_li(banks: LightBanks, ltype, lidx, p, lam, u2) -> LightSample:
    """Dense spectral sample_li over point and area lights, selected per
    lane by type tag (physical-wavefront/lights.jl:39-396)."""
    eps = 1e-3
    # point
    lp = _bl(banks.point_pos, lidx % banks.point_pos.shape[0])
    to_l = lp - p
    dist2 = torch.clamp((to_l * to_l).sum(-1), min=1e-12)
    dist = torch.sqrt(dist2)
    wi_pt = to_l / dist[..., None]
    li_pt = coeff4_illuminant_eval(
        _bl(banks.point_i_c4, lidx % banks.point_i_c4.shape[0]), lam) / dist2[..., None]
    # area: uniform triangle sampling (diffuse-area.jl:25-60)
    ai = lidx % banks.area_p0.shape[0]
    p_l, _, _ = sample_triangle(u2[..., 0], u2[..., 1], _bl(banks.area_p0, ai),
                                _bl(banks.area_p1, ai), _bl(banks.area_p2, ai))
    to_a = p_l - p
    d2a = torch.clamp((to_a * to_a).sum(-1), min=1e-12)
    da = torch.sqrt(d2a)
    wi_ar = to_a / da[..., None]
    cos_l = dot(_bl(banks.area_n, ai), -wi_ar)
    facing = (cos_l > 0.0) | _bl(banks.area_two_sided, ai)
    area = torch.clamp(_bl(banks.area_area, ai), min=1e-12)
    pdf_ar = d2a / torch.clamp(torch.abs(cos_l) * area, min=1e-9)
    li_ar = torch.where(facing[..., None],
                        coeff4_illuminant_eval(_bl(banks.area_le_c4, ai), lam), 0.0)

    is_pt, is_ar = ltype == POINT, ltype == AREA
    up = torch.zeros_like(p)
    up[..., 2] = 1.0
    wi = torch.where(is_pt[..., None], wi_pt, torch.where(is_ar[..., None], wi_ar, up))
    li = torch.where(is_pt[..., None], li_pt, torch.where(is_ar[..., None], li_ar, 0.0))
    pdf = torch.where(is_ar, pdf_ar, 1.0)
    t_max = torch.where(is_pt, dist - eps, torch.where(is_ar, da - eps, 1.0))
    valid = (pdf > 0.0) & (li > 0.0).any(-1)
    return LightSample(wi=wi, li=li, pdf=pdf, t_max=t_max, is_delta=is_pt,
                       valid=valid)


def area_light_pdf(banks: LightBanks, aidx, p_ref, p_hit, n_hit):
    """Solid-angle pdf of having sampled p_hit on area light aidx."""
    to_l = p_hit - p_ref
    d2 = torch.clamp((to_l * to_l).sum(-1), min=1e-12)
    wi = to_l / torch.sqrt(d2)[..., None]
    cos_l = torch.abs(dot(n_hit, -wi))
    area = torch.clamp(_bl(banks.area_area, aidx), min=1e-12)
    return d2 / torch.clamp(cos_l * area, min=1e-9)
