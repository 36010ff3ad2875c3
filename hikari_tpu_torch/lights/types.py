"""Lights: host definitions, the packed banks, and the spectral sample_li.

Port of ``hikari_tpu/lights/types.py``: point, spot, distant (and sun),
ambient, per-face area and equal-area environment lights; the banks with
the power or uniform sampler's alias table; the dense ``sample_li`` that
evaluates each present light type over the lanes and selects per lane by
type tag; and the environment lookup of escaped rays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from functools import cached_property

import numpy as np
import torch

from ..core.lookup import bank_lookup as _bl
from ..core.vecmath import dot
from ..geometry.triangle import sample_triangle, triangle_area, triangle_normal
from ..sampling.distributions import (Distribution2D, make_distribution_2d,
                                      pdf_distribution_2d, sample_distribution_2d)
from ..spectral.cie import D65_PHOTOMETRIC
from ..spectral.rgb2spec import (coeff4_illuminant_eval, rgb_illuminant_eval, srgb_table,
                                 unbounded_coeff4)
from ..utils import profiling
from .sampler import build_alias_table, light_powers

POINT = 0
SPOT = 1
DISTANT = 2
AMBIENT = 3
AREA = 4
ENV = 5
N_LIGHT_TYPES = 6


@dataclass
class PointLight:
    position: tuple = (0.0, 0.0, 0.0)
    intensity: tuple = (1.0, 1.0, 1.0)  # RGB radiant intensity
    scale: float = 1.0


@dataclass
class SpotLight:
    position: tuple = (0.0, 0.0, 0.0)
    direction: tuple = (0.0, 0.0, -1.0)
    intensity: tuple = (1.0, 1.0, 1.0)
    cone_angle_deg: float = 30.0
    falloff_start_deg: float = 25.0
    scale: float = 1.0


@dataclass
class DistantLight:
    direction: tuple = (0.0, -1.0, 0.0)  # direction light travels
    radiance: tuple = (1.0, 1.0, 1.0)
    scale: float = 1.0


@dataclass
class SunLight:
    """Delta directional sun (sun.jl:7-50). angular_diameter and
    corona_falloff are carried for API parity (the reference declares but
    does not consume them); transport-wise a SunLight is a DistantLight."""

    direction: tuple = (0.0, -1.0, 0.0)  # direction light travels
    radiance: tuple = (1.0, 1.0, 1.0)
    scale: float = 1.0
    angular_diameter: float = 0.00933
    corona_falloff: float = 8.0


@dataclass
class AmbientLight:
    radiance: tuple = (0.1, 0.1, 0.1)
    scale: float = 1.0


@dataclass
class EnvironmentLight:
    """Equal-area octahedral environment map (environment.jl:5-35).

    image: (H, W, 3) equal-area square map (H == W), linear RGB."""

    image: np.ndarray = None
    scale: float = 1.0
    rotation: tuple = None  # optional 3x3 world rotation


def equirect_to_equal_area(img, resolution: int | None = None, up: str = "y"):
    """Host lat-long (equirectangular) -> equal-area octahedral resample.

    Every equal-area texel centre maps to a direction, which bilinearly
    samples the lat-long source; feed the result to
    ``EnvironmentLight(image=...)``.

    img: (H, W, 3) linear RGB lat-long image. Row 0 is the top pole (+up
        axis); u wraps longitude with phi = atan2 about the up axis
        (u = (phi + pi) / 2pi).
    resolution: output square size; defaults to H.
    up: world axis of the image's pole: 'y' (standard HDRI) or 'z' (the
        sun-sky bake's)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    res = int(resolution or h)
    uu, vv = np.meshgrid((np.arange(res) + 0.5) / res, (np.arange(res) + 0.5) / res)
    d = equal_area_square_to_sphere_np(uu, vv)  # (res, res, 3)
    if up == "y":
        pole, az_y, az_x = d[..., 1], d[..., 2], d[..., 0]
    elif up == "z":
        pole, az_y, az_x = d[..., 2], d[..., 1], d[..., 0]
    else:
        raise ValueError(f"up must be 'y' or 'z', got {up!r}")
    theta = np.arccos(np.clip(pole, -1.0, 1.0))
    phi = np.arctan2(az_y, az_x)
    su = np.mod((phi + np.pi) / (2.0 * np.pi), 1.0) * w - 0.5
    sv = (theta / np.pi) * h - 0.5
    x0 = np.floor(su).astype(np.int64)
    y0 = np.floor(sv).astype(np.int64)
    fx = (su - x0)[..., None]
    fy = (sv - y0)[..., None]
    x1 = (x0 + 1) % w
    x0 = x0 % w                      # longitude wraps
    y1 = np.clip(y0 + 1, 0, h - 1)   # latitude clamps at the poles
    y0 = np.clip(y0, 0, h - 1)
    out = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
           + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)
    return out.astype(np.float32)


def equal_area_square_to_sphere_np(u, v):
    """numpy twin of equal_area_square_to_sphere, for host bakes."""
    up = np.abs(2 * u - 1)
    vp = np.abs(2 * v - 1)
    sd = 1.0 - (up + vp)
    r = 1.0 - np.abs(sd)
    phi = np.where(r == 0.0, 1.0, (vp - up) / np.where(r == 0.0, 1.0, r) + 1.0) * (np.pi / 4.0)
    z = np.copysign(1.0 - r * r, sd)
    cos_phi = np.copysign(np.cos(phi), 2 * u - 1)
    sin_phi = np.copysign(np.sin(phi), 2 * v - 1)
    s = r * np.sqrt(np.maximum(2.0 - r * r, 0.0))
    return np.stack([cos_phi * s, sin_phi * s, z], -1)


# --- equal-area octahedral mapping (environment_map.jl:71-210) -----------------------


def equal_area_square_to_sphere(uv: torch.Tensor) -> torch.Tensor:
    """[0,1]^2 -> unit sphere, equal-area (pbrt-v4)."""
    u = 2.0 * uv[..., 0] - 1.0
    v = 2.0 * uv[..., 1] - 1.0
    up = torch.abs(u)
    vp = torch.abs(v)
    sd = 1.0 - (up + vp)
    r = 1.0 - torch.abs(sd)
    phi = torch.where(r == 0.0, 1.0,
                      (vp - up) / torch.where(r == 0.0, 1.0, r) + 1.0) * (math.pi / 4.0)
    z = torch.copysign(1.0 - r * r, sd)
    cos_phi = torch.copysign(torch.cos(phi), u)
    sin_phi = torch.copysign(torch.sin(phi), v)
    s = r * torch.sqrt(torch.clamp(2.0 - r * r, min=0.0))
    return torch.stack([cos_phi * s, sin_phi * s, z], -1)


def equal_area_sphere_to_square(d: torch.Tensor) -> torch.Tensor:
    """Unit sphere -> [0,1]^2, the inverse of the above."""
    x = torch.abs(d[..., 0])
    y = torch.abs(d[..., 1])
    r = torch.sqrt(torch.clamp(1.0 - torch.abs(d[..., 2]), min=0.0))
    a = torch.maximum(x, y)
    b = torch.minimum(x, y)
    b = torch.where(a == 0.0, 0.0, b / torch.where(a == 0.0, 1.0, a))
    phi = torch.atan(b) * (2.0 / math.pi)
    phi = torch.where(x < y, 1.0 - phi, phi)
    v = phi * r
    u = r - v
    neg = d[..., 2] < 0.0  # the lower hemisphere folds over the diagonals
    u, v = torch.where(neg, 1.0 - v, u), torch.where(neg, 1.0 - u, v)
    u = torch.copysign(u, d[..., 0])
    v = torch.copysign(v, d[..., 1])
    return torch.stack([(u + 1.0) * 0.5, (v + 1.0) * 0.5], -1)


@dataclass
class LightBanks:
    point_pos: torch.Tensor         # (Np, 3)
    point_i: torch.Tensor           # (Np, 3)
    spot_pos: torch.Tensor          # (Ns, 3)
    spot_dir: torch.Tensor          # (Ns, 3)
    spot_i: torch.Tensor            # (Ns, 3)
    spot_cos_total: torch.Tensor    # (Ns,)
    spot_cos_falloff: torch.Tensor  # (Ns,)
    dist_dir: torch.Tensor          # (Nd, 3) direction the light travels
    dist_l: torch.Tensor            # (Nd, 3)
    ambient_l: torch.Tensor         # (Nam, 3)
    area_p0: torch.Tensor           # (Na, 3)
    area_p1: torch.Tensor
    area_p2: torch.Tensor
    area_le: torch.Tensor           # (Na, 3)
    area_two_sided: torch.Tensor    # (Na,) bool
    area_n: torch.Tensor            # (Na, 3)
    area_area: torch.Tensor         # (Na,)
    env_image: torch.Tensor         # (H, W, 3)
    env_dist: Distribution2D        # over the map's luminance
    env_scale: torch.Tensor         # ()
    light_type: torch.Tensor        # (NL,) int32 flat light list
    light_idx: torch.Tensor         # (NL,) int32 index in its type's bank
    # illuminant coefficients [c0, c1, c2, scale / D65_PHOTOMETRIC]
    point_i_c4: torch.Tensor        # (Np, 4)
    spot_i_c4: torch.Tensor         # (Ns, 4)
    dist_l_c4: torch.Tensor         # (Nd, 4)
    area_le_c4: torch.Tensor        # (Na, 4)
    pmf: torch.Tensor               # (NL,) the power or uniform sampler's pmf
    alias_q: torch.Tensor           # (NL,)
    alias_j: torch.Tensor           # (NL,) int32
    has_env: bool = False
    area_flat_base: int = 0         # flat index of the first area light
    n_flat: int = 0                 # true flat-light count (arrays are padded)

    @cached_property
    def present_types(self) -> frozenset:
        """The flat list's light types: sample_li evaluates only these."""
        return frozenset(int(t) for t in self.light_type[: self.n_flat].tolist())

    @cached_property
    def has_ambient(self) -> bool:
        """Escaped rays add the ambient lights' summed radiance."""
        return bool((self.ambient_l.sum(0) > 0.0).any())

    def to(self, device) -> "LightBanks":
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.to(device) if hasattr(v, "to") else v
        return LightBanks(**out)


def pack_lights(lights: list, area_tris=None, scene_radius: float = 1.0,
                sampler: str = "power") -> LightBanks:
    """area_tris: optional (p0, p1, p2, le, two_sided) numpy arrays of the
    emissive faces collected at scene build.

    sampler: 'power' builds a power-weighted alias table
    (PowerLightSampler, light-sampler.jl:230-278); 'uniform' gives every
    light equal probability (UniformLightSampler, :186). Distant and
    environment lights weigh by the scene's radius."""
    if sampler not in ("power", "uniform"):
        raise ValueError(f"sampler {sampler!r}: expected 'power' or 'uniform'")
    pp, pi = [], []
    sp, sd, si, sct, scf = [], [], [], [], []
    dd, dl = [], []
    al = []
    env = None
    for light in lights:
        if isinstance(light, PointLight):
            pp.append(light.position)
            pi.append(np.asarray(light.intensity) * light.scale)
        elif isinstance(light, SpotLight):
            sp.append(light.position)
            sd.append(np.asarray(light.direction) / np.linalg.norm(light.direction))
            si.append(np.asarray(light.intensity) * light.scale)
            sct.append(np.cos(np.deg2rad(light.cone_angle_deg)))
            scf.append(np.cos(np.deg2rad(light.falloff_start_deg)))
        elif isinstance(light, (DistantLight, SunLight)):
            dd.append(np.asarray(light.direction) / np.linalg.norm(light.direction))
            dl.append(np.asarray(light.radiance) * light.scale)
        elif isinstance(light, AmbientLight):
            al.append(np.asarray(light.radiance) * light.scale)
        elif isinstance(light, EnvironmentLight):
            env = light
        else:
            raise TypeError(f"unknown light {type(light)}")
    if area_tris is not None and len(area_tris[0]):
        a_p0, a_p1, a_p2, a_le, a_two = area_tris
    else:
        a_p0 = a_p1 = a_p2 = np.zeros((0, 3), np.float32)
        a_le = np.zeros((0, 3), np.float32)
        a_two = np.zeros((0,), bool)

    # the flat list: punctual lights, area lights, the environment last.
    # Ambient lights are left out: escaped rays add their radiance in full,
    # so sampling them too would count them twice.
    types, idxs = [], []
    for t, n in ((POINT, len(pp)), (SPOT, len(sp)), (DISTANT, len(dd))):
        types += [t] * n
        idxs += list(range(n))
    area_flat_base = len(types)
    types += [AREA] * len(a_p0)
    idxs += list(range(len(a_p0)))
    if env is not None:
        types.append(ENV)
        idxs.append(0)

    def pad3(rows, default=(0.0, 0.0, 0.0)):
        arr = (np.asarray(rows, np.float32).reshape(-1, 3) if len(rows)
               else np.array([default], np.float32))
        return torch.from_numpy(arr)

    def pad1(rows, default=0.0, dtype=np.float32):
        return torch.from_numpy(np.asarray(rows, dtype) if len(rows)
                                else np.array([default], dtype))

    env_mean_lum = 0.0
    if env is not None:
        img = np.asarray(env.image, np.float32)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"environment image: shape {img.shape}, expected (H, W, 3)")
        lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
        env_mean_lum = float(lum.mean())
        env_image = torch.from_numpy(img)
        env_dist = make_distribution_2d(torch.from_numpy(lum))
        env_scale = torch.tensor(float(env.scale), dtype=torch.float32)
    else:
        env_image = torch.zeros((1, 1, 3))
        env_dist = make_distribution_2d(torch.ones((1, 1)))
        env_scale = torch.tensor(0.0)

    if len(a_p0):
        a_p0t, a_p1t, a_p2t = (torch.from_numpy(np.asarray(a, np.float32))
                               for a in (a_p0, a_p1, a_p2))
    else:
        a_p0t = torch.zeros((1, 3))
        a_p1t = torch.tensor([[1.0, 0.0, 0.0]])
        a_p2t = torch.tensor([[0.0, 1.0, 0.0]])
    a_area = triangle_area(a_p0t, a_p1t, a_p2t)

    if sampler == "power" and types:
        rows3 = (lambda rows: np.asarray(rows, np.float32).reshape(-1, 3))
        phi = light_powers(
            np.asarray(types), np.asarray(idxs), point_i=rows3(pi), spot_i=rows3(si),
            spot_cos_total=np.asarray(sct, np.float32),
            spot_cos_falloff=np.asarray(scf, np.float32), dist_l=rows3(dl),
            area_le=rows3(a_le), area_area=a_area.numpy(),
            area_two_sided=np.asarray(a_two, bool), env_mean_lum=env_mean_lum,
            env_scale=float(env.scale) if env is not None else 1.0,
            scene_radius=scene_radius)
    else:
        phi = np.ones(len(types), np.float64)
    pmf, q, j = build_alias_table(phi)
    if len(pmf) == 0:  # one dummy entry keeps the shapes fixed
        pmf, q, j = np.ones(1, np.float32), np.ones(1, np.float32), np.zeros(1, np.int32)

    table = srgb_table()

    def illum_c4(rows3):
        c4 = unbounded_coeff4(table, rows3)
        c4[..., 3] *= 1.0 / D65_PHOTOMETRIC
        return c4

    return LightBanks(
        point_pos=pad3(pp), point_i=pad3(pi),
        spot_pos=pad3(sp), spot_dir=pad3(sd, (0.0, 0.0, -1.0)), spot_i=pad3(si),
        spot_cos_total=pad1(sct), spot_cos_falloff=pad1(scf),
        dist_dir=pad3(dd, (0.0, -1.0, 0.0)), dist_l=pad3(dl), ambient_l=pad3(al),
        area_p0=a_p0t, area_p1=a_p1t, area_p2=a_p2t, area_le=pad3(a_le),
        area_two_sided=pad1(a_two, False, bool),
        area_n=triangle_normal(a_p0t, a_p1t, a_p2t), area_area=a_area,
        env_image=env_image, env_dist=env_dist, env_scale=env_scale,
        light_type=torch.tensor(types or [POINT], dtype=torch.int32),
        light_idx=torch.tensor(idxs or [0], dtype=torch.int32),
        point_i_c4=illum_c4(pad3(pi)), spot_i_c4=illum_c4(pad3(si)),
        dist_l_c4=illum_c4(pad3(dl)), area_le_c4=illum_c4(pad3(a_le)),
        pmf=torch.from_numpy(pmf), alias_q=torch.from_numpy(q),
        alias_j=torch.from_numpy(np.asarray(j, np.int32)),
        has_env=env is not None, area_flat_base=area_flat_base, n_flat=len(types))


@profiling.spanned("hikari.lights")
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


def illuminant(table, rgb, lam):
    """Photometrically normalised illuminant uplift: RGB (1, 1, 1)
    integrates to unit luminance (lights/point.jl:58,73)."""
    return rgb_illuminant_eval(table, torch.clamp(rgb, min=0.0), lam) * (1.0 / D65_PHOTOMETRIC)


def _env_texel(banks: LightBanks, uv):
    """The environment map's RGB at uv, scaled."""
    h, w = banks.env_image.shape[:2]
    xi = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
    yi = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
    return banks.env_image[yi, xi] * banks.env_scale


def _towards(p_light, p):
    """(unit direction from p to p_light, squared distance, distance)."""
    to_l = p_light - p
    d2 = torch.clamp((to_l * to_l).sum(-1), min=1e-12)
    dist = torch.sqrt(d2)
    return to_l / dist[..., None], d2, dist


@profiling.spanned("hikari.lights")
def sample_li(banks: LightBanks, table, ltype, lidx, p, lam, u2,
              scene_radius: float) -> LightSample:
    """Dense spectral sample_li (physical-wavefront/lights.jl:39-396): each
    light type of the flat list is evaluated over every lane and selected
    per lane by type tag. Distant and environment shadow rays run to twice
    the scene's radius."""
    eps = 1e-3
    n = p.shape[0]
    dev = p.device
    present = banks.present_types
    ones = torch.ones(n, device=dev)
    wi = torch.zeros_like(p)
    wi[..., 2] = 1.0
    li = torch.zeros((n, 4), device=dev)
    pdf, t_max = ones, ones

    def pick(t_id, wi_t, li_t, pdf_t, t_max_t):
        nonlocal wi, li, pdf, t_max
        m = ltype == t_id
        wi = torch.where(m[..., None], wi_t, wi)
        li = torch.where(m[..., None], li_t, li)
        pdf = torch.where(m, pdf_t, pdf)
        t_max = torch.where(m, t_max_t, t_max)

    if POINT in present:
        i = lidx % banks.point_pos.shape[0]
        wi_pt, d2, dist = _towards(_bl(banks.point_pos, i), p)
        li_pt = coeff4_illuminant_eval(_bl(banks.point_i_c4, i), lam) / d2[..., None]
        pick(POINT, wi_pt, li_pt, ones, dist - eps)
    if SPOT in present:
        i = lidx % banks.spot_pos.shape[0]
        wi_sp, d2, dist = _towards(_bl(banks.spot_pos, i), p)
        cos_t = dot(-wi_sp, _bl(banks.spot_dir, i))
        ct = _bl(banks.spot_cos_total, i)
        cf = _bl(banks.spot_cos_falloff, i)
        t = torch.clamp((cos_t - ct) / torch.clamp(cf - ct, min=1e-6), 0.0, 1.0)
        falloff = (t * t) * (t * t)  # pbrt's quartic falloff between the cone edges
        li_sp = coeff4_illuminant_eval(_bl(banks.spot_i_c4, i), lam) * (falloff / d2)[..., None]
        pick(SPOT, wi_sp, li_sp, ones, dist - eps)
    t_far = torch.full_like(ones, 2.0 * scene_radius)  # past the whole scene
    if DISTANT in present:
        i = lidx % banks.dist_dir.shape[0]
        li_di = coeff4_illuminant_eval(_bl(banks.dist_l_c4, i), lam)
        pick(DISTANT, -_bl(banks.dist_dir, i), li_di, ones, t_far)
    if AREA in present:  # uniform triangle sampling (diffuse-area.jl:25-60)
        ai = lidx % banks.area_p0.shape[0]
        p_l, _, _ = sample_triangle(u2[..., 0], u2[..., 1], _bl(banks.area_p0, ai),
                                    _bl(banks.area_p1, ai), _bl(banks.area_p2, ai))
        wi_ar, d2a, da = _towards(p_l, p)
        cos_l = dot(_bl(banks.area_n, ai), -wi_ar)
        facing = (cos_l > 0.0) | _bl(banks.area_two_sided, ai)
        area = torch.clamp(_bl(banks.area_area, ai), min=1e-12)
        pdf_ar = d2a / torch.clamp(torch.abs(cos_l) * area, min=1e-9)
        li_ar = torch.where(facing[..., None],
                            coeff4_illuminant_eval(_bl(banks.area_le_c4, ai), lam), 0.0)
        pick(AREA, wi_ar, li_ar, pdf_ar, da - eps)
    if ENV in present:  # importance-sample the equal-area map
        uv, pdf_uv = sample_distribution_2d(banks.env_dist, u2)
        li_env = illuminant(table, _env_texel(banks, uv), lam)
        # equal-area: every texel subtends the same solid angle
        pick(ENV, equal_area_square_to_sphere(uv), li_env, pdf_uv / (4.0 * math.pi), t_far)
    is_delta = (ltype == POINT) | (ltype == SPOT) | (ltype == DISTANT)
    valid = (pdf > 0.0) & (li > 0.0).any(-1)
    return LightSample(wi=wi, li=li, pdf=pdf, t_max=t_max, is_delta=is_delta, valid=valid)


@profiling.spanned("hikari.lights")
def env_radiance(banks: LightBanks, table, d: torch.Tensor, lam: torch.Tensor):
    """Le(lambda) and solid-angle pdf of escaped rays leaving along d
    (lights.jl:408-500)."""
    uv = equal_area_sphere_to_square(d)
    le = illuminant(table, _env_texel(banks, uv), lam)
    return le, pdf_distribution_2d(banks.env_dist, uv) / (4.0 * math.pi)


@profiling.spanned("hikari.lights")
def area_light_pdf(banks: LightBanks, aidx, p_ref, p_hit, n_hit):
    """Solid-angle pdf of having sampled p_hit on area light aidx."""
    to_l = p_hit - p_ref
    d2 = torch.clamp((to_l * to_l).sum(-1), min=1e-12)
    wi = to_l / torch.sqrt(d2)[..., None]
    cos_l = torch.abs(dot(n_hit, -wi))
    area = torch.clamp(_bl(banks.area_area, aidx), min=1e-12)
    return d2 / torch.clamp(cos_l * area, min=1e-9)
