"""Material definitions (host) and packed per-type banks (device).

Port of the main-path materials of ``hikari_tpu/materials/types.py``:
Matte, Mirror, Glass (with Cauchy / Sellmeier dispersion), Conductor
(measured metals: Gold, Silver, Copper, Aluminum, Brass; or RGB eta/k), the
Sellmeier glass presets (BK7, SF11, Sapphire, FusedSilica, Diamond),
Emissive, and Interface, the invisible boundary of a participating medium
(no BSDF). Materials are pushed into per-type banks and referenced per
face by a (type tag, index) pair; the tags equal the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..spectral.piecewise import metal_eta_k
from ..spectral.piecewise_poly import fit_piecewise_poly
from ..spectral.rgb2spec import albedo_coeff4, srgb_table, unbounded_coeff4

# material type tags (the JAX package's numbering)
MATTE = 0
MIRROR = 1
GLASS = 2
CONDUCTOR = 3
EMISSIVE = 4
INTERFACE = 5  # no BSDF: a medium boundary that rays pass straight through

_LAM_GRID = np.arange(360.0, 831.0, dtype=np.float64)  # 471 samples


@dataclass
class Matte:
    """Lambertian / Oren-Nayar diffuse (uber-material.jl:180)."""

    kd: tuple = (0.5, 0.5, 0.5)
    sigma: float = 0.0


@dataclass
class Mirror:
    """Perfect specular reflector (uber-material.jl:193)."""

    kr: tuple = (1.0, 1.0, 1.0)


@dataclass
class Glass:
    """Dielectric with reflection + transmission (uber-material.jl:209);
    cauchy_b > 0 or Sellmeier B1 > 0 makes it dispersive."""

    kr: tuple = (1.0, 1.0, 1.0)
    kt: tuple = (1.0, 1.0, 1.0)
    eta: float = 1.5
    u_roughness: float = 0.0
    v_roughness: float = 0.0
    remap_roughness: bool = True
    cauchy_b: float = 0.0
    sellmeier: tuple = (0.0,) * 6


@dataclass
class Conductor:
    """Microfacet conductor (uber-material.jl:378): a measured metal preset
    ('AU', 'AG', 'CU', 'AL', 'CUZN') or explicit RGB eta/k."""

    metal: str | None = "AU"
    eta: tuple = (0.2, 0.92, 1.1)
    k: tuple = (3.9, 2.45, 2.14)
    roughness: float = 0.0
    v_roughness: float | None = None
    remap_roughness: bool = True


def BK7(**kw):
    """N-BK7 borosilicate crown (SCHOTT catalog Sellmeier)."""
    return Glass(eta=1.5168, sellmeier=(
        1.03961212, 0.231792344, 1.01046945,
        0.00600069867, 0.0200179144, 103.560653), **kw)


def SF11(**kw):
    """N-SF11 dense flint (SCHOTT catalog Sellmeier; strong dispersion)."""
    return Glass(eta=1.7847, sellmeier=(
        1.73759695, 0.313747346, 1.89878101,
        0.013188707, 0.0623068142, 155.23629), **kw)


def Sapphire(**kw):
    """Sapphire, ordinary ray (Malitson & Dodge Sellmeier)."""
    return Glass(eta=1.7682, sellmeier=(
        1.4313493, 0.65054713, 5.3414021,
        0.0052799261, 0.0142382647, 325.017834), **kw)


def FusedSilica(**kw):
    """Fused silica (Malitson 1965 Sellmeier)."""
    return Glass(eta=1.4585, sellmeier=(
        0.6961663, 0.4079426, 0.8974794,
        0.0046791483, 0.0135120631, 97.9340025), **kw)


def Diamond(**kw):
    """Diamond (Peter 1923 two-term Sellmeier; n_d 2.4175)."""
    return Glass(eta=2.4175, sellmeier=(
        0.3306, 4.3356, 0.0,
        0.030625, 0.011236, 1.0), **kw)


def Gold(roughness=0.0, **kw):
    return Conductor(metal="AU", roughness=roughness, **kw)


def Silver(roughness=0.0, **kw):
    return Conductor(metal="AG", roughness=roughness, **kw)


def Copper(roughness=0.0, **kw):
    return Conductor(metal="CU", roughness=roughness, **kw)


def Aluminum(roughness=0.0, **kw):
    return Conductor(metal="AL", roughness=roughness, **kw)


def Brass(roughness=0.0, **kw):
    return Conductor(metal="CUZN", roughness=roughness, **kw)


@dataclass
class Emissive:
    """Area emission (emissive.jl:30-62); its faces become area lights."""

    le: tuple = (1.0, 1.0, 1.0)
    scale: float = 1.0
    two_sided: bool = False


@dataclass
class Interface:
    """Invisible medium boundary: rays pass straight through, switching
    between the inside and outside media of the faces they cross."""


# the reference's user-facing names (uber-material.jl:433-451)
Diffuse = Matte
Dielectric = Glass
Metal = Conductor


@dataclass
class MaterialBanks:
    """Per-type parameter banks, each padded to at least one row."""

    matte_kd: torch.Tensor        # (Nm, 3)
    matte_sigma: torch.Tensor     # (Nm,)
    matte_kd_c4: torch.Tensor     # (Nm, 4) sigmoid coefficients + scale
    mirror_kr: torch.Tensor       # (Nr, 3)
    mirror_kr_c4: torch.Tensor    # (Nr, 4)
    glass_kr: torch.Tensor        # (Ng, 3)
    glass_kt: torch.Tensor        # (Ng, 3)
    glass_eta: torch.Tensor       # (Ng,)
    glass_cauchy: torch.Tensor    # (Ng,) Cauchy B (um^2); > 0 = dispersive
    glass_sell: torch.Tensor      # (Ng, 6) Sellmeier B1..3, C1..3
    glass_ax: torch.Tensor        # (Ng,)
    glass_ay: torch.Tensor        # (Ng,)
    glass_kr_c4: torch.Tensor     # (Ng, 4)
    glass_kt_c4: torch.Tensor     # (Ng, 4)
    cond_eta: torch.Tensor        # (Nc, 471) dense spectral eta
    cond_k: torch.Tensor          # (Nc, 471)
    cond_eta_pw: torch.Tensor     # (Nc, 16, 4) piecewise-cubic fits
    cond_k_pw: torch.Tensor       # (Nc, 16, 4)
    cond_ax: torch.Tensor         # (Nc,)
    cond_ay: torch.Tensor         # (Nc,)
    emissive_le: torch.Tensor     # (Ne, 3)
    emissive_scale: torch.Tensor  # (Ne,)
    emissive_two_sided: torch.Tensor  # (Ne,) bool
    emissive_le_c4: torch.Tensor  # (Ne, 4) unbounded coefficients

    def to(self, device) -> "MaterialBanks":
        return MaterialBanks(**{f.name: getattr(self, f.name).to(device)
                                for f in fields(self)})


def _alpha(rough: float, remap: bool) -> float:
    return float(np.sqrt(rough)) if remap else float(rough)


def _rgb(field, what: str):
    try:
        return tuple(float(x) for x in np.broadcast_to(np.asarray(field, np.float32), (3,)))
    except (TypeError, ValueError) as e:
        raise NotImplementedError(
            f"{what}: only constant RGB values are ported; textures and vertex "
            "colours are not") from e


def _scalar(field, what: str) -> float:
    try:
        return float(field)
    except (TypeError, ValueError) as e:
        raise NotImplementedError(
            f"{what}: only constant values are ported; textures are not") from e


def pack_materials(materials: list):
    """Pack host materials into banks. Returns (banks, type tags (M,),
    bank indices (M,), present type set)."""
    matte_kd, matte_sigma, mirror_kr = [], [], []
    glass = {k: [] for k in ("kr", "kt", "eta", "cauchy", "sell", "ax", "ay")}
    cond_eta, cond_k, cond_ax, cond_ay = [], [], [], []
    emis_le, emis_scale, emis_two = [], [], []
    tags = np.zeros(len(materials), np.int32)
    idxs = np.zeros(len(materials), np.int32)
    present: set[int] = set()
    for i, m in enumerate(materials):
        if isinstance(m, Matte):
            tags[i], idxs[i] = MATTE, len(matte_kd)
            matte_kd.append(_rgb(m.kd, "Matte.kd"))
            matte_sigma.append(_scalar(m.sigma, "Matte.sigma"))
        elif isinstance(m, Mirror):
            tags[i], idxs[i] = MIRROR, len(mirror_kr)
            mirror_kr.append(_rgb(m.kr, "Mirror.kr"))
        elif isinstance(m, Glass):
            tags[i], idxs[i] = GLASS, len(glass["kr"])
            ur = _scalar(m.u_roughness, "Glass.u_roughness")
            vr = _scalar(m.v_roughness, "Glass.v_roughness")
            glass["kr"].append(_rgb(m.kr, "Glass.kr"))
            glass["kt"].append(_rgb(m.kt, "Glass.kt"))
            glass["eta"].append(m.eta)
            glass["cauchy"].append(m.cauchy_b)
            glass["sell"].append(tuple(m.sellmeier))
            glass["ax"].append(_alpha(ur, m.remap_roughness))
            glass["ay"].append(_alpha(vr, m.remap_roughness))
        elif isinstance(m, Conductor):
            tags[i], idxs[i] = CONDUCTOR, len(cond_eta)
            if m.metal is not None:
                eta_s, k_s = metal_eta_k(m.metal)
                lam = _LAM_GRID.astype(np.float32)
                cond_eta.append(eta_s(lam))
                cond_k.append(k_s(lam))
            else:
                def rgb_to_dense(rgb):
                    lam = _LAM_GRID
                    return np.where(lam < 490, rgb[2], np.where(
                        lam < 580, rgb[1], rgb[0])).astype(np.float32)

                cond_eta.append(rgb_to_dense(np.asarray(m.eta)))
                cond_k.append(rgb_to_dense(np.asarray(m.k)))
            rough = _scalar(m.roughness, "Conductor.roughness")
            vr = rough if m.v_roughness is None else m.v_roughness
            cond_ax.append(_alpha(rough, m.remap_roughness))
            cond_ay.append(_alpha(vr, m.remap_roughness))
        elif isinstance(m, Emissive):
            tags[i], idxs[i] = EMISSIVE, len(emis_le)
            emis_le.append(_rgb(m.le, "Emissive.le"))
            emis_scale.append(m.scale)
            emis_two.append(m.two_sided)
        elif isinstance(m, Interface):
            tags[i], idxs[i] = INTERFACE, 0
        else:
            raise NotImplementedError(
                f"{type(m).__name__} is not ported to hikari_tpu_torch yet; "
                "the port has Matte, Mirror, Glass, Conductor, Emissive and Interface")
        present.add(int(tags[i]))

    def pad3(rows, default):
        return torch.tensor(rows or [default], dtype=torch.float32)

    def pad1(rows, default, dtype=torch.float32):
        return torch.tensor(rows or [default], dtype=dtype)

    def dense(rows, fill):
        return np.stack(rows) if rows else np.full((1, len(_LAM_GRID)), fill, np.float32)

    def pw(rows, fill):
        return torch.from_numpy(np.stack(
            [fit_piecewise_poly(r, 16) for r in dense(rows, fill)]))

    table = srgb_table()

    def a_c4(rows, default):
        return albedo_coeff4(table, torch.clamp(pad3(rows, default), 0.0, 1.0))

    banks = MaterialBanks(
        matte_kd=pad3(matte_kd, (0.5, 0.5, 0.5)),
        matte_sigma=pad1(matte_sigma, 0.0),
        matte_kd_c4=a_c4(matte_kd, (0.5, 0.5, 0.5)),
        mirror_kr=pad3(mirror_kr, (1.0, 1.0, 1.0)),
        mirror_kr_c4=a_c4(mirror_kr, (1.0, 1.0, 1.0)),
        glass_kr=pad3(glass["kr"], (1.0, 1.0, 1.0)),
        glass_kt=pad3(glass["kt"], (1.0, 1.0, 1.0)),
        glass_eta=pad1(glass["eta"], 1.5),
        glass_cauchy=pad1(glass["cauchy"], 0.0),
        glass_sell=torch.tensor(glass["sell"] or [(0.0,) * 6], dtype=torch.float32),
        glass_ax=pad1(glass["ax"], 0.0),
        glass_ay=pad1(glass["ay"], 0.0),
        glass_kr_c4=a_c4(glass["kr"], (1.0, 1.0, 1.0)),
        glass_kt_c4=a_c4(glass["kt"], (1.0, 1.0, 1.0)),
        cond_eta=torch.from_numpy(dense(cond_eta, 0.0).astype(np.float32)),
        cond_k=torch.from_numpy(dense(cond_k, 1.0).astype(np.float32)),
        cond_eta_pw=pw(cond_eta, 0.0),
        cond_k_pw=pw(cond_k, 1.0),
        cond_ax=pad1(cond_ax, 0.0),
        cond_ay=pad1(cond_ay, 0.0),
        emissive_le=pad3(emis_le, (1.0, 1.0, 1.0)),
        emissive_scale=pad1(emis_scale, 1.0),
        emissive_two_sided=pad1(emis_two, False, torch.bool),
        emissive_le_c4=unbounded_coeff4(table, pad3(emis_le, (1.0, 1.0, 1.0))),
    )
    return banks, tags, idxs, present
