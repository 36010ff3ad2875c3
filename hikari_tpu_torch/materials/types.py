"""Material definitions (host) and packed per-type banks (device).

Port of ``hikari_tpu/materials/types.py``: Matte, Mirror, Glass (with
Cauchy / Sellmeier dispersion), Conductor (measured metals: Gold, Silver,
Copper, Aluminum, Brass; or RGB eta/k), the Sellmeier glass presets (BK7,
SF11, Sapphire, FusedSilica, Diamond), Emissive, Interface (the invisible
boundary of a participating medium, no BSDF), ThinDielectric,
DiffuseTransmission, the layered CoatedDiffuse (alias Plastic),
CoatedConductor and CoatedDiffuseTransmission, and Mix (resolved to one of
its two children per hit). Materials are pushed into per-type banks and
referenced per face by a (type tag, index) pair; the tags, the bank field
names and the packing order equal the JAX package's. A field that the JAX
package textures may be a constant, an ``ImageTexture`` (packed into the
scene's atlas) or a ``VertexColorTexture``; its ``*_tex`` column holds the
reference (``textures/atlas.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..spectral.piecewise import metal_eta_k
from ..spectral.piecewise_poly import fit_piecewise_poly
from ..spectral.rgb2spec import albedo_coeff4, srgb_table, unbounded_coeff4
from ..textures.atlas import (CONST_TEX, VERTEX_TEX, AtlasBuilder, ImageTexture,
                              VertexColorTexture)

# material type tags (the JAX package's numbering)
MATTE = 0
MIRROR = 1
GLASS = 2
CONDUCTOR = 3
EMISSIVE = 4
INTERFACE = 5  # no BSDF: a medium boundary that rays pass straight through
THIN_DIELECTRIC = 6
DIFFUSE_TRANSMISSION = 7
MIX = 8  # resolved to a concrete child at each hit
COATED_DIFFUSE = 9
COATED_CONDUCTOR = 10
COATED_DIFFUSE_TRANSMISSION = 11
N_MATERIAL_TYPES = 12

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


@dataclass
class ThinDielectric:
    """Thin glass pane / bubble wall (thin-dielectric.jl:45): transmission
    passes straight through without bending or entering a medium; the
    reflectance counts interreflection, R' = 2R / (1 + R)."""

    kr: tuple = (1.0, 1.0, 1.0)
    kt: tuple = (1.0, 1.0, 1.0)
    eta: float = 1.5


@dataclass
class DiffuseTransmission:
    """Lambertian reflection + Lambertian transmission
    (diffuse-transmission.jl:39)."""

    reflectance: tuple = (0.25, 0.25, 0.25)
    transmittance: tuple = (0.25, 0.25, 0.25)


@dataclass
class CoatedDiffuse:
    """Dielectric coating over a diffuse base (coated-diffuse.jl:32),
    evaluated by the stochastic layered walk (materials/layered.py);
    thickness, albedo and g describe the slab between the layers in optical
    units."""

    reflectance: object = (0.5, 0.5, 0.5)
    roughness: float = 0.0       # coating interface roughness
    ior: float = 1.5
    thickness: float = 0.01
    albedo: tuple = (0.0, 0.0, 0.0)
    g: float = 0.0
    remap_roughness: bool = True


def Plastic(kd=(0.5, 0.5, 0.5), roughness=0.1, **kw):
    """The reference's PlasticMaterial: a CoatedDiffuse."""
    return CoatedDiffuse(reflectance=kd, roughness=roughness, **kw)


@dataclass
class CoatedDiffuseTransmission:
    """Dielectric coating over a diffuse layer that both reflects and
    transmits (coated-diffuse-transmission.jl:12)."""

    reflectance: object = (0.5, 0.5, 0.5)
    transmittance: object = (0.25, 0.25, 0.25)
    roughness: float = 0.0
    ior: float = 1.5
    thickness: float = 0.01
    albedo: tuple = (0.0, 0.0, 0.0)
    g: float = 0.0
    remap_roughness: bool = True


@dataclass
class CoatedConductor:
    """Dielectric coating over a conductor (coated-conductor.jl:48): a
    measured metal preset or RGB eta/k under the coat."""

    interface_roughness: float = 0.0
    interface_ior: float = 1.5
    metal: str | None = "AU"
    eta: tuple = (0.2, 0.92, 1.1)
    k: tuple = (3.9, 2.45, 2.14)
    conductor_roughness: float = 0.1
    thickness: float = 0.01
    albedo: tuple = (0.0, 0.0, 0.0)
    g: float = 0.0
    remap_roughness: bool = True


@dataclass
class Mix:
    """Stochastic blend of two materials, resolved to one child per hit by
    a hash of the hit (mix-material.jl:39-57); children may not be Mix."""

    m1: object = None
    m2: object = None
    amount: float = 0.5  # probability of choosing m1


# the reference's user-facing names (uber-material.jl:433-451)
Diffuse = Matte
Dielectric = Glass
Metal = Conductor


@dataclass
class MaterialBanks:
    """Per-type parameter banks, each padded to at least one row. A
    ``*_tex`` column holds each row's texture reference: an atlas id >= 0,
    CONST_TEX (-1) or VERTEX_TEX (-2)."""

    matte_kd: torch.Tensor        # (Nm, 3)
    matte_sigma: torch.Tensor     # (Nm,)
    matte_kd_c4: torch.Tensor     # (Nm, 4) sigmoid coefficients + scale
    matte_kd_tex: torch.Tensor    # (Nm,) int32
    mirror_kr: torch.Tensor       # (Nr, 3)
    mirror_kr_c4: torch.Tensor    # (Nr, 4)
    mirror_kr_tex: torch.Tensor   # (Nr,) int32
    glass_kr: torch.Tensor        # (Ng, 3)
    glass_kt: torch.Tensor        # (Ng, 3)
    glass_eta: torch.Tensor       # (Ng,)
    glass_cauchy: torch.Tensor    # (Ng,) Cauchy B (um^2); > 0 = dispersive
    glass_sell: torch.Tensor      # (Ng, 6) Sellmeier B1..3, C1..3
    glass_ax: torch.Tensor        # (Ng,)
    glass_ay: torch.Tensor        # (Ng,)
    glass_kr_c4: torch.Tensor     # (Ng, 4)
    glass_kt_c4: torch.Tensor     # (Ng, 4)
    glass_kr_tex: torch.Tensor    # (Ng,) int32
    glass_kt_tex: torch.Tensor    # (Ng,) int32
    glass_rough_tex: torch.Tensor  # (Ng,) int32 (replaces ax / ay)
    cond_eta: torch.Tensor        # (Nc, 471) dense spectral eta
    cond_k: torch.Tensor          # (Nc, 471)
    cond_eta_pw: torch.Tensor     # (Nc, 16, 4) piecewise-cubic fits
    cond_k_pw: torch.Tensor       # (Nc, 16, 4)
    cond_ax: torch.Tensor         # (Nc,)
    cond_ay: torch.Tensor         # (Nc,)
    cond_rough_tex: torch.Tensor  # (Nc,) int32 (replaces ax / ay)
    emissive_le: torch.Tensor     # (Ne, 3)
    emissive_scale: torch.Tensor  # (Ne,)
    emissive_two_sided: torch.Tensor  # (Ne,) bool
    emissive_le_c4: torch.Tensor  # (Ne, 4) unbounded coefficients
    emissive_le_tex: torch.Tensor  # (Ne,) int32
    thin_kr: torch.Tensor         # (Nt, 3) thin dielectric
    thin_kt: torch.Tensor         # (Nt, 3)
    thin_eta: torch.Tensor        # (Nt,)
    thin_kr_c4: torch.Tensor      # (Nt, 4)
    thin_kt_c4: torch.Tensor      # (Nt, 4)
    dt_refl: torch.Tensor         # (Nd, 3) diffuse transmission
    dt_trans: torch.Tensor        # (Nd, 3)
    dt_refl_c4: torch.Tensor      # (Nd, 4)
    dt_trans_c4: torch.Tensor     # (Nd, 4)
    dt_refl_tex: torch.Tensor     # (Nd,) int32
    dt_trans_tex: torch.Tensor    # (Nd,) int32
    mix_m1_type: torch.Tensor     # (Nx,) int32 child (type, index) pairs
    mix_m1_idx: torch.Tensor      # (Nx,) int32
    mix_m2_type: torch.Tensor     # (Nx,) int32
    mix_m2_idx: torch.Tensor      # (Nx,) int32
    mix_amount: torch.Tensor      # (Nx,) probability of the first child
    mix_amount_tex: torch.Tensor  # (Nx,) int32
    cd_refl: torch.Tensor         # (Ncd, 3) coated diffuse
    cd_refl_c4: torch.Tensor      # (Ncd, 4)
    cd_refl_tex: torch.Tensor     # (Ncd,) int32
    cd_ax: torch.Tensor           # (Ncd,) coating alpha
    cd_ay: torch.Tensor           # (Ncd,)
    cd_eta: torch.Tensor          # (Ncd,)
    cd_thick: torch.Tensor        # (Ncd,)
    cd_albedo: torch.Tensor       # (Ncd, 3)
    cd_albedo_c4: torch.Tensor    # (Ncd, 4)
    cd_g: torch.Tensor            # (Ncd,)
    cc_iax: torch.Tensor          # (Ncc,) coated conductor: interface alpha
    cc_iay: torch.Tensor          # (Ncc,)
    cc_eta: torch.Tensor          # (Ncc,) interface IOR
    cc_cond_eta: torch.Tensor     # (Ncc, 471)
    cc_cond_k: torch.Tensor       # (Ncc, 471)
    cc_cond_eta_pw: torch.Tensor  # (Ncc, 16, 4)
    cc_cond_k_pw: torch.Tensor    # (Ncc, 16, 4)
    cc_cax: torch.Tensor          # (Ncc,) conductor alpha
    cc_cay: torch.Tensor          # (Ncc,)
    cc_thick: torch.Tensor        # (Ncc,)
    cc_albedo: torch.Tensor       # (Ncc, 3)
    cc_albedo_c4: torch.Tensor    # (Ncc, 4)
    cc_g: torch.Tensor            # (Ncc,)
    cdt_refl: torch.Tensor        # (Nct, 3) coated diffuse transmission
    cdt_trans: torch.Tensor       # (Nct, 3)
    cdt_refl_c4: torch.Tensor     # (Nct, 4)
    cdt_trans_c4: torch.Tensor    # (Nct, 4)
    cdt_refl_tex: torch.Tensor    # (Nct,) int32
    cdt_trans_tex: torch.Tensor   # (Nct,) int32
    cdt_albedo_c4: torch.Tensor   # (Nct, 4)
    cdt_ax: torch.Tensor          # (Nct,)
    cdt_ay: torch.Tensor          # (Nct,)
    cdt_eta: torch.Tensor         # (Nct,)
    cdt_thick: torch.Tensor       # (Nct,)
    cdt_g: torch.Tensor           # (Nct,)
    # static: some field is an image or vertex colour (False: shading skips
    # the per-lane uplift entirely)
    has_textures: bool = False

    def to(self, device) -> "MaterialBanks":
        return MaterialBanks(**{f.name: getattr(self, f.name).to(device)
                                for f in fields(self) if f.name != "has_textures"},
                             has_textures=self.has_textures)


def _alpha(rough: float, remap: bool) -> float:
    return float(np.sqrt(rough)) if remap else float(rough)


def _rgb(field, what: str):
    """A constant RGB field; a texture here raises TypeError, as the JAX
    package takes none for it."""
    if isinstance(field, (ImageTexture, VertexColorTexture)):
        raise TypeError(f"{what} takes a constant colour, not a texture")
    return tuple(float(x) for x in np.broadcast_to(np.asarray(field, np.float32), (3,)))


def _scalar(field, what: str) -> float:
    if isinstance(field, (ImageTexture, VertexColorTexture)):
        raise TypeError(f"{what} takes a constant value, not a texture")
    return float(field)


class _Resolver:
    """The JAX package's resolve_rgb / resolve_scalar: a field -> (constant,
    texture reference), images going into the atlas builder. A textured
    field's constant is the default."""

    def __init__(self, atlas_builder: AtlasBuilder):
        self.atlas = atlas_builder

    def _ref(self, field):
        if isinstance(field, ImageTexture):
            return self.atlas.add(field)
        return VERTEX_TEX if isinstance(field, VertexColorTexture) else CONST_TEX

    def rgb(self, field, what: str, default=(1.0, 1.0, 1.0)):
        ref = self._ref(field)
        return (tuple(default) if ref != CONST_TEX else _rgb(field, what)), ref

    def scalar(self, field, what: str, default=0.0):
        ref = self._ref(field)
        return (float(default) if ref != CONST_TEX else _scalar(field, what)), ref


def _dense_eta_k(metal, eta, k):
    """Dense (471,) eta and k spectra of a measured metal, or of RGB eta/k
    as piecewise constants over thirds of the visible range."""
    if metal is not None:
        eta_s, k_s = metal_eta_k(metal)
        lam = _LAM_GRID.astype(np.float32)
        return eta_s(lam), k_s(lam)

    def rgb_to_dense(rgb):
        return np.where(_LAM_GRID < 490, rgb[2], np.where(
            _LAM_GRID < 580, rgb[1], rgb[0])).astype(np.float32)

    return rgb_to_dense(np.asarray(eta)), rgb_to_dense(np.asarray(k))


def _with_mix_children(materials: list) -> list:
    """The packing list: `materials`, then the Mix children not in it (by
    identity), in order of first appearance; nested Mix is refused."""
    work = list(materials)
    for m in materials:
        if isinstance(m, Mix):
            for ch in (m.m1, m.m2):
                if ch is None:
                    raise ValueError("Mix needs two child materials")
                if isinstance(ch, Mix):
                    raise ValueError("nested Mix is not supported")
                if not any(ch is w for w in work):
                    work.append(ch)
    return work


def pack_materials(materials: list, atlas_builder: AtlasBuilder | None = None):
    """Pack host materials into banks. Mix children that are not in the
    list themselves get rows after it (the tags and indices then cover
    them too), as the JAX package packs them. Images of textured fields go
    into atlas_builder (a new one when None). Returns (banks, type tags
    (M,), bank indices (M,), present type set)."""
    res = _Resolver(AtlasBuilder() if atlas_builder is None else atlas_builder)
    matte_kd, matte_sigma, mirror_kr = [], [], []
    tex = {k: [] for k in ("matte_kd", "mirror_kr", "glass_kr", "glass_kt", "glass_rough",
                           "cond_rough", "emissive_le", "dt_refl", "dt_trans", "mix_amount",
                           "cd_refl", "cdt_refl", "cdt_trans")}
    glass = {k: [] for k in ("kr", "kt", "eta", "cauchy", "sell", "ax", "ay")}
    cond_eta, cond_k, cond_ax, cond_ay = [], [], [], []
    emis_le, emis_scale, emis_two = [], [], []
    thin_kr, thin_kt, thin_eta = [], [], []
    dt_refl, dt_trans = [], []
    cd = {k: [] for k in ("refl", "ax", "ay", "eta", "thick", "albedo", "g")}
    cdt = {k: [] for k in ("refl", "trans", "ax", "ay", "eta", "thick", "albedo", "g")}

    def put(column, rows, resolved):
        """Append a resolved (constant, reference) to its rows and column."""
        rows.append(resolved[0])
        tex[column].append(resolved[1])
    cc = {k: [] for k in ("iax", "iay", "eta", "ceta", "ck", "cax", "cay", "thick",
                          "albedo", "g")}
    mixes = []
    work = _with_mix_children(materials)
    tags = np.zeros(len(work), np.int32)
    idxs = np.zeros(len(work), np.int32)
    present: set[int] = set()
    for i, m in enumerate(work):
        name = type(m).__name__
        if isinstance(m, Matte):
            tags[i], idxs[i] = MATTE, len(matte_kd)
            put("matte_kd", matte_kd, res.rgb(m.kd, "Matte.kd", (0.5, 0.5, 0.5)))
            matte_sigma.append(_scalar(m.sigma, "Matte.sigma"))
        elif isinstance(m, Mirror):
            tags[i], idxs[i] = MIRROR, len(mirror_kr)
            put("mirror_kr", mirror_kr, res.rgb(m.kr, "Mirror.kr"))
        elif isinstance(m, Glass):
            tags[i], idxs[i] = GLASS, len(glass["kr"])
            put("glass_kr", glass["kr"], res.rgb(m.kr, "Glass.kr"))
            put("glass_kt", glass["kt"], res.rgb(m.kt, "Glass.kt"))
            ur, rough_tex = res.scalar(m.u_roughness, "Glass.u_roughness")
            tex["glass_rough"].append(rough_tex)
            vr = ur if rough_tex >= 0 else _scalar(m.v_roughness, "Glass.v_roughness")
            glass["eta"].append(m.eta)
            glass["cauchy"].append(m.cauchy_b)
            glass["sell"].append(tuple(m.sellmeier))
            glass["ax"].append(_alpha(ur, m.remap_roughness))
            glass["ay"].append(_alpha(vr, m.remap_roughness))
        elif isinstance(m, Conductor):
            tags[i], idxs[i] = CONDUCTOR, len(cond_eta)
            eta_d, k_d = _dense_eta_k(m.metal, m.eta, m.k)
            cond_eta.append(eta_d)
            cond_k.append(k_d)
            rough, rough_tex = res.scalar(m.roughness, "Conductor.roughness")
            tex["cond_rough"].append(rough_tex)
            vr = rough if m.v_roughness is None else m.v_roughness
            cond_ax.append(_alpha(rough, m.remap_roughness))
            cond_ay.append(_alpha(vr, m.remap_roughness))
        elif isinstance(m, Emissive):
            tags[i], idxs[i] = EMISSIVE, len(emis_le)
            put("emissive_le", emis_le, res.rgb(m.le, "Emissive.le"))
            emis_scale.append(m.scale)
            emis_two.append(m.two_sided)
        elif isinstance(m, Interface):
            tags[i], idxs[i] = INTERFACE, 0
        elif isinstance(m, ThinDielectric):
            tags[i], idxs[i] = THIN_DIELECTRIC, len(thin_kr)
            thin_kr.append(_rgb(m.kr, "ThinDielectric.kr"))
            thin_kt.append(_rgb(m.kt, "ThinDielectric.kt"))
            thin_eta.append(m.eta)
        elif isinstance(m, DiffuseTransmission):
            tags[i], idxs[i] = DIFFUSE_TRANSMISSION, len(dt_refl)
            quarter = (0.25, 0.25, 0.25)
            put("dt_refl", dt_refl, res.rgb(m.reflectance, f"{name}.reflectance", quarter))
            put("dt_trans", dt_trans, res.rgb(m.transmittance, f"{name}.transmittance", quarter))
        elif isinstance(m, (CoatedDiffuse, CoatedDiffuseTransmission)):
            rows = cd if isinstance(m, CoatedDiffuse) else cdt
            tags[i] = COATED_DIFFUSE if rows is cd else COATED_DIFFUSE_TRANSMISSION
            idxs[i] = len(rows["refl"])
            pre = "cd" if rows is cd else "cdt"
            put(f"{pre}_refl", rows["refl"],
                res.rgb(m.reflectance, f"{name}.reflectance", (0.5, 0.5, 0.5)))
            if rows is cdt:
                put("cdt_trans", rows["trans"],
                    res.rgb(m.transmittance, f"{name}.transmittance", (0.25, 0.25, 0.25)))
            a = _alpha(_scalar(m.roughness, f"{name}.roughness"), m.remap_roughness)
            rows["ax"].append(a)
            rows["ay"].append(a)
            rows["eta"].append(m.ior)
            rows["thick"].append(m.thickness)
            rows["albedo"].append(_rgb(m.albedo, f"{name}.albedo"))
            rows["g"].append(m.g)
        elif isinstance(m, CoatedConductor):
            tags[i], idxs[i] = COATED_CONDUCTOR, len(cc["iax"])
            ia = _alpha(m.interface_roughness, m.remap_roughness)
            cc["iax"].append(ia)
            cc["iay"].append(ia)
            cc["eta"].append(m.interface_ior)
            eta_d, k_d = _dense_eta_k(m.metal, m.eta, m.k)
            cc["ceta"].append(eta_d)
            cc["ck"].append(k_d)
            ca = _alpha(m.conductor_roughness, m.remap_roughness)
            cc["cax"].append(ca)
            cc["cay"].append(ca)
            cc["thick"].append(m.thickness)
            cc["albedo"].append(_rgb(m.albedo, f"{name}.albedo"))
            cc["g"].append(m.g)
        elif isinstance(m, Mix):
            tags[i], idxs[i] = MIX, len(mixes)
            mixes.append(m)
        else:
            raise TypeError(f"unknown material {type(m)}")
        present.add(int(tags[i]))

    # second pass: the Mix children now have bank rows
    def slot_of(child):
        return next(j for j, w in enumerate(work) if w is child)

    mix = {k: [] for k in ("m1t", "m1i", "m2t", "m2i", "amount")}
    for m in mixes:
        j1, j2 = slot_of(m.m1), slot_of(m.m2)
        mix["m1t"].append(int(tags[j1]))
        mix["m1i"].append(int(idxs[j1]))
        mix["m2t"].append(int(tags[j2]))
        mix["m2i"].append(int(idxs[j2]))
        put("mix_amount", mix["amount"], res.scalar(m.amount, "Mix.amount", 0.5))

    def pad3(rows, default):
        return torch.tensor(rows or [default], dtype=torch.float32)

    def pad1(rows, default, dtype=torch.float32):
        return torch.tensor(rows or [default], dtype=dtype)

    tex_cols = {f"{k}_tex": pad1(v, CONST_TEX, torch.int32) for k, v in tex.items()}

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
        thin_kr=pad3(thin_kr, (1.0, 1.0, 1.0)),
        thin_kt=pad3(thin_kt, (1.0, 1.0, 1.0)),
        thin_eta=pad1(thin_eta, 1.5),
        thin_kr_c4=a_c4(thin_kr, (1.0, 1.0, 1.0)),
        thin_kt_c4=a_c4(thin_kt, (1.0, 1.0, 1.0)),
        dt_refl=pad3(dt_refl, (0.25, 0.25, 0.25)),
        dt_trans=pad3(dt_trans, (0.25, 0.25, 0.25)),
        dt_refl_c4=a_c4(dt_refl, (0.25, 0.25, 0.25)),
        dt_trans_c4=a_c4(dt_trans, (0.25, 0.25, 0.25)),
        mix_m1_type=pad1(mix["m1t"], 0, torch.int32),
        mix_m1_idx=pad1(mix["m1i"], 0, torch.int32),
        mix_m2_type=pad1(mix["m2t"], 0, torch.int32),
        mix_m2_idx=pad1(mix["m2i"], 0, torch.int32),
        mix_amount=pad1(mix["amount"], 0.5),
        cd_refl=pad3(cd["refl"], (0.5, 0.5, 0.5)),
        cd_refl_c4=a_c4(cd["refl"], (0.5, 0.5, 0.5)),
        cd_ax=pad1(cd["ax"], 0.0),
        cd_ay=pad1(cd["ay"], 0.0),
        cd_eta=pad1(cd["eta"], 1.5),
        cd_thick=pad1(cd["thick"], 0.01),
        cd_albedo=pad3(cd["albedo"], (0.0, 0.0, 0.0)),
        cd_albedo_c4=a_c4(cd["albedo"], (0.0, 0.0, 0.0)),
        cd_g=pad1(cd["g"], 0.0),
        cc_iax=pad1(cc["iax"], 0.0),
        cc_iay=pad1(cc["iay"], 0.0),
        cc_eta=pad1(cc["eta"], 1.5),
        cc_cond_eta=torch.from_numpy(dense(cc["ceta"], 0.0).astype(np.float32)),
        cc_cond_k=torch.from_numpy(dense(cc["ck"], 1.0).astype(np.float32)),
        cc_cond_eta_pw=pw(cc["ceta"], 0.0),
        cc_cond_k_pw=pw(cc["ck"], 1.0),
        cc_cax=pad1(cc["cax"], 0.0),
        cc_cay=pad1(cc["cay"], 0.0),
        cc_thick=pad1(cc["thick"], 0.01),
        cc_albedo=pad3(cc["albedo"], (0.0, 0.0, 0.0)),
        cc_albedo_c4=a_c4(cc["albedo"], (0.0, 0.0, 0.0)),
        cc_g=pad1(cc["g"], 0.0),
        cdt_refl=pad3(cdt["refl"], (0.5, 0.5, 0.5)),
        cdt_trans=pad3(cdt["trans"], (0.25, 0.25, 0.25)),
        cdt_refl_c4=a_c4(cdt["refl"], (0.5, 0.5, 0.5)),
        cdt_trans_c4=a_c4(cdt["trans"], (0.25, 0.25, 0.25)),
        cdt_albedo_c4=a_c4(cdt["albedo"], (0.0, 0.0, 0.0)),
        cdt_ax=pad1(cdt["ax"], 0.0),
        cdt_ay=pad1(cdt["ay"], 0.0),
        cdt_eta=pad1(cdt["eta"], 1.5),
        cdt_thick=pad1(cdt["thick"], 0.01),
        cdt_g=pad1(cdt["g"], 0.0),
        **tex_cols,
        has_textures=any(r != CONST_TEX for col in tex.values() for r in col),
    )
    return banks, tags, idxs, present
