"""Participating media: host definitions, presets and the packed banks.

Port of ``hikari_tpu/media/types.py``: HomogeneousMedium, GridMedium (a
density grid), RGBGridMedium (per-voxel RGB sigma_a / sigma_s / Le), the
procedural CloudVolume, the measured presets, and ``pack_media``, which
packs a scene's media into one ``MediumBanks``: every grid medium shares
one flat density buffer (and one flat RGB buffer) addressed by a
per-medium offset, resolution and world box, every sparse
``BrickGridMedium`` (NanoVDB-class volumes, ``media/nanovdb.py``) shares one
page table and one brick pool, and every spatial medium carries a
MAJORANT_RES^3 grid of majorant cells that the tracking loops walk.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..spectral.rgb2spec import srgb_table, unbounded_coeff4

HOMOGENEOUS = 0
GRID = 1
RGBGRID = 2
BRICK = 3       # sparse brick-paged grid (NanoVDB-class volumes)
BRICK_DIM = 8   # voxels per brick edge (the NanoVDB leaf)

MAJORANT_RES = 16  # majorant cells per axis


@dataclass
class HomogeneousMedium:
    """Uniform sigma_a / sigma_s RGB and HG asymmetry g."""

    sigma_a: tuple = (0.01, 0.01, 0.01)
    sigma_s: tuple = (1.0, 1.0, 1.0)
    le: tuple = (0.0, 0.0, 0.0)
    g: float = 0.0
    scale: float = 1.0
    # ray bending at null-scatter events: ("gravity", (cx, cy, cz), strength)
    deflection: tuple | None = None
    # majorant inflation: > 1 adds null-scattering events to the exact
    # homogeneous majorant, which deflection needs to bend the ray
    majorant_scale: float = 1.0


@dataclass
class GridMedium:
    """Heterogeneous density grid: density (nz, ny, nx) float32 over the
    world box (bounds_lo, bounds_hi); sigma_a / sigma_s per unit density."""

    density: np.ndarray = None
    bounds_lo: tuple = (0.0, 0.0, 0.0)
    bounds_hi: tuple = (1.0, 1.0, 1.0)
    sigma_a: tuple = (1.0, 1.0, 1.0)
    sigma_s: tuple = (1.0, 1.0, 1.0)
    le: tuple = (0.0, 0.0, 0.0)
    g: float = 0.0
    scale: float = 1.0
    deflection: tuple | None = None


@dataclass
class RGBGridMedium:
    """Per-voxel RGB absorption / scattering / emission grids, each
    (nz, ny, nx, 3) or None; the *_scale fields multiply the stored values."""

    sigma_a_grid: np.ndarray = None
    sigma_s_grid: np.ndarray = None
    le_grid: np.ndarray = None
    bounds_lo: tuple = (0.0, 0.0, 0.0)
    bounds_hi: tuple = (1.0, 1.0, 1.0)
    sigma_a_scale: float = 1.0
    sigma_s_scale: float = 1.0
    le_scale: float = 1.0
    g: float = 0.0
    deflection: tuple | None = None


@dataclass
class BrickGridMedium:
    """Sparse density medium: active 8^3 bricks under a coarse int32 page
    table over the index bbox, so memory follows the active bricks and the
    table, not the dense extent.

    table: (tbz, tby, tbx) int32 brick ids, -1 = background.
    bricks: (NB, 512) float32, voxel order ((z&7)*8+(y&7))*8+(x&7).
    bounds_lo / bounds_hi: world box of the index bbox (table * 8 voxels);
    sigma_a / sigma_s per unit density."""

    table: object
    bricks: object
    bounds_lo: tuple = (0.0, 0.0, 0.0)
    bounds_hi: tuple = (1.0, 1.0, 1.0)
    background: float = 0.0
    sigma_a: tuple = (0.0, 0.0, 0.0)
    sigma_s: tuple = (1.0, 1.0, 1.0)
    le: tuple = (0.0, 0.0, 0.0)
    g: float = 0.0
    scale: float = 1.0


def CloudVolume(resolution: int = 96, bounds_lo=(0.0, 0.0, 0.0), bounds_hi=(1.0, 1.0, 1.0),
                sigma_s=(1.0, 1.0, 1.0), sigma_a=(0.02, 0.02, 0.02), g: float = 0.877,
                scale: float = 1.0, **noise_kwargs) -> GridMedium:
    """Procedural cloud: a GridMedium filled by the Worley / Perlin recipe
    of ``media/noise.py``."""
    from .noise import generate_cloud_density

    d = generate_cloud_density(resolution, **noise_kwargs)
    return GridMedium(density=d, bounds_lo=bounds_lo, bounds_hi=bounds_hi,
                      sigma_a=sigma_a, sigma_s=sigma_s, g=g, scale=scale)


# measured scattering media (sigma_s, sigma_a per mm; the pbrt measured-media
# dataset) and the non-measured Fog / Smoke conveniences
_MEDIUM_PRESETS = {
    "Wholemilk": ((2.55, 3.21, 3.77), (0.0011, 0.0024, 0.014)),
    "Skimmilk": ((0.70, 1.22, 1.90), (0.0014, 0.0025, 0.0142)),
    "LowfatMilk": ((0.89, 1.51, 2.53), (0.0029, 0.0058, 0.0115)),
    "ReducedMilk": ((2.49, 3.17, 4.52), (0.0026, 0.0051, 0.0128)),
    "RegularMilk": ((4.55, 5.83, 7.14), (0.0015, 0.0046, 0.0199)),
    "Cream": ((7.38, 5.47, 3.15), (0.0002, 0.0028, 0.0163)),
    "LowfatChocolateMilk": ((0.65, 0.84, 1.11), (0.0115, 0.0368, 0.1564)),
    "RegularChocolateMilk": ((1.46, 2.13, 2.95), (0.0101, 0.0431, 0.1438)),
    "LowfatSoyMilk": ((0.31, 0.34, 0.62), (0.0014, 0.0072, 0.0359)),
    "RegularSoyMilk": ((0.59, 0.74, 1.47), (0.0019, 0.0096, 0.0652)),
    "Espresso": ((0.72, 0.85, 1.02), (4.80, 6.58, 8.85)),
    "MintMochaCoffee": ((0.32, 0.39, 0.48), (3.77, 5.82, 7.82)),
    "Chardonnay": ((1.8e-5, 1.4e-5, 1.2e-5), (0.0108, 0.0119, 0.0240)),
    "WhiteZinfandel": ((1.8e-5, 1.9e-5, 1.3e-5), (0.0121, 0.0162, 0.0198)),
    "Merlot": ((2.1e-5, 0.0, 0.0), (0.116, 0.252, 0.294)),
    "BudweiserBeer": ((2.4e-5, 2.4e-5, 1.1e-5), (0.0115, 0.0249, 0.0578)),
    "CoorsLightBeer": ((5.1e-5, 4.3e-5, 0.0), (0.0062, 0.0140, 0.0350)),
    "AppleJuice": ((1.4e-4, 1.6e-4, 2.3e-4), (0.0130, 0.0237, 0.0522)),
    "CranberryJuice": ((1.0e-4, 1.2e-4, 7.8e-5), (0.0394, 0.0942, 0.1243)),
    "GrapeJuice": ((5.4e-5, 0.0, 0.0), (0.1040, 0.2396, 0.2933)),
    "RubyGrapefruitJuice": ((0.011, 0.011, 0.011), (0.0859, 0.1831, 0.2526)),
    "Sprite": ((6.0e-6, 6.4e-6, 6.6e-6), (0.00189, 0.00183, 0.00200)),
    "Coke": ((8.9e-5, 8.4e-5, 0.0), (0.1001, 0.1650, 0.2468)),
    "Pepsi": ((6.2e-5, 4.3e-5, 0.0), (0.0916, 0.1416, 0.2073)),
    "Apple": ((2.29, 2.39, 1.97), (0.0030, 0.0034, 0.046)),
    "Potato": ((0.68, 0.70, 0.55), (0.0024, 0.0090, 0.12)),
    "Chicken1": ((0.15, 0.21, 0.38), (0.015, 0.077, 0.19)),
    "Chicken2": ((0.19, 0.25, 0.32), (0.018, 0.088, 0.20)),
    "Ketchup": ((0.18, 0.07, 0.03), (0.061, 0.97, 1.45)),
    "Skin1": ((0.74, 0.88, 1.01), (0.032, 0.17, 0.48)),
    "Skin2": ((1.09, 1.59, 1.79), (0.013, 0.070, 0.145)),
    "Marble": ((2.19, 2.62, 3.00), (0.0021, 0.0041, 0.0071)),
    "Spectralon": ((11.6, 20.4, 14.9), (0.0, 0.0, 0.0)),
    "Shampoo": ((0.0007, 0.0008, 0.0009), (0.0141, 0.0457, 0.0617)),
    "HeadShouldersShampoo": ((0.0238, 0.0288, 0.0343), (0.0846, 0.1569, 0.2037)),
    "Clorox": ((0.0024, 0.0031, 0.0040), (0.0034, 0.0149, 0.0263)),
    "CappuccinoPowder": ((1.84, 2.59, 2.17), (35.84, 49.55, 61.08)),
    "SaltPowder": ((0.0273, 0.0325, 0.0320), (0.284, 0.326, 0.341)),
    "SugarPowder": ((2.2e-4, 2.6e-4, 2.7e-4), (0.0126, 0.0311, 0.0501)),
    "PacificOceanSurfaceWater": ((1.8e-4, 3.2e-4, 2.0e-4), (0.0318, 0.0313, 0.0301)),
    "Fog": ((0.01, 0.01, 0.01), (0.0001, 0.0001, 0.0001)),
    "Smoke": ((0.08, 0.08, 0.08), (0.01, 0.01, 0.01)),
}
_MEDIUM_PRESETS["Milk"] = _MEDIUM_PRESETS["Wholemilk"]


def medium_preset(name: str, scale: float = 1.0, g: float = 0.0) -> HomogeneousMedium:
    """A homogeneous medium from the preset table."""
    sigma_s, sigma_a = _MEDIUM_PRESETS[name]
    return HomogeneousMedium(sigma_a=sigma_a, sigma_s=sigma_s, g=g, scale=scale)


def Milk(scale=1.0):
    return medium_preset("Milk", scale, g=0.9)


def Fog(scale=1.0):
    return medium_preset("Fog", scale, g=0.8)


def Smoke(scale=1.0):
    return medium_preset("Smoke", scale, g=0.0)


@dataclass
class MediumBanks:
    """A scene's media on one device; one row per medium (a single dummy
    row when there is none)."""

    med_type: torch.Tensor     # (M,) HOMOGENEOUS / GRID / RGBGRID
    sigma_a: torch.Tensor      # (M, 3) rgb, pre-scaled (per unit density for grids)
    sigma_s: torch.Tensor      # (M, 3)
    le: torch.Tensor           # (M, 3)
    sigma_a_c4: torch.Tensor   # (M, 4) uplift coefficients [c0, c1, c2, scale]
    sigma_s_c4: torch.Tensor   # (M, 4)
    le_c4: torch.Tensor        # (M, 4)
    g: torch.Tensor            # (M,)
    bounds_lo: torch.Tensor    # (M, 3) world box of a spatial medium (zeros otherwise)
    bounds_hi: torch.Tensor    # (M, 3)
    grid_offset: torch.Tensor  # (M,) into density (voxels)
    grid_res: torch.Tensor     # (M, 3) (nx, ny, nz)
    density: torch.Tensor      # (V,) every GRID medium's voxels
    rgb_sa: torch.Tensor       # (Vr, 3) every RGBGRID medium's voxels
    rgb_ss: torch.Tensor       # (Vr, 3)
    rgb_le: torch.Tensor       # (Vr, 3)
    rgb_offset: torch.Tensor   # (M,) into the rgb buffers
    max_density: torch.Tensor  # (M,) global majorant scale
    maj: torch.Tensor          # (M, R, R, R) per-cell majorant scale
    defl_strength: torch.Tensor  # (M,) 0 = straight rays
    defl_center: torch.Tensor    # (M, 3)
    brick_table: torch.Tensor    # (TV,) int32 page tables of every BRICK medium
    brick_vals: torch.Tensor     # (NB * 512,) their bricks' voxels
    brick_tab_off: torch.Tensor  # (M,) int32 into brick_table
    brick_base: torch.Tensor     # (M,) int32 brick-id offset into the pool
    brick_bg: torch.Tensor       # (M,) background density
    n_media: int = 0
    has_grid: bool = False         # a GRID or RGBGRID medium is present
    has_brick: bool = False        # a BRICK medium is present
    has_deflection: bool = False
    has_rgb: bool = False          # an RGBGRID medium is present

    def to(self, device) -> "MediumBanks":
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.to(device) if isinstance(v, torch.Tensor) else v
        return MediumBanks(**out)


def _build_majorant_cells(d: np.ndarray) -> np.ndarray:
    """Max-pool a (nz, ny, nx) grid to MAJORANT_RES^3 cells, each widened by
    one voxel on every side so that trilinear reads stay bounded."""
    r = MAJORANT_RES
    nz, ny, nx = d.shape
    out = np.zeros((r, r, r), np.float32)
    zs = np.linspace(0, nz, r + 1).astype(int)
    ys = np.linspace(0, ny, r + 1).astype(int)
    xs = np.linspace(0, nx, r + 1).astype(int)
    for iz in range(r):
        z0, z1 = max(zs[iz] - 1, 0), min(zs[iz + 1] + 1, nz)
        for iy in range(r):
            y0, y1 = max(ys[iy] - 1, 0), min(ys[iy + 1] + 1, ny)
            for ix in range(r):
                x0, x1 = max(xs[ix] - 1, 0), min(xs[ix + 1] + 1, nx)
                blk = d[z0:z1, y0:y1, x0:x1]
                out[iz, iy, ix] = blk.max() if blk.size else 0.0
    return out


def _f32(rows) -> torch.Tensor:
    return torch.from_numpy(np.asarray(rows, np.float32))


def _empty_banks() -> MediumBanks:
    """One dummy row keeps every bank non-empty."""
    r = MAJORANT_RES
    black = torch.zeros((1, 4))
    black[:, 2] = -1e10
    z3 = torch.zeros((1, 3))
    return MediumBanks(
        med_type=torch.zeros(1, dtype=torch.int32), sigma_a=z3, sigma_s=z3.clone(),
        le=z3.clone(), sigma_a_c4=black, sigma_s_c4=black.clone(), le_c4=black.clone(),
        g=torch.zeros(1), bounds_lo=z3.clone(), bounds_hi=z3.clone(),
        grid_offset=torch.zeros(1, dtype=torch.int32),
        grid_res=torch.ones((1, 3), dtype=torch.int32), density=torch.zeros(1),
        rgb_sa=z3.clone(), rgb_ss=z3.clone(), rgb_le=z3.clone(),
        rgb_offset=torch.zeros(1, dtype=torch.int32), max_density=torch.ones(1),
        maj=torch.ones((1, r, r, r)), defl_strength=torch.zeros(1),
        defl_center=z3.clone(), brick_table=torch.full((1,), -1, dtype=torch.int32),
        brick_vals=torch.zeros(1), brick_tab_off=torch.zeros(1, dtype=torch.int32),
        brick_base=torch.zeros(1, dtype=torch.int32), brick_bg=torch.zeros(1))


def pack_media(media: list) -> MediumBanks:
    """Host media -> MediumBanks (on the CPU; SceneData.to moves them)."""
    if not media:
        return _empty_banks()
    rows = {k: [] for k in ("type", "sa", "ss", "le", "g", "lo", "hi", "goff", "roff",
                            "res", "maxd", "maj", "defl_s", "defl_c", "btab", "bbase",
                            "bbg")}
    flat, rgb_sa, rgb_ss, rgb_le, brick_tabs, brick_pool = [], [], [], [], [], []
    offset = rgb_offset = brick_tab_cursor = brick_cursor = 0
    r = MAJORANT_RES
    for m in media:
        if not isinstance(m, BrickGridMedium):
            rows["btab"].append(0)
            rows["bbase"].append(0)
            rows["bbg"].append(0.0)
        spec = getattr(m, "deflection", None)
        if spec is None:
            rows["defl_s"].append(0.0)
            rows["defl_c"].append((0.0, 0.0, 0.0))
        else:
            kind, center, strength = spec
            if kind != "gravity":
                raise ValueError(f"deflection {spec!r}: only 'gravity' is known")
            rows["defl_s"].append(float(strength))
            rows["defl_c"].append(tuple(float(x) for x in center))
        if isinstance(m, HomogeneousMedium):
            rows["type"].append(HOMOGENEOUS)
            rows["sa"].append(np.asarray(m.sigma_a) * m.scale)
            rows["ss"].append(np.asarray(m.sigma_s) * m.scale)
            rows["le"].append(np.asarray(m.le))
            rows["lo"].append((0, 0, 0))
            rows["hi"].append((0, 0, 0))
            rows["goff"].append(0)
            rows["roff"].append(0)
            rows["res"].append((1, 1, 1))
            rows["maxd"].append(float(getattr(m, "majorant_scale", 1.0)))
            rows["maj"].append(np.ones((r, r, r), np.float32))
        elif isinstance(m, GridMedium):
            d = np.asarray(m.density, np.float32)
            if d.ndim != 3:
                raise ValueError(f"GridMedium.density: shape {d.shape}, expected (nz, ny, nx)")
            nz, ny, nx = d.shape
            rows["type"].append(GRID)
            rows["sa"].append(np.asarray(m.sigma_a) * m.scale)
            rows["ss"].append(np.asarray(m.sigma_s) * m.scale)
            rows["le"].append(np.asarray(m.le))
            rows["lo"].append(m.bounds_lo)
            rows["hi"].append(m.bounds_hi)
            rows["goff"].append(offset)
            rows["roff"].append(0)
            rows["res"].append((nx, ny, nz))
            rows["maxd"].append(float(d.max()))
            rows["maj"].append(_build_majorant_cells(d))
            flat.append(d.reshape(-1))
            offset += d.size
        elif isinstance(m, RGBGridMedium):
            def scaled(grid, s):
                return None if grid is None else np.asarray(grid, np.float32) * s

            sag = scaled(m.sigma_a_grid, m.sigma_a_scale)
            ssg = scaled(m.sigma_s_grid, m.sigma_s_scale)
            leg = scaled(m.le_grid, m.le_scale)
            shape = (sag if sag is not None else ssg).shape[:3]
            nz, ny, nx = shape
            zero = np.zeros(shape + (3,), np.float32)
            sag = zero if sag is None else sag
            ssg = zero if ssg is None else ssg
            leg = zero if leg is None else leg
            rows["type"].append(RGBGRID)
            # per-voxel values are absolute: unit bank coefficients, and the
            # largest component of sigma_t drives the majorant
            rows["sa"].append((1.0, 1.0, 1.0))
            rows["ss"].append((1.0, 1.0, 1.0))
            rows["le"].append((0.0, 0.0, 0.0))
            rows["lo"].append(m.bounds_lo)
            rows["hi"].append(m.bounds_hi)
            rows["goff"].append(0)
            rows["roff"].append(rgb_offset)
            rows["res"].append((nx, ny, nz))
            sig_t = (sag + ssg).max(-1)
            rows["maxd"].append(float(sig_t.max()) if sig_t.size else 0.0)
            rows["maj"].append(_build_majorant_cells(sig_t))
            rgb_sa.append(sag.reshape(-1, 3))
            rgb_ss.append(ssg.reshape(-1, 3))
            rgb_le.append(leg.reshape(-1, 3))
            rgb_offset += nz * ny * nx
        elif isinstance(m, BrickGridMedium):
            tab = np.asarray(m.table, np.int32)
            if tab.ndim != 3:
                raise ValueError(f"BrickGridMedium.table: shape {tab.shape}, "
                                 "expected (tbz, tby, tbx)")
            bricks = np.asarray(m.bricks, np.float32).reshape(-1, 512)
            tbz, tby, tbx = tab.shape
            rows["type"].append(BRICK)
            rows["sa"].append(np.asarray(m.sigma_a) * m.scale)
            rows["ss"].append(np.asarray(m.sigma_s) * m.scale)
            rows["le"].append(np.asarray(m.le))
            rows["lo"].append(m.bounds_lo)
            rows["hi"].append(m.bounds_hi)
            rows["goff"].append(0)
            rows["roff"].append(0)
            rows["res"].append((tbx * BRICK_DIM, tby * BRICK_DIM, tbz * BRICK_DIM))
            rows["btab"].append(brick_tab_cursor)
            rows["bbase"].append(brick_cursor)
            rows["bbg"].append(float(m.background))
            brick_tabs.append(tab.reshape(-1))
            brick_pool.append(bricks)
            brick_tab_cursor += tab.size
            brick_cursor += len(bricks)
            # majorant cells from the brick maxima: _build_majorant_cells'
            # one-unit dilation is a whole brick of slack here, which covers
            # the trilinear bleed across brick borders
            bmax = bricks.max(axis=1) if len(bricks) else np.zeros(1, np.float32)
            cell = np.where(tab >= 0, bmax[np.maximum(tab, 0)], m.background)
            rows["maxd"].append(float(cell.max()) if cell.size else 0.0)
            rows["maj"].append(_build_majorant_cells(cell.astype(np.float32)))
        else:
            raise TypeError(f"unknown medium {type(m).__name__}")
        rows["g"].append(m.g)

    def cat(parts, width):
        if not parts:
            return torch.zeros((1, width) if width else (1,))
        return torch.from_numpy(np.concatenate(parts).astype(np.float32))

    # a brick medium without bricks still reads the pool (masked): one value
    pool = (np.concatenate(brick_pool).reshape(-1) if brick_pool
            else np.zeros(0, np.float32))
    table = srgb_table()
    sa, ss, le = (torch.from_numpy(np.stack(rows[k]).astype(np.float32))
                  for k in ("sa", "ss", "le"))
    defl_s = rows["defl_s"]
    return MediumBanks(
        med_type=torch.tensor(rows["type"], dtype=torch.int32),
        sigma_a=sa, sigma_s=ss, le=le,
        sigma_a_c4=unbounded_coeff4(table, sa), sigma_s_c4=unbounded_coeff4(table, ss),
        le_c4=unbounded_coeff4(table, le),
        g=_f32(rows["g"]),
        bounds_lo=_f32(rows["lo"]), bounds_hi=_f32(rows["hi"]),
        grid_offset=torch.tensor(rows["goff"], dtype=torch.int32),
        grid_res=torch.tensor(rows["res"], dtype=torch.int32),
        density=cat(flat, 0), rgb_sa=cat(rgb_sa, 3), rgb_ss=cat(rgb_ss, 3),
        rgb_le=cat(rgb_le, 3),
        rgb_offset=torch.tensor(rows["roff"], dtype=torch.int32),
        max_density=_f32(rows["maxd"]),
        maj=torch.from_numpy(np.stack(rows["maj"])),
        defl_strength=_f32(defl_s), defl_center=_f32(rows["defl_c"]),
        brick_table=torch.from_numpy(np.concatenate(brick_tabs) if brick_tabs
                                     else np.full(1, -1, np.int32)),
        brick_vals=torch.from_numpy(pool if pool.size else np.zeros(1, np.float32)),
        brick_tab_off=torch.tensor(rows["btab"], dtype=torch.int32),
        brick_base=torch.tensor(rows["bbase"], dtype=torch.int32),
        brick_bg=_f32(rows["bbg"]),
        n_media=len(media), has_grid=bool(flat or rgb_sa), has_brick=bool(brick_tabs),
        has_deflection=any(s != 0.0 for s in defl_s), has_rgb=bool(rgb_sa))
