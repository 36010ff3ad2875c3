"""Hosek-Wilkie spectral sky, baked to an environment light.

Port of ``hikari_tpu/lights/sunsky.py`` (sun_sky.jl + hosek_wilkie_data.jl,
themselves ports of the ArHosekSkyModel, Hosek & Wilkie 2012, and of
pbrt-v4's makesky): the 11-band spectral model (320-720 nm) is evaluated at
13 wavelengths over an equal-area octahedral map, converted XYZ -> linear
sRGB, and returned as an EnvironmentLight plus a separate delta SunLight.
The bake is host numpy in float64, stored as float32, as the JAX package's;
it reads the port's own copy of the model's tables
(``data/hosek_wilkie.npz``).
"""

from __future__ import annotations

import numpy as np

from .._data import load_npz
from .types import EnvironmentLight, SunLight, equal_area_square_to_sphere_np


def _tables():
    z = load_npz("hosek_wilkie.npz")
    return z["configs"], z["radiances"], z["limb"], z["bands"]


def _bernstein5(t, c):
    """Quintic Bezier through 6 control points. c: (..., 6)."""
    s = 1.0 - t
    return (
        c[..., 0] * s**5
        + c[..., 1] * 5.0 * t * s**4
        + c[..., 2] * 10.0 * t**2 * s**3
        + c[..., 3] * 10.0 * t**3 * s**2
        + c[..., 4] * 5.0 * t**4 * s
        + c[..., 5] * t**5
    )


def _cook_config(dataset, turbidity, albedo, elevation):
    """ArHosekSkyModel_CookConfiguration. dataset: (1080,) = [albedo 0|1][10
    turbidities][6 ctrl pts][9 coeffs]. Returns (9,) config."""
    d = dataset.reshape(2, 10, 6, 9)
    it = int(np.clip(np.floor(turbidity), 1, 10))
    rem = turbidity - it
    t = (elevation / (np.pi / 2.0)) ** (1.0 / 3.0)

    def quintic(alb, turb_i):
        ctrl = d[alb, turb_i]            # (6, 9)
        return _bernstein5(t, ctrl.T)    # (9,)

    cfg = (1.0 - albedo) * (1.0 - rem) * quintic(0, it - 1)
    cfg += albedo * (1.0 - rem) * quintic(1, it - 1)
    if it < 10:
        cfg += (1.0 - albedo) * rem * quintic(0, it)
        cfg += albedo * rem * quintic(1, it)
    return cfg


def _cook_radiance(dataset, turbidity, albedo, elevation):
    """dataset: (120,) = [2 albedos][10 turbidities][6 ctrl points]."""
    d = dataset.reshape(2, 10, 6)
    it = int(np.clip(np.floor(turbidity), 1, 10))
    rem = turbidity - it
    t = (elevation / (np.pi / 2.0)) ** (1.0 / 3.0)
    res = (1.0 - albedo) * (1.0 - rem) * _bernstein5(t, d[0, it - 1])
    res += albedo * (1.0 - rem) * _bernstein5(t, d[1, it - 1])
    if it < 10:
        res += (1.0 - albedo) * rem * _bernstein5(t, d[0, it])
        res += albedo * rem * _bernstein5(t, d[1, it])
    return res


def _radiance(cfg, theta, gamma):
    """ArHosekSkyModel_GetRadianceInternal, vectorized over pixels."""
    cos_g = np.cos(gamma)
    cos_t = np.maximum(np.cos(theta), 0.0)
    exp_m = np.exp(cfg[4] * gamma)
    ray_m = cos_g * cos_g
    mie_m = (1.0 + cos_g * cos_g) / (
        (1.0 + cfg[8] * cfg[8] - 2.0 * cfg[8] * cos_g) ** 1.5
    )
    zenith = np.sqrt(cos_t)
    return (1.0 + cfg[0] * np.exp(cfg[1] / (cos_t + 0.01))) * (
        cfg[2] + cfg[3] * exp_m + cfg[5] * ray_m + cfg[6] * mie_m + cfg[7] * zenith
    )


def sky_spectral_radiance(theta, gamma, lam, turbidity, albedo, elevation):
    """Sky radiance at wavelength lam (nm), linear band interpolation
    (arhosekskymodel_radiance). theta/gamma arrays broadcast."""
    configs, radiances, _, bands = _tables()
    x = (lam - 320.0) / 40.0
    lo = int(np.floor(x))
    if lo < 0 or lo >= 11:
        return np.zeros_like(theta)
    frac = x - lo

    def band(i):
        cfg = _cook_config(configs[i], turbidity, albedo, elevation)
        rad = _cook_radiance(radiances[i], turbidity, albedo, elevation)
        return _radiance(cfg, theta, gamma) * rad

    val = (1.0 - frac) * band(lo)
    if frac > 1e-6 and lo + 1 < 11:
        val = val + frac * band(lo + 1)
    return val


def _xyz_tables():
    z = load_npz("cie_xyz.npz")
    return z["x"], z["y"], z["z"]


def sunsky_environment(
    direction=(0.3, 0.4, 1.0),
    intensity: float = 1.0,
    turbidity: float = 2.5,
    ground_albedo=(0.3, 0.3, 0.3),
    ground_enabled: bool = True,
    resolution: int = 256,
    up: str = "z",
):
    """Bake the Hosek-Wilkie sky and return (EnvironmentLight, SunLight)
    (sunsky_to_envlight, sun_sky.jl:358-434).

    direction points TO the sun; `up` selects the world up axis ('z' like
    the reference bake, or 'y')."""
    dirn = np.asarray(direction, np.float64)
    dirn = dirn / np.linalg.norm(dirn)
    up_axis = {"z": 2, "y": 1}[up]
    elevation = float(np.arcsin(np.clip(dirn[up_axis], 0.0, 1.0)))
    albedo = float(np.mean(ground_albedo))

    n_lam = 13
    lams = np.linspace(320.0, 720.0, n_lam)

    res = resolution
    uu, vv = np.meshgrid(
        (np.arange(res) + 0.5) / res, (np.arange(res) + 0.5) / res
    )
    wi = equal_area_square_to_sphere_np(uu, vv)   # (res, res, 3), z-up map
    if up_axis == 1:  # rotate so map z maps to world y
        wi = wi[..., [0, 2, 1]] * np.array([1.0, 1.0, 1.0])

    cos_up = wi[..., up_axis]
    theta = np.arccos(np.clip(cos_up, 0.0, 1.0))
    cos_gamma = np.clip(np.einsum("...k,k->...", wi, dirn), -1.0, 1.0)
    gamma = np.arccos(cos_gamma)

    spec = np.stack(
        [
            sky_spectral_radiance(theta, gamma, l, turbidity, albedo, elevation)
            for l in lams
        ],
        axis=-1,
    )  # (res, res, 13)

    # spectrum -> XYZ (Riemann sum / CIE Y integral), then linear sRGB
    cx, cy, cz = _xyz_tables()
    li = np.clip((lams - 360.0).astype(int), 0, 470)
    wx = cx[li]
    wy = cy[li]
    wz = cz[li]
    dl = lams[1] - lams[0]
    y_int = float(np.sum(cy))
    x = np.sum(spec * wx, -1) * dl / y_int
    y = np.sum(spec * wy, -1) * dl / y_int
    z = np.sum(spec * wz, -1) * dl / y_int
    m = np.array(
        [
            [3.2406, -1.5372, -0.4986],
            [-0.9689, 1.8758, 0.0415],
            [0.0557, -0.2040, 1.0570],
        ]
    )
    rgb = np.einsum("ij,...j->...i", m, np.stack([x, y, z], -1))
    rgb = np.maximum(rgb, 0.0)

    below = cos_up <= 0.0
    if ground_enabled:
        rgb[below] = np.asarray(ground_albedo, np.float64) * 0.3

    env = EnvironmentLight(image=rgb.astype(np.float32), scale=float(intensity))
    sun_scale = 5.0 * intensity
    sun = SunLight(
        direction=tuple(-dirn),
        radiance=(sun_scale, sun_scale * 0.95, sun_scale * 0.85),
    )
    return env, sun
