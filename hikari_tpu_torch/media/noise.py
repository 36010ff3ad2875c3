"""Procedural noise + cloud density generation (host-side, vectorized numpy).

The port's copy of ``hikari_tpu/media/noise.py`` (perlin3d, fbm3d,
worley3d, worley_fbm3d, generate_cloud_density): the same code, so both
packages fill a CloudVolume with the same grid; only this docstring
differs (``tests/test_torch_independence.py`` holds the rest to the
original). Gradients and feature points derive from an integer hash
instead of a permutation table, and everything is vectorized over whole
grids: one call generates the full volume.
"""

from __future__ import annotations

import numpy as np


def _hash3(ix, iy, iz, seed=0):
    """Integer lattice hash -> uint32 (xxhash-style mixing)."""
    h = (
        ix.astype(np.uint32) * np.uint32(0x8DA6B343)
        + iy.astype(np.uint32) * np.uint32(0xD8163841)
        + iz.astype(np.uint32) * np.uint32(0xCB1AB31F)
        + np.uint32((seed * 0x9E3779B9) & 0xFFFFFFFF)
    )
    h ^= h >> np.uint32(13)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(16)
    return h


def _grad_dot(ix, iy, iz, fx, fy, fz, seed=0):
    """Dot of a pseudo-random unit-ish gradient with the offset vector.
    Gradient = one of the 12 edge directions of a cube (Perlin's set)."""
    h = _hash3(ix, iy, iz, seed) % np.uint32(12)
    # 12 edge vectors
    gx = np.select([h < 4, (h >= 4) & (h < 8)], [np.where(h % 2 == 0, 1.0, -1.0), 0.0],
                   np.where(h % 2 == 0, 1.0, -1.0))
    gy = np.select([h < 4, (h >= 4) & (h < 8)], [np.where(h % 4 < 2, 1.0, -1.0),
                   np.where(h % 2 == 0, 1.0, -1.0)], 0.0)
    gz = np.select([h < 4, (h >= 4) & (h < 8)], [0.0, np.where(h % 4 < 2, 1.0, -1.0)],
                   np.where(h % 4 < 2, 1.0, -1.0))
    return gx * fx + gy * fy + gz * fz


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin3d(x, y, z, seed=0):
    """Gradient noise in approximately [-1, 1]; arrays broadcast."""
    x, y, z = np.broadcast_arrays(
        np.asarray(x, np.float64), np.asarray(y, np.float64), np.asarray(z, np.float64)
    )
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    z0 = np.floor(z).astype(np.int64)
    fx = x - x0
    fy = y - y0
    fz = z - z0
    u, v, w = _fade(fx), _fade(fy), _fade(fz)

    def g(dx, dy, dz):
        return _grad_dot(x0 + dx, y0 + dy, z0 + dz, fx - dx, fy - dy, fz - dz, seed)

    def lerp(a, b, t):
        return a + (b - a) * t

    c00 = lerp(g(0, 0, 0), g(1, 0, 0), u)
    c10 = lerp(g(0, 1, 0), g(1, 1, 0), u)
    c01 = lerp(g(0, 0, 1), g(1, 0, 1), u)
    c11 = lerp(g(0, 1, 1), g(1, 1, 1), u)
    return lerp(lerp(c00, c10, v), lerp(c01, c11, v), w)


def fbm3d(x, y, z, octaves=4, persistence=0.5, lacunarity=2.0, seed=0):
    """Fractional Brownian motion over perlin3d, ~[-1, 1]."""
    total = 0.0
    amp = 1.0
    freq = 1.0
    norm = 0.0
    for i in range(octaves):
        total = total + perlin3d(x * freq, y * freq, z * freq, seed + i) * amp
        norm += amp
        amp *= persistence
        freq *= lacunarity
    return total / norm


def worley3d(x, y, z, seed=0):
    """Cellular noise: distance to the nearest feature point, [0, ~1.5]."""
    x, y, z = np.broadcast_arrays(
        np.asarray(x, np.float64), np.asarray(y, np.float64), np.asarray(z, np.float64)
    )
    xi = np.floor(x).astype(np.int64)
    yi = np.floor(y).astype(np.int64)
    zi = np.floor(z).astype(np.int64)
    fx, fy, fz = x - xi, y - yi, z - zi
    best = np.full(x.shape, 10.0)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                h = _hash3(xi + dx, yi + dy, zi + dz, seed)
                px = dx + (h & 1023).astype(np.float64) / 1024.0
                py = dy + ((h >> 10) & 1023).astype(np.float64) / 1024.0
                pz = dz + ((h >> 20) & 1023).astype(np.float64) / 1024.0
                d = np.sqrt((fx - px) ** 2 + (fy - py) ** 2 + (fz - pz) ** 2)
                best = np.minimum(best, d)
    return best


def worley_fbm3d(x, y, z, octaves=3, persistence=0.5, lacunarity=2.0, seed=0):
    total = 0.0
    amp = 1.0
    freq = 1.0
    norm = 0.0
    for i in range(octaves):
        total = total + worley3d(x * freq, y * freq, z * freq, seed + 17 * (i + 1)) * amp
        norm += amp
        amp *= persistence
        freq *= lacunarity
    return total / norm


def generate_cloud_density(
    resolution: int,
    scale=4.0,
    sphere_falloff=True,
    threshold=0.3,
    worley_weight=0.6,
    edge_sharpness=1.5,
    density_scale=3.0,
    seed=0,
) -> np.ndarray:
    """Puffy-cloud density grid (nz, ny, nx) float32 in [0, density_scale]
    (generate_cloud_density, random.jl:131-206): inverted multi-octave
    Worley cells + billowed Perlin ridges + fine turbulence, optionally
    masked by a noise-perturbed spherical falloff."""
    r = resolution
    axis = (np.arange(r) + 0.5) / r
    z, y, x = np.meshgrid(axis, axis, axis, indexing="ij")

    worley = 1.0 - worley_fbm3d(
        x * scale * 0.8, y * scale * 0.8, z * scale * 0.8, octaves=3, seed=seed
    )
    billow = 1.0 - np.abs(
        fbm3d(x * scale * 1.5, y * scale * 1.5, z * scale * 1.5,
              octaves=4, persistence=0.55, seed=seed + 101)
    )
    base = worley_weight * worley + (1.0 - worley_weight) * billow
    base = base + 0.12 * fbm3d(
        x * scale * 4.0 + 13.7, y * scale * 4.0 - 5.3, z * scale * 4.0 + 9.1,
        octaves=3, seed=seed + 202,
    )

    val = np.clip((base - threshold) / (1.0 - threshold), 0.0, 1.0)

    if sphere_falloff:
        center, radius = 0.5, 0.45
        dist = np.sqrt((x - center) ** 2 + (y - center) ** 2 + (z - center) ** 2)
        boundary = 0.15 * fbm3d(
            x * scale * 2.0 + 7.1, y * scale * 2.0, z * scale * 2.0 - 3.3,
            octaves=3, seed=seed + 303,
        )
        eff_r = radius * (1.0 + boundary)
        t = dist / np.maximum(eff_r, 1e-6)
        falloff_mod = 0.3 + 0.7 * base
        edge = np.clip(1.0 - (t / np.maximum(falloff_mod, 1e-6)) ** edge_sharpness, 0.0, 1.0)
        out = np.where(dist < eff_r, val * edge, 0.0)
    else:
        out = val
    return (out * density_scale).astype(np.float32)
