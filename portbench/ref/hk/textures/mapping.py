"""Texture coordinate mappings (port of ``hikari_tpu/textures/mapping.py``;
the reference's mapping.jl:9-58).

UVMapping2D lives inside ImageTexture as uv_scale / uv_offset (su, sv, du,
dv), applied at every atlas lookup. TransformMapping3D maps world-space
shading points through a linear transform into texture space, for the
procedural 3D fields of ``media/noise.py``; its derivative is the same
transform applied to dpdx / dpdy. eval_noise3d computes those fields with
torch on the points' device (media/noise.py is host numpy, the JAX
package's code).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.transform import Transform


@dataclass
class UVMapping2D:
    """su / sv scale and du / dv offset of surface uv (mapping.jl:9-14);
    ``as_texture_kwargs()`` gives the ImageTexture fields."""

    su: float = 1.0
    sv: float = 1.0
    du: float = 0.0
    dv: float = 0.0

    def as_texture_kwargs(self) -> dict:
        return {"uv_scale": (self.su, self.sv), "uv_offset": (self.du, self.dv)}

    def map(self, uv: torch.Tensor, duvdx=None, duvdy=None):
        """(st, dstdx, dstdy): texture coordinates and their screen
        derivatives (mapping.jl:31-37)."""
        sc = torch.tensor([self.su, self.sv], dtype=torch.float32, device=uv.device)
        st = uv * sc + torch.tensor([self.du, self.dv], dtype=torch.float32, device=uv.device)
        dx = duvdx * sc if duvdx is not None else None
        dy = duvdy * sc if duvdy is not None else None
        return st, dx, dy


@dataclass
class TransformMapping3D:
    """World-space point -> texture-space point through a linear transform
    (mapping.jl:49-58), typically the object-space inverse."""

    world_to_texture: Transform

    def map(self, p: torch.Tensor, dpdx=None, dpdy=None):
        """(pt, dptdx, dptdy) in texture space; derivatives transform as
        vectors, the mapping being linear."""
        t = self.world_to_texture
        dx = t.apply_vector(dpdx) if dpdx is not None else None
        dy = t.apply_vector(dpdy) if dpdy is not None else None
        return t.apply_point(p), dx, dy


_MASK32 = 0xFFFFFFFF


def _hash3(ix, iy, iz, seed=0):
    """media/noise.py's lattice hash on int64 tensors: the uint32 word in
    [0, 2^32) (products wrap modulo 2^64, and their low 32 bits are the
    uint32 product's)."""
    h = ((ix & _MASK32) * 0x8DA6B343 + (iy & _MASK32) * 0xD8163841
         + (iz & _MASK32) * 0xCB1AB31F + ((seed * 0x9E3779B9) & _MASK32)) & _MASK32
    h = h ^ (h >> 13)
    h = (h * 0x85EBCA6B) & _MASK32
    return h ^ (h >> 16)


def _grad_dot(ix, iy, iz, fx, fy, fz, seed=0):
    h = _hash3(ix, iy, iz, seed) % 12
    lo, mid = h < 4, (h >= 4) & (h < 8)
    s2 = torch.where(h % 2 == 0, 1.0, -1.0).double()
    s4 = torch.where(h % 4 < 2, 1.0, -1.0).double()
    gx = torch.where(mid, 0.0, s2)
    gy = torch.where(lo, s4, torch.where(mid, s2, 0.0))
    gz = torch.where(lo, 0.0, s4)
    return gx * fx + gy * fy + gz * fz


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _perlin3d(x, y, z, seed=0):
    """media/noise.py's perlin3d on float64 tensors, on their device."""
    x0, y0, z0 = (torch.floor(c).long() for c in (x, y, z))
    fx, fy, fz = x - x0, y - y0, z - z0
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


def _fbm3d(x, y, z, octaves=4, persistence=0.5, lacunarity=2.0, seed=0):
    total, amp, freq, norm = 0.0, 1.0, 1.0, 0.0
    for i in range(octaves):
        total = total + _perlin3d(x * freq, y * freq, z * freq, seed + i) * amp
        norm += amp
        amp *= persistence
        freq *= lacunarity
    return total / norm


def _worley3d(x, y, z, seed=0):
    """media/noise.py's worley3d on float64 tensors, on their device."""
    xi, yi, zi = (torch.floor(c).long() for c in (x, y, z))
    fx, fy, fz = x - xi, y - yi, z - zi
    best = torch.full_like(x, 10.0)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                h = _hash3(xi + dx, yi + dy, zi + dz, seed)
                px = dx + (h & 1023).double() / 1024.0
                py = dy + ((h >> 10) & 1023).double() / 1024.0
                pz = dz + ((h >> 20) & 1023).double() / 1024.0
                d = torch.sqrt((fx - px) ** 2 + (fy - py) ** 2 + (fz - pz) ** 2)
                best = torch.minimum(best, d)
    return best


def eval_noise3d(mapping: TransformMapping3D, p: torch.Tensor, kind: str = "perlin",
                 octaves: int = 4) -> torch.Tensor:
    """A procedural 3D field of ``media/noise.py`` (perlin, worley, fbm) at
    world points through the mapping, computed in float64 on p's device;
    float32 out."""
    pt, _, _ = mapping.map(p)
    x, y, z = pt.double().unbind(-1)
    if kind == "perlin":
        out = _perlin3d(x, y, z)
    elif kind == "worley":
        out = _worley3d(x, y, z)
    elif kind == "fbm":
        out = _fbm3d(x, y, z, octaves=octaves)
    else:
        raise ValueError(f"unknown noise kind {kind!r}")
    return out.float()
