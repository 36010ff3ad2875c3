"""Texture atlas: storage and per-lane evaluation of surface textures.

Port of ``hikari_tpu/textures/atlas.py``. Every image of a scene, with its
mip pyramid, is packed into one flat (T, 3) texel buffer with per-texture,
per-level (offset, width, height); a material field stores an int32
reference:

    tex_id >= 0  -> image texture `tex_id` of the atlas (bilinear, wrap)
    tex_id == -1 -> constant (the value stored in the material bank)
    tex_id == -2 -> vertex colour (barycentric-interpolated mesh colours)

The builder is host numpy and equals the JAX package's array for array;
lookups are two gathers and a lerp per lane. Texel indices wrap with a
floor modulo (``torch.remainder``), as ``jnp.mod`` does, so uv outside
[0, 1) tiles the image.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

CONST_TEX = -1
VERTEX_TEX = -2


@dataclass
class ImageTexture:
    """Image-backed texture. image: (H, W, 3) or (H, W) float; uv wraps.
    uv_scale / uv_offset are the reference's UVMapping2D (su, sv, du, dv)
    parameters (mapping.jl:9-37): st = uv * scale + offset."""

    image: np.ndarray
    uv_scale: tuple = (1.0, 1.0)
    uv_offset: tuple = (0.0, 0.0)


@dataclass
class VertexColorTexture:
    """Per-vertex colour interpolated by barycentrics (basic.jl
    VertexColorTexture)."""


@dataclass
class TextureAtlas:
    """All scene images and their mip pyramids in one flat texel buffer.
    Level arrays are (K, L), the last real level repeated out to L, so a
    lookup never indexes past a texture's pyramid."""

    data: torch.Tensor       # (T, 3) float32 texels, all levels concatenated
    offset: torch.Tensor     # (K, L) int32 per-level start
    width: torch.Tensor      # (K, L) int32
    height: torch.Tensor     # (K, L) int32
    uv_scale: torch.Tensor   # (K, 2)
    uv_offset: torch.Tensor  # (K, 2)

    def to(self, device) -> "TextureAtlas":
        return TextureAtlas(**{f.name: getattr(self, f.name).to(device) for f in fields(self)})


def _downsample(im: np.ndarray) -> np.ndarray:
    """One mip level: odd sizes padded by their last row / column, then a
    2x2 box (a 2x1 box where one side is 1)."""
    h, w, _ = im.shape
    if h > 1 and h % 2:
        im = np.concatenate([im, im[-1:]], axis=0)
    if w > 1 and w % 2:
        im = np.concatenate([im, im[:, -1:]], axis=1)
    h, w, _ = im.shape
    if h == 1:
        return 0.5 * (im[:, 0::2] + im[:, 1::2]) if w > 1 else im
    if w == 1:
        return 0.5 * (im[0::2] + im[1::2])
    return 0.25 * (im[0::2, 0::2] + im[1::2, 0::2] + im[0::2, 1::2] + im[1::2, 1::2])


class AtlasBuilder:
    """Host-side accumulation of scene textures during material packing."""

    def __init__(self):
        self.images: list[np.ndarray] = []
        self.uv_scales: list[tuple] = []
        self.uv_offsets: list[tuple] = []

    def add(self, tex: ImageTexture) -> int:
        img = np.asarray(tex.image, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"ImageTexture.image: shape {img.shape}, expected (H, W) or "
                             "(H, W, 3)")
        self.images.append(img)
        self.uv_scales.append(tuple(tex.uv_scale))
        self.uv_offsets.append(tuple(tex.uv_offset))
        return len(self.images) - 1

    def build(self) -> TextureAtlas:
        """The atlas on the CPU (the scene moves it to its device); a
        one-texel dummy when no image was added."""
        if not self.images:
            return TextureAtlas(
                data=torch.zeros((1, 3)), offset=torch.zeros((1, 1), dtype=torch.int32),
                width=torch.ones((1, 1), dtype=torch.int32),
                height=torch.ones((1, 1), dtype=torch.int32),
                uv_scale=torch.ones((1, 2)), uv_offset=torch.zeros((1, 2)))
        pyramids = []
        for img in self.images:
            levels = [img]
            while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
                levels.append(_downsample(levels[-1]))
            pyramids.append(levels)
        lmax = max(len(p) for p in pyramids)
        chunks, offs, ws, hs = [], [], [], []
        cur = 0
        for levels in pyramids:
            o_row, w_row, h_row = [], [], []
            for im in levels:
                h, w, _ = im.shape
                o_row.append(cur)
                w_row.append(w)
                h_row.append(h)
                chunks.append(im.reshape(-1, 3))
                cur += h * w
            pad = lmax - len(o_row)  # repeat the 1x1 tail level
            offs.append(o_row + o_row[-1:] * pad)
            ws.append(w_row + w_row[-1:] * pad)
            hs.append(h_row + h_row[-1:] * pad)

        def i32(rows):
            return torch.tensor(rows, dtype=torch.int32)

        return TextureAtlas(
            data=torch.from_numpy(np.concatenate(chunks).astype(np.float32)),
            offset=i32(offs), width=i32(ws), height=i32(hs),
            uv_scale=torch.tensor(self.uv_scales, dtype=torch.float32),
            uv_offset=torch.tensor(self.uv_offsets, dtype=torch.float32))


@dataclass
class TexCtx:
    """Per-lane evaluation context (the reference's TextureFilterContext,
    texture-ref.jl:21-33)."""

    uv: torch.Tensor                    # (..., 2)
    vcolor: torch.Tensor                # (..., 3) interpolated vertex colour
    duvdx: torch.Tensor | None = None   # (..., 2) screen-space uv derivative
    duvdy: torch.Tensor | None = None

    def take(self, ix) -> "TexCtx":
        """The context of lanes `ix` (an index tensor or a slice)."""
        return TexCtx(*(None if getattr(self, f.name) is None else getattr(self, f.name)[ix]
                        for f in fields(self)))


def atlas_lookup(atlas: TextureAtlas, tex: torch.Tensor, uv: torch.Tensor, level=None):
    """Bilinear wrap-mode fetch at one mip level. tex (...,) int >= 0, uv
    (..., 2) -> (..., 3)."""
    t = torch.clamp(tex, min=0).long()
    lvl = torch.zeros_like(t) if level is None else level.long()
    off = atlas.offset[t, lvl].long()
    w = atlas.width[t, lvl].long()
    h = atlas.height[t, lvl].long()
    sc = atlas.uv_scale[t]
    do = atlas.uv_offset[t]
    u = uv[..., 0] * sc[..., 0] + do[..., 0]
    # image rows run top-down; flip v so uv = (0, 0) is the bottom-left texel
    v = 1.0 - (uv[..., 1] * sc[..., 1] + do[..., 1])
    x = u * w.float() - 0.5
    y = v * h.float() - 0.5
    x0 = torch.floor(x).to(torch.int32).long()
    y0 = torch.floor(y).to(torch.int32).long()
    fx = (x - x0.float())[..., None]
    fy = (y - y0.float())[..., None]
    last = atlas.data.shape[0] - 1

    def at(xi, yi):
        lin = off + torch.remainder(yi, h) * w + torch.remainder(xi, w)
        return atlas.data[torch.clamp(lin, 0, last)]

    return (at(x0, y0) * (1 - fx) * (1 - fy) + at(x0 + 1, y0) * fx * (1 - fy)
            + at(x0, y0 + 1) * (1 - fx) * fy + at(x0 + 1, y0 + 1) * fx * fy)


def _lod(atlas: TextureAtlas, tex, ctx: TexCtx):
    """Trilinear level of detail from the uv screen derivatives: log2 of
    the pixel footprint in base-level texels."""
    t = torch.clamp(tex, min=0).long()
    w0 = atlas.width[t, 0].float()
    h0 = atlas.height[t, 0].float()
    sc = atlas.uv_scale[t]
    dx = ctx.duvdx * sc
    dy = ctx.duvdy * sc
    fx = torch.sqrt((dx[..., 0] * w0) ** 2 + (dx[..., 1] * h0) ** 2)
    fy = torch.sqrt((dy[..., 0] * w0) ** 2 + (dy[..., 1] * h0) ** 2)
    width = torch.clamp(torch.maximum(fx, fy), min=1e-8)
    return torch.clamp(torch.log2(width), 0.0, atlas.offset.shape[1] - 1.001)


def textured_lookup(atlas: TextureAtlas, tex, ctx: TexCtx):
    """Trilinearly filtered lookup where derivatives are available."""
    if ctx.duvdx is None or atlas.offset.shape[1] == 1:
        return atlas_lookup(atlas, tex, ctx.uv)
    lod = _lod(atlas, tex, ctx)
    l0 = torch.floor(lod).to(torch.int32)
    f = (lod - l0.float())[..., None]
    c0 = atlas_lookup(atlas, tex, ctx.uv, l0)
    c1 = atlas_lookup(atlas, tex, ctx.uv, torch.clamp(l0 + 1, max=atlas.offset.shape[1] - 1))
    return c0 * (1.0 - f) + c1 * f


def eval_rgb(atlas: TextureAtlas, tex, const_rgb, ctx: TexCtx):
    """Resolve an RGB material field: image, vertex colour or constant
    (eval_tex, texture-ref.jl)."""
    img = textured_lookup(atlas, tex, ctx)
    out = torch.where((tex >= 0)[..., None], img, const_rgb)
    return torch.where((tex == VERTEX_TEX)[..., None], ctx.vcolor, out)


def eval_scalar(atlas: TextureAtlas, tex, const_v, ctx: TexCtx):
    """Resolve a scalar field (roughness, alpha, a Mix amount): channel 0
    of the texture."""
    img = textured_lookup(atlas, tex, ctx)[..., 0]
    return torch.where(tex >= 0, img, const_v)
