"""Dependency-free image I/O: PNG (8/16-bit grey, RGB, RGBA) and PFM (float
HDR) readers and writers, for textures and environment maps.

The port's own copy of ``hikari_tpu/film/imageio.py`` (host numpy, no
JAX): the same decoding, so both packages read an image to the same array.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters (None, Sub, Up, Average, Paeth)."""
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for row in range(h):
        filt = raw[pos]
        cur = np.frombuffer(raw, np.uint8, stride, pos + 1).copy()
        pos += 1 + stride
        if filt == 1:  # Sub
            for i in range(bpp, stride):
                cur[i] = (int(cur[i]) + int(cur[i - bpp])) & 0xFF
        elif filt == 2:  # Up
            cur = (cur + prev) & 0xFF
        elif filt == 3:  # Average
            for i in range(stride):
                left = int(cur[i - bpp]) if i >= bpp else 0
                cur[i] = (int(cur[i]) + ((left + int(prev[i])) >> 1)) & 0xFF
        elif filt == 4:  # Paeth
            for i in range(stride):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                c = int(prev[i - bpp]) if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (int(cur[i]) + pred) & 0xFF
        elif filt != 0:
            raise ValueError(f"PNG filter {filt}")
        out[row] = cur
        prev = cur
    return out


def read_png(path) -> np.ndarray:
    """Decode a PNG into (H, W, 3) float32 in [0, 1] (alpha dropped): 8- or
    16-bit greyscale (colour type 0), RGB (2) or RGBA (6), not interlaced."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    w = h = depth = ctype = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if interlace != 0 or ctype not in (0, 2, 6) or depth not in (8, 16):
                raise ValueError(f"{path}: PNG colour type {ctype}, bit depth {depth}, "
                                 f"interlace {interlace} unsupported")
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    nch = {0: 1, 2: 3, 6: 4}[ctype]
    bpp = nch * (depth // 8)
    out = _unfilter(zlib.decompress(idat), h, w * bpp, bpp)
    if depth == 8:
        img = out.reshape(h, w, nch).astype(np.float32) / 255.0
    else:
        img = out.reshape(h, w, nch, 2).astype(np.uint16)
        img = ((img[..., 0] << 8) | img[..., 1]).astype(np.float32) / 65535.0
    if nch == 1:
        img = np.repeat(img, 3, axis=-1)
    return img[..., :3]


def read_pfm(path) -> np.ndarray:
    """Portable FloatMap reader -> (H, W, 3) float32 (HDR environment maps)."""
    with open(path, "rb") as f:
        head = f.readline().strip()
        if head not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM")
        color = head == b"PF"
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        count = w * h * (3 if color else 1)
        data = np.frombuffer(f.read(count * 4), "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, 3 if color else 1).astype(np.float32)[::-1]  # rows bottom-up
    if not color:
        img = np.repeat(img, 3, axis=-1)
    return img


def write_pfm(path, img) -> None:
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        f.write(img[::-1].astype("<f4").tobytes())


def load_image(path) -> np.ndarray:
    """By extension: .png / .pfm / .npy / .npz['image']."""
    p = str(path).lower()
    if p.endswith(".png"):
        return read_png(path)
    if p.endswith(".pfm"):
        return read_pfm(path)
    if p.endswith(".npy"):
        return np.asarray(np.load(path), np.float32)
    if p.endswith(".npz"):
        with np.load(path) as z:
            return np.asarray(z["image"], np.float32)
    raise ValueError(f"unsupported image format: {path}")
