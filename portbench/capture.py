"""What the timed path produces, kept for the check after the window.

The wrappers sit on module attributes the program's callers look up at
call time and add no host sync: the lanes of the sampled pixels are found
by a stable sort of a membership mask, sized from the wavefront's shape,
with a validity flag for each kept slot."""

from __future__ import annotations

import torch

STATE_KEYS = ("o", "d", "beta", "r_u", "r_l", "L", "alive", "spec", "eta", "anyns",
              "prev_p", "prev_ns", "disp", "lam", "px", "py", "si", "med")


def lane_key(si, px, py, w, h):
    return (si.long() * h + py.long()) * w + px.long()


class PixelSet:
    """The sampled pixels: (px, py) on the device and a membership mask."""

    def __init__(self, px, py, w, h, device):
        self.px = torch.as_tensor(px, device=device).long()
        self.py = torch.as_tensor(py, device=device).long()
        self.w, self.h = w, h
        self.mask = torch.zeros(w * h, dtype=torch.bool, device=device)
        self.mask[self.py * w + self.px] = True

    def select(self, px, py, n_per_pixel: int):
        """(positions, valid) of the lanes of the sampled pixels, no sync."""
        m = self.mask[py.long() * self.w + px.long()]
        k = min(m.numel(), self.px.numel() * max(n_per_pixel, 1))
        pos = torch.sort(m.to(torch.uint8), descending=True, stable=True).indices[:k]
        return pos, m[pos]


class VolPathCapture:
    """Wraps volpath.render_lanes (each wavefront's lanes of the sampled
    pixels: key, rgb, filter weight) and volpath._bounce_core (the state in
    and out of every bounce of the wavefronts in `bounce_waves`)."""

    def __init__(self, volpath, pixels: PixelSet, bounce_waves):
        self.vp_mod = volpath
        self.pix = pixels
        self.bounce_waves = set(bounce_waves)
        self.wave = -1
        self.active = False
        self.lanes = []     # per wavefront: dict(key, rgb, w, valid)
        self.bounces = {}   # wavefront -> [(depth, in, out, valid)]

    def __enter__(self):
        self.orig = (self.vp_mod.render_lanes, self.vp_mod._bounce_core)
        self.vp_mod.render_lanes = self._render_lanes
        self.vp_mod._bounce_core = self._bounce_core
        return self

    def __exit__(self, *exc):
        self.vp_mod.render_lanes, self.vp_mod._bounce_core = self.orig

    def _per_pixel(self, px):
        return max(1, px.numel() // (self.pix.w * self.pix.h))

    def _render_lanes(self, vp, scene, camera, filt, sample_idx, px, py, *args, **kw):
        self.wave += 1
        self.active = self.wave in self.bounce_waves
        try:
            out = self.orig[0](vp, scene, camera, filt, sample_idx, px, py, *args, **kw)
        finally:
            self.active = False
        if kw.get("return_carry"):
            return out
        rgb, filter_w, _ = out
        px = torch.as_tensor(px, device=rgb.device)
        py = torch.as_tensor(py, device=rgb.device)
        si = torch.as_tensor(sample_idx, device=rgb.device).long().expand(px.shape[0])
        pos, valid = self.pix.select(px, py, self._per_pixel(px))
        self.lanes.append(dict(key=lane_key(si[pos], px[pos], py[pos], self.pix.w, self.pix.h),
                               rgb=rgb[pos], w=filter_w[pos], valid=valid))
        return out

    def _bounce_core(self, vp, scene, zcfg, depth, st, rays, *args, **kw):
        out = self.orig[1](vp, scene, zcfg, depth, st, rays, *args, **kw)
        if self.active:
            pos, valid = self.pix.select(st["px"], st["py"], self._per_pixel(st["px"]))
            keep = lambda s: {k: s[k][pos].clone() for k in STATE_KEYS}
            self.bounces.setdefault(self.wave, []).append((depth, keep(st), keep(out[0]), valid))
        return out


class PreviewCapture:
    """Wraps preview.preview_lanes: each frame's RGB at the sampled pixels."""

    def __init__(self, preview, pixels: PixelSet):
        self.pv_mod = preview
        self.pix = pixels
        self.rgb = []

    def __enter__(self):
        self.orig = self.pv_mod.preview_lanes
        self.pv_mod.preview_lanes = self._preview_lanes
        return self

    def __exit__(self, *exc):
        self.pv_mod.preview_lanes = self.orig

    def _preview_lanes(self, integ, scene, camera, sample_idx, *args, **kw):
        img = self.orig(integ, scene, camera, sample_idx, *args, **kw)
        self.rgb.append(img[self.pix.py, self.pix.px].clone())
        return img
