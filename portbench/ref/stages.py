"""The reference's stages, on a subset of lanes: the camera stage and the
film conversion of ``render_lanes`` and one bounce of ``_bounce_core``
(``integrators/volpath.py`` of ``hikari_tpu_torch`` at commit 5d48e3d,
whose frozen copy is ``hk/``), and FastWavefront's lanes of given pixels.
Traversal is brute force (``hk/geometry/brute.py``)."""

from __future__ import annotations

import torch

from .hk.camera.camera import CameraSample
from .hk.film.filters import filter_sample, make_filter
from .hk.integrators import preview as rpv
from .hk.integrators import volpath as rvp
from .hk.sampling import sobol as sb
from .hk.spectral import spectrum as sp
from .hk.spectral.cie import spectral_to_xyz, xyz_to_linear_srgb

VolPath = rvp.VolPath


def zsobol(vp: VolPath, camera):
    w, h = camera.resolution
    return sb.make_zsobol(w, h, max(vp.samples_per_pixel, 1), seed=vp.seed)


def camera_state(vp: VolPath, scene, camera, si, px, py):
    """render_lanes' camera stage for lanes (si, px, py): (path state,
    filter weight, wavelength pdf), the state as _bounce_core takes it."""
    dev = scene.device
    n = px.shape[0]
    zcfg = zsobol(vp, camera)
    ps = sb.compute_pixel_sample(zcfg, px, py, si)
    offset, filter_w = filter_sample(make_filter(), ps.jitter)
    p_film = torch.stack([px.float(), py.float()], -1) + 0.5 + offset
    wl = sp.sample_wavelengths_visible(ps.wavelength_u)
    o, d = camera.generate_rays(CameraSample(p_film=p_film, lens=ps.lens,
                                             time=ps.time, filter_weight=filter_w))
    lam = wl.lam
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    st = dict(o=o, d=d, beta=torch.ones_like(lam), r_u=torch.ones_like(lam),
              r_l=torch.ones_like(lam), L=torch.zeros_like(lam), alive=ones, spec=ones,
              eta=torch.ones(n, device=dev), anyns=~ones, prev_p=o,
              prev_ns=torch.zeros_like(o), disp=~ones, lam=lam,
              px=px, py=py, si=si,
              med=torch.full((n,), scene.camera_medium, dtype=torch.int32, device=dev))
    return st, filter_w, wl.pdf


def bounce(vp: VolPath, scene, camera, depth: int, st: dict) -> dict:
    """One bounce of the lanes of state st."""
    out, _ = rvp._bounce_core(vp, scene, zsobol(vp, camera), depth, st,
                              torch.zeros((), device=scene.device), camera=camera)
    return out


def film_rgb(vp: VolPath, L, lam, disp, wl_pdf):
    """render_lanes' film conversion of the final radiance of each lane."""
    hero_only = torch.zeros_like(wl_pdf)
    hero_only[..., 0] = 0.25
    pdf_eff = torch.where(disp[..., None], wl_pdf * hero_only, wl_pdf)
    rgb = xyz_to_linear_srgb(spectral_to_xyz(L, lam, pdf_eff))
    mx = rgb.amax(-1)
    scale = torch.where(mx > vp.max_component_value,
                        vp.max_component_value / torch.clamp(mx, min=1e-12), 1.0)
    rgb = rgb * scale[..., None]
    return torch.nan_to_num(rgb, nan=0.0, posinf=0.0, neginf=0.0)


def preview_rgb(scene, camera, sample_idx: int, seed: int, spp: int, px, py):
    """FastWavefront's RGB of one sample of pixels (px, py)."""
    return rpv._preview_lanes(scene, camera, sample_idx, spp, seed, 2, pix=(px, py))
