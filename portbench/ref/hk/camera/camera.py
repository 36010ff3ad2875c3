"""Perspective (thin-lens) camera (port of ``hikari_tpu/camera/camera.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.transform import Transform, deg2rad, from_matrix, look_at, perspective
from ..core.vecmath import normalize
from ..sampling.distributions import concentric_sample_disk


@dataclass
class CameraSample:
    """Film-plane sample for one ray (camera.jl:3-34)."""

    p_film: torch.Tensor  # (..., 2) raster position in pixels
    lens: torch.Tensor    # (..., 2) in [0,1)^2
    time: torch.Tensor    # (...,)
    filter_weight: torch.Tensor  # (...,)


@dataclass
class PerspectiveCamera:
    """pbrt-style projective camera; camera space looks down +z."""

    camera_to_world: Transform
    raster_to_camera: Transform
    dx_camera: torch.Tensor  # (3,) camera-space offset of one raster pixel in x
    dy_camera: torch.Tensor  # (3,) and in y (texture filter footprints)
    lens_radius: float
    focal_distance: float
    resolution: tuple  # (W, H)

    def generate_rays(self, sample: CameraSample):
        """World-space (o, d) for a batch of camera samples
        (perspective.jl:95-128)."""
        p_raster = torch.cat(
            [sample.p_film, torch.zeros_like(sample.p_film[..., :1])], dim=-1)
        d = normalize(self.raster_to_camera.apply_point(p_raster))
        o = torch.zeros_like(d)
        if self.lens_radius > 0.0:
            p_lens = self.lens_radius * concentric_sample_disk(sample.lens)
            t = self.focal_distance / d[..., 2]
            o = torch.cat([p_lens, torch.zeros_like(p_lens[..., :1])], -1)
            d = normalize(d * t[..., None] - o)
        o_w = self.camera_to_world.apply_point(o)
        d_w = normalize(self.camera_to_world.apply_vector(d))
        return o_w, d_w


def _pixel_steps(raster_to_camera: Transform) -> dict:
    """dx_camera / dy_camera: the camera-space points of raster (1, 0) and
    (0, 1) less that of the origin (perspective.jl:58-60)."""
    pts = raster_to_camera.apply_point(torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                                                     [0.0, 0.0, 0.0]]))
    return dict(dx_camera=pts[0] - pts[2], dy_camera=pts[1] - pts[2])


def make_perspective_camera(eye, target, resolution, up=(0.0, 1.0, 0.0),
                            fov_deg: float = 55.0, lens_radius: float = 0.0,
                            focal_distance: float = 1e6) -> PerspectiveCamera:
    """PerspectiveCamera(eyepos, lookat, film; up, fov) (perspective.jl:82-91)."""
    w, h = resolution
    cam_to_world = look_at(eye, target, up)
    cam_from_screen = perspective(deg2rad(fov_deg)).inverse()
    aspect = w / h
    if aspect > 1.0:
        sx0, sx1, sy0, sy1 = -aspect, aspect, -1.0, 1.0
    else:
        sx0, sx1, sy0, sy1 = -1.0, 1.0, -1.0 / aspect, 1.0 / aspect
    m = torch.tensor([[(sx1 - sx0) / w, 0.0, 0.0, sx0],
                      [0.0, -(sy1 - sy0) / h, 0.0, sy1],
                      [0.0, 0.0, 1.0, 0.0],
                      [0.0, 0.0, 0.0, 1.0]], dtype=torch.float32)
    raster_to_camera = cam_from_screen.compose(from_matrix(m))
    return PerspectiveCamera(
        camera_to_world=cam_to_world, raster_to_camera=raster_to_camera,
        **_pixel_steps(raster_to_camera), lens_radius=float(lens_radius), focal_distance=float(focal_distance),
        resolution=(w, h))


def make_matrix_camera(view, projection, resolution) -> PerspectiveCamera:
    """Camera from explicit view / projection matrices (matrix.jl:13-115),
    e.g. handed over from an interactive viewer: camera-to-world is the
    inverse view, raster-to-camera the inverse projection after raster to
    NDC; no lens."""
    w, h = resolution
    view = torch.from_numpy(np.array(view, dtype=np.float32))
    projection = torch.from_numpy(np.array(projection, dtype=np.float32))
    screen_from_ndc = torch.tensor([[2.0 / w, 0.0, 0.0, -1.0],
                                    [0.0, -2.0 / h, 0.0, 1.0],
                                    [0.0, 0.0, 1.0, 0.0],
                                    [0.0, 0.0, 0.0, 1.0]], dtype=torch.float32)
    raster_to_camera = from_matrix(torch.linalg.inv(projection) @ screen_from_ndc)
    return PerspectiveCamera(
        camera_to_world=from_matrix(torch.linalg.inv(view)), raster_to_camera=raster_to_camera,
        **_pixel_steps(raster_to_camera), lens_radius=0.0, focal_distance=1e6,
        resolution=(w, h))
