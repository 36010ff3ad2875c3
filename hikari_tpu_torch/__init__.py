"""hikari_tpu_torch: the spectral path tracer of ``hikari_tpu`` on PyTorch
and CUDA, for an NVIDIA H100.

The JAX package ``hikari_tpu`` is the reference; this package mirrors its
module tree and names and is checked against it. It imports neither JAX nor
``hikari_tpu`` and reads no file of it: its data tables (``data/``) and
BVH builder source (``csrc/bvh_builder.cpp``) are copies of the
reference's. Every material (the layered coats through their random
walks, Mix resolved per hit), participating media (homogeneous,
density-grid, RGB-grid and sparse brick grids read from NanoVDB files,
delta and ratio tracking), every light (point, spot, distant, sun, ambient,
area, environment and the Hosek-Wilkie sun and sky) and the power, uniform
and BVH light samplers, image and vertex-colour textures, stochastic alpha,
the denoiser's aux pass, the a-trous denoiser, the tonemaps and the image
and checkpoint I/O are plain PyTorch. The Pallas sweep kernels of the
flat, pair-grid and instanced paths are hand-written CUDA (``csrc/sweep_tiles.cu``,
``csrc/sweep_pairs.cu``, ``csrc/sweep_inst.cu``), built with nvcc at first
use. Entry points run on the first CUDA device unless given
``device="cpu"``.

    import hikari_tpu_torch as hk

    s = hk.Scene()
    s.add(hk.make_quad((-2, 0, -2), (2, 0, -2), (2, 0, 2), (-2, 0, 2)),
          hk.Matte(kd=(0.7, 0.7, 0.7)))
    s.add(hk.make_sphere((0, 0.5, 0), 0.5), hk.Plastic(kd=(0.8, 0.1, 0.1)))
    s.add_light(hk.PointLight(position=(1, 2, -1), intensity=(6, 6, 6)))
    cam = hk.make_perspective_camera((0, 1, -3), (0, 0.4, 0), (256, 256))
    img = hk.framebuffer(hk.render(hk.VolPath(samples_per_pixel=16),
                                   s.build(), cam))
"""

__version__ = "0.1.0"

from .camera.camera import PerspectiveCamera, make_matrix_camera, make_perspective_camera
from .core.transform import (Transform, from_matrix, identity, look_at, perspective, rotate,
                             rotate_x, rotate_y, rotate_z, scale, translate)
from .film.denoise import DenoiseConfig, denoise
from .film.film import Film, aux_buffers, film_load, film_save, framebuffer, make_film
from .film.filters import BOX, GAUSSIAN, LANCZOS, MITCHELL, TRIANGLE, make_filter
from .film.imageio import load_image, read_pfm, read_png, write_pfm
from .film.postprocess import FilmSensor, postprocess, write_png
from .integrators.volpath import (VolPath, render, render_aux, render_lanes, scene_any_hit,
                                  scene_closest_hit)
from .lights.sunsky import sunsky_environment
from .lights.types import (AmbientLight, DistantLight, EnvironmentLight, PointLight,
                           SpotLight, SunLight, equirect_to_equal_area)
from .materials.types import (BK7, SF11, Aluminum, Brass, CoatedConductor, CoatedDiffuse,
                              CoatedDiffuseTransmission, Conductor, Copper, Diamond,
                              Dielectric, Diffuse, DiffuseTransmission, Emissive, FusedSilica,
                              Glass, Gold, Interface, Matte, Metal, Mirror, Mix, Plastic,
                              Sapphire, Silver, ThinDielectric)
from .media.nanovdb import load_nanovdb, load_nanovdb_sparse, nanovdb_medium, save_nanovdb
from .media.noise import fbm3d, generate_cloud_density, perlin3d, worley3d
from .media.types import (BrickGridMedium, CloudVolume, Fog, GridMedium, HomogeneousMedium,
                          Milk, RGBGridMedium, Smoke, medium_preset)
from .scene.mesh import (TriangleMesh, compute_vertex_normals, load_obj, make_box,
                         make_quad, make_sphere)
from .scene.scene import Scene, SceneData
from .textures.atlas import ImageTexture, VertexColorTexture
from .utils.metrics import RenderMeter

__all__ = [
    "Scene", "SceneData", "TriangleMesh", "make_box", "make_quad", "make_sphere",
    "load_obj", "compute_vertex_normals",
    "Transform", "identity", "translate", "scale", "rotate", "rotate_x", "rotate_y",
    "rotate_z", "look_at", "perspective", "from_matrix",
    "Matte", "Diffuse", "Gold", "Silver", "Copper", "Aluminum", "Brass", "Conductor",
    "Metal", "Glass", "Dielectric", "BK7", "SF11", "Sapphire", "FusedSilica", "Diamond",
    "Mirror", "Emissive", "Interface", "ThinDielectric", "DiffuseTransmission",
    "CoatedDiffuse", "Plastic", "CoatedConductor", "CoatedDiffuseTransmission", "Mix",
    "PointLight",
    "SpotLight", "DistantLight", "SunLight", "AmbientLight", "EnvironmentLight",
    "sunsky_environment", "equirect_to_equal_area",
    "HomogeneousMedium", "GridMedium", "RGBGridMedium", "BrickGridMedium", "CloudVolume",
    "Fog", "Milk", "Smoke", "medium_preset",
    "save_nanovdb", "load_nanovdb", "load_nanovdb_sparse", "nanovdb_medium",
    "perlin3d", "fbm3d", "worley3d", "generate_cloud_density",
    "PerspectiveCamera", "make_perspective_camera", "make_matrix_camera",
    "make_filter", "BOX", "TRIANGLE", "GAUSSIAN", "MITCHELL", "LANCZOS",
    "VolPath", "render", "render_lanes", "scene_closest_hit", "scene_any_hit",
    "Film", "make_film", "framebuffer",
    "ImageTexture", "VertexColorTexture",
    "render_aux", "aux_buffers", "film_save", "film_load",
    "FilmSensor", "postprocess", "write_png", "DenoiseConfig", "denoise",
    "read_png", "read_pfm", "write_pfm", "load_image",
    "RenderMeter",
]
