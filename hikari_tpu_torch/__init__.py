"""hikari_tpu_torch: the spectral path tracer of ``hikari_tpu`` on PyTorch
and CUDA, for an NVIDIA H100.

The JAX package ``hikari_tpu`` is the reference; this package mirrors its
module tree and names and is checked against it. It imports neither JAX nor
``hikari_tpu`` and reads no file of it: its data tables (``data/``) and
BVH builder source (``csrc/bvh_builder.cpp``) are copies of the
reference's. The Pallas sweep kernels of the flat, pair-grid and
instanced paths are hand-written CUDA (``csrc/sweep_tiles.cu``,
``csrc/sweep_pairs.cu``, ``csrc/sweep_inst.cu``), built with nvcc at first
use. Entry points run on the first CUDA device unless given
``device="cpu"``.

    import hikari_tpu_torch as hk

    s = hk.Scene()
    s.add(hk.make_quad((-2, 0, -2), (2, 0, -2), (2, 0, 2), (-2, 0, 2)),
          hk.Matte(kd=(0.7, 0.7, 0.7)))
    s.add(hk.make_sphere((0, 0.5, 0), 0.5), hk.Gold(roughness=0.15))
    s.add_light(hk.PointLight(position=(1, 2, -1), intensity=(6, 6, 6)))
    cam = hk.make_perspective_camera((0, 1, -3), (0, 0.4, 0), (256, 256))
    img = hk.framebuffer(hk.render(hk.VolPath(samples_per_pixel=16),
                                   s.build(), cam))
"""

__version__ = "0.1.0"

from .camera.camera import make_perspective_camera
from .film.film import framebuffer, make_film
from .film.filters import make_filter
from .integrators.volpath import VolPath, render, render_lanes
from .lights.types import PointLight
from .materials.types import Conductor, Emissive, Glass, Gold, Matte, Mirror
from .scene.mesh import TriangleMesh, make_box, make_quad, make_sphere
from .scene.scene import Scene, SceneData

__all__ = [
    "Scene", "SceneData", "TriangleMesh", "make_box", "make_quad", "make_sphere",
    "Matte", "Gold", "Conductor", "Glass", "Mirror", "Emissive", "PointLight",
    "make_perspective_camera", "make_filter", "VolPath", "render",
    "render_lanes", "make_film", "framebuffer",
]
