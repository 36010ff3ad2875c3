"""The reference's scene-building names, from its frozen copy (``hk/``):
every name of ``hikari_tpu_torch.__all__`` that builds a scene (meshes,
transforms, materials and their presets, lights, media, textures, the
camera) and that the copy has, under the program's name, so one scene
description builds both.

Scene-building names the program exports and the copy has not, because
the copy holds the modules a render runs and these make a scene's data
before it is built:

- ``save_nanovdb``, ``load_nanovdb``, ``load_nanovdb_sparse``,
  ``nanovdb_medium``: NanoVDB file I/O (the program's ``media/nanovdb.py``).
  A scene maker hands a volume over as arrays, to ``GridMedium`` or
  ``BrickGridMedium``, so both sides read the same data.
- ``perlin3d``, ``fbm3d``, ``worley3d``, ``generate_cloud_density``:
  procedural densities (the program's ``media/noise.py``). A scene maker
  computes a density itself, in numpy, and hands the same array to both."""

from .hk.camera.camera import (PerspectiveCamera, make_matrix_camera,  # noqa: F401
                               make_perspective_camera)
from .hk.core.transform import (Transform, from_matrix, identity, look_at,  # noqa: F401
                                perspective, rotate, rotate_x, rotate_y, rotate_z, scale,
                                translate)
from .hk.lights.sunsky import sunsky_environment  # noqa: F401
from .hk.lights.types import (AmbientLight, DistantLight, EnvironmentLight,  # noqa: F401
                              PointLight, SpotLight, SunLight, equirect_to_equal_area)
from .hk.materials.types import (BK7, SF11, Aluminum, Brass, CoatedConductor,  # noqa: F401
                                 CoatedDiffuse, CoatedDiffuseTransmission, Conductor, Copper,
                                 Diamond, Dielectric, Diffuse, DiffuseTransmission, Emissive,
                                 FusedSilica, Glass, Gold, Interface, Matte, Metal, Mirror, Mix,
                                 Plastic, Sapphire, Silver, ThinDielectric)
from .hk.media.types import (BrickGridMedium, CloudVolume, Fog, GridMedium,  # noqa: F401
                             HomogeneousMedium, Milk, RGBGridMedium, Smoke, medium_preset)
from .hk.scene.mesh import (TriangleMesh, compute_vertex_normals, load_obj,  # noqa: F401
                            make_box, make_quad, make_sphere)
from .hk.scene.scene import Scene, SceneData  # noqa: F401
from .hk.textures.atlas import ImageTexture, VertexColorTexture  # noqa: F401
