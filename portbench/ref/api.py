"""The reference's scene-building names, from its frozen copy: the same
names the program exports, so one scene description builds both."""

from .hk.camera.camera import make_perspective_camera  # noqa: F401
from .hk.lights.sunsky import sunsky_environment  # noqa: F401
from .hk.lights.types import PointLight  # noqa: F401
from .hk.materials.types import Emissive, Glass, Gold, Interface, Matte, Mirror  # noqa: F401
from .hk.media.types import GridMedium  # noqa: F401
from .hk.scene.mesh import TriangleMesh  # noqa: F401
from .hk.scene.scene import Scene  # noqa: F401
