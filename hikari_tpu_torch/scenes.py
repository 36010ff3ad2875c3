"""The benchmark scenes of ``bench.py`` and its transport probe, for the port.

``bench.py`` imports JAX, so its scene builders are ported here:
``default_scene`` (``build_scene``, the main path's 61,450 triangles),
``mesh_scene`` (``build_mesh_scene``, a 327,680-triangle displaced
icosphere in the same room) and ``sphere_scene`` (``build_sphere_scene``,
glass and gold spheres under the Hosek-Wilkie sun and sky). Two instanced
scenes exercise the two-level path: ``instanced_default_scene`` (the
default scene with its 16 spheres as 16 instances of one) and
``forest_scene`` (``examples/instancing_example.py``, 400 placements of one
tree under the sun and sky). Three scenes hold participating media:
``fog_scene`` (``bench.build_fog_scene``, a homogeneous medium in an
Interface box inside a Cornell room), ``cloud_scene``
(``bench.build_cloud_scene``, a 64^3 CloudVolume grid in an Interface box
over a floor under the sun and sky) and ``cloud_grid_scene`` (the same
cloud under an emissive quad and a point light) and ``sparse_cloud_scene``
(``examples/sparse_cloud_example.py``: a 96^3 cloud written to a NanoVDB
file and read back as a sparse BrickGridMedium, under the sun and sky).
``lights_scene`` holds a spot, a distant, an ambient and an environment
light. ``materials_scene`` (``bench.build_materials_scene``) is the default
scene with its 16 spheres cycling through all ten BSDF-bearing materials,
the layered ones included, and ``mix_scene`` a floor whose Mix picks red or
green per hit (``tests/test_materials_ext.py``'s).
``triangle_scene`` is bench.py's single Matte triangle under a point
light. ``textured_scene`` is the default scene's geometry with every
texture source bound (an image floor, a vertex-coloured back wall,
textured sphere materials, a textured Mix amount, image and constant
alpha), ``cornell_scene`` the flagship example
(``examples/cornell_scene.py``), and ``foliage_scene`` eight stacked
alpha-0.3 quads (``tests/test_alpha_mix.py``'s). These four build through
either package's API (``api``: a module exposing its public names;
the port's by default), so ``tools/gen_probe_ref.py`` builds the JAX twin
from the same arrays.
``quickstart_scene`` (``examples/quickstart.py``), ``specular_scene`` (glass,
mirror and smooth gold over a textured floor) and ``box_scene``
(``tests/test_sppm.py``'s) are the preview integrators' and SPPM's, also
through either API.
``aux_against_reference`` holds ``render_aux`` pixel for pixel against
the JAX package's, stored in ``data/aux_ref.npz``.
``transport_probe`` is the port of ``bench.transport_probe`` and
``check_transport`` holds it against the stored reference: the bench's
surface and fog probes in ``tools/transport_ref.json``, with the
tolerances of ``bench.py:171-178``; every other probe (the clouds', the
light samplers', the lights scene's) in ``data/probe_ref.json``, computed
with the JAX package by ``tools/gen_probe_ref.py``.
"""

from __future__ import annotations

import functools
import importlib
import json
import tempfile
from pathlib import Path

import numpy as np
import torch

from .camera.camera import make_perspective_camera
from .film.filters import BOX, GAUSSIAN, LANCZOS, MITCHELL, TRIANGLE, make_filter
from .integrators.volpath import (VolPath, pixel_centre_rays, render_aux, render_lanes,
                                  render_lanes_segmented, scene_closest_hit)
from .lights.sunsky import sunsky_environment
from .lights.types import (AmbientLight, DistantLight, EnvironmentLight, PointLight,
                           SpotLight, equirect_to_equal_area)
from .materials.types import Emissive, Glass, Gold, Interface, Matte, Mirror, Mix
from .media.nanovdb import nanovdb_medium, save_nanovdb
from .media.noise import generate_cloud_density
from .media.types import CloudVolume, HomogeneousMedium
from .scene.mesh import TriangleMesh, make_box, make_quad, make_sphere
from .scene.scene import Scene

TRANSPORT_REF = Path(__file__).resolve().parent.parent / "tools" / "transport_ref.json"
PROBE_REF = Path(__file__).resolve().parent / "data" / "probe_ref.json"
AUX_REF = Path(__file__).resolve().parent / "data" / "aux_ref.npz"
# two faces tie for a ray where both hold its hit point within this share of t
AUX_TIE_RTOL = 1e-6

# camera (eye, look-at, fov) and transport probe (res, depth, spp, rgb
# tolerance): bench.py SCENE_DEFS; cloud_grid takes the bench cloud's
SCENE_DEFS = {
    "default": (((0.0, 1.6, -2.8), (0.0, 0.9, 2.0), 45.0), (64, 5, 1, 0.02)),
    "mesh": (((0.0, 1.6, -2.8), (0.0, 0.9, 2.0), 45.0), (64, 5, 1, 0.02)),
    "fog": (((0.0, 1.0, -2.6), (0.0, 1.0, 1.0), 50.0), (64, 5, 1, 0.02)),
    "sphere": (((0.0, 1.0, -3.2), (0.0, 0.5, 0.0), 45.0), (64, 5, 1, 0.02)),
    "cloud": (((0.0, 0.7, -3.0), (0.0, 0.9, 0.0), 50.0), (32, 12, 16, 0.10)),
    "cloud_grid": (((0.0, 0.7, -3.0), (0.0, 0.9, 0.0), 50.0), (32, 12, 16, 0.10)),
    "lights": (((0.0, 1.5, -3.5), (0.0, 0.6, 1.0), 50.0), (64, 5, 1, 0.02)),
    "sparse_cloud": (((0.0, 1.1, -4.2), (0.0, 1.0, 0.0), 50.0), (32, 12, 16, 0.10)),
    "materials": (((0.0, 1.6, -2.8), (0.0, 0.9, 2.0), 45.0), (64, 5, 1, 0.02)),
    "mix": (((0.0, 2.5, -2.5), (0.0, 0.0, 0.0), 50.0), (32, 2, 4, 0.02)),
    "triangle": (((0.0, 0.3, -2.2), (0.0, 0.3, 0.0), 45.0), (64, 5, 1, 0.02)),
    "textured": (((0.0, 1.6, -2.8), (0.0, 0.9, 2.0), 45.0), (64, 5, 4, 0.02)),
    "cornell": (((0.0, 1.0, -2.6), (0.0, 1.0, 1.0), 50.0), (64, 6, 1, 0.02)),
    "foliage": (((0.0, 0.0, -1.0), (0.0, 0.0, 1.0), 50.0), (32, 2, 4, 0.02)),
    "swatch": (((0.0, 0.0, -2.0), (0.0, 0.0, 1.0), 60.0), (32, 3, 4, 0.02)),
    "quickstart": (((0.0, 1.4, -3.2), (0.0, 0.5, 0.0), 45.0), (64, 4, 1, 0.02)),
    "specular": (((0.0, 1.2, -3.0), (0.0, 0.5, 0.5), 45.0), (64, 5, 1, 0.02)),
    "box": (((0.0, 1.0, -2.6), (0.0, 1.0, 1.0), 50.0), (64, 5, 1, 0.02)),
    # the examples' scenes at their own depths; the three medium probes are
    # held to the JAX package's six-draw mean, each at a sample count whose
    # draw spreads under a third of the tolerance (tools/gen_probe_ref.py),
    # the medium example's taken on its packet engine (PACKET_PROBES)
    "dispersion": (((0.8, 1.6, -3.6), (0.0, 0.6, 0.0), 45.0), (32, 8, 16, 0.02)),
    "lensing": (((0.0, 0.8, -7.0), (0.0, 0.0, 0.0), 28.0), (32, 3, 64, 0.10)),
    "medium_example": (((0.0, 1.3, -3.4), (0.2, 0.7, 0.0), 48.0), (32, 10, 32, 0.10)),
    "cloud_example": (((0.0, 1.6, -7.5), (0.0, 1.9, 0.0), 55.0), (32, 32, 32, 0.10)),
}
FILTER_NAMES = {BOX: "box", TRIANGLE: "triangle", GAUSSIAN: "gaussian",
                MITCHELL: "mitchell", LANCZOS: "lanczos"}
PROBE_BATCH = 16  # samples a transport_probe renders in one wavefront


def _api(api):
    """The module whose public names build a scene: the port unless given
    (the JAX package's twin passes its own)."""
    return importlib.import_module(__package__) if api is None else api


def _room(s, m=None):
    m = _api(m)
    white = m.Matte(kd=(0.73, 0.73, 0.73))
    s.add(m.make_quad((-3, 0, -1), (3, 0, -1), (3, 0, 5), (-3, 0, 5)), white)
    s.add(m.make_quad((-3, 0, 5), (3, 0, 5), (3, 4, 5), (-3, 4, 5)), white)
    s.add(m.make_quad((-3, 0, -1), (-3, 0, 5), (-3, 4, 5), (-3, 4, -1)),
          m.Matte(kd=(0.65, 0.05, 0.05)))
    s.add(m.make_quad((3, 0, -1), (3, 4, -1), (3, 4, 5), (3, 0, 5)),
          m.Matte(kd=(0.12, 0.45, 0.15)))


def _lights(s, m=None):
    m = _api(m)
    s.add(m.make_quad((-1.0, 3.99, 1.0), (1.0, 3.99, 1.0), (1.0, 3.99, 3.0),
                      (-1.0, 3.99, 3.0)),
          m.Emissive(le=(1.0, 0.95, 0.85), scale=25.0))
    s.add_light(m.PointLight(position=(0.0, 3.0, -0.5), intensity=(8.0, 8.0, 8.0)))


def _sphere_mats():
    return [Gold(roughness=0.15), Glass(eta=1.5), Mirror(), Matte(kd=(0.3, 0.4, 0.8)),
            Matte(kd=(0.8, 0.6, 0.2))]


# the 16 sphere centres of bench.py build_scene, in its order
SPHERE_CENTRES = [(-1.8 + 1.2 * ix, 0.45, 0.2 + 1.2 * iz)
                  for ix in range(4) for iz in range(4)]


def default_scene(sphere_res=(32, 64)) -> Scene:
    """bench.py build_scene: Cornell walls, 16 spheres cycling Gold / Glass /
    Mirror / two Mattes, an emissive quad and a point light. sphere_res
    (n_theta, n_phi) = (32, 64) gives the benchmark's 61,450 triangles."""
    s = Scene()
    _room(s)
    mats = _sphere_mats()
    for k, c in enumerate(SPHERE_CENTRES):
        s.add(make_sphere(c, 0.42, *sphere_res), mats[k % len(mats)])
    _lights(s)
    return s


def _material_mats(m):
    """bench.py build_materials_scene's ten sphere materials, in its order."""
    return [m.Matte(kd=(0.3, 0.4, 0.8)), m.Mirror(), m.Glass(eta=1.5), m.Gold(roughness=0.15),
            m.ThinDielectric(), m.DiffuseTransmission(), m.CoatedDiffuse(),
            m.CoatedConductor(), m.CoatedDiffuseTransmission(), m.Glass(eta=1.33)]


def materials_scene(sphere_res=(32, 64), api=None):
    """bench.py build_materials_scene: the default scene with its 16 spheres
    cycling through the ten BSDF-bearing materials (spheres 6, 7 and 8 are
    the three layered coats), the scene where per-type shading dispatch
    dominates."""
    m = _api(api)
    s = m.Scene()
    _room(s, m)
    mats = _material_mats(m)
    for k, c in enumerate(SPHERE_CENTRES):
        s.add(m.make_sphere(c, 0.42, *sphere_res), mats[k % len(mats)])
    _lights(s, m)
    return s


def mix_scene() -> Scene:
    """tests/test_materials_ext.py's Mix floor: a 4 x 4 quad whose
    Mix(red Matte, green Matte, amount 0.5) picks a child per hit, under a
    point light."""
    s = Scene()
    s.add(make_quad((-2, 0, -2), (2, 0, -2), (2, 0, 2), (-2, 0, 2)),
          Mix(m1=Matte(kd=(0.9, 0.05, 0.05)), m2=Matte(kd=(0.05, 0.9, 0.05)), amount=0.5))
    s.add_light(PointLight(position=(0, 3, 0), intensity=(20, 20, 20)))
    return s


def instanced_default_scene() -> Scene:
    """The default scene with its 16 spheres as 16 instances of one
    make_sphere((0, 0, 0), 0.42, 32, 64) translated to the same centres,
    with the same materials; walls and emissive quad form BLAS 0. One
    3,840-triangle BLAS (15 treelets): 16 x 15 + 1 = 241 world treelets, as
    many as the flat default scene has treelets."""
    s = Scene()
    _room(s)
    mats = _sphere_mats()
    tr = np.tile(np.eye(4, dtype=np.float32), (len(SPHERE_CENTRES), 1, 1))
    tr[:, :3, 3] = SPHERE_CENTRES
    s.add_instanced(make_sphere((0.0, 0.0, 0.0), 0.42, 32, 64), tr, mats[0],
                    materials=[mats[k % len(mats)] for k in range(len(tr))])
    _lights(s)
    return s


def tree_mesh() -> TriangleMesh:
    """examples/instancing_example.py tree_mesh: a 10 x 20 sphere canopy on
    a box trunk, one mesh of 332 triangles."""
    canopy = make_sphere((0.0, 1.2, 0.0), 0.55, 10, 20)
    trunk = make_box((-0.08, 0.0, -0.08), (0.08, 0.8, 0.08))
    v = np.concatenate([canopy.vertices, trunk.vertices])
    f = np.concatenate([canopy.faces, trunk.faces + len(canopy.vertices)])
    return TriangleMesh(vertices=v, faces=f)


def forest_scene(n: int = 400) -> Scene:
    """examples/instancing_example.py: a ground quad and n = 400 placements
    of tree_mesh() from RandomState(7) (random yaw, scale 0.6-1.4) under
    sunsky_environment(direction=(0.5, 0.4, 0.4)). 2n instanced world
    treelets plus BLAS 0's one."""
    s = Scene()
    s.add(make_quad((-20, 0, -20), (20, 0, -20), (20, 0, 20), (-20, 0, 20)),
          Matte(kd=(0.35, 0.4, 0.25)))
    rng = np.random.RandomState(7)
    tr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    scale = rng.uniform(0.6, 1.4, n).astype(np.float32)
    theta = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    tr[:, 0, 0] = np.cos(theta) * scale
    tr[:, 0, 2] = np.sin(theta) * scale
    tr[:, 2, 0] = -np.sin(theta) * scale
    tr[:, 2, 2] = np.cos(theta) * scale
    tr[:, 1, 1] = scale
    tr[:, 0, 3] = rng.uniform(-15, 15, n)
    tr[:, 2, 3] = rng.uniform(-2, 30, n)
    s.add_instanced(tree_mesh(), tr, Matte(kd=(0.15, 0.45, 0.12)))
    for light in sunsky_environment(direction=(0.5, 0.4, 0.4)):
        s.add_light(light)
    return s


def forest_camera(width: int, height: int):
    """The example's camera at another resolution."""
    return make_perspective_camera((0, 3.0, -8), (0, 1.0, 8), (width, height), fov_deg=55.0)


def _displaced_icosphere(subdiv: int, seed: int = 7):
    """~20 * 4^subdiv-triangle icosphere displaced by multi-octave value
    noise (bench.py _displaced_icosphere, same arithmetic)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.asarray([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdiv):
        n = len(v)
        edges = {}
        verts = [v]

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edges:
                m = v[a] + v[b]
                m /= np.linalg.norm(m)
                edges[key] = n + len(edges)
                verts.append(m[None])
            return edges[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.concatenate(verts)
        f = np.asarray(nf, np.int64)
    rng = np.random.RandomState(seed)
    disp = np.zeros(len(v))
    for octv in range(4):
        k = 2.0 ** octv
        ph = rng.rand(3, 3) * 6.2832
        amp = 0.18 / k
        for ax in range(3):
            disp += amp * np.sin(k * 3.1 * (v @ rng.rand(3)) + ph[ax, 0]) \
                * np.cos(k * 2.3 * (v @ rng.rand(3)) + ph[ax, 1])
    v = v * (1.0 + 0.35 * disp[:, None])
    return v.astype(np.float32), f.astype(np.int32)


def mesh_scene() -> Scene:
    """bench.py build_mesh_scene: the 327,680-triangle displaced icosphere
    (Gold) in the bench room with the same lights."""
    s = Scene()
    _room(s)
    v, f = _displaced_icosphere(7)
    v = v * 0.9 + np.asarray([[0.0, 1.1, 2.0]], np.float32)
    s.add(TriangleMesh(vertices=v, faces=f), Gold(roughness=0.2))
    _lights(s)
    return s


def fog_scene() -> Scene:
    """bench.py build_fog_scene: a 2 x 2 x 2 Cornell room, a homogeneous
    medium (sigma_a 0.05, sigma_s 0.25, g 0.3) inside an Interface box
    that nearly fills it, an emissive ceiling quad and a point light."""
    s = Scene()
    white = Matte(kd=(0.73, 0.73, 0.73))
    s.add(make_quad((-1, 0, 0), (1, 0, 0), (1, 0, 2), (-1, 0, 2)), white)
    s.add(make_quad((-1, 2, 0), (-1, 2, 2), (1, 2, 2), (1, 2, 0)), white)
    s.add(make_quad((-1, 0, 2), (1, 0, 2), (1, 2, 2), (-1, 2, 2)), white)
    s.add(make_quad((-1, 0, 0), (-1, 0, 2), (-1, 2, 2), (-1, 2, 0)),
          Matte(kd=(0.65, 0.05, 0.05)))
    s.add(make_quad((1, 0, 0), (1, 2, 0), (1, 2, 2), (1, 0, 2)),
          Matte(kd=(0.12, 0.45, 0.15)))
    fog = HomogeneousMedium(sigma_a=(0.05,) * 3, sigma_s=(0.25,) * 3, g=0.3)
    s.add(make_box((-0.95, 0.02, 0.05), (0.95, 1.95, 1.95)), Interface(), inside_medium=fog)
    s.add(make_quad((-0.3, 1.99, 0.7), (0.3, 1.99, 0.7), (0.3, 1.99, 1.3), (-0.3, 1.99, 1.3)),
          Emissive(le=(1.0, 0.9, 0.7), scale=20.0))
    s.add_light(PointLight(position=(0.0, 1.5, 0.3), intensity=(2.0, 2.0, 2.0)))
    return s


def _cloud_over_floor() -> Scene:
    """bench.py build_cloud_scene's geometry: a floor quad and the 64^3
    CloudVolume (bounds (-1.6, 0.1, -1.2)-(1.6, 1.8, 1.2), sigma_s 60,
    sigma_a 0.4, g 0.877) in an Interface box; no light."""
    s = Scene()
    s.add(make_quad((-8, -0.5, -8), (8, -0.5, -8), (8, -0.5, 8), (-8, -0.5, 8)),
          Matte(kd=(0.3, 0.35, 0.4)))
    cloud = CloudVolume(resolution=64, bounds_lo=(-1.6, 0.1, -1.2), bounds_hi=(1.6, 1.8, 1.2),
                        sigma_s=(60.0,) * 3, sigma_a=(0.4,) * 3, g=0.877)
    s.add(make_box((-1.6, 0.1, -1.2), (1.6, 1.8, 1.2)), Interface(), inside_medium=cloud)
    return s


def cloud_grid_scene() -> Scene:
    """cloud_scene's floor and cloud lit by an emissive quad above the box
    (facing down) and a point light in place of the sky and the sun (the
    grid-cloud probes stored in data/probe_ref.json were drawn with
    these lights)."""
    s = _cloud_over_floor()
    s.add(make_quad((-2.0, 3.5, -1.5), (2.0, 3.5, -1.5), (2.0, 3.5, 1.5), (-2.0, 3.5, 1.5)),
          Emissive(le=(0.85, 0.9, 1.0), scale=4.0))
    s.add_light(PointLight(position=(2.5, 4.0, -2.5), intensity=(40.0, 38.0, 34.0)))
    return s


def sphere_scene(sphere_res=(24, 48)) -> Scene:
    """bench.py build_sphere_scene: a glass and a gold sphere on a Matte
    plane under sunsky_environment(direction=(0.4, 0.35, 0.6)); no area
    light, so the environment light is the whole flat light list's tail.
    sphere_res (n_theta, n_phi) = (24, 48) is the bench's."""
    s = Scene()
    s.add(make_quad((-6, 0, -6), (6, 0, -6), (6, 0, 6), (-6, 0, 6)),
          Matte(kd=(0.55, 0.55, 0.55)))
    s.add(make_sphere((-0.7, 0.55, 0.2), 0.55, *sphere_res), Glass(eta=1.5))
    s.add(make_sphere((0.7, 0.5, -0.2), 0.5, *sphere_res), Gold(roughness=0.1))
    for light in sunsky_environment(direction=(0.4, 0.35, 0.6)):
        s.add_light(light)
    return s


def cloud_scene() -> Scene:
    """bench.py build_cloud_scene: cloud_grid_scene's floor and 64^3
    CloudVolume in its Interface box under sunsky_environment(direction=
    (0.5, 0.45, 0.3)); escaped paths leave the volume into the sky."""
    s = _cloud_over_floor()
    for light in sunsky_environment(direction=(0.5, 0.45, 0.3)):
        s.add_light(light)
    return s


SPARSE_CLOUD_BOX = ((-1.6, 0.2, -1.2), (1.6, 2.0, 1.2))


@functools.lru_cache(maxsize=None)
def cloud_density(resolution: int) -> np.ndarray:
    """generate_cloud_density(resolution), read-only and kept for the next
    call: the 96^3 noise costs seconds of host time, and the sparse cloud,
    its dense twin and its example each write it anew."""
    density = generate_cloud_density(resolution)
    density.setflags(write=False)
    return density


def sparse_cloud_medium(resolution: int = 96, path=None, dense: bool = False):
    """examples/sparse_cloud_example.py's cloud: cloud_density(resolution)
    written by save_nanovdb over SPARSE_CLOUD_BOX to `path` (a
    temporary file when None), read back by nanovdb_medium (sigma_s 55,
    sigma_a 0.3, g 0.877) as a sparse BrickGridMedium, or with dense=True
    as a dense GridMedium."""
    lo, hi = SPARSE_CLOUD_BOX

    def load(nvdb):
        save_nanovdb(str(nvdb), cloud_density(resolution), origin=lo,
                     extent=tuple(b - a for a, b in zip(lo, hi)))
        return nanovdb_medium(str(nvdb), sigma_s=(55.0,) * 3, sigma_a=(0.3,) * 3, g=0.877,
                              sparse=not dense)

    if path is None:
        with tempfile.TemporaryDirectory() as tmp:
            return load(Path(tmp) / "cloud.nvdb")
    return load(path)


def sparse_cloud_scene(resolution: int = 96, path=None, dense: bool = False,
                       cloud=None) -> Scene:
    """examples/sparse_cloud_example.py: sparse_cloud_medium(resolution,
    path, dense) (or `cloud`) in an Interface box over a 24 x 24 floor,
    under sunsky_environment(direction=(0.55, 0.4, 0.35)). dense=True reads
    the same file as a dense GridMedium: the same transport, so the two
    isolate the cost of the brick reads."""
    lo, hi = SPARSE_CLOUD_BOX
    if cloud is None:
        cloud = sparse_cloud_medium(resolution, path, dense)
    s = Scene()
    s.add(make_quad((-12, 0, -12), (12, 0, -12), (12, 0, 12), (-12, 0, 12)),
          Matte(kd=(0.3, 0.34, 0.4)))
    s.add(make_box(lo, hi), Interface(), inside_medium=cloud)
    for light in sunsky_environment(direction=(0.55, 0.4, 0.35)):
        s.add_light(light)
    return s


def latlong_sky(height: int = 32, width: int = 64) -> np.ndarray:
    """A procedural lat-long (equirectangular) sky, y up: a blue gradient
    over a grey ground and a warm patch at one azimuth."""
    theta = (np.arange(height) + 0.5) / height * np.pi
    phi = (np.arange(width) + 0.5) / width * 2.0 * np.pi - np.pi
    up = np.cos(theta)[:, None, None]
    sky = np.asarray([0.35, 0.55, 0.9]) * (0.4 + 0.6 * up) + np.asarray([0.3, 0.3, 0.3]) * (1 - up)
    img = np.where(up > 0.0, sky, np.asarray([0.12, 0.11, 0.1]))
    patch = np.exp(-((phi[None, :] - 1.0) ** 2) / 0.1 - ((theta[:, None] - 1.0) ** 2) / 0.05)
    img = img + patch[..., None] * np.asarray([4.0, 3.0, 1.5])
    return img.astype(np.float32)


def lights_scene() -> Scene:
    """A floor, a back wall, a gold sphere and a box under a spot, a
    distant, an ambient and an environment light (latlong_sky() resampled
    by equirect_to_equal_area to 64 x 64): every light type but point and
    area."""
    s = Scene()
    s.add(make_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4)), Matte(kd=(0.6, 0.6, 0.6)))
    s.add(make_quad((-4, 0, 3), (4, 0, 3), (4, 3, 3), (-4, 3, 3)), Matte(kd=(0.5, 0.3, 0.2)))
    s.add(make_sphere((-0.6, 0.5, 0.8), 0.5, 16, 32), Gold(roughness=0.2))
    s.add(make_box((0.3, 0.0, 0.2), (1.1, 0.8, 1.0)), Matte(kd=(0.2, 0.4, 0.7)))
    s.add_light(SpotLight(position=(0.0, 2.5, -1.0), direction=(0.0, -1.0, 0.6),
                          intensity=(12.0, 11.0, 9.0), cone_angle_deg=35.0,
                          falloff_start_deg=20.0))
    s.add_light(DistantLight(direction=(-0.4, -1.0, 0.5), radiance=(1.2, 1.1, 1.0)))
    s.add_light(AmbientLight(radiance=(0.05, 0.05, 0.06)))
    s.add_light(EnvironmentLight(image=equirect_to_equal_area(latlong_sky(), 64), scale=0.8))
    return s


def triangle_scene(api=None):
    """bench.py build_triangle_scene: one Matte triangle facing the camera
    under a point light (single_triangle_test.jl)."""
    m = _api(api)
    s = m.Scene()
    v = np.asarray([[-0.8, -0.4, 0.0], [0.8, -0.4, 0.0], [0.0, 0.9, 0.0]], np.float32)
    s.add(m.TriangleMesh(vertices=v, faces=np.asarray([[0, 1, 2]], np.int32)),
          m.Matte(kd=(0.7, 0.3, 0.2)))
    s.add_light(m.PointLight(position=(0.0, 1.0, -2.0), intensity=(10.0,) * 3))
    return s


def checker_image(n: int, c0=(0.85, 0.85, 0.85), c1=(0.2, 0.3, 0.55),
                  cells: int = 16) -> np.ndarray:
    """(n, n, 3) float32 checkerboard of cells x cells squares, colours c0
    and c1 (examples/cornell_scene.py's at n = cells = 16)."""
    idx = (np.arange(n) * cells) // n
    odd = (idx[:, None] + idx[None, :]) % 2 == 1
    return np.where(odd[..., None], np.asarray(c1, np.float32),
                    np.asarray(c0, np.float32)).astype(np.float32)


def stripes_mask(n: int, stripes: int = 8, duty: float = 0.5) -> np.ndarray:
    """(n, n) float32 mask of `stripes` vertical bands, 1 over the first
    `duty` of each band and 0 elsewhere (an alpha cut-out or Mix amount)."""
    phase = (np.arange(n) + 0.5) * stripes / n % 1.0
    return np.broadcast_to((phase < duty).astype(np.float32), (n, n)).copy()


# the textured scene's images: the floor's 1024^2 checker (11 mip levels)
# also textures the Matte spheres at another uv scale; sharing one array
# lets Scene's material deduplication tell the two Mattes apart by their uv
# scale without comparing images (equal-shaped arrays would not compare)
FLOOR_CHECKER = 1024


def textured_scene(sphere_res=(32, 64), api=None):
    """default_scene's geometry (61,450 triangles at the default sphere_res)
    with every texture source bound: the floor a Matte whose kd is a
    checker_image(1024) at uv scale (4, 4), the back wall a Matte of
    per-vertex colours, and the 16 spheres cycling through eight variants:
    image kd, image CoatedDiffuse reflectance, Gold with
    an image roughness, Glass with an image kt, DiffuseTransmission with an
    image reflectance, a Mix of two Mattes with an image amount, and two
    Mattes with alpha (a stripes_mask(256) texture, and 0.5)."""
    m = _api(api)
    s = m.Scene()
    checker = checker_image(FLOOR_CHECKER)
    s.add(m.make_quad((-3, 0, -1), (3, 0, -1), (3, 0, 5), (-3, 0, 5)),
          m.Matte(kd=m.ImageTexture(checker, uv_scale=(4.0, 4.0))))
    wall = m.make_quad((-3, 0, 5), (3, 0, 5), (3, 4, 5), (-3, 4, 5))
    wall.colors = np.asarray([[0.9, 0.2, 0.2], [0.2, 0.9, 0.2], [0.2, 0.2, 0.9],
                              [0.9, 0.9, 0.3]], np.float32)
    s.add(wall, m.Matte(kd=m.VertexColorTexture()))
    s.add(m.make_quad((-3, 0, -1), (-3, 0, 5), (-3, 4, 5), (-3, 4, -1)),
          m.Matte(kd=(0.65, 0.05, 0.05)))
    s.add(m.make_quad((3, 0, -1), (3, 4, -1), (3, 4, 5), (3, 0, 5)),
          m.Matte(kd=(0.12, 0.45, 0.15)))
    warm = checker_image(64, (0.9, 0.6, 0.2), (0.2, 0.5, 0.8), cells=8)
    variants = [
        (m.Matte(kd=m.ImageTexture(checker, uv_scale=(2.0, 1.0))), None),
        (m.CoatedDiffuse(reflectance=m.ImageTexture(warm), roughness=0.1), None),
        (m.Gold(roughness=m.ImageTexture(checker_image(64, (0.05,) * 3, (0.5,) * 3, 8))),
         None),
        (m.Glass(eta=1.5, kt=m.ImageTexture(checker_image(64, (1.0,) * 3,
                                                            (0.6, 0.8, 1.0), 8))), None),
        (m.DiffuseTransmission(reflectance=m.ImageTexture(warm)), None),
        (m.Mix(m1=m.Matte(kd=(0.9, 0.1, 0.1)), m2=m.Matte(kd=(0.1, 0.1, 0.9)),
               amount=m.ImageTexture(stripes_mask(64))), None),
        (m.Matte(kd=(0.8, 0.6, 0.2)), m.ImageTexture(stripes_mask(256))),
        (m.Matte(kd=(0.3, 0.4, 0.8)), 0.5),
    ]
    for k, c in enumerate(SPHERE_CENTRES):
        mat, alpha = variants[k % len(variants)]
        s.add(m.make_sphere(c, 0.42, *sphere_res), mat, alpha=alpha)
    _lights(s, m)
    return s


def cornell_scene(sphere_res=(24, 48), api=None, obj=None):
    """examples/cornell_scene.py as it stands: a 2 x 2 x 2 Cornell box whose
    floor is a Matte of the 16 x 16 checker image, a Gold (roughness 0.15),
    a BK7 and a Plastic sphere (or, given an OBJ path `obj`, that mesh in
    Gold alone), under an emissive ceiling quad (the only light)."""
    m = _api(api)
    s = m.Scene()
    white = m.Matte(kd=(0.73, 0.73, 0.73))
    s.add(m.make_quad((-1, 0, 0), (1, 0, 0), (1, 0, 2), (-1, 0, 2)),
          m.Matte(kd=m.ImageTexture(checker_image(16))))
    s.add(m.make_quad((-1, 2, 0), (-1, 2, 2), (1, 2, 2), (1, 2, 0)), white)
    s.add(m.make_quad((-1, 0, 2), (1, 0, 2), (1, 2, 2), (-1, 2, 2)), white)
    s.add(m.make_quad((-1, 0, 0), (-1, 0, 2), (-1, 2, 2), (-1, 2, 0)),
          m.Matte(kd=(0.65, 0.05, 0.05)))
    s.add(m.make_quad((1, 0, 0), (1, 2, 0), (1, 2, 2), (1, 0, 2)),
          m.Matte(kd=(0.12, 0.45, 0.15)))
    if obj is not None:
        s.add(m.load_obj(obj), m.Gold(roughness=0.15))
    else:
        s.add(m.make_sphere((-0.45, 0.4, 1.3), 0.4, *sphere_res), m.Gold(roughness=0.15))
        s.add(m.make_sphere((0.45, 0.35, 0.9), 0.35, *sphere_res), m.BK7())
        s.add(m.make_sphere((0.0, 1.2, 1.4), 0.25, *sphere_res),
              m.Plastic(kd=(0.2, 0.3, 0.8), roughness=0.1))
    s.add(m.make_quad((-0.3, 1.99, 0.7), (0.3, 1.99, 0.7), (0.3, 1.99, 1.3),
                      (-0.3, 1.99, 1.3)), m.Emissive(le=(1.0, 0.9, 0.7), scale=18.0))
    return s


FOLIAGE_ALPHA = 0.3
FOLIAGE_LAYERS = 8


def foliage_scene(api=None):
    """tests/test_alpha_mix.py's dense alpha "foliage": FOLIAGE_LAYERS
    10 x 10 Matte quads at z = 1, 1.1, ... of alpha FOLIAGE_ALPHA, so a ray
    along +z escapes with probability (1 - alpha)^8 ~ 5.8%; a point light
    in front of the stack lights its probe."""
    m = _api(api)
    s = m.Scene()
    for i in range(FOLIAGE_LAYERS):
        z = 1.0 + 0.1 * i
        s.add(m.make_quad((-5, -5, z), (5, -5, z), (5, 5, z), (-5, 5, z)), m.Matte(),
              alpha=FOLIAGE_ALPHA)
    s.add_light(m.PointLight(position=(0.0, 0.0, 0.0), intensity=(2.0, 2.0, 2.0)))
    return s


SWATCH_BANDS = ("vertex colours", "textured Mix amount", "alpha 0", "alpha 0.5")


def swatch_scene(api=None):
    """Four 0.9 x 1.8 quads side by side before a grey wall, one a band
    of a square probe each (SWATCH_BANDS, left to right): per-vertex
    colours, a Mix of red and blue Mattes whose amount is a
    stripes_mask(64), a white Matte of alpha 0 (the wall shows through) and
    one of alpha 0.5 (half the hits pass), under a point light."""
    m = _api(api)
    s = m.Scene()
    s.add(m.make_quad((-3, -2, 1.5), (3, -2, 1.5), (3, 2, 1.5), (-3, 2, 1.5)),
          m.Matte(kd=(0.4, 0.4, 0.4)))
    x0 = (-1.95, -0.95, 0.05, 1.05)
    quads = [m.make_quad((x, -0.9, 1.0), (x + 0.9, -0.9, 1.0), (x + 0.9, 0.9, 1.0),
                         (x, 0.9, 1.0)) for x in x0]
    quads[0].colors = np.asarray([[0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.1, 0.1, 0.9],
                                  [0.9, 0.9, 0.1]], np.float32)
    s.add(quads[0], m.Matte(kd=m.VertexColorTexture()))
    s.add(quads[1], m.Mix(m1=m.Matte(kd=(0.9, 0.1, 0.1)), m2=m.Matte(kd=(0.1, 0.1, 0.9)),
                          amount=m.ImageTexture(stripes_mask(64))))
    white = m.Matte(kd=(0.9, 0.9, 0.9))
    s.add(quads[2], white, alpha=0.0)
    s.add(quads[3], white, alpha=0.5)
    s.add_light(m.PointLight(position=(0.0, 0.0, -1.5), intensity=(6.0, 6.0, 6.0)))
    return s


def quickstart_scene(sphere_res=(32, 64), api=None):
    """examples/quickstart.py's scene: a Plastic sphere on a Matte floor
    under a point light (its sphere at make_sphere's default 32 x 64)."""
    m = _api(api)
    s = m.Scene()
    s.add(m.make_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4)),
          m.Matte(kd=(0.6, 0.6, 0.6)))
    s.add(m.make_sphere((0, 0.6, 0), 0.6, *sphere_res),
          m.Plastic(kd=(0.8, 0.15, 0.1), roughness=0.15))
    s.add_light(m.PointLight(position=(2, 4, -2), intensity=(30, 30, 30)))
    return s


def specular_scene(sphere_res=(16, 32), api=None):
    """The preview integrators' specular set: a Glass, a Mirror and a
    smooth Gold sphere on a floor whose Matte reads a 16 x 16 checker image
    (Whitted's primary hits filter it through their ray differentials),
    before an emissive wall, under a point light."""
    m = _api(api)
    s = m.Scene()
    s.add(m.make_quad((-3, 0, -3), (3, 0, -3), (3, 0, 3), (-3, 0, 3)),
          m.Matte(kd=m.ImageTexture(checker_image(16))))
    s.add(m.make_quad((-3, 0, 2.5), (3, 0, 2.5), (3, 3, 2.5), (-3, 3, 2.5)),
          m.Emissive(le=(1.0, 0.95, 0.9), scale=3.0))
    for x, mat in ((-1.1, m.Glass(eta=1.5)), (0.0, m.Mirror()), (1.1, m.Gold(roughness=0.0))):
        s.add(m.make_sphere((x, 0.5, 0.5), 0.5, *sphere_res), mat)
    s.add_light(m.PointLight(position=(1.5, 3.0, -1.5), intensity=(12.0, 12.0, 12.0)))
    return s


def box_scene(api=None):
    """tests/test_sppm.py's closed box: white floor, ceiling and back wall,
    a red and a green side wall, a point light under the ceiling."""
    m = _api(api)
    s = m.Scene()
    white = m.Matte(kd=(0.73, 0.73, 0.73))
    s.add(m.make_quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1)), white)
    s.add(m.make_quad((-1, 2, -1), (-1, 2, 1), (1, 2, 1), (1, 2, -1)), white)
    s.add(m.make_quad((-1, 0, 1), (1, 0, 1), (1, 2, 1), (-1, 2, 1)), white)
    s.add(m.make_quad((-1, 0, -1), (-1, 0, 1), (-1, 2, 1), (-1, 2, -1)),
          m.Matte(kd=(0.65, 0.05, 0.05)))
    s.add(m.make_quad((1, 0, -1), (1, 2, -1), (1, 2, 1), (1, 0, 1)),
          m.Matte(kd=(0.12, 0.45, 0.15)))
    s.add_light(m.PointLight(position=(0, 1.7, 0), intensity=(6, 6, 6)))
    return s


def lensing_starfield() -> np.ndarray:
    """examples/lensing_example.py's environment image: 1,400 stars from
    RandomState(7) on a black 256 x 512 map (each star's RGB drawn after
    every position) and a faint nebula band over rows 100-139."""
    rng = np.random.RandomState(7)
    env = np.zeros((256, 512, 3), np.float32)
    for sy, sx in rng.rand(1400, 2):
        env[int(sy * 255), int(sx * 511)] = rng.rand(3) * 8.0 + 2.0
    env[100:140, :] += np.array([0.25, 0.18, 0.35])
    return env


def lensing_scene(api=None):
    """examples/lensing_example.py: a black Matte sphere of radius 0.5 at
    the origin before lensing_starfield() as the environment light, the
    camera inside a thin HomogeneousMedium (sigma_a 1e-5, no scattering)
    whose null events bend rays toward the origin (deflection ("gravity",
    origin, 60), majorant_scale 20,000: the null-event density is the
    bending sample rate)."""
    m = _api(api)
    s = m.Scene()
    s.add(m.make_sphere((0.0, 0.0, 0.0), 0.5, 24, 48), m.Matte(kd=(0.0, 0.0, 0.0)))
    s.add_light(m.EnvironmentLight(image=lensing_starfield()))
    s.set_camera_medium(m.HomogeneousMedium(
        sigma_a=(1e-5,) * 3, sigma_s=(0.0,) * 3,
        deflection=("gravity", (0.0, 0.0, 0.0), 60.0), majorant_scale=20000.0))
    return s


def dispersion_scene(api=None):
    """examples/dispersion_example.py: a Diamond() sphere (two-term
    Sellmeier, n_d 2.42) on a 12 x 12 Matte floor, lit only by a narrow
    0.2 x 0.8 emissive quad far to one side at scale 400 (a beam whose
    refraction angles differ per wavelength)."""
    m = _api(api)
    s = m.Scene()
    s.add(m.make_quad((-6, 0, -6), (6, 0, -6), (6, 0, 6), (-6, 0, 6)),
          m.Matte(kd=(0.75, 0.75, 0.75)))
    s.add(m.make_sphere((0.0, 0.8, 0.0), 0.8, 24, 48), m.Diamond())
    s.add(m.make_quad((-4.0, 3.0, -0.4), (-3.8, 3.0, -0.4), (-3.8, 3.0, 0.4), (-4.0, 3.0, 0.4)),
          m.Emissive(le=(1.0, 1.0, 1.0), scale=400.0))
    return s


def smoke_column(grid: int = 48) -> np.ndarray:
    """examples/medium_example.py's smoke plume: a Gaussian column about
    the grid's vertical axis fading with z, times 4, (grid,)^3 float32."""
    z, y, x = np.meshgrid(*(np.linspace(0, 1, grid),) * 3, indexing="ij")
    column = np.exp(-18.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2)) * (1.2 - z)
    return (column * 4).astype(np.float32)


def medium_example_scene(grid: int = 48, api=None):
    """examples/medium_example.py: a Glass(eta=1.4) sphere filled with
    Milk(scale=30) (a dielectric boundary around a measured medium), a
    smoke_column(grid) GridMedium (sigma_a 0.05, sigma_s 0.9, g 0.2) in an
    Interface box, on a Matte floor under a point and a distant light.
    The box's bottom face lies in the floor's plane (y = 0), so a ray that
    meets the floor there meets both faces at one t: the JAX package's
    skip-link walk and its packet engine keep different faces of such
    ties, and the port's sweeps keep the packet engine's (PACKET_PROBES,
    ROADMAP C)."""
    m = _api(api)
    s = m.Scene()
    s.add(m.make_quad((-3, 0, -3), (3, 0, -3), (3, 0, 3), (-3, 0, 3)),
          m.Matte(kd=(0.55, 0.55, 0.55)))
    s.add(m.make_sphere((-0.8, 0.5, 0.2), 0.5, 24, 48), m.Glass(eta=1.4),
          inside_medium=m.Milk(scale=30.0))
    lo, hi = (0.4, 0.0, -0.4), (1.6, 1.8, 0.8)
    smoke = m.GridMedium(density=smoke_column(grid), bounds_lo=lo, bounds_hi=hi,
                         sigma_a=(0.05, 0.05, 0.05), sigma_s=(0.9, 0.9, 0.9), g=0.2)
    s.add(m.make_box(lo, hi), m.Interface(), inside_medium=smoke)
    s.add_light(m.PointLight(position=(0, 2.6, -1.0), intensity=(14, 14, 14)))
    s.add_light(m.DistantLight(direction=(0.3, -1.0, 0.4), radiance=(1.5, 1.6, 1.8)))
    return s


CLOUD_EXAMPLE_BOX = ((-2.0, 0.8, -2.0), (2.0, 3.2, 2.0))


@functools.lru_cache(maxsize=None)
def example_cloud(grid: int = 96, api=None):
    """examples/cloud_example.py's procedural cloud: a grid^3 CloudVolume
    over CLOUD_EXAMPLE_BOX (sigma_s 12, sigma_a 0.02, g 0.877, scale 2.5,
    Worley weight 0.6, threshold 0.15), one object per (grid, api) kept
    for the next call (its noise costs seconds of host time)."""
    m = _api(api)
    lo, hi = CLOUD_EXAMPLE_BOX
    return m.CloudVolume(resolution=grid, bounds_lo=lo, bounds_hi=hi, sigma_s=(12.0,) * 3,
                         sigma_a=(0.02,) * 3, g=0.877, scale=2.5, worley_weight=0.6,
                         threshold=0.15)


def cloud_example_scene(grid: int = 96, cloud=None, api=None):
    """examples/cloud_example.py: a cloud medium (example_cloud(grid) unless
    given, e.g. a nanovdb_medium) in an Interface box over its bounds,
    above a 60 x 60 Matte floor, under sunsky_environment(direction=(0.5,
    0.35, 0.6), up="y", turbidity=3, resolution=128)."""
    m = _api(api)
    cloud = example_cloud(grid, m) if cloud is None else cloud
    s = m.Scene()
    s.add(m.make_quad((-30, 0, -30), (30, 0, -30), (30, 0, 30), (-30, 0, 30)),
          m.Matte(kd=(0.35, 0.4, 0.3)))
    s.add(m.make_box(cloud.bounds_lo, cloud.bounds_hi), m.Interface(), inside_medium=cloud)
    for light in m.sunsky_environment(direction=(0.5, 0.35, 0.6), up="y", turbidity=3.0,
                                      resolution=128):
        s.add_light(light)
    return s


BUILDERS = {"default": default_scene, "mesh": mesh_scene, "fog": fog_scene,
            "sphere": sphere_scene, "cloud": cloud_scene, "cloud_grid": cloud_grid_scene,
            "lights": lights_scene, "sparse_cloud": sparse_cloud_scene,
            "materials": materials_scene, "mix": mix_scene, "triangle": triangle_scene,
            "textured": textured_scene, "cornell": cornell_scene, "foliage": foliage_scene,
            "swatch": swatch_scene, "quickstart": quickstart_scene,
            "specular": specular_scene, "box": box_scene, "lensing": lensing_scene,
            "dispersion": dispersion_scene, "medium_example": medium_example_scene,
            "cloud_example": cloud_example_scene}


def scene_camera(which: str, width: int, height=None):
    """SCENE_DEFS's camera of a scene at width x height (square unless
    height is given)."""
    (eye, at, fov), _ = SCENE_DEFS[which]
    return make_perspective_camera(eye, at, (width, height or width), fov_deg=fov)


def probe_config(which: str, res=None, depth=None, spp=None):
    """(res, depth, spp) of a probe: SCENE_DEFS's unless given."""
    _, (pres, pdepth, pspp, _) = SCENE_DEFS[which]
    return res or pres, depth or pdepth, spp or pspp


def transport_probe(scene, which: str = "default", n_segments: int = 0, res=None,
                    depth=None, spp=None, ftype: int = GAUSSIAN, **vp_kw):
    """Render of a scene at its probe size (SCENE_DEFS, or res / depth /
    spp): (rays traced, mean framebuffer RGB), each averaged over samples
    0..spp-1 of VolPath(samples_per_pixel=spp), as a render draws them,
    through the filter ftype (make_filter's default radius).
    (bench.transport_probe keeps samples_per_pixel=1 for its 16-sample
    cloud probe; the sampler then folds sample indices past 0 onto other
    pixels' samples, and the probe averages few distinct samples.) Up to
    PROBE_BATCH samples go through one render_lanes call; a lane's result
    does not depend on the batch. vp_kw: further VolPath fields (the
    bounce-loop modes); n_segments > 0 renders through
    render_lanes_segmented."""
    pres, pdepth, pspp = probe_config(which, res, depth, spp)
    camera = scene_camera(which, pres)
    vp = VolPath(max_depth=pdepth, samples_per_pixel=pspp, **vp_kw)
    lanes = torch.arange(pres * pres, device=scene.device)
    rays = mean_rgb = 0.0
    for s0 in range(0, pspp, PROBE_BATCH):
        k = min(PROBE_BATCH, pspp - s0)
        si = s0 + torch.arange(k, device=scene.device).repeat_interleave(lanes.numel())
        args = (vp, scene, camera, make_filter(ftype), si, (lanes % pres).repeat(k),
                (lanes // pres).repeat(k))
        rgb, _, stats = (render_lanes_segmented(*args, n_segments) if n_segments
                         else render_lanes(*args))
        rays += float(stats["rays_traced"])
        mean_rgb += float(rgb.mean()) * k
    return rays / pspp, mean_rgb / pspp


# scenes whose bench probe (SCENE_DEFS) is stored in tools/transport_ref.json
# and drawn deterministically given the sampler (the fog's 1-sample rays
# too): the bench's sun-sky cloud probe is one LCG draw of 16 samples, so
# its reference is the JAX package's six-draw mean in data/probe_ref.json
TRANSPORT_REF_SCENES = ("default", "mesh", "fog", "sphere")


# scenes whose probe is held to the JAX package's packet engine
# (Scene.build(traversal="packets_interp"), the walk the port's sweeps
# mirror) instead of its CPU default, the skip-link walk: their faces tie
# at one t, and the two JAX walks keep different faces (ROADMAP C)
PACKET_PROBES = ("medium_example",)


def probe_key(which: str, res: int, depth: int, spp: int, sampler: str = "power",
              ftype: int = GAUSSIAN, packets: bool = False) -> str:
    key = f"{which} {res}x{res} depth {depth} {spp} spp"
    if sampler != "power":
        key = f"{key}, {sampler} sampler"
    if ftype != GAUSSIAN:
        key = f"{key}, {FILTER_NAMES[ftype]} filter"
    return f"{key}, packet engine" if packets else key


def probe_reference(which: str, res=None, depth=None, spp=None, sampler="power",
                    ftype: int = GAUSSIAN, packets=None) -> dict:
    """The JAX package's stored probe of a scene under a light sampler and
    a filter: its bench probe from tools/transport_ref.json, any other from
    data/probe_ref.json (written by tools/gen_probe_ref.py); taken on the
    JAX packet engine if packets (default: the scene is in PACKET_PROBES),
    else on the skip-link walk."""
    cfg = probe_config(which, res, depth, spp)
    packets = which in PACKET_PROBES if packets is None else packets
    if (sampler == "power" and ftype == GAUSSIAN and which in TRANSPORT_REF_SCENES
            and cfg == probe_config(which)):
        return json.loads(TRANSPORT_REF.read_text())["scenes"][which]
    return json.loads(PROBE_REF.read_text())["probes"][probe_key(which, *cfg, sampler, ftype,
                                                                 packets)]


def check_transport(scene, which: str = "default", rgb_tol=None, **probe_kw):
    """Probe (transport_probe's keywords) of a scene under its light
    sampler against its stored reference (probe_reference): rays within
    0.5%, mean RGB within rgb_tol (SCENE_DEFS's unless given). Returns
    (ok, message)."""
    cfg = {k: probe_kw.pop(k, None) for k in ("res", "depth", "spp")}
    ftype = probe_kw.pop("ftype", GAUSSIAN)
    ref = probe_reference(which, **cfg, sampler=scene.light_sampler, ftype=ftype)
    rays, mean_rgb = transport_probe(scene, which, **cfg, ftype=ftype, **probe_kw)
    tol = SCENE_DEFS[which][1][3] if rgb_tol is None else rgb_tol
    dr = abs(rays - ref["rays_traced"]) / max(ref["rays_traced"], 1.0)
    dc = abs(mean_rgb - ref["mean_rgb"]) / max(abs(ref["mean_rgb"]), 1e-6)
    res, depth, spp = probe_config(which, **cfg)
    if scene.light_sampler != "power":
        which = f"{which} ({scene.light_sampler} sampler)"
    if ftype != GAUSSIAN:
        which = f"{which} ({FILTER_NAMES[ftype]} filter)"
    msg = (f"{which} {res}x{res} depth {depth} {spp} spp: rays_traced {rays:.2f} vs "
           f"{ref['rays_traced']:.2f} ({dr * 100:.3f}%, tolerance 0.5%), mean_rgb "
           f"{mean_rgb:.7f} vs {ref['mean_rgb']:.7f} ({dc * 100:.3f}%, tolerance "
           f"{tol * 100:g}%)")
    return (dr <= 0.005 and dc <= tol), msg


def face_hits(tl, faces, o, d):
    """Moller-Trumbore in float64 of each ray (o, d) against the leaf-order
    face faces[i] of flat Treelets -> (t, hit), each (n,); hit where the
    face holds the hit point within 1e-6 in its barycentrics, t > 0."""
    slots = torch.full((int(tl.tri[:, 9].max()) + 1,), -1, dtype=torch.int64,
                       device=tl.tri.device)
    real = (tl.tri[:, 9] >= 0).nonzero().squeeze(1)
    slots[tl.tri[real, 9].long()] = real
    rows = tl.tri[slots[faces.long()]].double()
    p0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    o, d = o.double(), d.double()
    pvec = torch.linalg.cross(d, e2)
    inv = 1.0 / (e1 * pvec).sum(-1)
    tvec = o - p0
    u = (tvec * pvec).sum(-1) * inv
    qvec = torch.linalg.cross(tvec, e1)
    v = (d * qvec).sum(-1) * inv
    t = (e2 * qvec).sum(-1) * inv
    return t, (u >= -1e-6) & (v >= -1e-6) & (u + v <= 1.0 + 1e-6) & (t > 0.0)


def aux_reference(which: str) -> dict:
    """The JAX package's render_aux of a scene through SCENE_DEFS's camera,
    stored by tools/gen_probe_ref.py --renders: albedo (H, W, 3), normal
    (H, W, 3), depth (H, W) and face (H, W), the leaf-order face of each
    pixel's closest hit (-1 where the ray escapes)."""
    with np.load(AUX_REF) as z:
        return {k: z[f"{which}_{k}"] for k in ("albedo", "normal", "depth", "face")}


def aux_against_reference(scene, which: str) -> dict:
    """render_aux of a flat scene at the stored size against the JAX
    package's (aux_reference), pixel for pixel. A pixel keeps the same face
    as the reference, or sits on a tie: its ray meets the shared edge of
    two faces, both faces hold the hit point and their t differ by at most
    AUX_TIE_RTOL (face_hits, float64), and each traversal keeps one of them
    by its own rule (the port's and the JAX package's treelet sweeps the
    smaller of (t rounded to 24 bits, column); the skip-link walk the first
    smaller t). Every other pixel is unexplained. Returns the counts, the
    tie pixels' (row, column) and faces, and the largest differences:
    albedo and normal (absolute) on the pixels of the same face, depth
    (relative to max(depth, 1)) on every pixel; and the relative
    difference of the mean albedo over the pixels of the same face, which
    a Mix's child, picked per hit by a hash of the barycentrics' bits
    (rounded apart by the two packages), and a texel edge (where a uv
    that differs in its last bits reads another texel) move pixel by pixel
    but not in the mean."""
    ref = aux_reference(which)
    res = ref["depth"].shape[0]
    cam = scene_camera(which, res)
    albedo, normal, depth = (x.cpu().numpy() for x in render_aux(scene, cam))
    o, d = pixel_centre_rays(cam, scene.device)
    rec = scene_closest_hit(scene, o, d, torch.full((res * res,), float("inf"),
                                                     device=scene.device))
    face = torch.where(rec.hit, rec.tri, -1)
    ref_face = torch.as_tensor(ref["face"].reshape(-1), device=face.device)
    other = ((face != ref_face) & (face >= 0) & (ref_face >= 0)).nonzero().squeeze(1)
    t_a, hit_a = face_hits(scene.treelets, face[other], o[other], d[other])
    t_b, hit_b = face_hits(scene.treelets, ref_face[other], o[other], d[other])
    tie = hit_a & hit_b & ((t_a - t_b).abs() <= AUX_TIE_RTOL * torch.maximum(t_a, t_b))
    same = (face == ref_face).cpu().numpy().reshape(res, res)
    ties = other[tie].cpu().numpy()
    return {"which": which, "res": res, "pixels": res * res, "same": int(same.sum()),
            "ties": len(ties), "unexplained": res * res - int(same.sum()) - len(ties),
            "tie_pixels": [divmod(int(i), res) for i in ties],
            "tie_faces": list(zip(face[other[tie]].tolist(), ref_face[other[tie]].tolist())),
            "albedo_err": float(np.abs(albedo - ref["albedo"])[same].max()),
            "albedo_mean_err": float(abs(albedo[same].mean(dtype=np.float64)
                                         / ref["albedo"][same].mean(dtype=np.float64) - 1)),
            "normal_err": float(np.abs(normal - ref["normal"])[same].max()),
            "depth_err": float((np.abs(depth - ref["depth"])
                                / np.maximum(ref["depth"], 1.0)).max()),
            "means": [float(albedo.mean()), normal.reshape(-1, 3).mean(0).tolist(),
                      float(depth.mean())],
            "ref_means": [float(ref["albedo"].mean()), ref["normal"].reshape(-1, 3).mean(0).tolist(),
                          float(ref["depth"].mean())]}
