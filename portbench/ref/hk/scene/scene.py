"""Scene builder and the device-resident scene.

Port of ``hikari_tpu/scene/scene.py``: meshes and materials are collected
on the host, emissive faces become per-face area lights, the BVH fixes
the leaf order of every per-face array, and the result is packed into
tensors on one device. A flat scene (``Scene.build``, scene.py:263-478)
has one treelet table; a scene with ``add_instanced`` meshes takes the
two-level build (``_build_instanced_scene``, scene.py:561-777): one BLAS
per instanced mesh plus BLAS 0 holding every non-instanced mesh under an
identity instance. A mesh may bound participating media (``add(...,
inside_medium=, outside_medium=)``): each face row carries the word
``(inside + 1) << 16 | (outside + 1)`` of its medium ids (-1 is vacuum) and
the media are packed into ``SceneData.media`` (``media/types.py``). Images
of textured material fields and alpha textures go into one atlas
(``SceneData.atlas``); per-face uv, vertex colours and surface alpha ride
in the (F, 17) ``tex_rows``. A mesh's ``alpha`` (a constant in [0, 1] or
an ``ImageTexture``) keeps a hit with that probability (stochastic alpha,
``integrators/volpath.py``); ``has_alpha`` counts real faces only, so the
padding of an instanced BLAS (alpha 0 in the tables, as in the JAX
package) does not turn it on.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np
import torch

from ..core.device import resolve_device
from ..lights.bvh_sampler import LightBVH, build_light_bvh
from ..lights.types import LightBanks, pack_lights
from ..materials.types import EMISSIVE, MaterialBanks, pack_materials
from ..media.types import MediumBanks, pack_media
from ..spectral.rgb2spec import RGBToSpectrumTable, srgb_table
from ..textures.atlas import AtlasBuilder, ImageTexture, TextureAtlas
from .mesh import TriangleMesh, compute_vertex_normals


def _face_normals(p0, p1, p2):
    n = np.cross(p1 - p0, p2 - p0)
    ln = np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    return (n / ln).astype(np.float32)


def pack_face_rows(ng_raw, n0, n1, n2, mat_packed, med_packed, arealight_idx):
    """(F, 17) f32 rows [ng_raw | n0 | n1 | n2 | mat hi/lo | arealight+1 |
    med hi/lo]: one row gather fetches every per-face shading attribute.
    Integer fields ride as exact-in-f32 16-bit halves."""
    mp = mat_packed.astype(np.int64)
    med = med_packed.astype(np.int64)
    cols = [ng_raw, n0, n1, n2, (mp >> 16)[:, None], (mp & 0xFFFF)[:, None],
            (arealight_idx.astype(np.int64) + 1)[:, None],
            (med >> 16)[:, None], (med & 0xFFFF)[:, None]]
    return np.concatenate([np.asarray(c, np.float32) for c in cols], axis=1)


def pack_tex_rows(uv0, uv1, uv2, c0, c1, c2, alpha_const, alpha_tex):
    """(F, 17) f32 rows [uv0 uv1 uv2 | c0 c1 c2 | alpha | alpha_tex+1] for
    the textured and stochastic-alpha paths: one row gather."""
    cols = [uv0, uv1, uv2, c0, c1, c2, np.asarray(alpha_const)[:, None],
            (np.asarray(alpha_tex).astype(np.int64) + 1)[:, None]]
    return np.concatenate([np.asarray(c, np.float32) for c in cols], axis=1)


def surface_has_alpha(alpha_const, alpha_tex, real) -> bool:
    """Whether a real face (not BLAS padding) has alpha below 1 or an alpha
    texture."""
    return bool((((alpha_tex >= 0) | (alpha_const < 1.0)) & real).any())


def _face_alpha(alpha, n_faces: int, atlas: AtlasBuilder):
    """Per-face (alpha constant, alpha texture id) of a mesh's `alpha`."""
    if isinstance(alpha, ImageTexture):
        return np.ones(n_faces, np.float32), np.full(n_faces, atlas.add(alpha), np.int32)
    a = 1.0 if alpha is None else float(alpha)
    return np.full(n_faces, a, np.float32), np.full(n_faces, -1, np.int32)


@dataclass
class SceneData:
    """Device-resident scene; per-face arrays are in BVH leaf order (flat)
    or in BLAS order, each BLAS padded to a TREELET multiple (instanced)."""

    treelets: Treelets | None  # flat scenes; None for an instanced scene
    face_rows: torch.Tensor    # (F, 17) packed per-face attributes
    mat_type: torch.Tensor     # (F,) int32 material type tag
    mat_idx: torch.Tensor      # (F,) int32 index into that type's bank
    materials: MaterialBanks
    lights: LightBanks
    light_bvh: LightBVH        # the BVH light sampler's tree over `lights`
    world_lo: torch.Tensor     # (3,)
    world_hi: torch.Tensor     # (3,)
    scene_radius: float
    present_materials: tuple
    n_lights: int
    n_faces: int
    # two-level instancing (geometry/instanced.py); None in a flat scene
    inst: InstancedTreelets | None = None
    inst_nrm: torch.Tensor | None = None         # (I, 3, 3) object->world normals
    inst_l2w: torch.Tensor | None = None         # (I, 3, 4) object->world [linear | t]
    inst_mat_packed: torch.Tensor | None = None  # (I,) int32 override; -1 = per-face
    # participating media: the banks (one dummy row when there is none), the
    # medium the camera sits in (-1: vacuum), and whether any exists
    media: MediumBanks | None = None
    camera_medium: int = -1
    has_media: bool = False
    # the sRGB uplift table RGB-grid media read while tracking, on the
    # scene's device
    rgb2spec: RGBToSpectrumTable = field(default_factory=srgb_table)
    light_sampler: str = "power"  # 'power' | 'uniform' | 'bvh'
    # textures and stochastic alpha: per-face rows (pack_tex_rows), surface
    # alpha, the corners of each face row (object space on an instanced
    # scene; the uv derivatives solve against them) and the image atlas
    tex_rows: torch.Tensor | None = None     # (F, 17)
    alpha_const: torch.Tensor | None = None  # (F,) 1 = opaque
    alpha_tex: torch.Tensor | None = None    # (F,) int32 atlas id; -1 constant
    tri_p: torch.Tensor | None = None        # (F, 9) [p0 | p1 | p2]
    atlas: TextureAtlas | None = None
    has_alpha: bool = False
    # the traversal engine: 'packets' (the sweeps of wavefront.py; the
    # kernels on the card, their plain versions on the CPU), 'skiplink'
    # (the skip-link walk over `bvh`, flat scenes) or 'packets_interp' (the
    # plain sweeps, CPU only)
    traversal: str = "packets"
    bvh: DeviceBVH | None = None  # flat scenes; None for an instanced scene

    @property
    def has_instances(self) -> bool:
        return self.inst is not None

    @property
    def device(self) -> torch.device:
        return self.face_rows.device

    def to(self, device) -> "SceneData":
        def move(x):
            return x.to(device) if hasattr(x, "to") else x

        return SceneData(**{f.name: move(getattr(self, f.name)) for f in fields(self)})


_GEOMETRY = ("p0", "p1", "p2")


def _mesh_face_arrays(mesh: TriangleMesh) -> dict:
    """Per-face corner positions, vertex normals, uvs (zero without) and
    colours (one without), the mesh's own transform baked in
    (hikari_tpu/scene/scene.py:511-536)."""
    v = mesh.vertices
    if mesh.transform is not None:
        m = np.asarray(mesh.transform, np.float32)
        v = v @ m[:3, :3].T + m[:3, 3]
    f = mesh.faces
    n = mesh.normals
    if n is None:
        n = compute_vertex_normals(v, f)
    elif mesh.transform is not None:
        n = n @ np.linalg.inv(m[:3, :3])
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    uv = mesh.uvs if mesh.uvs is not None else np.zeros((len(v), 2), np.float32)
    col = mesh.colors if mesh.colors is not None else np.ones((len(v), 3), np.float32)
    return {k: a[f[:, c]].astype(np.float32)
            for a, names in ((v, _GEOMETRY), (n, ("n0", "n1", "n2")),
                             (uv, ("uv0", "uv1", "uv2")), (col, ("c0", "c1", "c2")))
            for c, k in enumerate(names)}


_TEX_KEYS = ("uv0", "uv1", "uv2", "c0", "c1", "c2")


def _concat_meshes(meshes, mat_ids, med_words):
    """Face arrays of several meshes, concatenated, each face's material
    slot and each face's medium word."""
    parts = [_mesh_face_arrays(m) for m in meshes]
    arrs = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def per_face(values):
        return np.concatenate([np.full(len(p["p0"]), v, np.int32)
                               for p, v in zip(parts, values)])

    return arrs, per_face(mat_ids), per_face(med_words)


def _medium_word(inside: int, outside: int) -> int:
    """The face row's medium pair: (inside + 1) << 16 | (outside + 1)."""
    return ((inside + 1) << 16) | (outside + 1)


def _baked_le(mat) -> np.ndarray:
    """An emissive material's light colour: a textured emission is baked to
    its image's mean for NEE (camera hits still see the texture)."""
    le = mat.le
    if isinstance(le, ImageTexture):
        le = np.asarray(le.image, np.float32).reshape(-1, 3).mean(0)
    return np.asarray(le, np.float32) * mat.scale


def _area_tris(materials, slot, p0, p1, p2, which):
    """Emissive faces `which` -> the per-face area lights (build_face_meta)."""
    mats = [materials[slot[i]] for i in which]
    a_le = np.stack([_baked_le(m) for m in mats])
    a_two = np.array([m.two_sided for m in mats], bool)
    return p0[which], p1[which], p2[which], a_le, a_two


def _check_alpha(alpha):
    """A mesh's alpha: None (opaque), a number or an ImageTexture."""
    if alpha is not None and not isinstance(alpha, ImageTexture):
        alpha = float(alpha)
    return alpha


def _equal(a, b) -> bool:
    """Dataclass equality; media holding different arrays are different."""
    try:
        return bool(a == b)
    except ValueError:
        return False


class Scene:
    """Host-side scene builder: Scene() -> add / add_instanced / add_light
    -> build()."""

    def __init__(self):
        self._meshes: list[TriangleMesh] = []
        self._mesh_mat: list[int] = []
        self._mesh_media: list[tuple[int, int]] = []  # (inside, outside) ids
        self._mesh_alpha: list = []
        self._materials: list = []
        self._media: list = []
        self._camera_medium = -1
        self._lights: list = []
        self._light_sampler = "power"
        # instanced groups: (mesh, transforms (I, 4, 4), material slot,
        # per-instance material slots or None, (inside, outside) medium ids,
        # alpha)
        self._instanced: list = []

    def _material_id(self, material) -> int:
        """Slot of `material`; materials are deduplicated."""
        try:
            return self._materials.index(material)
        except ValueError:
            self._materials.append(material)
            return len(self._materials) - 1

    def _medium_id(self, medium) -> int:
        """Slot of `medium` (-1 for None); media are deduplicated."""
        if medium is None:
            return -1
        for i, m in enumerate(self._media):
            if m is medium or _equal(m, medium):
                return i
        self._media.append(medium)
        return len(self._media) - 1

    def _media_pair(self, inside_medium, outside_medium) -> tuple[int, int]:
        return self._medium_id(inside_medium), self._medium_id(outside_medium)

    def add(self, mesh: TriangleMesh, material, inside_medium=None,
            outside_medium=None, alpha=None) -> int:
        """push!(scene, mesh, material), optionally bounding media: rays
        crossing a face against its winding normal enter inside_medium,
        along it outside_medium (None: vacuum). alpha: surface opacity in
        [0, 1] or an ImageTexture; a hit is kept with probability alpha
        (stochastic alpha testing, intersection.jl:223-252)."""
        self._mesh_alpha.append(_check_alpha(alpha))
        self._meshes.append(mesh)
        self._mesh_mat.append(self._material_id(material))
        self._mesh_media.append(self._media_pair(inside_medium, outside_medium))
        return len(self._meshes) - 1

    def set_camera_medium(self, medium) -> None:
        """The medium the camera sits in (None: vacuum)."""
        self._camera_medium = self._medium_id(medium)

    def set_light_sampler(self, mode: str) -> None:
        """'power' (default), 'uniform', or 'bvh' (the adaptive BVH light
        sampler, bvh-light-sampler.jl)."""
        if mode not in ("power", "uniform", "bvh"):
            raise ValueError(f"light sampler {mode!r}: expected 'power', 'uniform' or 'bvh'")
        self._light_sampler = mode

    def add_light(self, light) -> None:
        self._lights.append(light)

    def __repr__(self) -> str:
        """A summary: meshes and faces, materials, lights and media by type."""
        n_faces = sum(m.n_faces for m in self._meshes)

        def by_type(objs):
            out = {}
            for o in objs:
                out[type(o).__name__] = out.get(type(o).__name__, 0) + 1
            return out

        parts = [f"Scene({len(self._meshes)} meshes, {n_faces} faces",
                 f"{len(self._instanced)} instanced groups" if self._instanced else "",
                 f"materials: {by_type(self._materials)}" if self._materials else "",
                 f"lights: {by_type(self._lights)}" if self._lights else "",
                 f"media: {len(self._media)}" if self._media else ""]
        return ", ".join(p for p in parts if p) + ")"

    def build(self, traversal: str = "auto", device=None) -> SceneData:
        """sync!(scene): bake, BVH, pack, and move to `device` (default: the
        first CUDA device; without one this raises, and device="cpu" builds
        the scene on the CPU).

        traversal: 'packets' (the sweep kernels on the card, their plain
        versions on the CPU), 'skiplink' (the skip-link BVH walk; an
        instanced scene takes the packets), 'packets_interp' (the plain
        sweeps: CPU only, ValueError on the card) or 'auto', which picks
        'packets' on every device (the JAX package picks 'skiplink' on its
        CPU)."""
        if traversal not in ("auto", "packets", "skiplink", "packets_interp"):
            raise ValueError(f"traversal {traversal!r}: expected 'auto', 'packets', "
                             "'skiplink' or 'packets_interp'")
        if not self._meshes and not self._instanced:
            raise ValueError("scene has no geometry")
        device = resolve_device(device)
        if traversal == "packets_interp" and device.type != "cpu":
            raise ValueError("traversal='packets_interp' runs the plain sweeps, on the CPU "
                             "only; the card runs the sweep kernels ('packets')")
        if traversal == "auto" or (traversal == "skiplink" and self._instanced):
            traversal = "packets"
        scene = self._build_flat()
        scene.traversal = traversal
        scene.media = pack_media(self._media)
        scene.camera_medium = self._camera_medium
        scene.has_media = bool(self._media)
        scene.light_sampler = self._light_sampler
        return scene.to(device)

    def _pack_lights(self, area_tris, radius: float):
        """(banks, light BVH, scene radius): the bvh sampler keeps the power
        table beside its tree, as the reference does (scene.py:402-410)."""
        radius = max(radius, 1e-3)
        sampler = "power" if self._light_sampler == "bvh" else self._light_sampler
        lights = pack_lights(self._lights, area_tris, scene_radius=radius, sampler=sampler)
        return lights, build_light_bvh(lights), radius

    def _build_flat(self) -> SceneData:
        arrs, mat_of_face, med_of_face = _concat_meshes(
            self._meshes, self._mesh_mat, [_medium_word(*m) for m in self._mesh_media])
        p0, p1, p2 = (arrs[k] for k in _GEOMETRY)
        atlas = AtlasBuilder()
        banks, tags, idxs, present = pack_materials(self._materials, atlas)
        alpha_c, alpha_t = (np.concatenate(x) for x in zip(*(
            _face_alpha(a, m.n_faces, atlas) for m, a in zip(self._meshes, self._mesh_alpha))))
        face_type = tags[mat_of_face]
        face_idx = idxs[mat_of_face]

        emissive = face_type == EMISSIVE
        arealight_idx = np.full(len(p0), -1, np.int32)
        area_tris = None
        if emissive.any():
            which = np.nonzero(emissive)[0]
            arealight_idx[which] = np.arange(len(which), dtype=np.int32)
            area_tris = _area_tris(self._materials, mat_of_face, p0, p1, p2, which)

        tri_lo = np.minimum(np.minimum(p0, p1), p2)
        tri_hi = np.maximum(np.maximum(p0, p1), p2)
        # portbench: no BVH; the face tables keep the input order
        order = np.arange(len(p0))
        world_lo = tri_lo.min(axis=0)
        world_hi = tri_hi.max(axis=0)
        lights, light_bvh, radius = self._pack_lights(
            area_tris, 0.5 * float(np.linalg.norm(world_hi - world_lo)))

        mat_packed = (face_type[order].astype(np.int32) << 24) | face_idx[order]
        face_rows = pack_face_rows(
            _face_normals(p0[order], p1[order], p2[order]),
            arrs["n0"][order], arrs["n1"][order], arrs["n2"][order], mat_packed,
            med_of_face[order], arealight_idx[order])
        return SceneData(
            treelets=None, face_rows=torch.from_numpy(face_rows),
            mat_type=torch.from_numpy(face_type[order].astype(np.int32)),
            mat_idx=torch.from_numpy(face_idx[order].astype(np.int32)),
            materials=banks, lights=lights, light_bvh=light_bvh,
            world_lo=torch.from_numpy(world_lo), world_hi=torch.from_numpy(world_hi),
            scene_radius=radius, present_materials=tuple(sorted(present)),
            n_lights=lights.n_flat, n_faces=int(len(p0)), bvh=None,
            **_surface_fields([arrs[k][order] for k in _TEX_KEYS], alpha_c[order],
                              alpha_t[order], [p0[order], p1[order], p2[order]], atlas,
                              np.ones(len(p0), bool)))

def _surface_fields(tex_cols, alpha_c, alpha_t, corners, atlas: AtlasBuilder, real) -> dict:
    """SceneData's texture and alpha fields from per-face-row arrays."""
    return dict(
        tex_rows=torch.from_numpy(pack_tex_rows(*tex_cols, alpha_c, alpha_t)),
        alpha_const=torch.from_numpy(np.ascontiguousarray(alpha_c, np.float32)),
        alpha_tex=torch.from_numpy(np.ascontiguousarray(alpha_t, np.int32)),
        tri_p=torch.from_numpy(np.concatenate(corners, axis=1).astype(np.float32)),
        atlas=atlas.build(), has_alpha=surface_has_alpha(alpha_c, alpha_t, real))
