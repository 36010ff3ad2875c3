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
from ..geometry.bvh import build_bvh
from ..geometry.instanced import InstancedTreelets, build_instanced_treelets
from ..geometry.sweep import TREELET
from ..geometry.traverse import DeviceBVH, device_bvh
from ..geometry.wavefront import Treelets, build_treelets, bvh_super_boxes
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


def _instanced_bounds(blas_boxes, instances):
    """World box (float64) of an instanced scene's real triangles: each
    instance's BLAS box, its 8 corners moved by the instance's matrix."""
    corners = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)])
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    for bid, m in instances:
        b_lo, b_hi = (np.asarray(b, np.float64) for b in blas_boxes[bid])
        pts = np.where(corners, b_hi, b_lo)
        m = np.asarray(m, np.float64)
        pts = pts @ m[:3, :3].T + m[:3, 3]
        lo = np.minimum(lo, pts.min(axis=0))
        hi = np.maximum(hi, pts.max(axis=0))
    return lo, hi


def _check_alpha(alpha):
    """A mesh's alpha: None (opaque), a number or an ImageTexture."""
    if alpha is not None and not isinstance(alpha, ImageTexture):
        alpha = float(alpha)
    return alpha


def _check_transforms(transforms) -> np.ndarray:
    tr = np.asarray(transforms, np.float32)
    if tr.ndim != 3 or tr.shape[1:] != (4, 4):
        raise ValueError(f"transforms: shape {tr.shape}, expected (I, 4, 4)")
    return tr


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

    def add_instanced(self, mesh: TriangleMesh, transforms, material,
                      inside_medium=None, outside_medium=None, alpha=None,
                      materials=None) -> int:
        """Many placements of one mesh sharing a single BLAS: memory scales
        with the unique mesh, not the instance count. transforms: (I, 4, 4)
        world-from-object matrices; materials: optional per-instance list
        overriding `material`; alpha as in add. Returns a handle for
        set_instance_transforms."""
        alpha = _check_alpha(alpha)
        tr = _check_transforms(transforms)
        mat_id = self._material_id(material)
        per_inst = None
        if materials is not None:
            if len(materials) != len(tr):
                raise ValueError(f"{len(materials)} materials for {len(tr)} instances")
            per_inst = [self._material_id(m) for m in materials]
        self._instanced.append((mesh, tr, mat_id, per_inst,
                                self._media_pair(inside_medium, outside_medium), alpha))
        return len(self._instanced) - 1

    def set_instance_transforms(self, handle: int, transforms) -> None:
        """Re-place an instanced group; takes effect at the next build()."""
        mesh, _, mat_id, per_inst, media, alpha = self._instanced[handle]
        tr = _check_transforms(transforms)
        if per_inst is not None and len(per_inst) != len(tr):
            raise ValueError(f"{len(tr)} transforms for {len(per_inst)} per-instance "
                             "materials")
        self._instanced[handle] = (mesh, tr, mat_id, per_inst, media, alpha)

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
        scene = self._build_instanced() if self._instanced else self._build_flat()
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
        fb = build_bvh(tri_lo, tri_hi)
        order = fb.prim_order
        world_lo = tri_lo.min(axis=0)
        world_hi = tri_hi.max(axis=0)
        lights, light_bvh, radius = self._pack_lights(
            area_tris, 0.5 * float(np.linalg.norm(world_hi - world_lo)))

        mat_packed = (face_type[order].astype(np.int32) << 24) | face_idx[order]
        face_rows = pack_face_rows(
            _face_normals(p0[order], p1[order], p2[order]),
            arrs["n0"][order], arrs["n1"][order], arrs["n2"][order], mat_packed,
            med_of_face[order], arealight_idx[order])
        treelets = build_treelets(
            p0[order], p1[order], p2[order],
            supers=bvh_super_boxes(fb, len(p0), prim_lo=tri_lo[order],
                                   prim_hi=tri_hi[order]))
        return SceneData(
            treelets=treelets, face_rows=torch.from_numpy(face_rows),
            mat_type=torch.from_numpy(face_type[order].astype(np.int32)),
            mat_idx=torch.from_numpy(face_idx[order].astype(np.int32)),
            materials=banks, lights=lights, light_bvh=light_bvh,
            world_lo=torch.from_numpy(world_lo), world_hi=torch.from_numpy(world_hi),
            scene_radius=radius, present_materials=tuple(sorted(present)),
            n_lights=lights.n_flat, n_faces=int(len(p0)), bvh=device_bvh(fb, p0, p1, p2),
            **_surface_fields([arrs[k][order] for k in _TEX_KEYS], alpha_c[order],
                              alpha_t[order], [p0[order], p1[order], p2[order]], atlas,
                              np.ones(len(p0), bool)))

    def _build_instanced(self) -> SceneData:
        """Two-level build (scene.py:561-777): one BLAS per instanced mesh,
        BLAS 0 for every non-instanced mesh under an identity instance."""
        atlas = AtlasBuilder()
        banks, tags, idxs, present = pack_materials(self._materials, atlas)
        packed_of = (tags.astype(np.int32) << 24) | idxs.astype(np.int32)
        for _, _, mat_id, per_inst, _, _ in self._instanced:
            if any(tags[m] == EMISSIVE for m in [mat_id] + (per_inst or [])):
                raise ValueError(
                    "emissive materials on instanced meshes are not supported (one "
                    "area light per emissive face); add that mesh flattened instead")

        blas_tris, blas_boxes, chunks, instances, inst_mat = [], [], [], [], []

        def finish_blas(arrs, slot, med, alpha_c, alpha_t):
            """BVH leaf order, then padding to a TREELET multiple: far-away
            degenerate corners (never hit), zero attributes and alpha, slot
            -1, medium word -1 and alpha texture -1 (the reference's fill
            for int fields)."""
            tri_lo = np.minimum(np.minimum(arrs["p0"], arrs["p1"]), arrs["p2"])
            tri_hi = np.maximum(np.maximum(arrs["p0"], arrs["p1"]), arrs["p2"])
            order = build_bvh(tri_lo, tri_hi).prim_order
            blas_boxes.append((tri_lo.min(axis=0), tri_hi.max(axis=0)))
            pad = (-len(order)) % TREELET
            arrs = {k: np.concatenate([a[order], np.full(
                (pad,) + a.shape[1:], 3.0e37 if k in _GEOMETRY else 0.0, np.float32)])
                for k, a in arrs.items()}
            chunks.append((arrs, *(np.concatenate([x[order], np.full(pad, fill, x.dtype)])
                                   for x, fill in ((slot, -1), (med, -1), (alpha_c, 0.0),
                                                   (alpha_t, -1)))))
            blas_tris.append(tuple(arrs[k] for k in _GEOMETRY))
            return len(blas_tris) - 1

        def alphas(meshes, alpha_of):
            return tuple(np.concatenate(x) for x in zip(*(
                _face_alpha(a, m.n_faces, atlas) for m, a in zip(meshes, alpha_of))))

        if self._meshes:
            bid = finish_blas(*_concat_meshes(
                self._meshes, self._mesh_mat, [_medium_word(*m) for m in self._mesh_media]),
                *alphas(self._meshes, self._mesh_alpha))
            instances.append((bid, np.eye(4, dtype=np.float32)))
            inst_mat.append(-1)
        for mesh, tr, mat_id, per_inst, media, alpha in self._instanced:
            bid = finish_blas(*_concat_meshes([mesh], [mat_id], [_medium_word(*media)]),
                              *alphas([mesh], [alpha]))
            for k, m in enumerate(tr):
                instances.append((bid, m))
                inst_mat.append(-1 if per_inst is None else int(packed_of[per_inst[k]]))
        inst_tl = build_instanced_treelets(blas_tris, instances)

        arrs = {k: np.concatenate([c[0][k] for c in chunks]) for k in chunks[0][0]}
        slot, med_packed, alpha_c, alpha_t = (np.concatenate([c[j] for c in chunks])
                                              for j in range(1, 5))
        p0, p1, p2 = (arrs[k] for k in _GEOMETRY)
        real = slot >= 0
        face_packed = np.where(real, packed_of[np.maximum(slot, 0)], -1).astype(np.int32)
        face_type = face_packed >> 24
        face_idx = face_packed & 0xFFFFFF
        present |= {int(t) for t in np.unique(face_type)}

        # area lights: only BLAS-0 (identity instance) emissive faces
        arealight_idx = np.full(len(p0), -1, np.int32)
        area_tris = None
        emissive = (face_type == EMISSIVE) & (p0[:, 0] < 1.0e37)
        if emissive.any():
            which = np.nonzero(emissive)[0]
            arealight_idx[which] = np.arange(len(which), dtype=np.int32)
            area_tris = _area_tris(self._materials, slot, p0, p1, p2, which)

        # the traversal's world box is the reference's, unbounded where a
        # padded treelet is (ROADMAP C); the lights' radius is the real one
        lo, hi = inst_tl.lo.numpy(), inst_tl.hi.numpy()
        finite = lo[:, 0] < 1.0e37
        world_lo = lo[finite].min(axis=0)
        world_hi = hi[finite].max(axis=0)
        real_lo, real_hi = _instanced_bounds(blas_boxes, instances)
        lights, light_bvh, radius = self._pack_lights(
            area_tris, 0.5 * float(np.linalg.norm(real_hi - real_lo)))

        mats44 = np.stack([m for _, m in instances]).astype(np.float64)
        inv_lin = np.linalg.inv(mats44[:, :3, :3])
        face_rows = pack_face_rows(_face_normals(p0, p1, p2), arrs["n0"], arrs["n1"],
                                   arrs["n2"], face_packed, med_packed, arealight_idx)
        return SceneData(
            treelets=None, face_rows=torch.from_numpy(face_rows),
            mat_type=torch.from_numpy(face_type), mat_idx=torch.from_numpy(face_idx),
            materials=banks, lights=lights, light_bvh=light_bvh,
            world_lo=torch.from_numpy(world_lo.astype(np.float32)),
            world_hi=torch.from_numpy(world_hi.astype(np.float32)),
            scene_radius=radius, present_materials=tuple(sorted(present)),
            n_lights=lights.n_flat, n_faces=int(len(p0)), inst=inst_tl,
            inst_nrm=torch.from_numpy(np.ascontiguousarray(
                np.transpose(inv_lin, (0, 2, 1)), np.float32)),
            inst_l2w=torch.from_numpy(np.ascontiguousarray(mats44[:, :3, :4], np.float32)),
            inst_mat_packed=torch.from_numpy(np.asarray(inst_mat, np.int32)),
            **_surface_fields([arrs[k] for k in _TEX_KEYS], alpha_c, alpha_t, [p0, p1, p2],
                              atlas, real))


def _surface_fields(tex_cols, alpha_c, alpha_t, corners, atlas: AtlasBuilder, real) -> dict:
    """SceneData's texture and alpha fields from per-face-row arrays."""
    return dict(
        tex_rows=torch.from_numpy(pack_tex_rows(*tex_cols, alpha_c, alpha_t)),
        alpha_const=torch.from_numpy(np.ascontiguousarray(alpha_c, np.float32)),
        alpha_tex=torch.from_numpy(np.ascontiguousarray(alpha_t, np.int32)),
        tri_p=torch.from_numpy(np.concatenate(corners, axis=1).astype(np.float32)),
        atlas=atlas.build(), has_alpha=surface_has_alpha(alpha_c, alpha_t, real))
