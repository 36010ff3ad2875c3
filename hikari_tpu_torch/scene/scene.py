"""Scene builder and the device-resident scene (flat scenes).

Port of the flat path of ``hikari_tpu/scene/scene.py`` (``Scene.build``,
scene.py:263-478): meshes and materials are collected on the host,
emissive faces become per-face area lights, the BVH fixes the leaf order
of every per-face array, and the result is packed into tensors on one
device. Media, stochastic alpha, textures and instancing are not ported
and raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..geometry.bvh import build_bvh
from ..geometry.wavefront import Treelets, build_treelets, bvh_super_boxes
from ..lights.types import LightBanks, pack_lights
from ..materials.types import EMISSIVE, MaterialBanks, pack_materials
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


@dataclass
class SceneData:
    """Device-resident flat scene; per-face arrays are in BVH leaf order."""

    treelets: Treelets
    face_rows: torch.Tensor    # (F, 17) packed per-face attributes
    mat_type: torch.Tensor     # (F,) int32 material type tag
    mat_idx: torch.Tensor      # (F,) int32 index into that type's bank
    materials: MaterialBanks
    lights: LightBanks
    world_lo: torch.Tensor     # (3,)
    world_hi: torch.Tensor     # (3,)
    scene_radius: float
    present_materials: tuple
    n_lights: int
    n_faces: int

    @property
    def device(self) -> torch.device:
        return self.face_rows.device

    def to(self, device) -> "SceneData":
        return SceneData(
            treelets=self.treelets.to(device), face_rows=self.face_rows.to(device),
            mat_type=self.mat_type.to(device), mat_idx=self.mat_idx.to(device),
            materials=self.materials.to(device), lights=self.lights.to(device),
            world_lo=self.world_lo.to(device), world_hi=self.world_hi.to(device),
            scene_radius=self.scene_radius,
            present_materials=self.present_materials, n_lights=self.n_lights,
            n_faces=self.n_faces)


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


class Scene:
    """Host-side scene builder: Scene() -> add / add_light -> build()."""

    def __init__(self):
        self._meshes: list[TriangleMesh] = []
        self._mesh_mat: list[int] = []
        self._materials: list = []
        self._lights: list = []

    def add(self, mesh: TriangleMesh, material, inside_medium=None,
            outside_medium=None, alpha=None) -> int:
        """push!(scene, mesh, material); materials are deduplicated."""
        if inside_medium is not None or outside_medium is not None:
            raise NotImplementedError("participating media are not ported yet")
        if alpha is not None:
            raise NotImplementedError("stochastic alpha is not ported yet")
        try:
            mat_id = self._materials.index(material)
        except ValueError:
            mat_id = len(self._materials)
            self._materials.append(material)
        self._meshes.append(mesh)
        self._mesh_mat.append(mat_id)
        return len(self._meshes) - 1

    def add_instanced(self, *args, **kwargs):
        raise NotImplementedError("instancing is not ported yet")

    def set_camera_medium(self, medium) -> None:
        raise NotImplementedError("participating media are not ported yet")

    def set_light_sampler(self, mode: str) -> None:
        if mode != "power":
            raise NotImplementedError(f"light sampler {mode!r} is not ported yet")

    def add_light(self, light) -> None:
        self._lights.append(light)

    def build(self, device=None) -> SceneData:
        """sync!(scene): bake, BVH, pack, and move to `device` (default: the
        first CUDA device if there is one, else the CPU)."""
        if not self._meshes:
            raise ValueError("scene has no geometry")
        device = default_device() if device is None else torch.device(device)
        p0s, p1s, p2s, n0s, n1s, n2s, mat_of_face = [], [], [], [], [], [], []
        for mesh, mat_id in zip(self._meshes, self._mesh_mat):
            v = mesh.vertices
            if mesh.transform is not None:
                m = np.asarray(mesh.transform, np.float32)
                v = v @ m[:3, :3].T + m[:3, 3]
            f = mesh.faces
            p0s.append(v[f[:, 0]])
            p1s.append(v[f[:, 1]])
            p2s.append(v[f[:, 2]])
            n = mesh.normals
            if n is None:
                n = compute_vertex_normals(v, f)
            elif mesh.transform is not None:
                n = n @ np.linalg.inv(m[:3, :3])
                n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
            n0s.append(n[f[:, 0]])
            n1s.append(n[f[:, 1]])
            n2s.append(n[f[:, 2]])
            mat_of_face.append(np.full(len(f), mat_id, np.int32))
        p0, p1, p2, n0, n1, n2 = (np.concatenate(a).astype(np.float32)
                                  for a in (p0s, p1s, p2s, n0s, n1s, n2s))
        mat_of_face = np.concatenate(mat_of_face)

        banks, tags, idxs, present = pack_materials(self._materials)
        face_type = tags[mat_of_face]
        face_idx = idxs[mat_of_face]

        # emissive faces -> per-face area lights (build_face_meta)
        emissive = face_type == EMISSIVE
        arealight_idx = np.full(len(p0), -1, np.int32)
        area_tris = None
        if emissive.any():
            which = np.nonzero(emissive)[0]
            arealight_idx[which] = np.arange(len(which), dtype=np.int32)
            mats = [self._materials[mat_of_face[i]] for i in which]
            a_le = np.stack([np.asarray(m.le, np.float32) * m.scale for m in mats])
            a_two = np.array([m.two_sided for m in mats], bool)
            area_tris = (p0[which], p1[which], p2[which], a_le, a_two)

        tri_lo = np.minimum(np.minimum(p0, p1), p2)
        tri_hi = np.maximum(np.maximum(p0, p1), p2)
        fb = build_bvh(tri_lo, tri_hi)
        order = fb.prim_order
        world_lo = tri_lo.min(axis=0)
        world_hi = tri_hi.max(axis=0)
        radius = 0.5 * float(np.linalg.norm(world_hi - world_lo))
        lights = pack_lights(self._lights, area_tris)

        mat_packed = (face_type[order].astype(np.int32) << 24) | face_idx[order]
        # no media: (inside + 1) << 16 | (outside + 1) with both -1
        med_packed = np.zeros(len(p0), np.int32)
        face_rows = pack_face_rows(
            _face_normals(p0[order], p1[order], p2[order]),
            n0[order], n1[order], n2[order], mat_packed, med_packed,
            arealight_idx[order])
        treelets = build_treelets(
            p0[order], p1[order], p2[order],
            supers=bvh_super_boxes(fb, len(p0), prim_lo=tri_lo[order],
                                   prim_hi=tri_hi[order]))
        scene = SceneData(
            treelets=treelets, face_rows=torch.from_numpy(face_rows),
            mat_type=torch.from_numpy(face_type[order].astype(np.int32)),
            mat_idx=torch.from_numpy(face_idx[order].astype(np.int32)),
            materials=banks, lights=lights,
            world_lo=torch.from_numpy(world_lo), world_hi=torch.from_numpy(world_hi),
            scene_radius=max(radius, 1e-3), present_materials=tuple(sorted(present)),
            n_lights=lights.n_flat, n_faces=int(len(p0)))
        return scene.to(device)
