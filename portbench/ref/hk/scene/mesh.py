"""Triangle meshes (host numpy) and procedural constructors.

Port of ``hikari_tpu/scene/mesh.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TriangleMesh:
    vertices: np.ndarray               # (V, 3) float32
    faces: np.ndarray                  # (F, 3) int32
    normals: np.ndarray | None = None  # (V, 3)
    uvs: np.ndarray | None = None      # (V, 2)
    colors: np.ndarray | None = None   # (V, 3)
    transform: np.ndarray | None = None  # optional 4x4 object-to-world

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, np.float32).reshape(-1, 3)
        self.faces = np.asarray(self.faces, np.int32).reshape(-1, 3)
        if self.normals is not None:
            self.normals = np.asarray(self.normals, np.float32).reshape(-1, 3)
        if self.uvs is not None:
            self.uvs = np.asarray(self.uvs, np.float32).reshape(-1, 2)
        if self.colors is not None:
            self.colors = np.asarray(self.colors, np.float32).reshape(-1, 3)

    @property
    def n_faces(self):
        return self.faces.shape[0]


def compute_vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    p0, p1, p2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    n = np.zeros_like(verts)
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(ln, 1e-12)).astype(np.float32)


def make_quad(p0, p1, p2, p3) -> TriangleMesh:
    """Two-triangle quad with corners in CCW order."""
    v = np.array([p0, p1, p2, p3], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return TriangleMesh(v, f, uvs=uv)


def make_box(lo, hi) -> TriangleMesh:
    """Axis-aligned box of 12 triangles with outward winding."""
    x0, y0, z0 = np.asarray(lo, np.float32)
    x1, y1, z1 = np.asarray(hi, np.float32)
    quads = [  # -z, +z, -y, +y, -x, +x
        [(x0, y0, z0), (x0, y1, z0), (x1, y1, z0), (x1, y0, z0)],
        [(x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)],
        [(x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)],
        [(x0, y1, z0), (x0, y1, z1), (x1, y1, z1), (x1, y1, z0)],
        [(x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0)],
        [(x1, y0, z0), (x1, y1, z0), (x1, y1, z1), (x1, y0, z1)],
    ]
    faces = [f for b in range(0, 24, 4) for f in ([b, b + 1, b + 2], [b, b + 2, b + 3])]
    return TriangleMesh(np.array(quads, np.float32).reshape(24, 3), np.array(faces, np.int32))


def make_sphere(center, radius, n_theta=32, n_phi=64) -> TriangleMesh:
    """UV sphere with smooth vertex normals."""
    center = np.asarray(center, np.float32)
    thetas = np.linspace(0.0, np.pi, n_theta)
    phis = np.linspace(0.0, 2 * np.pi, n_phi, endpoint=False)
    T, P = np.meshgrid(thetas, phis, indexing="ij")
    normals = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P), np.cos(T)],
                       -1).reshape(-1, 3).astype(np.float32)
    verts = center + radius * normals
    uvs = np.stack([P / (2 * np.pi), T / np.pi], -1).reshape(-1, 2).astype(np.float32)
    faces = []
    for i in range(n_theta - 1):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            if i > 0:
                faces.append([a, c, b])
            if i < n_theta - 2:
                faces.append([b, c, d])
    return TriangleMesh(verts.astype(np.float32), np.array(faces, np.int32),
                        normals=normals, uvs=uvs)


def load_obj(path: str) -> TriangleMesh:
    """Minimal OBJ loader: v / vn / vt / f, polygons triangulated as fans.
    Negative (relative) indices are resolved for positions only, as in the
    JAX package: a corner with a negative vt / vn index gets none."""
    verts, norms, uvs = [], [], []
    f_v, f_n, f_t = [], [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                norms.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    sub = tok.split("/")
                    vi = int(sub[0])
                    ti = int(sub[1]) if len(sub) > 1 and sub[1] else 0
                    ni = int(sub[2]) if len(sub) > 2 and sub[2] else 0
                    idx.append((vi, ti, ni))
                for k in range(1, len(idx) - 1):
                    tri = [idx[0], idx[k], idx[k + 1]]
                    f_v.append([t[0] - 1 if t[0] > 0 else len(verts) + t[0] for t in tri])
                    f_t.append([t[1] - 1 for t in tri])
                    f_n.append([t[2] - 1 for t in tri])

    verts = np.asarray(verts, np.float32)
    faces = np.asarray(f_v, np.int32)
    # per-corner normals / uvs become per-vertex by splitting every corner
    if norms and any(n >= 0 for tri in f_n for n in tri):
        norms = np.asarray(norms, np.float32)
        corner_n = np.asarray(f_n, np.int64).reshape(-1)
        new_verts = verts[faces.reshape(-1)]
        new_norms = np.where((corner_n >= 0)[:, None],
                             norms[np.clip(corner_n, 0, len(norms) - 1)], 0.0).astype(np.float32)
        new_uvs = None
        if uvs and any(t >= 0 for tri in f_t for t in tri):
            uvarr = np.asarray(uvs, np.float32)
            new_uvs = uvarr[np.clip(np.asarray(f_t, np.int64).reshape(-1), 0, len(uvarr) - 1)]
        new_faces = np.arange(len(new_verts), dtype=np.int32).reshape(-1, 3)
        return TriangleMesh(new_verts, new_faces, normals=new_norms, uvs=new_uvs)
    return TriangleMesh(verts, faces)
