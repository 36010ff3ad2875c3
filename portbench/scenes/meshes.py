"""Mesh arrays of the benchmark's scenes, in numpy: a frozen copy of
``make_quad`` and ``make_sphere`` of ``hikari_tpu_torch/scene/mesh.py`` at
commit 5d48e3d, returning (vertices, faces, normals or None, uvs or None)
instead of a mesh object, so one set of arrays goes to the program and to
the reference."""

from __future__ import annotations

import numpy as np


def _mesh(v, f, normals=None, uvs=None) -> dict:
    return {"vertices": np.asarray(v, np.float32), "faces": np.asarray(f, np.int32),
            "normals": normals, "uvs": uvs}


def make_quad(p0, p1, p2, p3) -> dict:
    """Two-triangle quad with corners in CCW order."""
    v = np.array([p0, p1, p2, p3], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return _mesh(v, f, uvs=uv)


def make_sphere(center, radius, n_theta=32, n_phi=64) -> dict:
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
    return _mesh(verts, faces, normals=normals, uvs=uvs)
