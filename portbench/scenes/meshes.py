"""Mesh arrays of the benchmark's scenes, in numpy: a frozen copy of
``make_quad`` of ``hikari_tpu_torch/scene/mesh.py`` at commit 5d48e3d, returning
(vertices, faces, normals or None, uvs or None) instead of a mesh object,
so one set of arrays goes to the program and to the reference."""

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
