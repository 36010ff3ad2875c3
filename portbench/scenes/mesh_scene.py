"""The mesh scene: bench.py build_mesh_scene, frozen from
``hikari_tpu_torch/scenes.py`` ``mesh_scene`` and ``_displaced_icosphere``
at commit 5d48e3d. The bench room's four Matte walls, a displaced
icosphere of 327,680 triangles under Gold (the stand-in for the cat
scene's scanned mesh), an emissive quad and a point light."""

from __future__ import annotations

import numpy as np

from .meshes import _mesh, make_quad


def displaced_icosphere(subdiv: int, seed: int = 7):
    """~20 * 4^subdiv-triangle icosphere displaced by multi-octave value
    noise (bench.py _displaced_icosphere, same arithmetic; its edge loop
    done in numpy, which gives the same arrays in ~0.1 s instead of ~3 s)."""
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
        # each face's edges ab, bc, ca in turn; an edge's midpoint gets the
        # next index at its first appearance, as the original's dict gives it
        n = len(v)
        a, b = f.reshape(-1), np.roll(f, -1, axis=1).reshape(-1)
        _, first, inv = np.unique(np.minimum(a, b) * n + np.maximum(a, b),
                                  return_index=True, return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        m = v[a[first[order]]] + v[b[first[order]]]
        m = m / np.sqrt((m[:, None, :] @ m[:, :, None])[:, 0])  # np.linalg.norm's dot
        ab, bc, ca = (n + rank[inv.reshape(-1)]).reshape(-1, 3).T
        p, q, r = f.T
        f = np.stack([np.stack(t, 1) for t in ((p, ab, ca), (q, bc, ab), (r, ca, bc),
                                               (ab, bc, ca))], 1).reshape(-1, 3)
        v = np.concatenate([v, m])
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


def make(cfg: dict) -> dict:
    """The scene as arrays and parameters: meshes (each with its material),
    lights, and no environment."""
    white = ("Matte", {"kd": (0.73, 0.73, 0.73)})
    v, f = displaced_icosphere(cfg["icosphere_subdiv"])
    v = v * 0.9 + np.asarray([[0.0, 1.1, 2.0]], np.float32)
    meshes = [
        (make_quad((-3, 0, -1), (3, 0, -1), (3, 0, 5), (-3, 0, 5)), white),
        (make_quad((-3, 0, 5), (3, 0, 5), (3, 4, 5), (-3, 4, 5)), white),
        (make_quad((-3, 0, -1), (-3, 0, 5), (-3, 4, 5), (-3, 4, -1)),
         ("Matte", {"kd": (0.65, 0.05, 0.05)})),
        (make_quad((3, 0, -1), (3, 4, -1), (3, 4, 5), (3, 0, 5)),
         ("Matte", {"kd": (0.12, 0.45, 0.15)})),
        (_mesh(v, f), ("Gold", {"roughness": 0.2})),
        (make_quad((-1.0, 3.99, 1.0), (1.0, 3.99, 1.0), (1.0, 3.99, 3.0),
                   (-1.0, 3.99, 3.0)),
         ("Emissive", {"le": (1.0, 0.95, 0.85), "scale": 25.0})),
    ]
    return {"meshes": [dict(mesh=m, material=mat) for m, mat in meshes],
            "lights": [("PointLight", {"position": (0.0, 3.0, -0.5),
                                       "intensity": (8.0, 8.0, 8.0)})],
            "sunsky": None}
