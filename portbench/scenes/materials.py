"""The ten-material scene: bench.py build_materials_scene (bench.py:427-467),
frozen from ``hikari_tpu_torch/scenes.py`` ``materials_scene`` at commit
5d48e3d. The bench room's four Matte walls, 16 spheres of radius 0.42 on a
4 x 4 grid cycling through the ten BSDF-bearing materials (the three
layered coats are spheres 6, 7 and 8), an emissive quad and a point light."""

from __future__ import annotations

from .meshes import make_quad, make_sphere

# bench.py's ten sphere materials, in its order
MATERIALS = [
    ("Matte", {"kd": (0.3, 0.4, 0.8)}), ("Mirror", {}), ("Glass", {"eta": 1.5}),
    ("Gold", {"roughness": 0.15}), ("ThinDielectric", {}), ("DiffuseTransmission", {}),
    ("CoatedDiffuse", {}), ("CoatedConductor", {}), ("CoatedDiffuseTransmission", {}),
    ("Glass", {"eta": 1.33}),
]


def make(cfg: dict) -> dict:
    """The scene as arrays and parameters: meshes (each with its material),
    lights, and no environment. cfg["sphere_res"]: (n_theta, n_phi)."""
    white = ("Matte", {"kd": (0.73, 0.73, 0.73)})
    meshes = [
        (make_quad((-3, 0, -1), (3, 0, -1), (3, 0, 5), (-3, 0, 5)), white),
        (make_quad((-3, 0, 5), (3, 0, 5), (3, 4, 5), (-3, 4, 5)), white),
        (make_quad((-3, 0, -1), (-3, 0, 5), (-3, 4, 5), (-3, 4, -1)),
         ("Matte", {"kd": (0.65, 0.05, 0.05)})),
        (make_quad((3, 0, -1), (3, 4, -1), (3, 4, 5), (3, 0, 5)),
         ("Matte", {"kd": (0.12, 0.45, 0.15)})),
    ]
    k = 0
    for ix in range(4):
        for iz in range(4):
            c = (-1.8 + 1.2 * ix, 0.45, 0.2 + 1.2 * iz)
            meshes.append((make_sphere(c, 0.42, *cfg["sphere_res"]),
                           MATERIALS[k % len(MATERIALS)]))
            k += 1
    meshes.append((make_quad((-1.0, 3.99, 1.0), (1.0, 3.99, 1.0), (1.0, 3.99, 3.0),
                             (-1.0, 3.99, 3.0)),
                   ("Emissive", {"le": (1.0, 0.95, 0.85), "scale": 25.0})))
    return {"meshes": [dict(mesh=m, material=mat) for m, mat in meshes],
            "lights": [("PointLight", {"position": (0.0, 3.0, -0.5),
                                       "intensity": (8.0, 8.0, 8.0)})],
            "sunsky": None}
