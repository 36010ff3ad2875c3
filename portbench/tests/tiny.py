"""Cell sizes a CPU test run can hold: 16x16 images, an icosphere of 320
triangles, and a few sampled pixels."""

import copy


def overrides(cell: str) -> dict:
    ov = {"cfg": {"resolution": [16, 16], "icosphere_subdiv": 2},
          "cell": {"check": {"pixels": 24, "bounce_waves": 1, "bounce_wave_range": 1,
                             "ref_frames": 2},
                   "trace": {"stage_units": 2, "profile_units": 1}}}
    if "final" in cell:
        ov["traffic"] = {"volpath": {"samples_per_pixel": 8, "sample_batch": 2}}
    return copy.deepcopy(ov)


CELLS = ("mesh_scene.final", "mesh_scene.preview")
