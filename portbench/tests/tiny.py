"""Cell sizes a CPU test run can hold: 16x16 images, small meshes and a few
sampled pixels. The cells are BENCHMARK.json's, and each is cut by what
its files say (its traffic's kind, its configuration's size keys), never
by its name, so a cell added as files is tested as it stands."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# a configuration's size keys, each cut where the configuration has it
SMALL_CFG = {"resolution": [16, 16], "icosphere_subdiv": 2, "sphere_res": [8, 16]}


def overrides(cell: str, root: Path = ROOT) -> dict:
    """The harness's overrides of the cell at test size: a `wavefronts` cell
    keeps its own VolPath fields (its material_coherence among them) and
    takes 8 samples a pixel in wavefronts of 2."""
    from portbench.harness import load_cell

    info = load_cell(cell, root)
    plain = min(info["cell"].get("trace", {}).get("plain_units", 0), 1)
    ov = {"cfg": {k: v for k, v in SMALL_CFG.items() if k in info["cfg"]},
          "cell": {"check": {"pixels": 24, "bounce_waves": 1, "bounce_wave_range": 1,
                             "ref_frames": 2},
                   "trace": {"stage_units": 2, "plain_units": plain, "profile_units": 1}}}
    if info["traffic"]["kind"] == "wavefronts":
        ov["traffic"] = {"volpath": dict(info["traffic"]["volpath"], samples_per_pixel=8,
                                         sample_batch=2)}
    return ov


def traffic(cell: str, root: Path = ROOT) -> dict:
    """The cell's traffic mix with its own parameters merged in."""
    from portbench.harness import load_cell

    return load_cell(cell, root)["traffic"]


CELLS = tuple(w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"])
