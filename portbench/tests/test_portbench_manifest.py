"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by name."""

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_manifest_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert all(not w.startswith("/") and ".." not in w for w in MANIFEST["command"])
    assert all((ROOT / p).is_dir() for p in MANIFEST["paths"])
    assert len(json.dumps(MANIFEST)) < 64 * 1024
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_names_and_units():
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names = ([c["name"] for c in MANIFEST["configs"]] + CELLS + [m["name"] for m in metrics]
             + [w["traffic"] for w in MANIFEST["workloads"]]
             + [k for c in MANIFEST["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert {m["source"] for m in MANIFEST["end_to_end"]} <= {"host_clock", "device_trace"}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for text in ([c["why"] for c in MANIFEST["configs"] + MANIFEST["workloads"]]
                 + [m["layer"] for m in MANIFEST["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = {x["name"]: x for x in MANIFEST["workloads"]}[cell]
    bench = ROOT / "portbench"
    spec = json.loads((bench / "workloads" / f"{cell}.json").read_text())
    assert spec["config"] == w["config"] and spec["traffic"] == w["traffic"]
    cfg_entry = {c["name"]: c for c in MANIFEST["configs"]}[w["config"]]
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    assert (bench / "scenes" / f"{cfg['scene']}.py").exists()
    assert (bench / "traffic" / f"{w['traffic']}.json").exists()
    for m in MANIFEST["per_layer"]:
        if cell in m.get("workloads", [cell]):
            reader = importlib.import_module(f"portbench.metrics.{m['name'].split('.')[0]}")
            assert callable(reader.read)


@pytest.mark.parametrize("cell", CELLS)
def test_moves_reported_in_every_cell(cell):
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    reported = {n for n, m in e2e.items() if cell in m.get("workloads", [cell])}
    assert "setup_s" in reported and len(reported) >= 2
    layer = [m for m in MANIFEST["per_layer"] if cell in m.get("workloads", [cell])]
    assert layer
    for m in layer:
        assert m["moves"] in reported, (m["name"], cell)


def test_every_config_used_and_files_distinct():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    assert all(f.startswith("portbench/") for f in files)
