"""Nothing the benchmark runs loads JAX or the JAX package: a fresh
interpreter imports the harness, the scenes, the reference and the
program, and no loaded module's top-level name (compared whole: the
port's name begins with the JAX package's) is jax, jaxlib, flax or
hikari_tpu."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROBE = """
import importlib, json, pkgutil, sys
import portbench, portbench.harness, portbench.control, portbench.check
import portbench.scenes.build, portbench.ref.api, portbench.ref.stages
for pkg in ("portbench.scenes", "portbench.metrics", "portbench.ref.hk"):
    for m in pkgutil.walk_packages(importlib.import_module(pkg).__path__, pkg + "."):
        importlib.import_module(m.name)
import hikari_tpu_torch
from hikari_tpu_torch.integrators import preview, volpath
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_loaded():
    env = dict(os.environ, USE_FLAX="0")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "hikari_tpu_torch" in top and "portbench" in top
    assert not top & {"jax", "jaxlib", "flax", "hikari_tpu"}


def test_harness_refuses_a_checkout_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ gives no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "mesh_scene.preview", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
