"""On the card only: one short run of every cell from a fresh process,
correct and on the GPU. Run there with
``python3 -m pytest portbench/tests -m cuda``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.tests.tiny import CELLS

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sweep kernels build with nvcc and run on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                          "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res
