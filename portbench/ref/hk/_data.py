"""Locate the data tables shipped with this package.

``hikari_tpu_torch/data/`` holds byte-for-byte copies of the published
tables the JAX package ships in ``hikari_tpu/data/`` (CIE 1931, D65,
measured metal spectra, Joe-Kuo Sobol matrices, the sRGB
sigmoid-coefficient table), so both packages evaluate identical constants
while the port reads nothing of the JAX package
(``tests/test_torch_independence.py`` checks that the copies do not drift).
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

# portbench: the raw tables are read where the program keeps them
DATA_DIR = Path(__file__).resolve().parents[3] / "hikari_tpu_torch" / "data"


def data_path(name: str) -> Path:
    path = DATA_DIR / name
    if not path.exists():
        raise FileNotFoundError(
            f"{path} is missing: hikari_tpu_torch reads its tables from its own "
            "data/ directory")
    return path


@functools.cache
def load_npz(name: str) -> dict:
    with np.load(data_path(name)) as z:
        return {k: z[k] for k in z.files}


@functools.cache
def load_npy(name: str) -> np.ndarray:
    return np.load(data_path(name))
