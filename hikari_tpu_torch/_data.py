"""Locate the data tables shipped with the JAX reference package.

The port reads the same published tables (CIE 1931, D65, measured metal
spectra, Joe-Kuo Sobol matrices, the sRGB sigmoid-coefficient table) by
path from ``hikari_tpu/data/`` instead of copying them, so both packages
evaluate identical constants. Reading a file does not import ``hikari_tpu``
(whose ``__init__`` imports JAX).
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

DATA_DIR = Path(__file__).resolve().parent.parent / "hikari_tpu" / "data"


def data_path(name: str) -> Path:
    path = DATA_DIR / name
    if not path.exists():
        raise FileNotFoundError(
            f"{path} is missing: hikari_tpu_torch reads its tables from the "
            "hikari_tpu package directory next to it")
    return path


@functools.cache
def load_npz(name: str) -> dict:
    with np.load(data_path(name)) as z:
        return {k: z[k] for k in z.files}


@functools.cache
def load_npy(name: str) -> np.ndarray:
    return np.load(data_path(name))
