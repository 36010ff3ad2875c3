"""The ZSobol entry points' dispatch (``hikari_tpu_torch.sampling.sobol``):
CPU tensors take the plain version and launch nothing (the package's
launch record stays empty); the kernel's constant tables are the plain version's, and
Sobol dimension 0's matrix is the bit reversal that the kernel computes
instead of reading its rows; the stage timers still find the entry
points.
The kernel itself runs only on the card (``test_torch_zsobol_cuda.py``).

Runs on the CPU without JAX.
"""

import importlib
import inspect
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hikari_tpu_torch import _build
from hikari_tpu_torch.sampling import hashes, sobol

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "hikari_tpu_torch" / "csrc"
# entry point -> its arguments after the lanes
ENTRIES = {"compute_pixel_sample": (), "path_sample_1d": (3, 5), "path_sample_2d": (31, 7)}


def _lanes(w, h, spp, n=300, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randint(0, m, n).astype(np.int64)) for m in (w, h, spp))


def _call(name, cfg, lanes):
    return getattr(sobol, name)(cfg, *lanes, *ENTRIES[name])


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_cpu_tensors_take_the_plain_path_and_count_it(name, monkeypatch):
    def no_kernel(*args):
        raise AssertionError("the kernel was called on CPU tensors")

    monkeypatch.setattr(sobol, "draw_kernel", no_kernel)
    cfg = sobol.make_zsobol(800, 800, 4, seed=11)
    lanes = _lanes(800, 800, 4)
    _build.reset_counts()
    got = _call(name, cfg, lanes)
    assert not _build.launches and not _build.plain_cuda_runs
    # the plain version unchanged, field by field
    if name == "compute_pixel_sample":
        want = [sobol.sample_1d(cfg, *lanes, 1), torch.stack(sobol.sample_2d(cfg, *lanes, 3), -1),
                torch.stack(sobol.sample_2d(cfg, *lanes, 6), -1), sobol.sample_1d(cfg, *lanes, 4)]
        got = [got.wavelength_u, got.jitter, got.lens, got.time]
    else:
        plain = sobol.sample_1d if name == "path_sample_1d" else sobol.sample_2d
        want = plain(cfg, *lanes, 6 + 11 * ENTRIES[name][0] + ENTRIES[name][1])
        want, got = ([want], [got]) if name == "path_sample_1d" else (list(want), list(got))
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


def test_host_hash_equals_the_tensor_hash():
    rng = np.random.RandomState(5)
    a, b = (rng.randint(0, 2**32, 256, dtype=np.uint64).astype(np.int64) for _ in range(2))
    a[:3], b[:3] = [0, 2**32 - 1, 7], [0, 2**32 - 1, 2**32 - 1]
    for seed in (0, 1234567, 2**64 - 1):
        want = hashes.hash_u32x2(torch.from_numpy(a), torch.from_numpy(b), seed).tolist()
        assert [hashes.hash_u32x2_int(int(x), int(y), seed) for x, y in zip(a, b)] == want


def _cu_source() -> str:
    return (CSRC / "zsobol.cu").read_text()


def test_kernel_tables_are_the_plain_versions():
    src = _cu_source()
    body = re.search(r"kRows1\[kMatrixSize\] = \{(.*?)\};", src, re.S).group(1)
    rows = [int(x, 16) for x in re.findall(r"0x([0-9a-fA-F]{8})u", body)]
    np.testing.assert_array_equal(np.asarray(rows, np.uint32),
                                  sobol.sobol_matrices()[1, :sobol.SOBOL_MATRIX_SIZE])
    body = re.search(r"kPermutations\[24\]\[4\] = \{(.*?)\};", src, re.S).group(1)
    perms = [[int(d) for d in p.split(",")] for p in re.findall(r"\{([0-9, ]+)\}", body)]
    assert perms == sobol._PERMUTATIONS
    words = [0, 0, 0]
    for e in range(96):
        words[e // 32] |= sobol._PERMUTATIONS[e // 4][e % 4] << (2 * (e % 32))
    assert [int(x, 16) for x in re.findall(r"kPerm\d = 0x([0-9a-f]{16})ull", src)] == words
    assert int(re.search(r"kMaxDraws = (\d+);", src).group(1)) == sobol.MAX_DRAWS
    assert int(re.search(r"kMatrixSize = (\d+);", src).group(1)) == sobol.SOBOL_MATRIX_SIZE
    # the camera stage is one launch
    assert len(sobol.camera_draws(sobol.make_zsobol(8, 8, 1))) <= sobol.MAX_DRAWS


@pytest.mark.parametrize("max_bits", [1, 2, 22, 30, 31, 32, 33, 38, 52])
def test_sobol_dim_0_is_the_bit_reversal(max_bits):
    """The kernel reads no row of Sobol dimension 0: its rows are
    1 << (31 - b), then 0, so its product is the low min(max_bits, 32) bits
    of the index reversed, which FastOwen's first reversal undoes."""
    rows = sobol.sobol_matrices()[0, :sobol.SOBOL_MATRIX_SIZE].tolist()
    assert rows == [1 << (31 - b) if b < 32 else 0 for b in range(sobol.SOBOL_MATRIX_SIZE)]
    rng = np.random.RandomState(max_bits)
    index = rng.randint(0, 2**62, 512, dtype=np.int64)
    index[:3] = [0, 2**max_bits - 1, 2**62 - 1]
    got = hashes.reverse_bits32(sobol.sobol_sample_u32(torch.from_numpy(index), 0, max_bits))
    mask = (1 << min(max_bits, 32)) - 1
    assert got.tolist() == [int(i) & mask for i in index]


def test_no_header_beside_the_sweeps_one():
    """source_digest hashes every header in csrc/ into every library's name:
    a new one would rebuild the sweeps. zsobol.cu ships with the package."""
    assert sorted(p.name for p in CSRC.glob("*.cuh")) == ["sweep_grid.cuh"]
    assert '"csrc/*.cu"' in (ROOT / "pyproject.toml").read_text()


SAMPLER_TARGETS = json.loads((ROOT / "portbench" / "stages.json").read_text())["sampler"]


@pytest.mark.parametrize("target", SAMPLER_TARGETS)
def test_stage_timer_targets_resolve(target):
    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    assert fn.__name__ == name
    assert inspect.signature(fn) == inspect.signature(fn.__wrapped__)


def test_flat_lanes_keep_one_index_at_stride_zero():
    px, py = torch.arange(6), torch.arange(6) * 3
    for si in (torch.tensor(4).expand(6), torch.tensor(4), 4):
        shape, (fx, fy, fs) = sobol.flat_lanes(px, py, si)
        assert shape == (6,) and fs.stride(0) == 0 and fs.tolist() == [4] * 6
        assert fx.data_ptr() == px.data_ptr() and fy.data_ptr() == py.data_ptr()
    shape, lanes = sobol.flat_lanes(px.view(2, 3), py.view(2, 3), torch.arange(3))
    assert shape == (2, 3) and [t.tolist() for t in lanes] == [
        px.tolist(), py.tolist(), [0, 1, 2, 0, 1, 2]]


def test_draw_kernel_takes_only_card_tensors():
    cfg = sobol.make_zsobol(8, 8, 1)
    _, lanes = sobol.flat_lanes(torch.arange(4), torch.arange(4), 0)
    with pytest.raises(ValueError, match="on the card"):
        sobol.draw_kernel(cfg, lanes, sobol.draws_1d(cfg, 6), [torch.empty(4)])
