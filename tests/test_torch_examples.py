"""The port's example scripts (examples/torch_*.py), each run as a user runs
it, through main(argv), on the CPU at 16 x 16 and one sample into a
temporary directory: each must write a PNG that decodes (read_png) to a
finite, lit image of its size, beside its NanoVDB file where it writes one.
The sizes that a CPU run cannot afford are cut by the scripts' own flags:
the clouds' grids (--grid) and the forest's trees (--trees; the plain
instanced sweep walks 1,024-lane tiles against every world treelet, so
400 trees cost minutes however few the pixels). Each script defaults to
the card and raises without one when no --device is given.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import hikari_tpu_torch as hk
from test_torch_scene import F32_RTOL  # noqa: F401  (each worker's share of the cores)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
RES = 16

# script -> (argv besides --device / --res / --spp / the output, image (height, width),
# output flag: "--out" or positional, NanoVDB written beside the PNG)
CASES = {
    "cloud_example": (["--grid", "16"], (RES, RES), "--out", True),
    "cornell_scene": (["--denoise"], (RES, RES), "--out", False),
    "dispersion_example": ([], (RES, RES), "--out", False),
    "instancing_example": (["--trees", "4"], (RES * 2 // 3, RES), None, False),
    "lensing_example": ([], (RES, RES), "--out", False),
    "medium_example": ([], (RES, RES), "--out", False),
    "sparse_cloud_example": (["--grid", "32"], (RES * 2 // 3, RES), None, True),
}


def _script(name):
    spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                  EXAMPLES / f"torch_{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_every_example_has_a_port():
    originals = {p.stem for p in EXAMPLES.glob("*.py") if not p.stem.startswith("torch_")}
    ported = {p.stem[len("torch_"):] for p in EXAMPLES.glob("torch_*.py")}
    assert originals == ported == set(CASES) | {"quickstart"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_writes_a_lit_png(name, tmp_path):
    extra, shape, out_flag, nvdb = CASES[name]
    png = tmp_path / f"{name}.png"
    out = ["--out", str(png)] if out_flag else [str(png)]
    result = _script(name).main([*out, "--device", "cpu", "--res", str(RES), "--spp", "1",
                                 *extra])
    assert result["png"] == png and result["scene"].device.type == "cpu"
    img = hk.read_png(png)
    assert img.shape == (*shape, 3)
    assert np.isfinite(img).all() and img.mean() > 0.0
    assert bool(torch.isfinite(hk.framebuffer(result["film"])).all())
    if nvdb:
        assert result["nvdb"] == png.with_suffix(".nvdb") and result["nvdb"].stat().st_size > 0


def test_example_defaults_to_the_card(tmp_path):
    """Without --device an example builds on the card, and without one it
    raises rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is here: the example would render on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _script("dispersion_example").main(["--out", str(tmp_path / "d.png"), "--res", "4"])


def test_cloud_example_reads_a_nanovdb_file(tmp_path):
    """--nvdb renders the cloud of a NanoVDB file (here the one a first run
    wrote beside its PNG) in place of the procedural one."""
    ex = _script("cloud_example")
    first = ex.main(["--out", str(tmp_path / "a.png"), "--device", "cpu", "--res", "4",
                     "--spp", "1", "--grid", "16"])
    second = ex.main(["--out", str(tmp_path / "b.png"), "--device", "cpu", "--res", "8",
                      "--spp", "1", "--depth", "4", "--nvdb", str(first["nvdb"])])
    assert second["nvdb"] is None and not (tmp_path / "b.nvdb").exists()
    img = hk.read_png(second["png"])
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.mean() > 0.0
