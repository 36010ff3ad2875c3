"""The binding of the port's native code (``hikari_tpu_torch._build``): the
launch helper, the launch record, the attributes reader, the tensor check
and the loader's build failure, with fake C symbols and no card; and that
the package binds native code only there.

Runs on the CPU without JAX.
"""

import ast
import ctypes
import re
from pathlib import Path

import pytest
import torch

from hikari_tpu_torch import _build

PORT = Path(_build.__file__).resolve().parent
# the modules that bind a hand-written kernel
KERNEL_MODULES = {"sweep", "sweep_pairs", "sweep_inst", "wavefront", "sobol"}
CASES = ["launch error", "launch", "wrong device", "wrong dtype", "wrong shape",
         "not contiguous", "attributes", "attributes error", "compiler error"]


def _symbol(name, ret, fill=()):
    """A stand-in for a ctypes C function: returns ret; where fill is given,
    writes it to the int array at its first argument."""
    calls = []

    def symbol(*args):
        calls.append(args)
        if fill:
            (ctypes.c_int * len(fill)).from_address(args[0])[:] = list(fill)
        return ret

    symbol.__name__ = name
    return symbol, calls


@pytest.mark.parametrize("case", CASES)
def test_binding_helpers(case, tmp_path):
    _build.reset_counts()
    x = torch.zeros((4, 3), dtype=torch.float32)
    _build.check("x", x, torch.float32, (4, 3), x.device)
    if case.startswith("launch"):
        err = 700 if case == "launch error" else 0
        fn, calls = _symbol("hikari_fake_sweep", err)
        if err:
            with pytest.raises(RuntimeError,
                               match="hikari_fake_sweep launch failed: cudaError 700"):
                _build.launch(fn, 1, 2)
            assert not _build.launches
        else:
            _build.launch(fn, 1, 2)
            assert _build.launches == {"fake_sweep": 1}
        assert calls == [(1, 2)] and not _build.plain_cuda_runs
    elif case.startswith("attributes"):
        err = 0 if case == "attributes" else 98
        fn, _ = _symbol("hikari_fake_attributes", err, fill=range(1, 7))
        if err:
            with pytest.raises(RuntimeError,
                               match="hikari_fake_attributes failed: cudaError 98"):
                _build.kernel_attributes(fn, ("a", "b"))
        else:
            assert _build.kernel_attributes(fn, ("a", "b")) == {"a": (1, 2, 3), "b": (4, 5, 6)}
        assert not _build.launches
    elif case == "compiler error":
        source = tmp_path / "broken.cu"
        source.write_text("this is not C\n")
        want = f"false failed to build {re.escape(str(source))}"
        with pytest.raises(RuntimeError, match=want):
            _build.library("test_broken", source, {}, command=["false"])
        assert "test_broken" not in _build._loaded
        assert not list(_build.BUILD_DIR.glob("libtest_broken_*"))
    else:
        bad = {"wrong device": (x, torch.float32, (4, 3), torch.device("cuda")),
               "wrong dtype": (x, torch.int32, (4, 3), x.device),
               "wrong shape": (x, torch.float32, (3, 4), x.device),
               "not contiguous": (x.t(), torch.float32, None, x.device)}[case]
        with pytest.raises(ValueError, match="^x: "):
            _build.check("x", *bad)


def test_only_the_build_module_binds_native_code():
    """A kernel binds through _build.py: no other module of the package
    loads a library or runs a compiler or imports chip_smoke; no kernel
    module imports a leading-underscore name from another; the sampler
    imports nothing of the geometry layer."""
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT)
        src = path.read_text()
        if path.name != "_build.py":
            assert "ctypes.CDLL" not in src and "build_shared_library(" not in src, rel
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                assert all(a.name != "chip_smoke" for a in node.names), rel
            elif isinstance(node, ast.ImportFrom):
                module = node.module or ""
                assert module != "chip_smoke", rel
                assert not (rel.stem == "sobol" and "geometry" in module), rel
                if rel.stem in KERNEL_MODULES and module.split(".")[-1] in KERNEL_MODULES:
                    private = [a.name for a in node.names if a.name.startswith("_")]
                    assert not private, (rel, private)
