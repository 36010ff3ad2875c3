"""The port stands alone: it imports nothing of JAX or of the JAX package,
reads no file of it, and its copies of the JAX package's data tables, BVH
builder source, noise module and NanoVDB reader / writer have not drifted
from the originals.

Runs on the CPU without JAX.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "hikari_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "hikari_tpu"}

# the port's copy -> the JAX package's original. A Python module is held
# to its original past the module docstring: the original's names a path
# outside the repository, which the copy's replaces.
COPIES = {
    "data/cie_xyz.npz": "data/cie_xyz.npz",
    "data/hosek_wilkie.npz": "data/hosek_wilkie.npz",
    "data/illuminant_d65.npz": "data/illuminant_d65.npz",
    "data/metal_spectra.npz": "data/metal_spectra.npz",
    "data/sobol_matrices_32.npy": "data/sobol_matrices_32.npy",
    "data/srgb_spectrum_table.npz": "data/srgb_spectrum_table.npz",
    "csrc/bvh_builder.cpp": "native/bvh_builder.cpp",
    "media/noise.py": "media/noise.py",
    "media/nanovdb.py": "media/nanovdb.py",
}

SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "examples" / "torch_quickstart.py"]


def _imported_roots(tree: ast.AST):
    """Top-level names of every absolute import in a module, wherever the
    import statement stands (functions included)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, (ast.Name, ast.Attribute))
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted(set(_imported_roots(tree)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    # a path built from the JAX package's directory name ("hikari_tpu" / ...)
    names = [n.value for n in ast.walk(tree)
             if isinstance(n, ast.Constant) and n.value == "hikari_tpu"]
    assert not names, f"{path.relative_to(ROOT)} names the hikari_tpu directory"


def test_importing_every_port_module_loads_no_jax():
    """The import table after importing every module of the port, in a
    fresh interpreter."""
    code = (
        "import pkgutil, sys\n"
        "import hikari_tpu_torch\n"
        "for m in pkgutil.walk_packages(hikari_tpu_torch.__path__, 'hikari_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(len([k for k in sys.modules if k.startswith('hikari_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules > 30, out.stdout


def test_data_and_builder_resolve_inside_the_port():
    from hikari_tpu_torch import _data
    from hikari_tpu_torch.geometry import bvh

    port = PORT.resolve()
    assert _data.DATA_DIR.resolve().is_relative_to(port)
    assert bvh._NATIVE_SOURCE.resolve().is_relative_to(port)
    assert bvh._NATIVE_SOURCE.is_file()
    for name in COPIES:
        if name.startswith("data/"):
            assert _data.data_path(Path(name).name).resolve().is_relative_to(port)


def _held_bytes(path: Path) -> bytes:
    """The bytes of a copy that must equal the original's (see COPIES)."""
    if path.suffix != ".py":
        return path.read_bytes()
    text = path.read_text()
    assert ast.get_docstring(ast.parse(text)) is not None, path
    return text.split('"""', 2)[2].encode()


@pytest.mark.parametrize("copy", sorted(COPIES))
def test_copy_is_byte_identical_to_the_original(copy):
    ours = PORT / copy
    original = ROOT / "hikari_tpu" / COPIES[copy]
    assert _held_bytes(ours) == _held_bytes(original), (
        f"{ours.relative_to(ROOT)} has drifted from {original.relative_to(ROOT)}")
