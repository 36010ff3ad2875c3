"""The port's public API against the JAX package's, name by name.

Every public name of ``hikari_tpu`` that is not a subpackage must be in
``hikari_tpu_torch.__all__``, but for the names still to port, listed
here by name (none since the preview integrators, SPPM and the sharded
render were ported); the port may add ``render_lanes``. The test fails
when a name goes missing, when a name is exported beyond the JAX
package's and the allowed extra, and when a name still listed as missing
has been ported.
"""

import types

import hikari_tpu
import hikari_tpu_torch

STILL_TO_PORT = set()
PORT_ONLY = {"render_lanes"}


def _jax_public() -> set:
    return {n for n in hikari_tpu.__all__
            if not n.startswith("_") and not isinstance(getattr(hikari_tpu, n), types.ModuleType)}


def test_every_jax_name_is_exported_or_listed():
    port = set(hikari_tpu_torch.__all__)
    missing = _jax_public() - port
    assert missing == STILL_TO_PORT, (f"missing and not listed: {sorted(missing - STILL_TO_PORT)}"
                                      f"; listed but ported: {sorted(STILL_TO_PORT - missing)}")


def test_no_unexpected_export():
    port = set(hikari_tpu_torch.__all__)
    assert port - _jax_public() == PORT_ONLY
    assert len(port) == len(hikari_tpu_torch.__all__)  # no name twice
    for name in port:
        assert hasattr(hikari_tpu_torch, name), name


# the JAX package's modules with no counterpart in the port, each JAX or host
# plumbing with no function left to port (README.md names the same three)
NOT_PORTED = {"sampling/u64.py": "uint32-pair words; torch has int64",
              "core/pytree.py": "JAX pytree registration",
              "native/__init__.py": "a ctypes loader; the port builds csrc/bvh_builder.cpp itself"}


def _tree(package) -> set:
    from pathlib import Path

    root = Path(package.__file__).resolve().parent
    return {p.relative_to(root).as_posix() for p in root.rglob("*.py")}


def test_every_jax_module_has_a_port_or_is_listed():
    missing = _tree(hikari_tpu) - _tree(hikari_tpu_torch)
    assert missing == set(NOT_PORTED), (f"missing and not listed: {sorted(missing - set(NOT_PORTED))}"
                                        f"; listed but ported: {sorted(set(NOT_PORTED) - missing)}")


def test_readme_names_the_modules_not_ported():
    from pathlib import Path

    readme = (Path(hikari_tpu_torch.__file__).resolve().parent.parent / "README.md").read_text()
    section = readme.split("Deliberately not ported", 1)[1].split("\n#", 1)[0]
    for module in NOT_PORTED:
        assert f"hikari_tpu/{module}" in section, module
    assert "rgb2spec_gen" not in section
