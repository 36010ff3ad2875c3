"""The port's public API against the JAX package's, name by name.

Every public name of ``hikari_tpu`` that is not a subpackage must be in
``hikari_tpu_torch.__all__``, but for the names still to port (ROADMAP
A16: the preview integrators and SPPM; A18: the sharded render), listed
here by name; the port may add ``render_lanes``. The test fails when a
name goes missing, when a name is exported beyond the JAX package's and
the allowed extra, and when a name still listed as missing has been
ported (so the list shrinks with every slice).
"""

import types

import hikari_tpu
import hikari_tpu_torch

STILL_TO_PORT = {"Whitted", "FastWavefront", "render_preview", "SPPM", "render_sppm",
                 "make_render_mesh", "render_sharded"}
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
