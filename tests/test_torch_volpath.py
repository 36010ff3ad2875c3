"""Port parity for the slice as a whole: VolPath render_lanes.

The benchmark scene with coarse spheres (3082 triangles) is built by each
package through its own public API and rendered at 32x32, 1 spp: the JAX
reference with its skip-link BVH walk, the port with its packet engine
(plain sweeps on the CPU). At depth 5 the transport invariants of the
benchmark's probe must hold: rays traced within 0.5%, mean RGB within 2%.
At depth 1 (camera hit, emission, NEE, no continuation) >= 99% of pixels
must agree to 1e-3 relative (plus 1e-5 absolute for black pixels); the
rest are silhouette pixels where the two traversals flip an edge hit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.camera.camera import make_perspective_camera as j_camera
from hikari_tpu.film.filters import make_filter as j_filter
from hikari_tpu.integrators.volpath import VolPath as JVolPath
from hikari_tpu.integrators.volpath import render_lanes as j_render_lanes
from hikari_tpu_torch import VolPath, make_filter, render_lanes
from hikari_tpu_torch.scenes import default_scene, scene_camera
from test_torch_scene import SPHERE_RES, jax_default_scene

RES = 32
EYE, AT, FOV = (0.0, 1.6, -2.8), (0.0, 0.9, 2.0), 45.0


@pytest.fixture(scope="module")
def jax_render():
    """JAX renders by depth. One compiled program serves every depth: the
    bounce loop's upper bound is a traced argument (depth_hi), and nothing
    else in the bounce reads max_depth on surface-only scenes."""
    js = jax_default_scene()
    jcam = j_camera(EYE, AT, (RES, RES), fov_deg=FOV)
    jvp = JVolPath(max_depth=5, samples_per_pixel=1)
    jl = jnp.arange(RES * RES, dtype=jnp.uint32)
    fn = jax.jit(lambda depth: j_render_lanes(
        jvp, js, jcam, j_filter(), jnp.uint32(0), jl % RES, jl // RES,
        depth_lo=jnp.int32(0), depth_hi=depth))
    return lambda depth: fn(jnp.int32(depth))


@pytest.fixture(scope="module")
def port_scene():
    return default_scene(SPHERE_RES).build(device="cpu")


def _render_both(jax_render, ts, depth):
    jrgb, _, jstats = jax_render(depth)
    tl = torch.arange(RES * RES)
    trgb, _, tstats = render_lanes(VolPath(max_depth=depth, samples_per_pixel=1), ts,
                                   scene_camera("default", RES), make_filter(), 0,
                                   tl % RES, tl // RES)
    assert float(tstats["nonfinite_lanes"]) == 0.0
    return (np.asarray(jrgb), float(jstats["rays_traced"]), trgb.numpy(),
            float(tstats["rays_traced"]))


def test_transport_invariants_depth5(jax_render, port_scene):
    jrgb, jrays, trgb, trays = _render_both(jax_render, port_scene, 5)
    assert abs(trays - jrays) <= 0.005 * jrays
    assert abs(trgb.mean() - jrgb.mean()) <= 0.02 * abs(jrgb.mean())
    assert trgb.mean() > 0.1


def test_pixels_depth1(jax_render, port_scene):
    jrgb, jrays, trgb, trays = _render_both(jax_render, port_scene, 1)
    close = (np.abs(trgb - jrgb) <= 1e-3 * np.abs(jrgb) + 1e-5).all(-1)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} pixels differ"
    assert abs(trays - jrays) <= 0.005 * jrays


@pytest.mark.slow
def test_full_default_scene_transport_probe():
    """The benchmark's default scene (61,450 triangles) at the probe size
    against tools/transport_ref.json, on the CPU (~25 s)."""
    from hikari_tpu_torch.scenes import check_transport

    ok, msg = check_transport(default_scene().build(device="cpu"), "default")
    assert ok, msg


def test_triangle_probe_against_jax():
    """bench.py's triangle scene (scenes.triangle_scene): its 64x64 depth-5
    1-spp probe against the JAX package's in hikari_tpu_torch/data/
    probe_ref.json, rays within 0.5% and mean RGB within 2%."""
    from hikari_tpu_torch.scenes import check_transport, triangle_scene

    ok, msg = check_transport(triangle_scene().build(device="cpu"), "triangle")
    assert ok, msg
