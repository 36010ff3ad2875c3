"""Port parity: the bounce loop's modes and the slice as a whole.

On the port alone, with the benchmark scene at coarse spheres (3082
triangles, tests/test_torch_scene.py) at 32x32:

* material_coherence 'gated' and 'sorted' equal 'none' exactly: each lane
  is evaluated by the same elementwise code, on a subset of the lanes;
* render_lanes_segmented (2 and 3 segments) equals render_lanes bit for
  bit: the segments run the same bounces on the carried state;
* resident='on' equals 'off' to float32 tolerance (the reference's own
  tests/test_resident.py tolerance, 2e-3 absolute + 1e-3 relative): the
  lanes reach the sweeps in another order, so tiles differ, and a tie
  between two triangles at one quantized t may go the other way. Lane
  counts 1024 (one tile) and 900 (padded to a tile).

Against the JAX package: the same scene rendered by both at 24x24, depth
3, with every switch on (pair-grid sweep, banded closest hit at 0.15 of
the world diagonal, reversed shadows, sorted dispatch, resident loop),
rays within 0.5% and mean RGB within 2% (the transport probe's
tolerances; edge flips between the bf16x3 and float32 sweeps move single
pixels). The default scene's transport probe in pair-grid mode against
tools/transport_ref.json is in the slow tier (~10 s alone, ~55 s beside
five other pytest-xdist workers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.camera.camera import make_perspective_camera as j_camera
from hikari_tpu.film.filters import make_filter as j_filter
from hikari_tpu.geometry import wavefront as jwf
from hikari_tpu.integrators.volpath import VolPath as JVolPath
from hikari_tpu.integrators.volpath import render_lanes as j_render_lanes
from hikari_tpu_torch import VolPath, make_filter, render_lanes
from hikari_tpu_torch.geometry import wavefront as twf
from hikari_tpu_torch.integrators.volpath import render_lanes_segmented
from hikari_tpu_torch.scenes import default_scene, scene_camera
from test_torch_scene import SPHERE_RES, jax_default_scene

RES = 32
EYE, AT, FOV = (0.0, 1.6, -2.8), (0.0, 0.9, 2.0), 45.0


@pytest.fixture(scope="module")
def port_scene():
    return default_scene(SPHERE_RES).build(device="cpu")


def _render(scene, res=RES, n=None, **kw):
    lanes = torch.arange(res * res)[:n]
    vp = VolPath(max_depth=kw.pop("max_depth", 5), samples_per_pixel=1, **kw)
    rgb, w, st = render_lanes(vp, scene, scene_camera("default", res), make_filter(), 0,
                              lanes % res, lanes // res)
    return rgb, w, st


@pytest.mark.parametrize("coherence", ["gated", "sorted"])
def test_material_coherence_equals_none(port_scene, coherence):
    rgb0, w0, st0 = _render(port_scene)
    rgb1, w1, st1 = _render(port_scene, material_coherence=coherence)
    assert torch.equal(rgb0, rgb1) and torch.equal(w0, w1)
    assert float(st0["rays_traced"]) == float(st1["rays_traced"])
    assert float(rgb0.mean()) > 0.1


@pytest.mark.parametrize("n_segments", [2, 3])
def test_segmented_equals_render_lanes(port_scene, n_segments):
    lanes = torch.arange(RES * RES)
    args = (VolPath(max_depth=5, samples_per_pixel=1), port_scene,
            scene_camera("default", RES), make_filter(), 0, lanes % RES, lanes // RES)
    rgb0, w0, st0 = render_lanes(*args)
    rgb1, w1, st1 = render_lanes_segmented(*args, n_segments=n_segments)
    assert torch.equal(rgb0, rgb1) and torch.equal(w0, w1)
    assert torch.equal(st0["rays_traced"], st1["rays_traced"])


def test_segments_refuse_resident(port_scene):
    lanes = torch.arange(16)
    with pytest.raises(ValueError, match="resident"):
        render_lanes_segmented(VolPath(max_depth=2, resident="on"), port_scene,
                               scene_camera("default", 4), make_filter(), 0, lanes % 4,
                               lanes // 4, n_segments=2)


@pytest.mark.parametrize("n", [RES * RES, 900])
def test_resident_matches_off(port_scene, n):
    rgb0, _, st0 = _render(port_scene, n=n)
    rgb1, _, st1 = _render(port_scene, n=n, resident="on")
    assert rgb1.shape == (n, 3) and bool(torch.isfinite(rgb1).all())
    np.testing.assert_allclose(rgb1.numpy(), rgb0.numpy(), atol=2e-3, rtol=1e-3)
    assert abs(float(st1["rays_traced"]) - float(st0["rays_traced"])) <= 1e-3 * float(
        st0["rays_traced"])


def test_unknown_modes_are_refused(port_scene):
    for kw in (dict(material_coherence="queued"), dict(resident="maybe")):
        with pytest.raises(ValueError):
            _render(port_scene, res=4, **kw)


SLICE_RES = 24
SLICE_DEPTH = 3
BAND_FRAC = 0.15


def test_slice_all_modes_matches_jax(port_scene, monkeypatch):
    """Pair grid + band + reversed shadows + sorted + resident, both packages."""
    js = jax_default_scene(traversal="packets_interp")
    for mod in (jwf, twf):
        monkeypatch.setattr(mod, "SWEEP_MODE", "pairs")
        monkeypatch.setattr(mod, "BAND_FRAC", BAND_FRAC)
        monkeypatch.setattr(mod, "SHADOW_REV", True)
    # the JAX engines read the switches while tracing: clear the caches
    # before, and after, while the switches are still on
    jax.clear_caches()
    try:
        jvp = JVolPath(max_depth=SLICE_DEPTH, samples_per_pixel=1,
                       material_coherence="sorted", resident="on")
        jl = jnp.arange(SLICE_RES * SLICE_RES, dtype=jnp.uint32)
        jrgb, _, jst = jax.jit(lambda: j_render_lanes(
            jvp, js, j_camera(EYE, AT, (SLICE_RES, SLICE_RES), fov_deg=FOV), j_filter(),
            jnp.uint32(0), jl % SLICE_RES, jl // SLICE_RES))()
        jrgb, jrays = np.asarray(jrgb), float(jst["rays_traced"])
    finally:
        jax.clear_caches()
    trgb, _, tst = _render(port_scene, res=SLICE_RES, max_depth=SLICE_DEPTH,
                           material_coherence="sorted", resident="on")
    trays = float(tst["rays_traced"])
    assert abs(trays - jrays) <= 0.005 * jrays
    assert abs(float(trgb.mean()) - jrgb.mean()) <= 0.02 * abs(jrgb.mean())
    assert float(trgb.mean()) > 0.05


@pytest.mark.slow
def test_pairs_default_scene_transport_probe(monkeypatch):
    """The benchmark's default scene (61,450 triangles) at the probe size in
    pair-grid mode, against tools/transport_ref.json."""
    from hikari_tpu_torch.scenes import check_transport

    monkeypatch.setattr(twf, "SWEEP_MODE", "pairs")
    ok, msg = check_transport(default_scene().build(device="cpu"), "default")
    assert ok, msg


@pytest.mark.cuda
def test_cuda_modes_match_cpu(port_scene, monkeypatch):
    """On the card: the pair-grid kernels under every switch (band,
    reversed shadows, sorted dispatch, resident loop) against the CPU
    render, which runs their plain versions; the resident tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernels have no CPU mode")
    from hikari_tpu_torch.geometry import sweep

    for name, val in (("SWEEP_MODE", "pairs"), ("BAND_FRAC", BAND_FRAC),
                      ("SHADOW_REV", True)):
        monkeypatch.setattr(twf, name, val)
    kw = dict(material_coherence="sorted", resident="on")
    rgb_cpu, _, st_cpu = _render(port_scene, **kw)
    sweep.reset_counts()
    rgb_gpu, _, st_gpu = _render(port_scene.to("cuda"), **kw)
    assert sweep.launches["closest_pairs"] > 0 and sweep.launches["occlusion_pairs"] > 0
    assert not any(sweep.plain_cuda_runs.values())
    np.testing.assert_allclose(rgb_gpu.cpu().numpy(), rgb_cpu.numpy(), atol=2e-3, rtol=1e-3)
    assert abs(float(st_gpu["rays_traced"]) - float(st_cpu["rays_traced"])) <= 1e-3 * float(
        st_cpu["rays_traced"])
