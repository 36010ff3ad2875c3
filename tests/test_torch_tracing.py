"""The port's own spans and counters (``hikari_tpu_torch.utils.profiling``):
they record only while a torch profiler does, change no result, nest with
the right parents, add up to their roots, and count rays, pairs and host
syncs where the work happens; ``portbench``'s readers of them. On the card
(``-m cuda``): the host-sync counter equals torch's own count of
synchronising operations on the mesh scene's two paths.

Runs on the CPU without JAX.
"""

import contextlib
import importlib
import inspect
import os
import traceback
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

import hikari_tpu_torch as hk
from hikari_tpu_torch import scenes
from hikari_tpu_torch.geometry import wavefront
from hikari_tpu_torch.integrators import preview, volpath
from hikari_tpu_torch.utils import profiling

W, H = 16, 12
VP = hk.VolPath(samples_per_pixel=8, sample_batch=2, max_depth=5, seed=3)
FW = hk.FastWavefront(samples_per_pixel=1, seed=5)
PATHS = ("final", "preview")
# pair lists a unit, a closest and a shadow ray's a bounce (a sweep with no
# live lane lists its pairs and launches nothing)
LISTS = {"final": 2 * VP.max_depth, "preview": 2 * 2}
READERS = {"sampler_self_ms": 15.0, "traversal_self_ms": 10.0, "shading_self_ms": 5.0,
           "lights_self_ms": 4.0, "integrator_self_ms": 5.0, "host_syncs_per_sample": 81.0,
           "pairs_per_sample": 500.0, "rays_per_sample": 40.0}


def _mesh_room(subdiv: int) -> hk.Scene:
    """The mesh scene's room, lights and Gold icosphere, at a subdivision."""
    s = hk.Scene()
    scenes._room(s)
    v, f = scenes._displaced_icosphere(subdiv)
    s.add(hk.TriangleMesh(vertices=v * 0.9 + np.asarray([[0.0, 1.1, 2.0]], np.float32),
                          faces=f), hk.Gold(roughness=0.2))
    scenes._lights(s)
    return s


def _camera(w, h):
    return hk.make_perspective_camera((0.0, 1.6, -2.8), (0.0, 0.9, 2.0), (w, h), fov_deg=45.0)


def _run(path, scene, cam):
    """One unit of a portbench cell's path: a render_sample wavefront into a
    new film, or a preview frame read as a framebuffer."""
    if path == "final":
        film = hk.make_film(*cam.resolution, device=scene.device)
        return volpath.render_sample(VP, scene, cam, film, hk.make_filter(), 0).rgb_sum
    return hk.framebuffer(preview.render_preview(FW, scene, cam))


@contextlib.contextmanager
def _recording():
    profiling.reset()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        yield


@pytest.fixture(scope="module")
def cpu_scene():
    return _mesh_room(2).build(device="cpu"), _camera(W, H)


@pytest.fixture(scope="module")
def traced(cpu_scene):
    """Each path once as is and once recorded, with the pair lists it built."""
    scene, cam = cpu_scene
    out = {}
    for path in PATHS:
        plain = _run(path, scene, cam)
        lists = []
        orig = wavefront.pair_list

        def listed(*args):
            res = orig(*args)
            lists.append(int(res[0].shape[0]))
            return res

        wavefront.pair_list = listed
        try:
            with _recording():
                image = _run(path, scene, cam)
        finally:
            wavefront.pair_list = orig
        out[path] = dict(plain=plain, image=image, lists=lists, rec=profiling.recorded())
    profiling.reset()
    return out


def test_nothing_is_recorded_with_the_profiler_off(cpu_scene):
    profiling.reset()
    assert not profiling.recording()
    for path in PATHS:
        _run(path, *cpu_scene)
    rec = profiling.recorded()
    assert rec["spans"] == {} and rec["counters"] == {} and rec["roots"]["calls"] == 0


@pytest.mark.parametrize("path", PATHS)
def test_recording_leaves_the_image_bit_identical(traced, path):
    assert torch.equal(traced[path]["plain"], traced[path]["image"])


@pytest.mark.parametrize("path", PATHS)
def test_spans_nest_with_their_parents(traced, path):
    spans = traced[path]["rec"]["spans"]
    parents = {name: set(a["parents"]) for name, a in spans.items()}
    if path == "final":
        assert parents["hikari.render"] == {None}
        assert parents["hikari.lanes"] == {"hikari.render"}
        assert parents["hikari.bounce"] == {"hikari.lanes"}
        assert spans["hikari.bounce"]["calls"] == VP.max_depth
        assert parents["hikari.sampler"] == {"hikari.lanes", "hikari.bounce"}
        assert parents["hikari.traversal"] == {"hikari.bounce"}
        assert parents["hikari.film"] == {"hikari.render"}
    else:
        # the framebuffer is read after the frame, a root of its own
        assert parents["hikari.render"] == {None}
        assert parents["hikari.film"] == {"hikari.render", "hikari.film", None}
        assert parents["hikari.lanes"] == {"hikari.render"}
        assert parents["hikari.sampler"] == {"hikari.lanes"}
        assert parents["hikari.traversal"] == {"hikari.lanes"}
    assert parents["hikari.sweep"] == {"hikari.traversal"}
    assert parents["hikari.shading"] <= {"hikari.bounce", "hikari.lanes"}
    assert parents["hikari.lights"] <= {"hikari.bounce", "hikari.lanes"}
    assert 2 <= spans["hikari.sweep"]["calls"] <= LISTS[path]


def test_bounce_spans_carry_their_depth(traced):
    by = traced["final"]["rec"]["spans"]["hikari.bounce"]["by"]
    assert sorted(by) == [f"depth={d}" for d in range(VP.max_depth)]
    assert all(a["calls"] == 1 for a in by.values())


@pytest.mark.parametrize("path", PATHS)
def test_self_times_add_up_to_the_roots(traced, path):
    """On the host's clock here (the card's timeline has no events on the
    CPU, so its numbers are None)."""
    rec = traced[path]["rec"]
    total = sum(a["host_self_ms"] for a in rec["spans"].values())
    assert rec["roots"]["host_ms"] > 0.0
    assert total == pytest.approx(rec["roots"]["host_ms"], rel=1e-9)
    assert all(a["self_ms"] is None for a in rec["spans"].values())
    assert all(a["host_self_ms"] >= 0.0 for a in rec["spans"].values())


def test_rays_traced_is_render_lanes_stats(traced, cpu_scene):
    scene, cam = cpu_scene
    n = W * H
    k = VP.sample_batch
    lanes = torch.arange(n)
    si = torch.arange(k).repeat_interleave(n)
    _, _, stats = volpath.render_lanes(VP, scene, cam, hk.make_filter(), si,
                                       (lanes % W).repeat(k), (lanes // W).repeat(k))
    c = traced["final"]["rec"]["counters"]["rays_traced"]
    assert c["sites"] == {"render_lanes": float(stats["rays_traced"])}
    assert c["spans"] == {"hikari.lanes": float(stats["rays_traced"])}


def test_preview_rays_are_the_stats_rays(traced, cpu_scene):
    scene, cam = cpu_scene
    stats = {"rays": torch.zeros(()), "alive": []}
    preview.preview_lanes(FW, scene, cam, 0, stats)
    c = traced["preview"]["rec"]["counters"]["rays_traced"]
    assert c["total"] == float(stats["rays"]) > 0


@pytest.mark.parametrize("path", PATHS)
def test_pairs_listed_are_the_pair_lists(traced, path):
    t = traced[path]
    pairs = t["rec"]["counters"]["pairs_listed"]
    assert len(t["lists"]) == LISTS[path]
    assert pairs["total"] == sum(t["lists"])
    assert set(pairs["sites"]) == {"closest", "occlusion"}
    lanes = t["rec"]["counters"]["lanes_swept"]["sites"]
    # the live prefix is rounded up to whole ray tiles
    assert lanes["closest.live"] % 1024 == 0 and lanes["closest.live"] >= 1024
    n = W * H * (VP.sample_batch if path == "final" else 1)
    assert lanes["closest.input"] == n * LISTS[path] // 2


@pytest.mark.parametrize("path", PATHS)
def test_host_syncs_per_pair_list(traced, path):
    """Three syncs a pair list, all in the traversal driver: the live count and
    the pair list's two compactions. On the CPU the copies of host
    constants to the card are not counted (there is no card)."""
    syncs = traced[path]["rec"]["counters"]["host_syncs"]
    n = LISTS[path]
    assert syncs["sites"] == {"pair_list.live": n, "pair_list.tre": n, "pair_list.tn_bits": n}
    assert syncs["spans"] == {"hikari.traversal": 3 * n}


@profiling.spanned("inner")
def _inner():
    profiling.count("things", torch.tensor(3.0), "b")
    profiling.host_sync("copy", "cpu")  # a copy on the CPU waits for nothing
    profiling.host_sync("read")


@profiling.spanned("outer", attrs=("tag",))
def _outer(tag):
    profiling.count("things", 2, "a")
    _inner()


def test_counters_under_spans_and_reset():
    with _recording():
        _outer(1)
    rec = profiling.recorded()
    assert rec["spans"]["inner"]["parents"] == {"outer": 1}
    assert rec["spans"]["outer"]["by"]["tag=1"]["calls"] == 1
    assert rec["counters"]["things"] == {"total": 5.0, "sites": {"a": 2.0, "b": 3.0},
                                         "spans": {"outer": 2.0, "inner": 3.0}}
    assert rec["counters"]["host_syncs"]["sites"] == {"read": 1.0}
    assert rec["roots"]["calls"] == 1
    profiling.reset()
    assert profiling.recorded()["spans"] == {}


@pytest.mark.parametrize("fn", [volpath.render_sample, volpath._bounce_core,
                                volpath.scene_closest_hit, preview.render_preview,
                                wavefront.closest_tiles])
def test_spanned_functions_keep_name_and_signature(fn):
    """Stage timers and tests reach these functions by name and call them
    with their own arguments."""
    assert fn.__name__ == fn.__wrapped__.__name__
    assert inspect.signature(fn) == inspect.signature(fn.__wrapped__)


def test_idle_by_span_without_a_card():
    profiling.reset()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        _outer(2)
    assert profiling.idle_by_span(prof) == {"busy_s": 0.0, "window_s": 0.0, "idle_s": {}}
    profiling.reset()


def _reader(name):
    return importlib.import_module(f"portbench.metrics.{name}")


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_without_a_record_is_none(name, monkeypatch):
    profiling.reset()
    assert _reader(name).read({}) is None  # no profiled units (a CPU run)
    assert _reader(name).read({"prof_samples": 2}) is None  # nothing recorded
    monkeypatch.delattr(profiling, "recorded")  # a program without a record
    assert _reader(name).read({"prof_samples": 2}) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_per_sample_on_a_synthetic_record(name, monkeypatch):
    self_ms = {"hikari.sampler": 30.0, "hikari.traversal": 20.0, "hikari.shading": 10.0,
               "hikari.lights": 8.0, "hikari.render": 1.0, "hikari.lanes": 2.0,
               "hikari.bounce": 3.0, "hikari.film": 4.0, "hikari.sweep": 50.0}
    rec = {"spans": {k: {"self_ms": v} for k, v in self_ms.items()},
           "counters": {"host_syncs": {"total": 162.0}, "pairs_listed": {"total": 1000.0},
                        "rays_traced": {"total": 80.0}}}
    monkeypatch.setattr(profiling, "recorded", lambda: rec)
    assert _reader(name).read({"prof_samples": 2}) == pytest.approx(READERS[name])


# --- on the card --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the host syncs counted are the card's")
    return scenes.mesh_scene().build(device="cuda"), _camera(320, 180)


@pytest.mark.cuda
@pytest.mark.parametrize("path", PATHS)
def test_cuda_host_syncs_equal_torch_sync_count(card_scene, path):
    """torch.cuda.set_sync_debug_mode("warn") warns at every synchronising
    operation; the counter must have counted each of them."""
    scene, cam = card_scene
    _run(path, scene, cam)  # builds the kernels
    torch.cuda.synchronize()
    port = os.path.dirname(hk.__file__)
    stacks = []

    def hook(message, *args, **kw):
        # the first switch of the mode also warns once that it is a prototype
        if "synchroniz" in str(message) and "prototype" not in str(message):
            stacks.append([f"{f.filename}:{f.lineno}" for f in traceback.extract_stack()[:-1]
                           if f.filename.startswith(port)][-3:])

    old = warnings.showwarning
    with _recording(), warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _run(path, scene, cam)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = old
    syncs = profiling.recorded()["counters"]["host_syncs"]
    profiling.reset()
    assert syncs["total"] == len(stacks), (syncs["sites"], stacks)


@pytest.mark.cuda
def test_cuda_card_timeline_and_idle_by_span(card_scene):
    """On the card the self times of a frame's spans add up to its roots'
    interval on the card's timeline, and the card's idle gaps fall in
    named spans."""
    scene, cam = card_scene
    _run("preview", scene, cam)
    torch.cuda.synchronize()
    profiling.reset()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _run("preview", scene, cam)
        torch.cuda.synchronize()
    rec = profiling.recorded()
    idle = profiling.idle_by_span(prof)
    profiling.reset()
    assert rec["roots"]["ms"] > 0.0
    total = sum(a["self_ms"] for a in rec["spans"].values())
    assert total == pytest.approx(rec["roots"]["ms"], rel=1e-4)
    assert 0.0 < idle["busy_s"] <= idle["window_s"]
    assert sum(idle["idle_s"].values()) == pytest.approx(idle["window_s"] - idle["busy_s"],
                                                         rel=1e-6)
    assert set(idle["idle_s"]) <= set(rec["spans"]) | {None}
    assert any(k is not None for k in idle["idle_s"])
