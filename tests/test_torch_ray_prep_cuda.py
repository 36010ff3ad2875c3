"""On the card: the lane-stage kernel (``csrc/ray_prep.cu``) against its
plain version, bit for bit.

``wavefront.ray_prep_kernel`` and ``wavefront.ray_prep_plain`` run on the
same CUDA tensors; the padded origins, directions, reaches (their float32
bits: NaN and -0 included) and keys must be equal. The inputs: every lane
stage call of a 1280x720 VolPath wavefront of 4 samples on the mesh
scene (3.69 M lanes a sweep: camera lanes, each bounce's and each NEE
shadow ray's) and of a FastWavefront frame; seeded random lanes with the
adversarial cases of ``test_torch_ray_prep_dispatch.lanes`` (direction
components +-0, under 1e-20 and infinite, infinite, NaN and zero reach,
NaN origins, origins on box faces, inactive lanes) at 0 to 70,000 lanes,
in both modes, with a light group of either width and with reversed
shadow rays, with and without a key; on the mesh room (78 super boxes),
a one-treelet scene and the instanced default scene (no pre-pass, an
unbounded world box), and on the mesh scene with 300 more super boxes
than its own 75, so that lanes are admitted in a third shared-memory
tile. The PairSweep that prepare_closest / prepare_occlusion build from
the kernel's lanes equals the one they build from the plain version's, and
a traced sweep launches the kernel once and finds the hits that the plain
version finds in its place.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

import hikari_tpu_torch as hk
from hikari_tpu_torch import _build, scenes
from hikari_tpu_torch.geometry import wavefront as twf
from hikari_tpu_torch.integrators import preview, volpath
from test_torch_ray_prep_dispatch import (MODES, SIZES, assert_stage_equal, lanes, mesh_room,
                                          one_treelet_scene, stage_args)

DEV = "cuda"
EXTRA_BOXES = 300


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lane-stage kernel has no CPU mode")
    twf.ray_prep_attributes()  # builds and loads the kernel


def _with_far_boxes(sc, n_extra, seed=3):
    """The scene's treelets with n_extra super boxes ahead of its own: small
    boxes scattered in a shell around the world box, which admit few
    lanes, so most are admitted only in a later tile."""
    tl = sc.treelets
    rng = np.random.RandomState(seed)
    centre = (0.5 * (sc.world_lo + sc.world_hi)).cpu().numpy()
    radius = float(torch.linalg.vector_norm(sc.world_hi - sc.world_lo).cpu())
    u = rng.normal(size=(n_extra, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    c = centre + u * radius * rng.uniform(1.0, 4.0, (n_extra, 1))
    half = rng.uniform(0.01, 0.3, (n_extra, 3)) * radius
    lo = torch.from_numpy((c - half).astype(np.float32)).to(DEV)
    hi = torch.from_numpy((c + half).astype(np.float32)).to(DEV)
    return dataclasses.replace(tl, sup_lo=torch.cat([lo, tl.sup_lo]),
                               sup_hi=torch.cat([hi, tl.sup_hi]))


@pytest.fixture(scope="module")
def built(card):
    mesh = scenes.mesh_scene().build(device=DEV)
    out = {"mesh": mesh, "flat": mesh_room().build(device=DEV),
           "one treelet": one_treelet_scene().build(device=DEV),
           "instanced": scenes.instanced_default_scene().build(device=DEV)}
    return out


def _tables(built, which):
    """(scene, its traversal tables) of a case."""
    if which == "many boxes":
        sc = built["mesh"]
        return sc, _with_far_boxes(sc, EXTRA_BOXES)
    sc = built[which]
    return sc, sc.treelets if sc.treelets is not None else sc.inst


def _random_lanes(sc, tl, n, seed):
    sup = twf._super_boxes(tl)
    sup = (None, None) if sup is None else [x.cpu().numpy() for x in sup]
    return lanes(n, seed, sc.world_lo.cpu().numpy(), sc.world_hi.cpu().numpy(), *sup)


def _both(tl, args, world_lo, world_hi, kw):
    """(kernel, plain) of one lane stage call on the same CUDA tensors."""
    got = twf.ray_prep_kernel(tl, *args, world_lo, world_hi, **kw)
    want = twf.ray_prep_plain(tl, *args, world_lo, world_hi, **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES + [70_000])
@pytest.mark.parametrize("which", ["mesh", "flat", "one treelet", "instanced", "many boxes"])
def test_kernel_equals_plain_on_random_and_adversarial_lanes(built, which, n):
    sc, tl = _tables(built, which)
    if which == "many boxes":
        assert tl.sup_lo.shape[0] > 2 * 128  # three tiles of the kernel's shared memory
    arrays = _random_lanes(sc, tl, n, seed=n + 7)
    for mode in MODES:
        args, kw = stage_args(tl, arrays, *mode, device=DEV)
        for keys in (True, False) if mode[0] == "closest" else (True,):
            got, want = _both(tl, args, sc.world_lo, sc.world_hi, dict(kw, keys=keys))
            assert_stage_equal(got, want, f"{which} n={n} {mode} keys={keys}")


def _captured_calls(sc, run):
    """The lane stage calls that `run` makes, each as its arguments by name."""
    calls = []
    orig = twf.ray_prep_kernel
    sig = inspect.signature(twf.ray_prep_plain)

    def recording(*args, **kw):
        bound = sig.bind(*args, **kw)
        bound.apply_defaults()
        calls.append(dict(bound.arguments))
        return orig(*args, **kw)

    twf.ray_prep_kernel = recording
    try:
        run()
        torch.cuda.synchronize()
    finally:
        twf.ray_prep_kernel = orig
    return calls


@pytest.fixture(scope="module")
def mesh_calls(built):
    """Every lane stage call of a 1280x720 VolPath wavefront of 4 samples at
    256 spp (the final cell's 3.69 M lanes) and of a FastWavefront frame
    (922 k lanes) on the mesh scene."""
    sc = built["mesh"]
    w, h, k = 1280, 720, 4
    cam = scenes.scene_camera("mesh", w, h)
    px = torch.arange(w * h, device=DEV)

    def final():
        volpath.render_lanes(hk.VolPath(max_depth=5, samples_per_pixel=256), sc, cam,
                             hk.make_filter(), torch.arange(k, device=DEV).repeat_interleave(w * h),
                             (px % w).repeat(k), (px // w).repeat(k))

    def frame():
        preview.preview_lanes(hk.FastWavefront(), sc, cam, 0)

    return {"final": _captured_calls(sc, final), "preview": _captured_calls(sc, frame)}


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["final", "preview"])
def test_kernel_equals_plain_on_every_call_of_the_mesh_scene(mesh_calls, path):
    calls = mesh_calls[path]
    # a closest and a shadow sweep a bounce: 5 and 5 a wavefront, 2 and 2 a frame
    assert len(calls) == (10 if path == "final" else 4)
    modes = [call["occlusion"] for call in calls]
    assert any(modes) and not all(modes)
    for i, call in enumerate(calls):
        got = twf.ray_prep_kernel(**call)
        want = twf.ray_prep_plain(**call)
        torch.cuda.synchronize()
        assert_stage_equal(got, want, f"{path} call {i}")
        n = call["o"].shape[0]
        assert got[0].shape[0] == -(-n // 1024) * 1024
        if path == "final":
            assert n == 1280 * 720 * 4


def _prepare_both(fn, *args, **kw):
    """fn (prepare_closest / prepare_occlusion) with the kernel, then with
    the plain version in its place, on the same CUDA tensors."""
    got = fn(*args, **kw)
    orig = twf.ray_prep_kernel
    twf.ray_prep_kernel = twf.ray_prep_plain
    try:
        want = fn(*args, **kw)
    finally:
        twf.ray_prep_kernel = orig
    torch.cuda.synchronize()
    return got, want


def _assert_pair_sweep_equal(got, want, what):
    for f in dataclasses.fields(twf.PairSweep):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, f"{what} {f.name}"
            av = a.view(torch.int32) if a.dtype == torch.float32 else a
            bv = b.view(torch.int32) if b.dtype == torch.float32 else b
            assert torch.equal(av, bv), f"{what} {f.name}"
        else:
            assert a == b, f"{what} {f.name}"


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["mesh", "flat", "instanced", "many boxes"])
def test_pair_sweeps_equal_the_plain_paths(built, mesh_calls, which):
    """The PairSweep (order, lanes, tre, tn_bits, seg) that prepare_closest /
    prepare_occlusion return from the kernel's lanes equals the plain
    path's: camera lanes and the first bounce's of the mesh scene's
    wavefront, then random lanes, closest (also presorted) and occlusion
    (with a group, reversed)."""
    sc, tl = _tables(built, which)
    if which == "mesh":
        cases = [(tuple(c[k] for k in ("o", "d", "t_max", "world_lo", "world_hi")), c["active"])
                 for c in mesh_calls["final"][:3]]
    else:
        o, d, t, active, _ = _random_lanes(sc, tl, 50_000, seed=11)
        cases = [(tuple(torch.from_numpy(x).to(DEV) for x in (o, d, t)) + (sc.world_lo,
                                                                          sc.world_hi),
                  torch.from_numpy(active).to(DEV))]
    for i, ((o, d, t, wl, wh), active) in enumerate(cases):
        group = (torch.arange(o.shape[0], device=DEV) * 7) % 50
        runs = [(twf.prepare_closest, dict(active=active)),
                (twf.prepare_closest, dict(active=active, presorted=True)),
                (twf.prepare_occlusion, dict(active=active)),
                (twf.prepare_occlusion, dict(active=active, group=group, reverse=True))]
        for fn, kw in runs:
            got, want = _prepare_both(fn, tl, o, d, t, wl, wh, **kw)
            _assert_pair_sweep_equal(got, want, f"{which} case {i} {fn.__name__} "
                                                f"{sorted(kw)}")


@pytest.mark.cuda
def test_traced_sweeps_count_kernel_lanes_and_culled_lanes(built, mesh_calls):
    sc = built["mesh"]
    call = mesh_calls["final"][0]
    assert not call["occlusion"]
    o, d, t = call["o"], call["d"], call["t_max"]
    hits, launched = {}, {}
    for side in ("kernel", "plain"):
        _build.reset_counts()
        orig = twf.ray_prep_kernel
        if side == "plain":
            twf.ray_prep_kernel = twf.ray_prep_plain
        try:
            with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
                hits[side] = volpath.scene_closest_hit(sc, o, d, t, active=call["active"])
        finally:
            twf.ray_prep_kernel = orig
        launched[side] = _build.launches["ray_prep"]
    # the plain version stood in for the kernel inside the same dispatch
    assert launched == {"kernel": 1, "plain": 0}
    for f in dataclasses.fields(hits["plain"]):
        got, want = (getattr(hits[side], f.name) for side in ("kernel", "plain"))
        if want.dtype == torch.float32:  # the bits: NaN and -0 included
            got, want = got.contiguous().view(torch.int32), want.contiguous().view(torch.int32)
        assert torch.equal(got, want), f.name


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(built):
    sc, tl = _tables(built, "flat")
    o, d, t, _, _ = _random_lanes(sc, tl, 100, seed=1)
    o, d, t = (torch.from_numpy(x).to(DEV) for x in (o, d, t))
    with pytest.raises(ValueError, match="float32"):
        twf.ray_prep_kernel(tl, o.double(), d, t, sc.world_lo, sc.world_hi)
    with pytest.raises(ValueError, match="shape"):
        twf.ray_prep_kernel(tl, o, d, t[:50], sc.world_lo, sc.world_hi)
    with pytest.raises(ValueError, match="occlusion"):
        twf.ray_prep_kernel(tl, o, d, t, sc.world_lo, sc.world_hi, reverse=True)
    with pytest.raises(ValueError):
        twf.ray_prep_kernel(tl, o, d, t, sc.world_lo.cpu(), sc.world_hi)
