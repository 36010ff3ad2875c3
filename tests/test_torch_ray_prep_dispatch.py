"""The traversal driver's lane stage (``hikari_tpu_torch.geometry.wavefront.ray_prep``):
CPU tensors take the plain version and launch nothing (the package's
launch record stays empty); the plain version (``ray_prep_plain``) gives, bit for bit, the lanes and
keys of the composition it replaced in ``prepare_closest`` /
``prepare_occlusion`` (the finite reach, ``_world_exit_clamp`` or the
reversed shadow segment, the active mask, ``_ray_super_cull``,
``_pad_rays``, ``ray_sort_keys`` and the light group, the key clamp); no
pre-pass runs without super boxes; the kernel's source carries its note
and the plain version's constants.
The kernel itself runs only on the card (``test_torch_ray_prep_cuda.py``).

Runs on the CPU without JAX.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import hikari_tpu_torch as hk
from hikari_tpu_torch import _build, scenes
from hikari_tpu_torch.geometry import wavefront as twf
from hikari_tpu_torch.integrators import volpath

SOURCE = Path(twf.__file__).resolve().parent.parent / "csrc" / "ray_prep.cu"
# lane counts: none, one, under a tile, a tile, just over, several
SIZES = [0, 1, 1000, 1024, 1025, 3000]
# (mode, active, group dtype, reverse)
MODES = [("closest", False, None, False), ("closest", True, None, False),
         ("occlusion", False, None, False), ("occlusion", True, None, False),
         ("occlusion", True, torch.int32, False), ("occlusion", True, torch.int64, True),
         ("occlusion", False, None, True), ("occlusion", True, torch.int8, False)]


def mesh_room(subdiv: int = 3) -> hk.Scene:
    """The mesh scene's room, lights and Gold icosphere at a subdivision
    (subdiv 3: 6 treelets, 78 super boxes)."""
    s = hk.Scene()
    scenes._room(s)
    v, f = scenes._displaced_icosphere(subdiv)
    s.add(hk.TriangleMesh(vertices=v * 0.9 + np.asarray([[0.0, 1.1, 2.0]], np.float32),
                          faces=f), hk.Gold(roughness=0.2))
    scenes._lights(s)
    return s


def one_treelet_scene() -> hk.Scene:
    """One quad under a point light: a single treelet, so no pre-pass."""
    s = hk.Scene()
    s.add(hk.make_quad((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (1.0, 0.0, 1.0), (0.0, 0.0, 1.0)),
          hk.Matte())
    s.add_light(hk.PointLight(position=(0.0, 2.0, 0.0), intensity=(1.0, 1.0, 1.0)))
    return s


def lanes(n, seed, world_lo, world_hi, sup_lo=None, sup_hi=None):
    """n lanes (o, d, t_max, active, group) as numpy arrays: seeded random
    rays in and around the world box, then, cycled over the first lanes,
    the adversarial cases: direction components +-0, under and at 1e-20,
    and infinite; infinite, NaN, zero, negative and -0 reach; NaN and
    infinite origins; origins on a super box's faces and on the world
    box's, aimed along the face and across it."""
    rng = np.random.RandomState(seed)
    lo = np.where(np.abs(world_lo) < 1e30, world_lo, -3.0)
    hi = np.where(np.abs(world_hi) < 1e30, world_hi, 3.0)
    o = rng.uniform(lo - 0.5, hi + 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0.01, 12.0, n).astype(np.float32)
    active = rng.rand(n) > 0.2
    group = rng.randint(-3, 200, n)
    inf, nan = np.float32(np.inf), np.float32(np.nan)
    special = [
        (None, (0.0, -0.0, 1.0), None), (None, (-0.0, -0.0, -1.0), None),
        (None, (1e-21, -1e-25, 1.0), None), (None, (1e-20, -1e-20, 0.5), None),
        (None, (np.float32(9.9e-21), -np.float32(9.9e-21), -0.3), None),
        (None, (inf, 0.0, 0.0), None), (None, (0.0, -inf, 0.0), None),
        (None, None, inf), (None, None, -inf), (None, None, nan), (None, None, 0.0),
        (None, None, -0.0), (None, None, -1.5), (None, None, 1e-30),
        ((nan, 0.5, 0.5), None, None), ((0.5, nan, 0.5), (0.0, 0.0, 1.0), inf),
        ((inf, 1.0, 1.0), None, None), ((-inf, 1.0, 1.0), (1.0, 0.0, 0.0), None),
        (tuple(lo), (1.0, 0.0, 0.0), None), (tuple(hi), (-1.0, 0.0, 0.0), inf),
        (tuple(lo), (0.0, 1.0, 0.0), None),
    ]
    if sup_lo is not None and len(sup_lo):
        for b in range(min(4, len(sup_lo))):
            special += [(tuple(sup_lo[b]), (0.0, 0.0, 1.0), None),
                        (tuple(sup_hi[b]), (-1.0, 0.0, 0.0), None),
                        (tuple(sup_lo[b]), (0.0, -0.0, 1e-21), inf),
                        ((sup_lo[b][0], sup_hi[b][1], sup_lo[b][2]), (0.3, -0.4, 0.5), None)]
    for k in range(min(n, 2 * len(special))):
        so, sd, st = special[k % len(special)]
        if so is not None:
            o[k] = so
        if sd is not None:
            d[k] = sd
        if st is not None:
            t[k] = st
        active[k] = k < len(special) or active[k]
    return o, d, t, active, group


def scene_lanes(sc, n, seed):
    tl = sc.treelets if sc.treelets is not None else sc.inst
    sup = twf._super_boxes(tl)
    sup = (None, None) if sup is None else [x.numpy() for x in sup]
    return tl, lanes(n, seed, sc.world_lo.numpy(), sc.world_hi.numpy(), *sup)


def present(tl, o, d, t_max, world_lo, world_hi, active, occlusion, group, reverse, keys):
    """The lane stage as prepare_closest / prepare_occlusion / _prepare
    composed it before ray_prep: (o, d, reach, key) padded."""
    t_max = torch.where(torch.isfinite(t_max), t_max, 3.0e37)
    if occlusion:
        if active is not None:
            t_max = torch.where(active, t_max, 0.0)
        if reverse:
            o = o + d * t_max[:, None]
            d = -d
        t_max = t_max * 0.9999
        if group is not None:
            pad = (-group.shape[0]) % twf.RAY_TILE
            group = torch.cat([group.long(), group.new_zeros(pad, dtype=torch.int64)])

        def keys_fn(o_, d_):
            k = twf.ray_sort_keys(o_, d_, world_lo, world_hi)
            if group is not None:
                k = ((group & 63) << 26) | (k >> 6)
            return k
    else:
        t_max = twf._world_exit_clamp(o, d, t_max, world_lo, world_hi)
        if active is not None:
            t_max = torch.where(active, t_max, 0.0)

        def keys_fn(o_, d_):
            return twf.ray_sort_keys(o_, d_, world_lo, world_hi)
    if isinstance(tl, twf.Treelets) and tl.lo.shape[0] > 1:
        t_max = torch.where(twf._ray_super_cull(tl, o, d, t_max), t_max, 0.0)
    o, d, t_max, n, n_pad = twf._pad_rays(o, d, t_max)
    if not keys:
        return o, d, t_max, None
    k = torch.clamp(keys_fn(o, d), max=0xFFFFFFFE)
    return o, d, t_max, torch.where(t_max > 0.0, k, 0xFFFFFFFF)


def stage_args(tl, arrays, mode, use_active, group_dtype, reverse, device="cpu"):
    o, d, t, active, group = arrays
    args = [torch.from_numpy(x).to(device) for x in (o, d, t)]
    kw = dict(active=torch.from_numpy(active).to(device) if use_active else None,
              occlusion=mode == "occlusion", reverse=reverse,
              group=None if group_dtype is None else torch.from_numpy(group).to(group_dtype)
              .to(device))
    return args, kw


def bits(x):
    """A tensor's raw bits (int32 view of float32), NaN payloads and -0
    included."""
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def assert_stage_equal(got, want, what=""):
    names = ("o", "d", "reach", "key")
    for name, a, b in zip(names, got, want, strict=True):
        if b is None:
            assert a is None, f"{what} {name}"
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, f"{what} {name}"
        differ = int((bits(a) != bits(b)).sum())
        assert differ == 0, f"{what} {name}: {differ} of {b.numel()} differ"


@pytest.fixture(scope="module")
def built():
    return {"flat": mesh_room().build(device="cpu"),
            "one treelet": one_treelet_scene().build(device="cpu"),
            "instanced": scenes.instanced_default_scene().build(device="cpu")}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("which", ["flat", "one treelet", "instanced"])
def test_plain_equals_the_replaced_composition(built, which, n):
    tl, arrays = scene_lanes(built[which], n, seed=n + 1)
    sc = built[which]
    for mode in MODES:
        args, kw = stage_args(tl, arrays, *mode)
        want = present(tl, *args, sc.world_lo, sc.world_hi, kw["active"], kw["occlusion"],
                       kw["group"], kw["reverse"], True)
        got = twf.ray_prep_plain(tl, *args, sc.world_lo, sc.world_hi, **kw)
        assert_stage_equal(got, want, f"{which} {mode}")
        assert got[0].shape[0] % twf.RAY_TILE == 0 and got[0].shape[0] >= n


@pytest.mark.parametrize("mode", MODES[:2], ids=["closest", "closest active"])
def test_presorted_stage_has_no_key(built, mode):
    sc = built["flat"]
    tl, arrays = scene_lanes(sc, 3000, seed=4)
    args, kw = stage_args(tl, arrays, *mode)
    want = present(tl, *args, sc.world_lo, sc.world_hi, kw["active"], False, None, False,
                   False)
    assert_stage_equal(twf.ray_prep_plain(tl, *args, sc.world_lo, sc.world_hi, **kw,
                                          keys=False), want)


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_cpu_tensors_take_the_plain_path_and_count_it(built, kind, monkeypatch):
    def no_kernel(*args, **kw):
        raise AssertionError("the kernel was called on CPU tensors")

    monkeypatch.setattr(twf, "ray_prep_kernel", no_kernel)
    sc = built["flat"]
    tl, (o, d, t, active, group) = scene_lanes(sc, 3000, seed=9)
    o, d, t, active = (torch.from_numpy(x) for x in (o, d, t, active))
    _build.reset_counts()
    padded = []
    orig = twf.ray_prep_plain

    def plain(*args, **kw):
        out = orig(*args, **kw)
        padded.append(out[0].shape[0])
        return out

    monkeypatch.setattr(twf, "ray_prep_plain", plain)
    if kind == "closest":
        volpath.scene_closest_hit(sc, o, d, t, active=active)
    else:
        volpath.scene_any_hit(sc, o, d, t, active=active, group=torch.from_numpy(group))
    assert not _build.launches and not _build.plain_cuda_runs
    assert padded == [3072]


def test_no_pre_pass_and_no_culled_count_without_super_boxes(built, monkeypatch):
    def no_pre_pass(*args):
        raise AssertionError("the pre-pass ran without super boxes")

    monkeypatch.setattr(twf, "_ray_super_cull", no_pre_pass)
    for which in ("one treelet", "instanced"):
        sc = built[which]
        tl, (o, d, t, active, _) = scene_lanes(sc, 1500, seed=2)
        args = [torch.from_numpy(x) for x in (o, d, t)]
        active = torch.from_numpy(active)
        got = twf.ray_prep(tl, *args, sc.world_lo, sc.world_hi, active)
        # the uncut stage: no super boxes, so the composition skips the pre-pass too
        want = present(tl, *args, sc.world_lo, sc.world_hi, active, False, None, False, True)
        assert_stage_equal(got, want, which)
        assert got[0].shape[0] == 2048


def test_the_kernel_takes_only_card_tensors(built):
    sc = built["flat"]
    tl, (o, d, t, _, _) = scene_lanes(sc, 8, seed=1)
    with pytest.raises(ValueError, match="on the card"):
        twf.ray_prep_kernel(tl, *(torch.from_numpy(x) for x in (o, d, t)), sc.world_lo,
                            sc.world_hi)


def test_the_source_carries_its_note_and_the_plain_constants():
    src = SOURCE.read_text()
    note = src.split("#include")[0]
    for phrase in ("Replaces no TPU kernel", "hikari_tpu/geometry/wavefront.py",
                   "What bounds it", "What the design does about it", "bit for bit"):
        assert phrase in note, phrase
    # each float32 operand of the kernel is a Python float of the plain version
    plain = "".join(inspect.getsource(f) for f in (
        twf.ray_prep_plain, twf._world_exit_clamp, twf._ray_super_cull, twf.ray_sort_keys))
    consts = re.findall(r"constexpr float k\w+ = float\(([0-9.e+-]+)\);", src)
    assert sorted(set(consts)) == ["0.9999", "1.0001", "1e-20", "1e-3", "1e-4", "1e-6",
                                   "3.0e37"]
    for c in consts:
        assert re.search(rf"(?<![0-9.]){re.escape(c)}(?![0-9])", plain), c
    ints = dict(re.findall(r"constexpr (?:int|float) (k\w+) = ([0-9.]+)f?;", src))
    assert float(ints["kOrgScale"]) == (1 << twf.KEY_OBITS) - 1
    assert int(ints["kOriginBits"]) == 3 * twf.KEY_OBITS
    assert int(ints["kDirBits"]) == 29 - 3 * twf.KEY_OBITS
    assert twf.RAY_TILE % int(ints["kThreads"]) == 0
    assert "n_pad % 1024" in src and twf.RAY_TILE == 1024
