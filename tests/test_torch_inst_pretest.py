"""The instanced sweeps' pre-test (K3/K4), pinned on the CPU.

The CUDA kernels in ``csrc/sweep_inst.cu`` put each (ray, triangle) through
``may_hit``, a divide-free pre-test with a 1/64 slack, before the exact hit
test decides. Its PyTorch mirror ``sweep_inst.may_hit_plain`` (held against
the kernel's own evaluation on the card by
tests/test_torch_pretest_cuda.py) must refuse no (ray, triangle) that the
plain instanced hit test accepts:

* on the seeded wavefronts of the 3x3 instanced sphere grid of
  test_torch_instanced.py (its centre instance rotated and scaled
  non-uniformly);
* on rays aimed at edges and corners, steeply and grazing, and rays
  grazing the plane (``sweep.grazing_rays``), of triangles under rotated,
  non-uniformly scaled and translated instances;

and it refuses all-zero and NaN rows. Also here: the test count reckoned
from the final carry (``sweep.tests_from_final``) against the instanced
walk's own count. Only the port's scene is built: no JAX compile.
"""

import numpy as np
import pytest
import torch

from hikari_tpu_torch.geometry import instanced as tinst
from hikari_tpu_torch.geometry import sweep, sweep_inst
from hikari_tpu_torch.geometry import wavefront as twf
from test_torch_instanced import N_RAYS, PORT_API, _build_grid, _rays, _torch


@pytest.fixture(scope="module")
def grid():
    return _build_grid(PORT_API).build(device="cpu")


def _args(tl):
    return tl.ti_obj, tl.ti_inst, tl.coef, tl.inst_a


def test_instance_matrices_keep_the_affine_column_exact(grid):
    """may_hit takes o.w = 1 and d.w = 0 as exact: the matrices' last
    column must be (0, 0, 0, 1) bit for bit."""
    for a in (grid.inst.inst_a, _instances()[0].inst_a):
        assert a.shape[0] >= 4
        assert torch.equal(a[:, :3, 3], torch.zeros(a.shape[0], 3))
        assert torch.equal(a[:, 3, 3], torch.ones(a.shape[0]))


@pytest.mark.parametrize("which", ["closest", "occlusion"])
def test_inst_pretest_keeps_every_plain_hit_of_the_wavefront(grid, which):
    """Every listed pair of a seeded wavefront; closest: with the far limit
    at each lane's final t (the tightest carry a block can hold), occlusion:
    at its shadow distance."""
    o, d, act, tmax = _torch(*_rays(seed=3))
    if which == "closest":
        ps = twf.prepare_closest(grid.inst, o, d, torch.full((N_RAYS,), float("inf")),
                                 grid.world_lo, grid.world_hi, active=act)
        t_far = sweep_inst.closest_inst_plain(ps.os, ps.ds, ps.ts, ps.tre, ps.tn_bits,
                                              ps.seg, *_args(grid.inst))[0]
    else:
        ps = twf.prepare_occlusion(grid.inst, o, d, tmax, grid.world_lo, grid.world_hi,
                                   active=act)
        t_far = ps.ts
    hits, drops = sweep_inst.pretest_drops_inst(ps.os, ps.ds, t_far, ps.tre, ps.seg,
                                                *_args(grid.inst))
    assert hits > 500
    assert drops == 0


def _instances():
    """Small random triangles (one BLAS of two treelets) under four
    instances: translated, rotated about a skew axis and scaled
    non-uniformly, flattened along one axis, mirrored."""
    rng = np.random.RandomState(11)
    p = 512
    c = rng.rand(p, 3).astype(np.float32) * 2 - 1
    p0, p1, p2 = (c + rng.rand(p, 3).astype(np.float32) * 0.08 for _ in range(3))
    axis = np.array([1.0, 2.0, -0.5]) / np.linalg.norm([1.0, 2.0, -0.5])
    th = 0.9
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    rot = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * (k @ k)
    mats = []
    for lin, move in ((np.eye(3), (4.0, 0.5, -1.0)),
                      (rot @ np.diag([2.5, 0.4, 1.3]), (-2.0, 3.0, 1.5)),
                      (np.diag([1.0, 0.05, 1.0]), (0.0, -2.0, 0.0)),
                      (rot @ np.diag([-1.0, 1.0, 0.7]), (1.0, 1.0, 6.0))):
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = lin, move
        mats.append(m.astype(np.float32))
    tl = tinst.build_instanced_treelets([(p0, p1, p2)], [(0, m) for m in mats])
    return tl, np.stack([p0, p1, p2], 1), np.stack(mats)


@pytest.mark.parametrize("which", ["closest", "occlusion"])
def test_inst_pretest_keeps_grazing_hits(which):
    """``sweep.grazing_rays`` at six triangles of each object treelet under
    each instance, in world space, each ray tested against its triangle's
    whole object-space treelet through the instance's matrix, with the far
    limit just behind the point aimed at (closest: one float32 ulp, the
    tightest exact carry; occlusion: 1e-5 relative)."""
    tl, tri_obj, mats = _instances()
    rng = np.random.RandomState(5)
    hits = drops = 0
    for ii, m in enumerate(mats):
        # world vertices of the object triangles under this instance
        w = tri_obj.astype(np.float64) @ m[:3, :3].T.astype(np.float64) + m[:3, 3]
        for tb in range(tl.coef.shape[0]):
            cols = rng.randint(0, 256, size=6)
            v = w[tb * 256 + cols]
            tri = np.concatenate([v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], 1)
            o, d, dist = _torch(*sweep.grazing_rays(tri.astype(np.float32), rng))
            if which == "closest":
                t_far = torch.nextafter(dist, torch.tensor(float("inf")))
            else:
                t_far = dist * (1 + 1e-5)
            c = tl.coef[tb][None].expand(o.shape[0], -1, -1)
            a = tl.inst_a[ii][None].expand(o.shape[0], -1, -1)
            t, _, _, hit = sweep_inst._block_tuv_inst(*sweep_inst._to_object(o, d, a), c)
            hit = hit & (t <= t_far[..., None])
            may = sweep_inst.may_hit_plain(o, d, a, c, t_far)
            hits += int(hit.sum())
            drops += int((hit & ~may).sum())
    assert hits > 2000   # the rays do graze: about half of them hit
    assert drops == 0


def test_inst_pretest_refuses_degenerate_rows():
    """All-zero (padding) rows and NaN rows fail the pre-test for every ray,
    under a rotated, scaled and translated instance."""
    tl, _, _ = _instances()
    o = torch.tensor([[[0.3, 0.2, -1.0], [5.0, -1.0, 2.0]]])
    d = torch.tensor([[[0.0, 0.0, 1.0], [-0.6, 0.0, 0.8]]])
    coef = torch.zeros(1, 2, 12)
    coef[0, 1] = float("nan")
    for a in tl.inst_a:
        assert not sweep_inst.may_hit_plain(o, d, a[None], coef,
                                            torch.tensor([[3.0e37, 1.0]])).any()


def test_inst_final_carry_count_bounds_the_walks_count(grid):
    """The tests counted from each lane's final t are at most the walk's
    count, and equal to it on a list that holds only each tile's first
    pair."""
    o, d, act, _ = _torch(*_rays(seed=4))
    ps = twf.prepare_closest(grid.inst, o, d, torch.full((N_RAYS,), float("inf")),
                             grid.world_lo, grid.world_hi, active=act)
    stats = {}
    t = sweep_inst.closest_inst_plain(ps.os, ps.ds, ps.ts, ps.tre, ps.tn_bits, ps.seg,
                                      *_args(grid.inst), stats=stats)[0]
    final = sweep.tests_from_final(t.view(torch.int32), ps.tn_bits, ps.seg)
    assert 0 < final <= stats["tests"]
    length = ps.seg[1:] - ps.seg[:-1]
    assert int(length.max()) > 1  # the full list has later pairs
    first = ps.seg[:-1][length > 0].long()
    seg1 = torch.cat([torch.zeros(1, dtype=torch.int32),
                      torch.cumsum((length > 0).to(torch.int32), 0).to(torch.int32)])
    stats = {}
    t = sweep_inst.closest_inst_plain(ps.os, ps.ds, ps.ts, ps.tre[first], ps.tn_bits[first],
                                      seg1, *_args(grid.inst), stats=stats)[0]
    assert stats["tests"] > 0
    assert sweep.tests_from_final(t.view(torch.int32), ps.tn_bits[first], seg1) == stats["tests"]
