"""On the card: the kernels' pre-tests against their PyTorch mirrors.

``sweep.pretest_grid`` runs the grid sweeps' pre-test (``may_hit_u`` and
``may_hit_vt`` of ``csrc/sweep_grid.cuh``, both stages joined, as K1/K2 and
K5/K6 evaluate it) alone, and ``sweep_inst.pretest_inst`` the instanced
sweeps' ``may_hit`` (``csrc/sweep_inst.cu``). Their (rays x 256 rows)
masks must equal ``sweep.may_hit_plain`` and ``sweep_inst.may_hit_plain``
bit for bit, on seeded wavefronts and on the grazing rays of the CPU tests
(``sweep.grazing_rays``), whose conservativeness tests then speak for the
kernels. Both wrappers raise on a CPU tensor: there is no CPU version.
"""

import numpy as np
import pytest
import torch

from hikari_tpu_torch.geometry import sweep, sweep_inst
from hikari_tpu_torch.geometry import wavefront as twf
from test_torch_inst_pretest import _instances
from test_torch_instanced import PORT_API, _build_grid, _rays
from test_torch_wavefront import _torch, setup  # noqa: F401

DEV = "cuda"


def _on_card(test):
    return pytest.mark.cuda(pytest.mark.skipif(
        not torch.cuda.is_available(),
        reason="needs a CUDA device: the pre-test kernels have no CPU mode")(test))


def _grid_mismatches(o, d, t_far, coef):
    """Rows where the device mask differs from the mirror's: rays (n, 3),
    t_far (n,), one treelet (256, 12)."""
    dev = sweep.pretest_grid(o, d, t_far, coef).bool()
    mirror = sweep.may_hit_plain(o[None], d[None], coef[None], t_far[None])[0]
    return int((dev != mirror).sum()), int(mirror.sum())


@_on_card
def test_cuda_grid_pretest_equals_its_mirror(setup):
    s = setup
    tl = s["ttl"].to(DEV)
    o, d, act, tmax = (x.to(DEV) for x in _torch(s["o"], s["d"], s["active"],
                                                 s["t_shadow"]))
    wl, wh = (x.to(DEV) for x in _torch(*s["world"]))
    ps = twf.prepare_closest(tl, o, d, torch.full((o.shape[0],), float("inf"), device=DEV),
                             wl, wh, active=act)
    cases = [(ps, (twf.closest_carry(ps)[0] | sweep.COL_MASK).view(torch.float32))]
    ps = twf.prepare_occlusion(tl, o, d, tmax, wl, wh, active=act)
    cases.append((ps, ps.ts))
    differ = passed = 0
    for ps, t_far in cases:
        tile = torch.searchsorted(ps.seg[1:].long(), torch.arange(ps.tre.numel(), device=DEV),
                                  right=True)
        for p in range(ps.tre.numel()):
            lanes = slice(int(tile[p]) * 1024, int(tile[p]) * 1024 + 1024)
            n, m = _grid_mismatches(ps.os[lanes], ps.ds[lanes], t_far[lanes],
                                    tl.coef[int(ps.tre[p])])
            differ, passed = differ + n, passed + m
    rng = np.random.RandomState(7)
    for tb in range(tl.coef.shape[0]):
        tri = s["ttl"].tri[tb * 256 + rng.randint(0, 256, size=4), :9].numpy()
        o_g, d_g, dist = (x.to(DEV) for x in _torch(*sweep.grazing_rays(tri, rng)))
        n, m = _grid_mismatches(o_g.reshape(-1, 3), d_g.reshape(-1, 3),
                                dist.reshape(-1) * (1 + 1e-5), tl.coef[tb])
        differ, passed = differ + n, passed + m
    assert differ == 0
    assert passed > 10000


@_on_card
def test_cuda_inst_pretest_equals_its_mirror():
    sc = _build_grid(PORT_API).build(device=DEV)
    o, d, act, tmax = (x.to(DEV) for x in _torch(*_rays(seed=3)))
    ps = twf.prepare_occlusion(sc.inst, o, d, tmax, sc.world_lo, sc.world_hi, active=act)
    tl = sc.inst
    tile = torch.searchsorted(ps.seg[1:].long(), torch.arange(ps.tre.numel(), device=DEV),
                              right=True)
    differ = passed = 0

    def check(o_, d_, t_far, coef, a):
        dev = sweep_inst.pretest_inst(o_, d_, t_far, coef, a).bool()
        mirror = sweep_inst.may_hit_plain(o_[None], d_[None], a[None], coef[None],
                                          t_far[None])[0]
        return int((dev != mirror).sum()), int(mirror.sum())

    for p in range(ps.tre.numel()):
        lanes = slice(int(tile[p]) * 1024, int(tile[p]) * 1024 + 1024)
        wt = int(ps.tre[p])
        n, m = check(ps.os[lanes], ps.ds[lanes], ps.ts[lanes], tl.coef[int(tl.ti_obj[wt])],
                     tl.inst_a[int(tl.ti_inst[wt])])
        differ, passed = differ + n, passed + m
    itl, tri_obj, mats = _instances()
    itl = itl.to(DEV)
    rng = np.random.RandomState(5)
    for ii, mat in enumerate(mats):
        w = tri_obj.astype(np.float64) @ mat[:3, :3].T.astype(np.float64) + mat[:3, 3]
        for tb in range(itl.coef.shape[0]):
            v = w[tb * 256 + rng.randint(0, 256, size=4)]
            tri = np.concatenate([v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], 1)
            o_g, d_g, dist = (x.to(DEV) for x in _torch(
                *sweep.grazing_rays(tri.astype(np.float32), rng)))
            n, m = check(o_g.reshape(-1, 3), d_g.reshape(-1, 3), dist.reshape(-1) * (1 + 1e-5),
                         itl.coef[tb], itl.inst_a[ii])
            differ, passed = differ + n, passed + m
    assert differ == 0
    assert passed > 5000


def test_pretest_wrappers_raise_on_the_cpu():
    """No CPU version: a CPU tensor is refused, not evaluated by the mirror."""
    o = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        sweep.pretest_grid(o, o, torch.ones(4), torch.zeros(256, 12))
    with pytest.raises(ValueError):
        sweep_inst.pretest_inst(o, o, torch.ones(4), torch.zeros(256, 12), torch.eye(4))
