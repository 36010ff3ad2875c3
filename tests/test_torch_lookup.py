"""Per-lane bank reads (``hikari_tpu_torch.core.lookup``): ``bank_lookup``
is ``arr[where-or-clamp(idx)]`` bit for bit whatever form its gather takes;
the piecewise spectra read their coefficient rows as the dense index did;
the conductor albedo reads three columns per lane as the dense rows gave
them. On the card (``-m cuda``): the same at the final cell's width, and a
mesh-scene wavefront and a preview frame launch no one-block-a-row gather.

Runs on the CPU without JAX.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity

import hikari_tpu_torch as hk
from hikari_tpu_torch import scenes
from hikari_tpu_torch.core.lookup import MAX_UNROLL, bank_lookup
from hikari_tpu_torch.integrators import preview, volpath
from hikari_tpu_torch.materials import types as mt
from hikari_tpu_torch.spectral import piecewise_poly as pp

ROWS = [(), (3,), (4,), (16, 4), (32, 4), (471,)]
DTYPES = [torch.float32, torch.int32, torch.bool]
IDX = {"1d": (37,), "2d": (9, 4), "scalar": (), "empty": (0,)}


def _bank(m, row, dtype, gen, device="cpu"):
    vals = torch.randn((m,) + row, generator=gen) * 100.0
    if dtype == torch.bool:
        vals = vals > 0.0
    return vals.to(dtype).to(device)


def _reference(arr, idx):
    """The chain's semantics spelled out: outside [0, M) reads row 0 up to
    MAX_UNROLL rows, and clamps beyond."""
    m = arr.shape[0]
    idx = idx.long()
    if m <= MAX_UNROLL:
        idx = torch.where((idx >= 0) & (idx < m), idx, torch.zeros_like(idx))
    else:
        idx = idx.clamp(0, m - 1)
    return arr[idx]


@pytest.mark.parametrize("m", [1, 3, 16, 17])
@pytest.mark.parametrize("row", ROWS, ids=lambda r: "x".join(map(str, r)) or "scalar")
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[1])
@pytest.mark.parametrize("shape", list(IDX), ids=list(IDX))
def test_bank_lookup_is_the_indexed_read(m, row, dtype, shape):
    gen = torch.Generator().manual_seed(m * 131 + len(row))
    arr = _bank(m, row, dtype, gen)
    # every row, then negative and out-of-range indices
    idx = torch.randint(-3, m + 4, IDX[shape], generator=gen, dtype=torch.int32)
    out = bank_lookup(arr, idx)
    ref = _reference(arr, idx)
    assert out.shape == IDX[shape] + row and out.dtype == dtype
    assert torch.equal(out, ref)
    assert torch.equal(bank_lookup(arr, idx.long()), ref)


@pytest.mark.parametrize("seg_count", [16, 32, 64])
def test_piecewise_reads_the_rows_the_index_read(seg_count):
    gen = torch.Generator().manual_seed(seg_count)
    lam = 350.0 + 500.0 * torch.rand((41, 4), generator=gen)
    coeffs = torch.randn((seg_count, 4), generator=gen)
    x = torch.clamp((lam - pp.LAM0) / (pp.LAM1 - pp.LAM0), 0.0, 1.0 - 1e-7) * seg_count
    seg = x.to(torch.int64)
    t = x - seg.to(torch.float32)
    c = coeffs[seg]
    want = ((c[..., 0] * t + c[..., 1]) * t + c[..., 2]) * t + c[..., 3]
    assert torch.equal(pp.piecewise_eval(coeffs, lam), want)
    banked = torch.randn((3, seg_count, 4), generator=gen)
    idx = torch.randint(-1, 5, (41, 1), generator=gen)
    ok = torch.where((idx >= 0) & (idx < 3), idx, 0)
    c = banked[ok.expand_as(seg), seg]
    want = ((c[..., 0] * t + c[..., 1]) * t + c[..., 2]) * t + c[..., 3]
    assert torch.equal(pp.piecewise_eval_banked(banked, idx, lam), want)


def test_conductor_albedo_reads_three_columns_as_the_dense_rows():
    s = hk.Scene()
    s.add(hk.make_quad((-1, 0, 0), (1, 0, 0), (1, 0, 2), (-1, 0, 2)), hk.Gold(roughness=0.2))
    s.add(hk.make_quad((-1, 2, 0), (-1, 2, 2), (1, 2, 2), (1, 2, 0)), hk.Copper())
    s.add(hk.make_quad((-1, 0, 2), (1, 0, 2), (1, 2, 2), (-1, 2, 2)), hk.Matte(kd=(0.2, 0.5, 0.7)))
    s.add_light(hk.PointLight(position=(0.0, 1.5, 1.0), intensity=(1.0, 1.0, 1.0)))
    scene = s.build(device="cpu")
    b = scene.materials
    assert b.cond_eta.shape[0] == 2
    gen = torch.Generator().manual_seed(5)
    n = 64
    mat_type = torch.where(torch.rand(n, generator=gen) < 0.7, mt.CONDUCTOR, mt.MATTE)
    mat_idx = torch.randint(-1, 4, (n,), generator=gen, dtype=torch.int32)
    out = volpath._albedo_rgb_dispatch(scene, mat_type, mat_idx, None)
    li = torch.tensor([250, 190, 105])
    ci = torch.clamp(torch.clamp(mat_idx, min=0).long(), max=1)
    eta, k = b.cond_eta[ci][..., li], b.cond_k[ci][..., li]
    want = ((eta - 1.0) ** 2 + k * k) / ((eta + 1.0) ** 2 + k * k)
    cond = mat_type == mt.CONDUCTOR
    assert torch.equal(out[cond], want[cond])
    assert not torch.equal(want[ci == 0][0], want[ci == 1][0])


# --- on the card --------------------------------------------------------------------------


def _gather_launches(fn):
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names, "the profiler recorded no device operation"
    return [n for n in names if "vectorized_gather_kernel" in n]


@pytest.mark.cuda
def test_cuda_bank_lookup_and_no_block_a_row_gather():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gather's form is the card's")
    gen = torch.Generator().manual_seed(11)
    idx = torch.randint(-2, 5, (1280 * 720 * 4,), generator=gen).cuda()
    for row in ROWS:
        for dtype in DTYPES:
            arr = _bank(3, row, dtype, gen, "cuda")
            ref = arr[torch.where((idx >= 0) & (idx < 3), idx, 0)]
            assert torch.equal(bank_lookup(arr, idx), ref), (row, dtype)
    scene = scenes.mesh_scene().build(device="cuda")
    cam = hk.make_perspective_camera((0.0, 1.6, -2.8), (0.0, 0.9, 2.0), (160, 90), fov_deg=45.0)
    vp = hk.VolPath(samples_per_pixel=4, sample_batch=4, max_depth=5, seed=3)

    def wavefront():
        film = hk.make_film(*cam.resolution, device="cuda")
        volpath.render_sample(vp, scene, cam, film, hk.make_filter(), 0)

    def frame():
        hk.framebuffer(preview.render_preview(hk.FastWavefront(samples_per_pixel=1, seed=5),
                                              scene, cam))

    for unit in (wavefront, frame):
        unit()  # builds the kernels
        assert _gather_launches(unit) == [], unit.__name__
