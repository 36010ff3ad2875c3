"""On the card: the ZSobol kernel (``csrc/zsobol.cu``) against the plain
version, bit for bit.

``compute_pixel_sample``, ``path_sample_1d`` and ``path_sample_2d`` launch
the kernel on CUDA tensors; ``sample_1d`` / ``sample_2d`` are the plain
version, run here on the same CUDA tensors (its integer operations give
the CPU's bits; one test holds the two devices equal). Each value must
have the plain version's float32 bits, over films from 1x1 to 1280x720,
1 to 65,536 samples a pixel (both parities of log2(spp), and a
generator-matrix product of 38 rows), seeds 0, 7 and 2^32 - 1, the camera
dims and the path dims up to depth 32, edge pixels, and a wavefront of
3.69 M random lanes with its sample index contiguous and expanded. The
plain version is held to the JAX package on the CPU, at these films and
sample counts too (``test_torch_sampling.py``).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from hikari_tpu_torch import _build
from hikari_tpu_torch.sampling import sobol
from hikari_tpu_torch.utils import profiling

DEV = "cuda"
RESOLUTIONS = [(1280, 720), (800, 800), (64, 64), (1, 1)]
SPPS = [1, 2, 4, 8, 256, 1024, 65536]
SEEDS = [0, 7, 2**32 - 1]
FIELDS = ("jitter", "wavelength_u", "lens", "time")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sampler kernel has no CPU mode")
    sobol.kernel_attributes()  # builds and loads the kernel


def _bits(x):
    return x.contiguous().view(torch.int32)


def _assert_bits_equal(got, want, what):
    differ = int((_bits(got) != _bits(want)).sum())
    assert torch.equal(_bits(got), _bits(want)), f"{what}: {differ} of {want.numel()} differ"


def _plain_pixel_sample(cfg, px, py, si):
    jx, jy = sobol.sample_2d(cfg, px, py, si, 3)
    lu, lv = sobol.sample_2d(cfg, px, py, si, 6)
    return {"jitter": torch.stack([jx, jy], -1),
            "wavelength_u": sobol.sample_1d(cfg, px, py, si, 1),
            "lens": torch.stack([lu, lv], -1), "time": sobol.sample_1d(cfg, px, py, si, 4)}


def _check_camera(cfg, px, py, si, what):
    got = sobol.compute_pixel_sample(cfg, px, py, si)
    want = _plain_pixel_sample(cfg, px, py, si)
    for f in FIELDS:
        assert getattr(got, f).shape == want[f].shape, f
        _assert_bits_equal(getattr(got, f), want[f], f"{what} {f}")


def _check_path(cfg, px, py, si, depths, what):
    for depth in depths:
        for local in range(11):
            dim = 6 + depth * 11 + local
            _assert_bits_equal(sobol.path_sample_1d(cfg, px, py, si, depth, local),
                               sobol.sample_1d(cfg, px, py, si, dim), f"{what} 1d dim {dim}")
            for a, b, c in zip(sobol.path_sample_2d(cfg, px, py, si, depth, local),
                               sobol.sample_2d(cfg, px, py, si, dim), "uv"):
                _assert_bits_equal(a, b, f"{what} 2d dim {dim} {c}")


def _edge_and_random_lanes(w, h, spp, n=4096, seed=0):
    """Every pixel of the film's border with the first and last sample
    index, then n random (pixel, sample) lanes."""
    xs = np.arange(w)
    ys = np.arange(h)
    ex = np.concatenate([xs, xs, np.zeros(h, int), np.full(h, w - 1)])
    ey = np.concatenate([np.zeros(w, int), np.full(w, h - 1), ys, ys])
    rng = np.random.RandomState(seed)
    px = np.concatenate([ex, ex, rng.randint(0, w, n)])
    py = np.concatenate([ey, ey, rng.randint(0, h, n)])
    si = np.concatenate([np.zeros(ex.size, int), np.full(ex.size, spp - 1),
                         rng.randint(0, spp, n)])
    return tuple(torch.from_numpy(a.astype(np.int64)).to(DEV) for a in (px, py, si))


@pytest.mark.cuda
@pytest.mark.parametrize("spp", SPPS)
@pytest.mark.parametrize("res", RESOLUTIONS, ids=lambda r: f"{r[0]}x{r[1]}")
def test_kernel_equals_plain_on_edges_and_random_lanes(card, res, spp):
    w, h = res
    for seed in SEEDS:
        cfg = sobol.make_zsobol(w, h, spp, seed=seed)
        lanes = _edge_and_random_lanes(w, h, spp, seed=spp + seed % 97)
        what = f"{w}x{h} spp {spp} seed {seed}"
        _check_camera(cfg, *lanes, what)
        _check_path(cfg, *lanes, (0, 7, 31), what)


@pytest.mark.cuda
def test_kernel_equals_plain_on_every_path_dim_to_depth_32(card):
    """1280x720 at 65,536 spp: 19 base-4 digits, 38 generator-matrix rows."""
    cfg = sobol.make_zsobol(1280, 720, 65536, seed=2**32 - 1)
    assert min(2 * cfg.n_base4_digits, sobol.SOBOL_MATRIX_SIZE) > 32
    _check_path(cfg, *_edge_and_random_lanes(1280, 720, 65536, n=2048, seed=3), range(32),
                "every dim")


@pytest.mark.cuda
@pytest.mark.parametrize("index", ["contiguous", "expanded"])
def test_kernel_equals_plain_on_a_wavefront_of_random_lanes(card, index):
    """3.69 M lanes (a 4-sample wavefront at 1280x720), as the final
    render's lanes are laid out, and as one render_sample pass's
    (px, py) with one sample index expanded over them."""
    w, h, spp = 1280, 720, 256
    n = 4 * w * h
    rng = np.random.RandomState(17)
    px, py = (torch.from_numpy(rng.randint(0, m, n).astype(np.int64)).to(DEV) for m in (w, h))
    if index == "contiguous":
        si = torch.from_numpy(rng.randint(0, spp, n).astype(np.int64)).to(DEV)
    else:
        si = torch.tensor(spp - 1, device=DEV).expand(n)
        assert sobol.flat_lanes(px, py, si)[1][2].stride(0) == 0
    cfg = sobol.make_zsobol(w, h, spp, seed=2**32 - 1)
    _check_camera(cfg, px, py, si, index)
    for depth, local in ((0, 0), (0, 1), (0, 3), (4, 5), (4, 6)):
        _assert_bits_equal(sobol.path_sample_1d(cfg, px, py, si, depth, local),
                           sobol.sample_1d(cfg, px, py, si, 6 + depth * 11 + local),
                           f"{index} 1d ({depth}, {local})")
        for a, b in zip(sobol.path_sample_2d(cfg, px, py, si, depth, local),
                        sobol.sample_2d(cfg, px, py, si, 6 + depth * 11 + local)):
            _assert_bits_equal(a, b, f"{index} 2d ({depth}, {local})")


@pytest.mark.cuda
def test_plain_on_the_card_equals_plain_on_the_cpu(card):
    cfg = sobol.make_zsobol(1280, 720, 65536, seed=7)
    lanes = _edge_and_random_lanes(1280, 720, 65536, n=1024, seed=1)
    cpu = tuple(t.cpu() for t in lanes)
    for dim in (1, 3, 6 + 31 * 11 + 10):
        _assert_bits_equal(sobol.sample_1d(cfg, *lanes, dim).cpu(),
                           sobol.sample_1d(cfg, *cpu, dim), f"1d dim {dim}")
        for a, b in zip(sobol.sample_2d(cfg, *lanes, dim), sobol.sample_2d(cfg, *cpu, dim)):
            _assert_bits_equal(a.cpu(), b, f"2d dim {dim}")


@pytest.mark.cuda
def test_traced_calls_count_kernel_dims_and_no_sync(card):
    cfg = sobol.make_zsobol(1280, 720, 256, seed=5)
    px, py, si = _edge_and_random_lanes(1280, 720, 256, n=4096)
    _build.reset_counts()
    profiling.reset()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        sobol.compute_pixel_sample(cfg, px, py, si)
        sobol.path_sample_1d(cfg, px, py, si, 0, 0)
        sobol.path_sample_2d(cfg, px, py, si, 0, 1)
        torch.cuda.synchronize()
    counters = profiling.recorded()["counters"]
    profiling.reset()
    assert _build.launches == {"zsobol": 3}
    assert "host_syncs" not in counters, counters["host_syncs"]


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    cfg = sobol.make_zsobol(64, 64, 4)
    _, lanes = sobol.flat_lanes(*(torch.arange(8, device=DEV) for _ in range(3)))
    draws = sobol.draws_1d(cfg, 6) * (sobol.MAX_DRAWS + 1)
    outs = [torch.empty(8, device=DEV) for _ in draws]
    with pytest.raises(ValueError, match="draws"):
        sobol.draw_kernel(cfg, lanes, draws, outs)
    with pytest.raises(ValueError, match="float32"):
        sobol.draw_kernel(cfg, lanes, draws[:1], [torch.empty(8, device=DEV).double()])
    regs, _, blocks = sobol.kernel_attributes()
    assert regs > 0 and blocks >= 1
