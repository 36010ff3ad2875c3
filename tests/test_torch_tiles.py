"""The pair-grid design of the flat sweeps, pinned on the CPU.

The CUDA kernels of the tile sweeps (K1/K2, ``csrc/sweep_tiles.cu``) and of
the pair-grid sweeps (K5/K6, ``csrc/sweep_pairs.cu``) are one body,
``csrc/sweep_grid.cuh``, with two hit tests: ``sweep._block_hit`` and
``sweep_pairs._block_hit_pairs`` (den clamped at 1e-20). They run one block
per (tile, treelet) pair in no order and merge into a per-lane carry; each
(ray, triangle) first goes through a divide-free pre-test. None of that
runs without a card, so these tests hold the design's three claims against
the plain walk with each hit test, on the scene and rays of
test_torch_wavefront.py:

* the pre-test (its PyTorch mirror ``sweep.may_hit_plain``) refuses no
  (ray, triangle) that the plain hit test accepts, on the seeded wavefronts,
  on rays built to graze triangle edges, corners and planes, and on rows
  whose |den| lies at the pair test's clamp;
* the closest sweep's 64-bit word order, minimised over every listed pair
  without any early-out, is the walk's rule: the two differ only where two
  hits tie in the key's upper 24 bits;
* the occlusion union over every pair whose entry distance lies before the
  lane's reach is the walk's result exactly.

Also here: the test count of a closest walk reckoned from the final carry
(what bounds a kernel whose walk is too slow to run), and the build digest
covers the headers beside a source.
"""

import numpy as np
import pytest
import torch

from hikari_tpu_torch import _build
from hikari_tpu_torch.geometry import sweep, sweep_pairs
from hikari_tpu_torch.geometry import wavefront as twf
from test_torch_pairs import _live_first
from test_torch_wavefront import _torch, setup  # noqa: F401

N = 4096
COL_MASK = sweep.COL_MASK
# the two hit tests of the grid body, and their plain walks
HIT = {"tiles": sweep._block_hit, "pairs": sweep_pairs._block_hit_pairs}
CLOSEST = {"tiles": sweep.closest_tiles_plain, "pairs": sweep_pairs.closest_pairs_plain}
OCCLUSION = {"tiles": sweep.occlusion_tiles_plain,
             "pairs": sweep_pairs.occlusion_pairs_plain}


def _over_hit_tests(name, values):
    """Parametrise over `values` and the two hit tests; the tile test's
    cases keep the bare value as their id."""
    return pytest.mark.parametrize(
        f"{name}, test", [pytest.param(v, t, id=v if t == "tiles" else f"{v}-{t}")
                          for t in HIT for v in values])


def _closest_ps(s, presorted=False, band=None):
    o, d, act = _live_first(s) if presorted else (s["o"], s["d"], s["active"])
    return twf.prepare_closest(s["ttl"], *_torch(o, d), torch.full((N,), float("inf")),
                               *_torch(*s["world"]), active=torch.from_numpy(act),
                               presorted=presorted, band=band)


def _occlusion_ps(s):
    o, d, act, tmax = _torch(s["o"], s["d"], s["active"], s["t_shadow"])
    return twf.prepare_occlusion(s["ttl"], o, d, tmax, *_torch(*s["world"]), active=act)


def _pairs(ps, coef, block_hit):
    """Every listed pair: (tile, rank in the tile's segment, t, hit), t and
    hit of (1024, 256), from the plain hit test block_hit."""
    n_tiles = ps.seg.numel() - 1
    o_t, d_t = ps.os.view(n_tiles, 1024, 3), ps.ds.view(n_tiles, 1024, 3)
    for tile in range(n_tiles):
        for p in range(int(ps.seg[tile]), int(ps.seg[tile + 1])):
            t, hit = block_hit(o_t[tile:tile + 1], d_t[tile:tile + 1],
                               coef[ps.tre[p].long()][None])
            yield tile, p - int(ps.seg[tile]), p, t[0], hit[0]


# --- (a) the pre-test is conservative ---------------------------------------------


@_over_hit_tests("which", ["closest", "occlusion"])
def test_pretest_keeps_every_plain_hit_of_the_wavefront(setup, which, test):
    s = setup
    if which == "closest":
        ps = _closest_ps(s)
        # the far limit of the carried key: its t rounded up
        t_far = (twf.closest_carry(ps)[0] | COL_MASK).view(torch.float32)
    else:
        ps = _occlusion_ps(s)
        t_far = ps.ts
    hits, drops = sweep.pretest_drops(ps.os, ps.ds, t_far, ps.tre, ps.seg, s["ttl"].coef,
                                      HIT[test])
    assert hits > 1000
    assert drops == 0


@_over_hit_tests("which", ["closest", "occlusion"])
def test_pretest_keeps_grazing_hits(setup, which, test):
    """Rays through edges and corners, steeply and at a sliver of an angle
    to the plane, and rays grazing the plane towards its inside
    (``sweep.grazing_rays``), at one triangle of every treelet row sampled;
    each is tested against its triangle's whole treelet, with the far limit
    just behind the point aimed at (the tightest a sweep can hand the
    pre-test)."""
    ttl = setup["ttl"]
    rng = np.random.RandomState(7)
    n_treelets = ttl.coef.shape[0]
    cols = rng.randint(0, 256, size=(n_treelets, 6))
    hits = drops = 0
    for j in range(cols.shape[1]):
        slot = torch.arange(n_treelets) * 256 + torch.from_numpy(cols[:, j])
        o, d, dist = _torch(*sweep.grazing_rays(ttl.tri[slot, :9].numpy(), rng))
        if which == "closest":
            # a carried key just behind the hit: its t rounded up to the key grid
            t_far = (dist.view(torch.int32) | COL_MASK).view(torch.float32)
        else:
            t_far = dist * (1 + 1e-5)
        t, hit = HIT[test](o, d, ttl.coef)
        hit = hit & (t <= t_far[..., None])
        may = sweep.may_hit_plain(o, d, ttl.coef, t_far)
        hits += int(hit.sum())
        drops += int((hit & ~may).sum())
    assert hits > 500   # the rays do graze: about half of them hit
    assert drops == 0


def test_pretest_refuses_degenerate_rows():
    """All-zero (padding) rows and NaN rows fail the pre-test for every ray."""
    o = torch.tensor([[[0.0, 0.0, -1.0]]])
    d = torch.tensor([[[0.0, 0.0, 1.0]]])
    coef = torch.zeros(1, 2, 12)
    coef[0, 1] = float("nan")
    assert not sweep.may_hit_plain(o, d, coef, torch.tensor([[3.0e37]])).any()


def test_pretest_keeps_pair_hits_at_the_den_clamp():
    """Rows whose |den| lies in (0, 1e-20], where the pair test clamps den
    and refuses the hit that the tile test takes, and just above it, where
    both take it: the pre-test passes every one, so it refuses no hit of
    either test. One ray along z against planes z = 1 scaled by s (n = (0,
    0, s), dw = -s: den = s, t = 1), u = v = 1/4."""
    scales = torch.tensor([1e-22, 1e-21, 5e-21, 1e-20, 1.5e-20, 1e-19, 1e-12])
    coef = torch.zeros(1, scales.numel(), 12)
    coef[0, :, 2], coef[0, :, 3] = scales, -scales
    coef[0, :, 4], coef[0, :, 7] = 1.0, 0.25
    coef[0, :, 9], coef[0, :, 11] = 1.0, 0.25
    o = torch.tensor([[[0.0, 0.0, 0.0]]])
    d = torch.tensor([[[0.0, 0.0, 1.0]]])
    t_far = torch.tensor([[2.0]])
    above = (scales > 1e-20).tolist()
    for name, want in (("tiles", [True] * len(above)), ("pairs", above)):
        t, hit = HIT[name](o, d, coef)
        assert hit[0, 0].tolist() == want, name
        assert bool((t[0, 0][hit[0, 0]] == 1.0).all())
    assert bool(sweep.may_hit_plain(o, d, coef, t_far).all())


# --- (b) the closest sweep's word order is the walk's rule ----------------------------


def _min_word_over_all_pairs(ps, coef, key_in, tr_in, block_hit):
    """Per lane the minimum of key << 32 | rank + 1 over every listed pair,
    the carried key with low word 0: what the kernel's atomicMin merges to."""
    n_tiles = ps.seg.numel() - 1
    word = (key_in.long() << 32).view(n_tiles, 1024).clone()
    cols = torch.arange(256, dtype=torch.int32)
    for tile, rank, _, t, hit in _pairs(ps, coef, block_hit):
        bits = torch.where(hit, t, sweep._MISS_T).view(torch.int32)
        key = ((bits & ~COL_MASK) | cols).amin(-1)
        word[tile] = torch.minimum(word[tile], (key.long() << 32) | (rank + 1))
    word = word.view(-1)
    low = word & 0xFFFFFFFF
    p = ps.seg[:-1].long().repeat_interleave(1024) + low - 1
    tr = torch.where(low == 0, tr_in, ps.tre[p.clamp(min=0)])
    return (word >> 32).to(torch.int32), tr


@_over_hit_tests("carry", ["reach", "banded", "presorted"])
def test_closest_word_order_is_the_walks_rule(setup, carry, test):
    s = setup
    coef = s["ttl"].coef
    if carry == "banded":
        # the second pass of the banded closest hit: first-pass hit keys with
        # tr_in >= 0 ride in beside fresh reaches (closest_hit_packets)
        band = torch.tensor(0.15 * float(np.linalg.norm(s["world"][1] - s["world"][0])))
        ps = _closest_ps(s, band=band)
        ts1 = torch.clamp(ps.ts, max=band)
        key1, tr1 = CLOSEST[test](
            ps.os, ps.ds, twf._keyify(ts1), torch.full_like(twf._keyify(ts1), -1),
            ps.tre, ps.tn_bits, ps.seg, coef)
        done = (tr1 >= 0) | (ps.ts <= band)
        assert 0.05 < float((tr1 >= 0).float().mean()) < 0.95
        ps.tre, ps.tn_bits, ps.seg = twf.pair_list(s["ttl"], ps.os, ps.ds,
                                                   torch.where(done, 0.0, ps.ts))
        key_in, tr_in = torch.where(done, key1, twf._keyify(ps.ts)), tr1
    else:
        ps = _closest_ps(s, presorted=carry == "presorted")
        key_in, tr_in = twf.closest_carry(ps)
    live = ps.ts > 0
    if carry == "presorted":  # dead lanes ride along with key 255
        assert int((key_in[~live] == COL_MASK).sum()) >= 1024
    key_p, tr_p = CLOSEST[test](ps.os, ps.ds, key_in, tr_in, ps.tre, ps.tn_bits, ps.seg,
                                coef)
    key_w, tr_w = _min_word_over_all_pairs(ps, coef, key_in, tr_in, HIT[test])
    same = (key_w == key_p) & (tr_w == tr_p)
    assert float(same[live].float().mean()) >= 0.9999
    assert bool(same[~live].all())
    # a lane that differs ties in the key's upper 24 bits
    assert torch.equal((key_w & ~COL_MASK)[~same], (key_p & ~COL_MASK)[~same])
    assert float((tr_p[live] >= 0).float().mean()) > 0.3


# --- (c) the occlusion union is the walk's result -------------------------------------


def _occlusion_union_is_the_walk(s, test):
    coef = s["ttl"].coef
    ps = _occlusion_ps(s)
    occ_in = (ps.ts <= 0.0).to(torch.int32)
    n_tiles = ps.seg.numel() - 1
    occ = occ_in.clone().view(n_tiles, 1024)
    tm = ps.ts.view(n_tiles, 1024)
    for tile, _, p, t, hit in _pairs(ps, coef, HIT[test]):
        # a lane takes part while it is unoccluded at the start and its reach
        # lies past the pair's entry distance
        live = ((occ_in.view(n_tiles, 1024)[tile] == 0)
                & (ps.tn_bits[p] < tm[tile].view(torch.int32)))
        occ[tile] |= (live & (hit & (t < tm[tile][:, None])).any(-1)).to(torch.int32)
    walk = OCCLUSION[test](ps.os, ps.ds, ps.ts, occ_in, ps.tre, ps.tn_bits, ps.seg, coef)
    assert torch.equal(occ.view(-1), walk)
    assert 0.05 < float(walk[ps.ts > 0].float().mean()) < 0.95


def test_occlusion_union_is_the_walk(setup):
    _occlusion_union_is_the_walk(setup, "tiles")


def test_occlusion_union_is_the_pair_walk(setup):
    _occlusion_union_is_the_walk(setup, "pairs")


# --- (d) the test count from the final carry --------------------------------------------


@pytest.mark.parametrize("test", list(HIT))
def test_final_carry_count_bounds_the_walks_count(setup, test):
    """The ray-triangle tests counted from each lane's final key are at most
    the walk's count, and equal to it on a list that holds only each tile's
    first pair (no lane's carry falls before a later pair)."""
    s = setup
    coef = s["ttl"].coef
    ps = _closest_ps(s)
    key_in, tr_in = twf.closest_carry(ps)
    stats = {}
    key, _ = CLOSEST[test](ps.os, ps.ds, key_in, tr_in, ps.tre, ps.tn_bits, ps.seg, coef,
                           stats)
    final = sweep.tests_from_final(key | COL_MASK, ps.tn_bits, ps.seg)
    assert 0 < final <= stats["tests"]
    length = ps.seg[1:] - ps.seg[:-1]
    first = ps.seg[:-1][length > 0].long()
    seg1 = torch.cat([torch.zeros(1, dtype=torch.int32),
                      torch.cumsum((length > 0).to(torch.int32), 0).to(torch.int32)])
    stats = {}
    key, _ = CLOSEST[test](ps.os, ps.ds, key_in, tr_in, ps.tre[first], ps.tn_bits[first],
                           seg1, coef, stats)
    assert sweep.tests_from_final(key | COL_MASK, ps.tn_bits[first], seg1) == stats["tests"]
    assert stats["tests"] > 0


# --- (e) the schedule, (f) the build digest -------------------------------------------


def test_pair_schedule_handles_empty_segments_and_no_pairs():
    seg = torch.tensor([0, 0, 2, 2, 3], dtype=torch.int32)
    tile, order = sweep.pair_schedule(seg, 3)
    assert tile.tolist() == [1, 1, 3]
    assert order.tolist() == [0, 2, 1]
    tile, order = sweep.pair_schedule(torch.zeros(3, dtype=torch.int32), 0)
    assert tile.numel() == 0 and order.numel() == 0
    assert tile.dtype == order.dtype == torch.int32


def test_build_digest_covers_the_headers_beside_a_source(tmp_path):
    source, header = tmp_path / "k.cu", tmp_path / "k.cuh"
    source.write_text('#include "k.cuh"\n')
    header.write_text("constexpr int N = 1;\n")
    cmd = ["nvcc", "-O3"]
    first = _build.source_digest(source, cmd)
    assert first == _build.source_digest(source, cmd)
    header.write_text("constexpr int N = 2;\n")
    changed_header = _build.source_digest(source, cmd)
    assert changed_header != first
    source.write_text('#include "k.cuh"\n// edited\n')
    assert _build.source_digest(source, cmd) != changed_header
    assert _build.source_digest(source, cmd + ["-g"]) != _build.source_digest(source, cmd)


def test_the_tile_sweeps_source_includes_the_shared_header():
    """The library name must change with csrc/sweep_grid.cuh: the header is
    beside the source that includes it, where the digest looks."""
    assert '#include "sweep_grid.cuh"' in sweep._SOURCE.read_text()
    assert (sweep._SOURCE.parent / "sweep_grid.cuh").is_file()


def test_the_pair_sweeps_source_is_an_instantiation_of_the_shared_header():
    """K5/K6 are the grid body with PairHit: no kernel of their own."""
    src = sweep_pairs._SOURCE.read_text()
    assert '#include "sweep_grid.cuh"' in src
    assert "struct PairHit" in src and "__global__" not in src
    for name in ("hikari_closest_pairs", "hikari_occlusion_pairs", "hikari_pairs_attributes"):
        assert f"int {name}(" in src
