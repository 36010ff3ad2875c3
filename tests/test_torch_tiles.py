"""The pair-grid design of the tile sweeps (K1/K2), pinned on the CPU.

The CUDA kernels in ``csrc/sweep_tiles.cu`` run one block per (tile,
treelet) pair in no order and merge into a per-lane carry; each (ray,
triangle) first goes through a divide-free pre-test. None of that runs
without a card, so these tests hold the design's three claims against the
plain walk on the scene and rays of test_torch_wavefront.py:

* the pre-test (its PyTorch mirror ``sweep.may_hit_plain``) refuses no
  (ray, triangle) that the plain hit test accepts, on the seeded wavefronts
  and on rays built to graze triangle edges, corners and planes;
* the closest sweep's 64-bit word order, minimised over every listed pair
  without any early-out, is the walk's rule: the two differ only where two
  hits tie in the key's upper 24 bits;
* the occlusion union over every pair whose entry distance lies before the
  lane's reach is the walk's result exactly.

Also here: the build digest covers the headers beside a source.
"""

import numpy as np
import pytest
import torch

from hikari_tpu_torch import _build
from hikari_tpu_torch.geometry import sweep
from hikari_tpu_torch.geometry import wavefront as twf
from test_torch_pairs import _live_first
from test_torch_wavefront import _torch, setup  # noqa: F401

N = 4096
COL_MASK = sweep.COL_MASK


def _closest_ps(s, presorted=False, band=None):
    o, d, act = _live_first(s) if presorted else (s["o"], s["d"], s["active"])
    return twf.prepare_closest(s["ttl"], *_torch(o, d), torch.full((N,), float("inf")),
                               *_torch(*s["world"]), active=torch.from_numpy(act),
                               presorted=presorted, band=band)


def _occlusion_ps(s):
    o, d, act, tmax = _torch(s["o"], s["d"], s["active"], s["t_shadow"])
    return twf.prepare_occlusion(s["ttl"], o, d, tmax, *_torch(*s["world"]), active=act)


def _pairs(ps, coef):
    """Every listed pair: (tile, rank in the tile's segment, t, hit), t and
    hit of (1024, 256), from the plain hit test."""
    n_tiles = ps.seg.numel() - 1
    o_t, d_t = ps.os.view(n_tiles, 1024, 3), ps.ds.view(n_tiles, 1024, 3)
    for tile in range(n_tiles):
        for p in range(int(ps.seg[tile]), int(ps.seg[tile + 1])):
            t, hit = sweep._block_hit(o_t[tile:tile + 1], d_t[tile:tile + 1],
                                      coef[ps.tre[p].long()][None])
            yield tile, p - int(ps.seg[tile]), p, t[0], hit[0]


# --- (a) the pre-test is conservative ---------------------------------------------


@pytest.mark.parametrize("which", ["closest", "occlusion"])
def test_pretest_keeps_every_plain_hit_of_the_wavefront(setup, which):
    s = setup
    if which == "closest":
        ps = _closest_ps(s)
        # the far limit of the carried key: its t rounded up
        t_far = (twf.closest_carry(ps)[0] | COL_MASK).view(torch.float32)
    else:
        ps = _occlusion_ps(s)
        t_far = ps.ts
    hits, drops = sweep.pretest_drops(ps.os, ps.ds, t_far, ps.tre, ps.seg, s["ttl"].coef)
    assert hits > 1000
    assert drops == 0


def _grazing_rays(tri, rng):
    """Rays aimed at the edges and corners of each triangle (on them and
    2e-6 of the barycentric range to either side, where the hit test's eps
    = 1e-6 decides), and rays that meet the triangle's plane at 1e-4 to 1e-2
    rad. tri: (K, 9) [p0 | e1 | e2] -> origins, directions (K, L, 3) and the
    hit distance aimed for (K, L)."""
    p0, e1, e2 = tri[:, None, 0:3], tri[:, None, 3:6], tri[:, None, 6:9]
    k = tri.shape[0]
    s = rng.rand(k, 12).astype(np.float32)
    z = np.zeros_like(s)
    uv = np.concatenate([np.stack([s, z], -1), np.stack([z, s], -1),
                         np.stack([s, 1 - s], -1)], 1)          # on the three edges
    corners = np.broadcast_to(np.array([[0, 0], [1, 0], [0, 1]], np.float32), (k, 3, 2))
    uv = np.concatenate([uv, corners], 1)
    inward = np.float32(1 / 3) - uv
    uv = np.concatenate([uv + e * inward for e in (-2e-6, 0.0, 2e-6)], 1)
    target = p0 + uv[..., 0:1] * e1 + uv[..., 1:2] * e2
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    # steep and shallow approaches to the edge points
    lanes = target.shape[1]
    dirs = rng.randn(k, lanes, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dist = (rng.rand(k, lanes, 1) * 4 + 0.5).astype(np.float32)
    o_edge = target - dirs * dist
    # plane-grazing: towards a point inside, along the plane plus a sliver of normal
    inside = p0 + 0.3 * e1 + 0.3 * e2
    along = e1 / np.linalg.norm(e1, axis=-1, keepdims=True)
    angle = (10.0 ** -(2 + 2 * rng.rand(k, 16, 1))).astype(np.float32)
    d_graze = along + angle * n
    d_graze /= np.linalg.norm(d_graze, axis=-1, keepdims=True)
    dist_g = (rng.rand(k, 16, 1) * 4 + 0.5).astype(np.float32)
    o_graze = inside - d_graze * dist_g
    o = np.concatenate([o_edge, o_graze], 1).astype(np.float32)
    d = np.concatenate([dirs, d_graze], 1).astype(np.float32)
    return o, d, np.concatenate([dist, dist_g], 1)[..., 0].astype(np.float32)


@pytest.mark.parametrize("which", ["closest", "occlusion"])
def test_pretest_keeps_grazing_hits(setup, which):
    """Rays through edges, corners and at a sliver of an angle to the plane
    of one triangle of every treelet row sampled; each is tested against its
    triangle's whole treelet, with the far limit just behind the point aimed
    at (the tightest a sweep can hand the pre-test)."""
    ttl = setup["ttl"]
    rng = np.random.RandomState(7)
    n_treelets = ttl.coef.shape[0]
    cols = rng.randint(0, 256, size=(n_treelets, 6))
    hits = drops = 0
    for j in range(cols.shape[1]):
        slot = torch.arange(n_treelets) * 256 + torch.from_numpy(cols[:, j])
        o, d, dist = _torch(*_grazing_rays(ttl.tri[slot, :9].numpy(), rng))
        if which == "closest":
            # a carried key just behind the hit: its t rounded up to the key grid
            t_far = (dist.view(torch.int32) | COL_MASK).view(torch.float32)
        else:
            t_far = dist * (1 + 1e-5)
        t, hit = sweep._block_hit(o, d, ttl.coef)
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


# --- (b) the closest sweep's word order is the walk's rule ----------------------------


def _min_word_over_all_pairs(ps, coef, key_in, tr_in):
    """Per lane the minimum of key << 32 | rank + 1 over every listed pair,
    the carried key with low word 0: what the kernel's atomicMin merges to."""
    n_tiles = ps.seg.numel() - 1
    word = (key_in.long() << 32).view(n_tiles, 1024).clone()
    cols = torch.arange(256, dtype=torch.int32)
    for tile, rank, _, t, hit in _pairs(ps, coef):
        bits = torch.where(hit, t, sweep._MISS_T).view(torch.int32)
        key = ((bits & ~COL_MASK) | cols).amin(-1)
        word[tile] = torch.minimum(word[tile], (key.long() << 32) | (rank + 1))
    word = word.view(-1)
    low = word & 0xFFFFFFFF
    p = ps.seg[:-1].long().repeat_interleave(1024) + low - 1
    tr = torch.where(low == 0, tr_in, ps.tre[p.clamp(min=0)])
    return (word >> 32).to(torch.int32), tr


@pytest.mark.parametrize("carry", ["reach", "banded", "presorted"])
def test_closest_word_order_is_the_walks_rule(setup, carry):
    s = setup
    coef = s["ttl"].coef
    if carry == "banded":
        # the second pass of the banded closest hit: first-pass hit keys with
        # tr_in >= 0 ride in beside fresh reaches (closest_hit_packets)
        band = torch.tensor(0.15 * float(np.linalg.norm(s["world"][1] - s["world"][0])))
        ps = _closest_ps(s, band=band)
        ts1 = torch.clamp(ps.ts, max=band)
        key1, tr1 = sweep.closest_tiles_plain(
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
    key_p, tr_p = sweep.closest_tiles_plain(ps.os, ps.ds, key_in, tr_in, ps.tre,
                                            ps.tn_bits, ps.seg, coef)
    key_w, tr_w = _min_word_over_all_pairs(ps, coef, key_in, tr_in)
    same = (key_w == key_p) & (tr_w == tr_p)
    assert float(same[live].float().mean()) >= 0.9999
    assert bool(same[~live].all())
    # a lane that differs ties in the key's upper 24 bits
    assert torch.equal((key_w & ~COL_MASK)[~same], (key_p & ~COL_MASK)[~same])
    assert float((tr_p[live] >= 0).float().mean()) > 0.3


# --- (c) the occlusion union is the walk's result -------------------------------------


def test_occlusion_union_is_the_walk(setup):
    s = setup
    coef = s["ttl"].coef
    ps = _occlusion_ps(s)
    occ_in = (ps.ts <= 0.0).to(torch.int32)
    n_tiles = ps.seg.numel() - 1
    occ = occ_in.clone().view(n_tiles, 1024)
    tm = ps.ts.view(n_tiles, 1024)
    for tile, _, p, t, hit in _pairs(ps, coef):
        # a lane takes part while it is unoccluded at the start and its reach
        # lies past the pair's entry distance
        live = ((occ_in.view(n_tiles, 1024)[tile] == 0)
                & (ps.tn_bits[p] < tm[tile].view(torch.int32)))
        occ[tile] |= (live & (hit & (t < tm[tile][:, None])).any(-1)).to(torch.int32)
    walk = sweep.occlusion_tiles_plain(ps.os, ps.ds, ps.ts, occ_in, ps.tre, ps.tn_bits,
                                       ps.seg, coef)
    assert torch.equal(occ.view(-1), walk)
    assert 0.05 < float(walk[ps.ts > 0].float().mean()) < 0.95


# --- (d) the schedule, (e) the build digest -------------------------------------------


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
