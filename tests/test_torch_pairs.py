"""Port parity: the pair-grid sweeps (K5/K6) and the traversal modes.

* The plain pair-grid sweeps (the kernels' CPU versions) against the Pallas
  pair kernels ``_closest_pairs_kernel`` / ``_occlusion_pairs_kernel`` run
  in interpret mode through ``_sweep_chunks`` on the port's pair list.
* closest_hit_packets / any_hit_packets against the JAX packet engine in
  interpret mode under each traversal mode: the pair grid
  (``SWEEP_MODE="pairs"``), the banded two-pass closest hit, reversed
  shadow rays and presorted lanes.

The scene and rays are test_torch_wavefront.py's (~2k random triangles, 8
treelets; camera rays, random bounce rays and inactive lanes). Tolerances
are that file's: winner (or occlusion flag) equal on >= 99.5% of live
lanes, t within 1e-5 relative where tri is equal. The differences allowed
for are edge flips: the JAX kernels evaluate the affine form through a
3-way bf16 split and divide through an approximate reciprocal with one
Newton step, the port in float32 with an IEEE divide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.geometry import wavefront as jwf
from hikari_tpu_torch.geometry import sweep, sweep_pairs
from hikari_tpu_torch.geometry import wavefront as twf
from test_torch_wavefront import AGREE, _check_hits, _jax_pairs, _torch, setup  # noqa: F401

N = 4096


@pytest.fixture
def jax_pairs_mode(monkeypatch):
    """The JAX engine in pair-grid mode: its jitted functions read
    SWEEP_MODE while tracing, so the caches are cleared around the change."""
    jax.clear_caches()
    monkeypatch.setattr(jwf, "SWEEP_MODE", "pairs")
    yield
    monkeypatch.setattr(jwf, "SWEEP_MODE", "tile")
    jax.clear_caches()


def _world(s):
    return _torch(*s["world"])


def test_plain_closest_pairs_matches_pallas_interpret(setup):
    s = setup
    o, d, act = _torch(s["o"], s["d"], s["active"])
    ps = twf.prepare_closest(s["ttl"], o, d, torch.full((N,), float("inf")), *_world(s),
                             active=act)
    key0, tr0 = twf.closest_carry(ps)
    stats = {}
    key, tr = sweep_pairs.closest_pairs_plain(ps.os, ps.ds, key0, tr0, ps.tre, ps.tn_bits,
                                              ps.seg, s["ttl"].coef, stats)
    meta, _, tn, a6, d6, n_tiles = _jax_pairs(ps)
    jkey, jtr = (np.asarray(x).reshape(-1) for x in jwf._sweep_chunks(
        jwf._closest_pairs_kernel, meta, meta.shape[0], tn, a6, d6,
        (jnp.asarray(key0.numpy()), jnp.asarray(tr0.numpy())), [], s["jtl"], n_tiles,
        True))
    live = ps.ts.numpy() > 0
    same = (tr.numpy() == jtr) & ((key.numpy() & 255) == (jkey & 255))
    assert same[live].mean() >= AGREE, f"{(~same & live).sum()} of {live.sum()} differ"
    assert (tr.numpy()[live] >= 0).mean() > 0.3  # the wavefront does hit
    # the counts the bound is reckoned from: sweeps made, tests they need
    assert 0 < stats["pairs"] <= ps.tre.numel()
    assert 0 < stats["tests"] <= stats["pairs"] * 1024 * 256


def test_plain_occlusion_pairs_matches_pallas_interpret(setup):
    s = setup
    o, d, act, tmax = _torch(s["o"], s["d"], s["active"], s["t_shadow"])
    ps = twf.prepare_occlusion(s["ttl"], o, d, tmax, *_world(s), active=act)
    occ0 = (ps.ts <= 0.0).to(torch.int32)
    occ = sweep_pairs.occlusion_pairs_plain(ps.os, ps.ds, ps.ts, occ0, ps.tre,
                                            ps.tn_bits, ps.seg, s["ttl"].coef)
    meta, _, tn, a6, d6, n_tiles = _jax_pairs(ps)
    (jocc,) = jwf._sweep_chunks(
        jwf._occlusion_pairs_kernel, meta, meta.shape[0], tn, a6, d6,
        (jnp.asarray(occ0.numpy()),), [jnp.asarray(ps.ts.numpy())], s["jtl"], n_tiles,
        True)
    live = ps.ts.numpy() > 0
    same = occ.numpy() == np.asarray(jocc).reshape(-1)
    assert same[live].mean() >= AGREE
    assert 0.05 < occ.numpy()[live].mean() < 0.95


def test_pair_schedule_is_rank_major():
    seg = torch.tensor([0, 3, 3, 5, 9], dtype=torch.int32)
    tile, order = sweep.pair_schedule(seg, 9)
    assert tile.tolist() == [0, 0, 0, 2, 2, 3, 3, 3, 3]
    # rank 0 of tiles 0, 2, 3, then rank 1 of each, ...
    assert order.tolist() == [0, 3, 5, 1, 4, 6, 2, 7, 8]


def _live_first(s):
    """The rays sorted as the resident loop sorts them: live lanes first,
    by ray_sort_keys."""
    o, d, act = _torch(s["o"], s["d"], s["active"])
    keys = torch.clamp(twf.ray_sort_keys(o, d, *_world(s)), max=0xFFFFFFFE)
    order = torch.sort(torch.where(act, keys, 0xFFFFFFFF), stable=True).indices.numpy()
    return s["o"][order], s["d"][order], s["active"][order]


@pytest.mark.parametrize("mode", ["pairs", "band", "presorted"])
def test_closest_hit_packets_modes_match_jax(setup, mode, request, monkeypatch):
    s = setup
    o, d, act = _live_first(s) if mode == "presorted" else (s["o"], s["d"], s["active"])
    kw, jkw = {}, {}
    if mode == "pairs":
        request.getfixturevalue("jax_pairs_mode")
        monkeypatch.setattr(twf, "SWEEP_MODE", "pairs")
    if mode == "band":  # a finite band: 0.15 of the world diagonal
        band = 0.15 * float(np.linalg.norm(s["world"][1] - s["world"][0]))
        kw["band"], jkw["band"] = torch.tensor(band, dtype=torch.float32), jnp.float32(band)
    if mode == "presorted":
        kw["presorted"] = jkw["presorted"] = True
    rec = twf.closest_hit_packets(s["ttl"], *_torch(o, d), torch.full((N,), float("inf")),
                                  *_world(s), active=torch.from_numpy(act), **kw)
    jrec = jwf.closest_hit_packets(s["jtl"], jnp.asarray(o), jnp.asarray(d),
                                   jnp.full((N,), jnp.inf), jnp.asarray(s["world"][0]),
                                   jnp.asarray(s["world"][1]), interpret=True,
                                   active=jnp.asarray(act), **jkw)
    _check_hits(rec, np.asarray(jrec.tri), np.asarray(jrec.t), act)
    assert (rec.tri.numpy()[act] >= 0).mean() > 0.3


@pytest.mark.parametrize("mode", ["pairs", "reverse"])
def test_any_hit_packets_modes_match_jax(setup, mode, request, monkeypatch):
    s = setup
    if mode == "pairs":
        request.getfixturevalue("jax_pairs_mode")
        monkeypatch.setattr(twf, "SWEEP_MODE", "pairs")
    group = (np.arange(N) % 3).astype(np.int32)
    occ = twf.any_hit_packets(s["ttl"], *_torch(s["o"], s["d"], s["t_shadow"]),
                              *_world(s), active=torch.from_numpy(s["active"]),
                              group=torch.from_numpy(group), reverse=mode == "reverse")
    jocc = jwf.any_hit_packets(s["jtl"], jnp.asarray(s["o"]), jnp.asarray(s["d"]),
                               jnp.asarray(s["t_shadow"]), jnp.asarray(s["world"][0]),
                               jnp.asarray(s["world"][1]), interpret=True,
                               active=jnp.asarray(s["active"]), group=jnp.asarray(group),
                               reverse=mode == "reverse")
    occ = occ.numpy()
    assert (occ == np.asarray(jocc)).mean() >= AGREE
    assert not occ[~s["active"]].any()
    assert 0.05 < occ[s["active"]].mean() < 0.95


def test_reverse_shadows_agree_with_forward(setup):
    """Occlusion over an open segment is symmetric: the reversed rays find
    the forward rays' occluders (the two shave 1e-4 of the segment at
    opposite ends, which flips a few grazing lanes)."""
    s = setup
    args = (s["ttl"], *_torch(s["o"], s["d"], s["t_shadow"]), *_world(s))
    act = torch.from_numpy(s["active"])
    fwd = twf.any_hit_packets(*args, active=act, reverse=False).numpy()
    rev = twf.any_hit_packets(*args, active=act, reverse=True).numpy()
    assert (fwd == rev).mean() >= AGREE


@pytest.mark.cuda
def test_cuda_pair_sweeps_match_plain(setup):
    """On the card: both pair-grid kernels against their plain versions, bit
    for bit (the grid body of csrc/sweep_grid.cuh with PairHit, which
    rounds as _block_hit_pairs does)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pair-grid kernels have no CPU mode")
    s = setup
    dev = torch.device("cuda")
    tl = s["ttl"].to(dev)
    o, d, act, tmax = (x.to(dev) for x in _torch(s["o"], s["d"], s["active"],
                                                 s["t_shadow"]))
    wl, wh = (x.to(dev) for x in _world(s))
    ps = twf.prepare_closest(tl, o, d, torch.full((N,), float("inf"), device=dev), wl, wh,
                             active=act)
    args = (ps.os, ps.ds, *twf.closest_carry(ps), ps.tre, ps.tn_bits, ps.seg, tl.coef)
    (key_k, tr_k) = sweep_pairs.closest_pairs(*args)
    (key_p, tr_p) = sweep_pairs.closest_pairs_plain(*args)
    assert torch.equal(key_k, key_p) and torch.equal(tr_k, tr_p)
    assert float((tr_k[ps.ts > 0] >= 0).float().mean()) > 0.3  # the wavefront does hit
    ps = twf.prepare_occlusion(tl, o, d, tmax, wl, wh, active=act)
    args = (ps.os, ps.ds, ps.ts, (ps.ts <= 0).to(torch.int32), ps.tre, ps.tn_bits,
            ps.seg, tl.coef)
    # the concurrent early-out is exact for occlusion (csrc/sweep_grid.cuh)
    assert torch.equal(sweep_pairs.occlusion_pairs(*args),
                       sweep_pairs.occlusion_pairs_plain(*args))
