"""Port parity: packet traversal and the two treelet sweeps.

* The plain sweeps (the kernels' CPU versions) against the Pallas tile
  kernels run in interpret mode on the same pair list.
* closest_hit_packets / any_hit_packets against the JAX packet engine in
  interpret mode and against the skip-link BVH walk.

The scene is ~2k random triangles (8 treelets); the 4096 rays mix camera
rays, random bounce rays and inactive lanes. Tolerances: the winning
treelet and column (or tri) equal on >= 99.5% of lanes, t within 1e-5
relative where tri is equal, occlusion flags equal on >= 99.5%. The
differences allowed for are edge flips: the JAX kernels evaluate the
affine form through a 3-way bf16 split, the port directly in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.geometry import traverse as jtr
from hikari_tpu.geometry import wavefront as jwf
from hikari_tpu.geometry.bvh import build_bvh
from hikari_tpu_torch.geometry import sweep
from hikari_tpu_torch.geometry import wavefront as twf

AGREE = 0.995
T_RTOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    p = 2048
    c = rng.rand(p, 3).astype(np.float32) * 4 - 2
    p0, p1, p2 = (c + rng.rand(p, 3).astype(np.float32) * 0.5 for _ in range(3))
    lo, hi = np.minimum(np.minimum(p0, p1), p2), np.maximum(np.maximum(p0, p1), p2)
    fb = build_bvh(lo, hi)
    order = fb.prim_order
    p0, p1, p2 = p0[order], p1[order], p2[order]
    supers = twf.bvh_super_boxes(fb, p, prim_lo=lo[order], prim_hi=hi[order])
    jtl = jwf.build_treelets(p0, p1, p2, supers=supers)
    ttl = twf.build_treelets(p0, p1, p2, supers)
    bvh = jtr.DeviceBVH(lo=jnp.asarray(fb.lo), hi=jnp.asarray(fb.hi),
                        first=jnp.asarray(fb.first), count=jnp.asarray(fb.count),
                        skip=jnp.asarray(fb.skip), p0=jnp.asarray(p0),
                        p1=jnp.asarray(p1), p2=jnp.asarray(p2))
    world_lo, world_hi = lo.min(0), hi.max(0)

    # 1024 camera rays, 2048 bounce rays, 1024 inactive lanes
    n = 4096
    o = np.empty((n, 3), np.float32)
    d = np.empty((n, 3), np.float32)
    o[:1024] = (0.1, 0.3, -6.0)
    d[:1024] = np.stack([rng.rand(1024) * 0.8 - 0.4, rng.rand(1024) * 0.8 - 0.4,
                         np.ones(1024)], -1)
    o[1024:] = rng.rand(n - 1024, 3) * 5 - 2.5
    d[1024:] = rng.randn(n - 1024, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    active = np.ones(n, bool)
    active[3072:] = False
    perm = rng.permutation(n)
    o, d, active = o[perm], d[perm], active[perm]
    t_shadow = (rng.rand(n) * 4 + 0.5).astype(np.float32)
    return dict(jtl=jtl, ttl=ttl, bvh=bvh, world=(world_lo, world_hi), o=o, d=d,
                active=active, t_shadow=t_shadow)


def _jax_pairs(ps):
    """The port's pair list in the Pallas kernels' packed form."""
    n_tiles = ps.seg.numel() - 1
    tile = torch.repeat_interleave(torch.arange(n_tiles), (ps.seg[1:] - ps.seg[:-1]).long())
    meta = (tile.to(torch.int32) << jwf.TILE_SHIFT) | ps.tre
    a6, d6 = jwf._ray_matrices(jnp.asarray(ps.os.numpy()), jnp.asarray(ps.ds.numpy()))
    return (jnp.asarray(meta.numpy()), jnp.asarray(ps.seg.numpy()),
            jnp.asarray(ps.tn_bits.view(torch.float32).numpy()), a6, d6, n_tiles)


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def test_plain_closest_sweep_matches_pallas_interpret(setup):
    s = setup
    o, d, act = _torch(s["o"], s["d"], s["active"])
    wl, wh = _torch(*s["world"])
    ps = twf.prepare_closest(s["ttl"], o, d, torch.full((4096,), float("inf")), wl, wh,
                             active=act)
    assert ps.tre.numel() > 0
    key0, tr0 = twf.closest_carry(ps)
    key, tr = sweep.closest_tiles_plain(ps.os, ps.ds, key0, tr0, ps.tre, ps.tn_bits,
                                        ps.seg, s["ttl"].coef)
    meta, seg, tn, a6, d6, n_tiles = _jax_pairs(ps)
    jkey, jtrl = jwf._sweep_tiles(
        jwf._closest_tiles_kernel, meta, seg, tn, a6, d6,
        (jnp.asarray(key0.numpy()), jnp.asarray(tr0.numpy())), [], s["jtl"],
        n_tiles, True)
    jkey, jtrl = np.asarray(jkey).reshape(-1), np.asarray(jtrl).reshape(-1)
    live = ps.ts.numpy() > 0
    same = (tr.numpy() == jtrl) & ((key.numpy() & 255) == (jkey & 255))
    flips = int((~same & live).sum())
    assert same[live].mean() >= AGREE, f"{flips} edge flips of {live.sum()} lanes"
    assert (tr.numpy()[live] >= 0).mean() > 0.3  # the wavefront does hit


def test_plain_occlusion_sweep_matches_pallas_interpret(setup):
    s = setup
    o, d, act, tmax = _torch(s["o"], s["d"], s["active"], s["t_shadow"])
    wl, wh = _torch(*s["world"])
    ps = twf.prepare_occlusion(s["ttl"], o, d, tmax, wl, wh, active=act)
    occ0 = (ps.ts <= 0.0).to(torch.int32)
    occ = sweep.occlusion_tiles_plain(ps.os, ps.ds, ps.ts, occ0, ps.tre, ps.tn_bits,
                                      ps.seg, s["ttl"].coef)
    meta, seg, tn, a6, d6, n_tiles = _jax_pairs(ps)
    (jocc,) = jwf._sweep_tiles(
        jwf._occlusion_tiles_kernel, meta, seg, tn, a6, d6,
        (jnp.asarray(occ0.numpy()),), [jnp.asarray(ps.ts.numpy())], s["jtl"],
        n_tiles, True)
    live = ps.ts.numpy() > 0
    same = occ.numpy() == np.asarray(jocc).reshape(-1)
    assert same[live].mean() >= AGREE
    assert 0.05 < occ.numpy()[live].mean() < 0.95


def _check_hits(rec, ref_tri, ref_t, active):
    tri = rec.tri.numpy()
    same = tri == ref_tri
    assert same[active].mean() >= AGREE, f"{(~same & active).sum()} tri mismatches"
    assert (tri[~active] == -1).all()
    both = same & (tri >= 0)
    np.testing.assert_allclose(rec.t.numpy()[both], ref_t[both], rtol=T_RTOL)
    assert (rec.hit.numpy() == (tri >= 0)).all()


def test_closest_hit_packets_matches_jax(setup):
    s = setup
    o, d, act = _torch(s["o"], s["d"], s["active"])
    wl, wh = _torch(*s["world"])
    rec = twf.closest_hit_packets(s["ttl"], o, d, torch.full((4096,), float("inf")),
                                  wl, wh, active=act)
    jo, jd, ja = jnp.asarray(s["o"]), jnp.asarray(s["d"]), jnp.asarray(s["active"])
    jt_max = jnp.full((4096,), jnp.inf)
    jrec = jwf.closest_hit_packets(s["jtl"], jo, jd, jt_max, jnp.asarray(s["world"][0]),
                                   jnp.asarray(s["world"][1]), interpret=True, active=ja)
    _check_hits(rec, np.asarray(jrec.tri), np.asarray(jrec.t), s["active"])
    srec = jtr.closest_hit(s["bvh"], jo, jd, jnp.where(ja, jt_max, 0.0))
    _check_hits(rec, np.asarray(srec.tri), np.asarray(srec.t), s["active"])


@pytest.mark.parametrize("grouped", [False, True])
def test_any_hit_packets_matches_jax(setup, grouped):
    s = setup
    o, d, act, tmax = _torch(s["o"], s["d"], s["active"], s["t_shadow"])
    wl, wh = _torch(*s["world"])
    group = (np.arange(4096) % 3).astype(np.int32) if grouped else None
    occ = twf.any_hit_packets(s["ttl"], o, d, tmax, wl, wh, active=act,
                              group=None if group is None else torch.from_numpy(group))
    args = (jnp.asarray(s["o"]), jnp.asarray(s["d"]), jnp.asarray(s["t_shadow"]))
    jocc = jwf.any_hit_packets(s["jtl"], *args, jnp.asarray(s["world"][0]),
                               jnp.asarray(s["world"][1]), interpret=True,
                               active=jnp.asarray(s["active"]),
                               group=None if group is None else jnp.asarray(group))
    occ = occ.numpy()
    assert (occ == np.asarray(jocc)).mean() >= AGREE
    assert not occ[~s["active"]].any()
    # the skip-link walk tests the full segment; the packet engines shave
    # 1e-4 of it at the far end (t_max * 0.9999)
    socc = jtr.any_hit(s["bvh"], *args[:2], jnp.where(jnp.asarray(s["active"]),
                                                       args[2] * 0.9999, 0.0))
    assert (occ == np.asarray(socc)).mean() >= AGREE


@pytest.mark.cuda
def test_cuda_sweeps_match_plain(setup):
    """On the card: both kernels against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernels have no CPU mode")
    s = setup
    dev = torch.device("cuda")
    tl = s["ttl"].to(dev)
    o, d, act, tmax = (x.to(dev) for x in _torch(s["o"], s["d"], s["active"],
                                                 s["t_shadow"]))
    wl, wh = (x.to(dev) for x in _torch(*s["world"]))
    ps = twf.prepare_closest(tl, o, d, torch.full((4096,), float("inf"), device=dev),
                             wl, wh, active=act)
    args = (ps.os, ps.ds, *twf.closest_carry(ps), ps.tre, ps.tn_bits, ps.seg, tl.coef)
    (key_k, tr_k), (key_p, tr_p) = sweep.closest_tiles(*args), sweep.closest_tiles_plain(*args)
    live = ps.ts > 0
    same = (tr_k == tr_p) & ((key_k & 255) == (key_p & 255))
    assert float(same[live].float().mean()) >= 0.999
    ps = twf.prepare_occlusion(tl, o, d, tmax, wl, wh, active=act)
    args = (ps.os, ps.ds, ps.ts, (ps.ts <= 0).to(torch.int32), ps.tre, ps.tn_bits,
            ps.seg, tl.coef)
    same = sweep.occlusion_tiles(*args) == sweep.occlusion_tiles_plain(*args)
    assert float(same[ps.ts > 0].float().mean()) >= 0.999
