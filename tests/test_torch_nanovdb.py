"""Port parity for sparse NanoVDB volumes: .nvdb files, brick reads, renders.

* files: a grid written by the port's save_nanovdb has the JAX package's
  bytes, and each package reads the other's file to the same dense grid,
  brick table and pool and world box (exact), on the JAX package's own
  cases (tests/test_nanovdb.py): sparse blobs, one non-empty leaf of 512,
  and an active constant lower tile;
* brick reads: medium_properties on a packed [dense, brick] pair of the
  same file equals the JAX package's at 512 seeded interior points, exact
  and stochastic one-corner reads, within 1e-6 relative; the brick and
  dense readings agree within 1e-3 (the JAX package's own test);
* pack_media: the brick page table, pool, offsets, background and
  majorant cells equal the JAX package's (exact);
* a 1024^3 index space (a 128^3 page table) holding two bricks stays
  sparse (1024 pool values), delta tracking passes the empty middle and
  is stopped by a corner brick, and the port's tracking equals the JAX
  package's on the same lanes and LCG streams;
* a tiny render of a brick cloud (8x8, depth 4, 2 samples) equals the JAX
  package's lane for lane with both packages' LCG seeded from rays rounded
  to 1/256 (as tests/test_torch_media_render.py), and the JAX scene
  carried over by scene/bridge.py has the port's brick tables;
* slow: the sparse cloud's 32x32 depth-12 16-sample probe against the JAX
  package's six-draw mean in hikari_tpu_torch/data/probe_ref.json (rays
  0.5%, mean RGB 10%), and its dense twin against it likewise.
"""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu_torch as hk
from hikari_tpu.media import nanovdb as jnv
from hikari_tpu.media import sample as jms
from hikari_tpu.media import types as jmed
from hikari_tpu.spectral.rgb2spec import srgb_table as j_table
from hikari_tpu_torch.media import nanovdb as tnv
from hikari_tpu_torch.media import sample as tms
from hikari_tpu_torch.media import types as tmed
from hikari_tpu_torch.spectral.rgb2spec import srgb_table as t_table
from test_torch_media import _jax_media_arrays
from test_torch_scene import F32_RTOL

N_POINTS = 512


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _blobs():
    rng = np.random.RandomState(0)
    d = np.zeros((24, 20, 16), np.float32)
    d[2:10, 3:9, 4:12] = rng.rand(8, 6, 8).astype(np.float32)
    d[16:22, 12:18, 2:8] = rng.rand(6, 6, 6).astype(np.float32) * 2.0
    return d, dict(origin=(-1, 0, 2), extent=(2, 2.5, 3))


def _one_leaf():
    d = np.zeros((64, 64, 64), np.float32)
    d[0:8, 0:8, 0:8] = 1.0
    return d, {}


def _blob_dense(n=40):
    """tests/test_nanovdb.py's two Gaussian blobs, cut below 0.02."""
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / (n - 1)
    d = np.exp(-60.0 * ((x - 0.3) ** 2 + (y - 0.5) ** 2 + (z - 0.6) ** 2))
    d = d + np.exp(-80.0 * ((x - 0.75) ** 2 + (y - 0.25) ** 2 + (z - 0.3) ** 2))
    d[d < 0.02] = 0.0
    return d.astype(np.float32)


def _equal_reads(buf, md):
    """to_dense and to_bricks of both packages on one node buffer."""
    for j, t in zip(jnv.to_dense(buf, dict(md)), tnv.to_dense(buf, dict(md))):
        if isinstance(j, dict):
            continue
        np.testing.assert_array_equal(t, j)
    for j, t in zip(jnv.to_bricks(buf, dict(md)), tnv.to_bricks(buf, dict(md))):
        if isinstance(j, dict):
            continue
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("case", [_blobs, _one_leaf], ids=["blobs", "one leaf"])
def test_nvdb_files_are_interchangeable(case, tmp_path):
    d, kw = case()
    jp, tp = tmp_path / "jax.nvdb", tmp_path / "port.nvdb"
    jnv.save_nanovdb(str(jp), d, **kw)
    tnv.save_nanovdb(str(tp), d, **kw)
    assert tp.read_bytes() == jp.read_bytes()
    jbuf, md = jnv.build_nanovdb(d, **kw)
    tbuf, tmd = tnv.build_nanovdb(d, **kw)
    assert tbuf == jbuf and md["leaf_count"] == tmd["leaf_count"]
    _equal_reads(jbuf, md)
    # each package reads the other's file
    for path in (jp, tp):
        for j, t in zip(jnv.load_nanovdb(str(path)), tnv.load_nanovdb(str(path))):
            np.testing.assert_array_equal(t, j)
        for j, t in zip(jnv.load_nanovdb_sparse(str(path)), tnv.load_nanovdb_sparse(str(path))):
            np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    dense, _, _ = tnv.load_nanovdb(str(jp))
    if case is _one_leaf:  # the empty leaves are neither stored nor read back
        assert md["leaf_count"] == md["lower_count"] == md["upper_count"] == 1
        assert dense.shape == (8, 8, 8) and (dense == 1.0).all()
    else:
        np.testing.assert_array_equal(dense[:d.shape[0], :d.shape[1], :d.shape[2]], d)


def test_constant_lower_tile_reads_alike():
    """An active constant lower tile (a value, no child) in the node buffer:
    both packages fill it the same way, densely and as a shared brick."""
    dense = np.random.RandomState(0).rand(16, 16, 16).astype(np.float32)
    buf, md = jnv.build_nanovdb(dense)
    buf = bytearray(buf)
    m = (24 >> 3) << 8  # the lower node's entry of the leaf region at x = 24
    lo = md["lower_offset"]
    buf[lo + jnv.LOWER_VALUEMASK_OFF + m // 8] |= 1 << (m % 8)
    tbl = lo + jnv.LOWER_TABLE_OFF + m * 8
    buf[tbl:tbl + 4] = np.float32(5.0).tobytes()
    buf[md["root_offset"]:md["root_offset"] + 24] = np.asarray(
        [0, 0, 0, 31, 15, 15], np.int32).tobytes()
    _equal_reads(bytes(buf), md)
    out, imin, imax, _ = tnv.to_dense(bytes(buf), dict(md))
    assert imax[0] - imin[0] == 32 and np.allclose(out[0:8, 0:8, 24:32], 5.0)
    table, bricks, *_ = tnv.to_bricks(bytes(buf), dict(md))
    assert (bricks[table[0, 0, 3]] == 5.0).all()


@pytest.fixture(scope="module")
def blob_pair(tmp_path_factory):
    """[dense, brick] media of one blob file, packed by both packages."""
    path = str(tmp_path_factory.mktemp("nvdb") / "blob.nvdb")
    tnv.save_nanovdb(path, _blob_dense(), origin=(0, 0, 0), extent=(1, 1, 1))
    kw = dict(sigma_s=(1.0, 0.8, 0.6), sigma_a=(0.1,) * 3, g=0.5)
    media = {pkg: [pkg_nv.nanovdb_medium(path, sparse=False, **kw),
                   pkg_nv.nanovdb_medium(path, sparse=True, **kw)]
             for pkg, pkg_nv in (("jax", jnv), ("port", tnv))}
    assert isinstance(media["port"][1], tmed.BrickGridMedium)
    return jmed.pack_media(media["jax"]), tmed.pack_media(media["port"])


def test_pack_media_brick_tables(blob_pair):
    jb, tb = blob_pair
    assert tb.has_brick and tb.has_grid and not tb.has_rgb
    for f in fields(tmed.MediumBanks):
        got = getattr(tb, f.name)
        if f.name == "has_rgb":
            continue
        want = getattr(jb, f.name)
        if not isinstance(got, torch.Tensor):
            assert got == want, f.name
        elif f.name.endswith("_c4"):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL,
                                       atol=1e-7, err_msg=f.name)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f.name)
    assert int(tb.med_type[1]) == tmed.BRICK and tb.brick_vals.numel() > 512


@pytest.mark.parametrize("stochastic", [False, True], ids=["exact", "stochastic"])
def test_brick_density_matches_jax(blob_pair, stochastic):
    jb, tb = blob_pair
    rng = np.random.RandomState(0)
    pts = rng.uniform(0.1, 0.9, (N_POINTS, 3)).astype(np.float32)
    lam = np.tile(np.asarray([[500.0, 550.0, 600.0, 650.0]], np.float32), (N_POINTS, 1))
    u3 = rng.rand(N_POINTS, 3).astype(np.float32) if stochastic else None
    ss = {}
    for which in (0, 1):
        mi = np.full(N_POINTS, which, np.int32)
        want = jms.medium_properties(jb, j_table(), jnp.asarray(mi), jnp.asarray(pts),
                                     jnp.asarray(lam), None if u3 is None else jnp.asarray(u3))
        got = tms.medium_properties(tb, t_table(), _t(mi), _t(pts), _t(lam),
                                    None if u3 is None else _t(u3))
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_RTOL, atol=1e-7)
        ss[which] = got[1].numpy()
        assert np.isfinite(ss[which]).all() and ss[which].max() > 0.1
    # the brick reads equal the dense ones of the same file
    assert np.abs(ss[0] - ss[1]).max() < 1e-3, np.abs(ss[0] - ss[1]).max()
    for name, fn in (("grid", "_grid_density"), ("brick", "_brick_density")):
        mi = np.full(N_POINTS, 0 if name == "grid" else 1, np.int32)
        args = (_t(mi), _t(pts), None if u3 is None else _t(u3))
        jargs = (jnp.asarray(mi), jnp.asarray(pts), None if u3 is None else jnp.asarray(u3))
        np.testing.assert_allclose(getattr(tms, fn)(tb, *args).numpy(),
                                   np.asarray(getattr(jms, fn)(jb, *jargs)), rtol=F32_RTOL,
                                   atol=1e-7, err_msg=name)


def _corner_bricks(pkg, nb=128):
    """Two opaque bricks at opposite corners of an (8 nb)^3 index space."""
    table = np.full((nb, nb, nb), -1, np.int32)
    table[0, 0, 0] = 0
    table[-1, -1, -1] = 1
    return pkg.BrickGridMedium(table=table, bricks=np.full((2, 512), 8.0, np.float32),
                               bounds_lo=(0, 0, 0), bounds_hi=(1, 1, 1),
                               sigma_a=(2000.0,) * 3, sigma_s=(0.0,) * 3)


def test_large_index_space_stays_sparse():
    tb = tmed.pack_media([_corner_bricks(tmed)])
    jb = jmed.pack_media([_corner_bricks(jmed)])
    assert tb.brick_vals.numel() == 2 * 512 and tb.brick_table.numel() == 128 ** 3
    assert tb.grid_res.tolist() == [[1024, 1024, 1024]]
    n = 64
    lam = np.tile(np.asarray([[500.0, 550.0, 600.0, 650.0]], np.float32), (n, 1))
    blob = 8.0 / 1024.0  # the corner brick's world extent
    for cx, spread, want in ((0.5, 0.1, "passes"), (0.0, blob * 0.5, "stops")):
        rs = np.random.RandomState(7)
        o = np.zeros((n, 3), np.float32)
        o[:, 0] = cx + rs.uniform(0, spread, n)
        o[:, 1] = cx + rs.uniform(0, spread, n)
        o[:, 2] = -0.1 - rs.uniform(0, 0.01, n)
        d = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (n, 1))
        t_max = np.full(n, 1.3, np.float32)
        ones = np.ones((n, 4), np.float32)
        active, mdh = np.ones(n, bool), np.zeros(n, bool)
        js = np.asarray(jms.delta_track(
            jb, j_table(), *(jnp.asarray(x) for x in (np.zeros(n, np.int32), o, d, t_max, lam,
                                                       ones, ones, ones, active, mdh))).status)
        ts = tms.delta_track(tb, t_table(), *(_t(x) for x in (np.zeros(n, np.int32), o, d,
                                                              t_max, lam, ones, ones, ones,
                                                              active, mdh))).status.numpy()
        assert (ts == js).mean() >= 0.98, (ts, js)
        through = float(np.mean(ts != tms.ABSORBED))
        assert (through > 0.98) if want == "passes" else (through < 0.2), (want, through)


def _brick_cloud(pkg, nv, path):
    """A floor and a 24^3 cloud read back sparse from an .nvdb file in an
    Interface box, under a point light, through package pkg's API."""
    nv.save_nanovdb(path, pkg.generate_cloud_density(24), origin=(-1, 0.2, -1),
                    extent=(2, 1.2, 2))
    cloud = nv.nanovdb_medium(path, sigma_s=(6.0,) * 3, sigma_a=(0.3,) * 3, g=0.8,
                              sparse=True)
    s = pkg.Scene()
    s.add(pkg.make_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4)),
          pkg.Matte(kd=(0.5, 0.5, 0.5)))
    s.add(pkg.make_box((-1, 0.2, -1), (1, 1.4, 1)), pkg.Interface(), inside_medium=cloud)
    s.add_light(pkg.PointLight(position=(2, 3, -2), intensity=(30, 30, 30)))
    return s


def test_brick_cloud_render_equals_jax_on_shared_streams(tmp_path, monkeypatch):
    import hikari_tpu as jhk
    from hikari_tpu.integrators.volpath import render_lanes as j_render_lanes
    from hikari_tpu_torch.scene.bridge import scene_from_numpy

    res, depth, spp, q = 8, 4, 2, 256.0
    j_init, t_init = jms.lcg_init, tms.lcg_init
    monkeypatch.setattr(jms, "lcg_init", lambda o, d, t: j_init(
        jnp.round(o * q) / q, jnp.round(d * q) / q, jnp.ones_like(t)))
    monkeypatch.setattr(tms, "lcg_init", lambda o, d, t: t_init(
        torch.round(o * q) / q, torch.round(d * q) / q, torch.ones_like(t)))
    js = _brick_cloud(jhk, jnv, str(tmp_path / "jax.nvdb")).build()
    ts = _brick_cloud(hk, tnv, str(tmp_path / "port.nvdb")).build(device="cpu")
    assert ts.media.has_brick and not ts.media.has_grid
    # the JAX scene carried over holds the port's brick tables
    bs = scene_from_numpy(_jax_media_arrays(js), "cpu")
    for name in ("brick_table", "brick_vals", "brick_tab_off", "brick_base", "grid_res"):
        assert torch.equal(getattr(bs.media, name), getattr(ts.media, name)), name
    assert bs.media.has_brick
    lanes = np.arange(res * res)
    si = np.repeat(np.arange(spp), res * res)
    px, py = np.tile(lanes % res, spp), np.tile(lanes // res, spp)
    eye, at = (0.0, 1.0, -3.5), (0.0, 0.8, 0.0)
    jcam = jhk.make_perspective_camera(eye, at, (res, res), fov_deg=45.0)
    jvp = jhk.VolPath(max_depth=depth, samples_per_pixel=spp)
    jrgb, _, jst = jax.jit(lambda a, b, c: j_render_lanes(
        jvp, js, jcam, jhk.make_filter(), a, b, c))(
        *(jnp.asarray(x, jnp.uint32) for x in (si, px, py)))
    trgb, _, tst = hk.render_lanes(
        hk.VolPath(max_depth=depth, samples_per_pixel=spp), ts,
        hk.make_perspective_camera(eye, at, (res, res), fov_deg=45.0), hk.make_filter(),
        *(torch.from_numpy(x) for x in (si, px, py)))
    j, t = np.asarray(jrgb, np.float64), trgb.numpy().astype(np.float64)
    jrays, trays = float(jst["rays_traced"]), float(tst["rays_traced"])
    assert abs(trays - jrays) <= 1e-3 * jrays, (trays, jrays)
    close = np.isclose(t, j, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, (close.mean(), np.abs(t - j).max())
    assert abs(t.mean() - j.mean()) <= 1e-3 * j.mean(), (t.mean(), j.mean())
    assert j.mean() > 0.01


@pytest.mark.slow
@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense twin"])
def test_sparse_cloud_probe(dense):
    from hikari_tpu_torch.scenes import check_transport, sparse_cloud_scene

    ok, msg = check_transport(sparse_cloud_scene(dense=dense).build(device="cpu"),
                              "sparse_cloud")
    assert ok, msg
