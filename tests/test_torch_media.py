"""Port parity: the media units (hikari_tpu_torch/media, Interface, scene media).

The same inputs, made from numpy seeds, go through the JAX function (run
eagerly on the CPU) and its port:

* the per-ray LCG: lcg_init and lcg_next bit for bit, over rays with +-0,
  denormal components and an infinite t_max;
* the HG phase function: hg_eval and hg_sample within 1e-6 relative (1e-6
  absolute on the unit vectors) for g in {-0.9, 0, 1e-4, 0.877};
* grid reads: _grid_density and _rgb_grid_trilinear, exact and
  stochastic, within 1e-6; _build_majorant_cells and pack_media's banks
  equal (uplift coefficients within 1e-6 relative, as the material banks);
* tracking: delta_track and ratio_track_tr on the same ray bits through a
  homogeneous, a density-grid, an RGB-grid and a deflected medium. Delta
  tracking's status agrees on >= 99.5% of lanes and beta, r_u, r_l and t
  agree within 1e-4 relative where it does. Ratio tracking's lanes are
  classed as transmitting (largest T above 1e-3) or not; the class agrees
  on >= 99.5% of lanes and T, r_l, r_u agree within 1e-4 relative where
  both transmit. Two cases are bounded by conditioning, not by the port:
  a homogeneous medium with its exact majorant gives sigma_n =
  sigma_maj - sigma_a - sigma_s, a difference of rounding errors, so after
  a null collision T is that noise in both packages (hence the classes);
  and the RGB grid's per-voxel uplift (rgb_unbounded_eval, a sigmoid of
  a quadratic in the wavelength whose terms cancel) rounds differently in
  the two packages, and in the JAX package's own jitted and eager runs
  (XLA contracts FMAs), to the order of 1e-4 relative, which each real or
  null event multiplies in, so there 1e-4 holds on >= 98% of the
  agreeing lanes and 1e-2 on all;
* the compacted tracking schedule equals the full-width one bit for bit
  (both capped at SCHEDULE_STEPS, past the last compaction);
* the bridge: the JAX-built fog scene carried over equals the port's
  build (face rows with the medium words, MediumBanks, camera_medium);
  the instanced build's medium words equal the JAX package's;
* every medium type, the camera medium and instanced media render on the
  CPU; a BrickGridMedium packs into the JAX package's brick tables
  (tests/test_torch_nanovdb.py holds its reads and renders).
"""

from dataclasses import fields

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.materials import types as jmt
from hikari_tpu.media import sample as jms
from hikari_tpu.media import types as jmed
from hikari_tpu.spectral.rgb2spec import srgb_table as j_table
from hikari_tpu_torch.media import sample as tms
from hikari_tpu_torch.media import types as tmed
from hikari_tpu_torch.spectral.rgb2spec import srgb_table as t_table
from test_torch_scene import F32_RTOL, jax_scene_arrays

N_TRACK = 4096  # tracked lanes, a quarter in each medium
SCHEDULE_STEPS = 128  # step cap of the schedule comparison
MEDIA = ["homogeneous", "grid", "rgb grid", "deflected"]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _u64(state):
    """The JAX package's (hi, lo) uint32 pair -> uint64 numpy."""
    return (np.asarray(state[0]).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(state[1]).astype(np.uint64)


def _media(m):
    """The four test media through package m's types, from fixed seeds."""
    rng = np.random.RandomState(1)
    dens = (rng.rand(12, 10, 8) * 3).astype(np.float32)
    rgb = (rng.rand(6, 7, 5, 3) * 4).astype(np.float32)
    box = dict(bounds_lo=(-1.0, -1.0, -1.0), bounds_hi=(1.0, 1.0, 1.0))
    return [
        m.HomogeneousMedium(sigma_a=(0.3, 0.2, 0.1), sigma_s=(1.5, 1.0, 0.5), g=0.3),
        m.GridMedium(density=dens, sigma_a=(0.5,) * 3, sigma_s=(4.0, 3.0, 2.0), g=0.8, **box),
        m.RGBGridMedium(sigma_a_grid=rgb * 0.2, sigma_s_grid=rgb, le_grid=rgb * 0.1, g=-0.3,
                        **box),
        m.HomogeneousMedium(sigma_a=(0.1,) * 3, sigma_s=(0.8,) * 3,
                            deflection=("gravity", (0.0, 0.0, 0.0), 0.5), majorant_scale=2.0),
    ]


@pytest.fixture(scope="module")
def banks():
    return jmed.pack_media(_media(jmed)), tmed.pack_media(_media(tmed))


def test_lcg_bit_exact():
    rng = np.random.RandomState(0)
    n = 1024
    o = rng.randn(n, 3).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    t = (rng.rand(n) * 10).astype(np.float32)
    o[0], o[1], d[2] = 0.0, -0.0, -0.0
    o[3, 0], d[4, 1], o[5, 2] = np.float32(1e-40), -np.float32(1e-42), np.float32(-3e-39)
    t[6:40] = np.inf
    t[41] = np.float32(1e-41)
    t[42] = 0.0
    js = jms.lcg_init(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t))
    ts = tms.lcg_init(_t(o), _t(d), _t(t))
    np.testing.assert_array_equal(ts.numpy().view(np.uint64), _u64(js))
    for _ in range(8):
        js, ju = jms.lcg_next(js)
        ts, tu = tms.lcg_next(ts)
        np.testing.assert_array_equal(ts.numpy().view(np.uint64), _u64(js))
        np.testing.assert_array_equal(tu.numpy().view(np.int32),
                                      np.asarray(ju).view(np.int32))
    assert float(tu.max()) < 1.0


@pytest.mark.parametrize("g", [-0.9, 0.0, 1e-4, 0.877])
def test_hg_eval_and_sample(g):
    rng = np.random.RandomState(2)
    n = 4096
    wo = rng.randn(n, 3).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wi = rng.randn(n, 3).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    u2 = rng.rand(n, 2).astype(np.float32)
    gs = np.full(n, g, np.float32)
    np.testing.assert_allclose(
        tms.hg_eval(_t(gs), _t(wo), _t(wi)).numpy(),
        np.asarray(jms.hg_eval(jnp.asarray(gs), jnp.asarray(wo), jnp.asarray(wi))),
        rtol=F32_RTOL)
    jwi, jpdf = jms.hg_sample(jnp.asarray(gs), jnp.asarray(wo), jnp.asarray(u2))
    twi, tpdf = tms.hg_sample(_t(gs), _t(wo), _t(u2))
    np.testing.assert_allclose(twi.numpy(), np.asarray(jwi), rtol=F32_RTOL, atol=1e-6)
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=F32_RTOL)


@pytest.mark.parametrize("stochastic", [False, True], ids=["exact", "stochastic"])
def test_grid_reads(banks, stochastic):
    jb, tb = banks
    rng = np.random.RandomState(3)
    n = 4096
    p = (rng.rand(n, 3) * 2.4 - 1.2).astype(np.float32)  # some outside the box
    u3 = rng.rand(n, 3).astype(np.float32) if stochastic else None
    ju3 = None if u3 is None else jnp.asarray(u3)
    tu3 = None if u3 is None else _t(u3)
    for which in (1, 2):
        mi = np.full(n, which, np.int32)
        if which == 1:
            want = jms._grid_density(jb, jnp.asarray(mi), jnp.asarray(p), ju3)
            got = tms._grid_density(tb, _t(mi), _t(p), tu3)
        else:
            want = jms._rgb_grid_trilinear(jb, jnp.asarray(mi), jnp.asarray(p), jb.rgb_ss, ju3)
            got = tms._rgb_grid_trilinear(tb, _t(mi), _t(p), tb.rgb_ss, tu3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL, atol=1e-7)
        assert (np.asarray(want) > 0).any() and (np.asarray(want) == 0).any()


def test_majorant_cells_and_banks(banks):
    rng = np.random.RandomState(4)
    for shape in ((5, 7, 9), (16, 16, 16), (33, 20, 17)):
        d = rng.rand(*shape).astype(np.float32)
        np.testing.assert_array_equal(tmed._build_majorant_cells(d),
                                      jmed._build_majorant_cells(d))
    jb, tb = banks
    for f in fields(tmed.MediumBanks):
        got = getattr(tb, f.name)
        if f.name == "has_rgb":
            assert got
            continue
        want = getattr(jb, f.name)
        if not isinstance(got, torch.Tensor):
            assert got == want, f.name
        elif f.name.endswith("_c4"):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL,
                                       atol=1e-7, err_msg=f.name)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f.name)
    table = np.array([[[0, -1], [-1, 1]]], np.int32)
    bricks = rng.rand(2, 512).astype(np.float32)
    tb = tmed.pack_media([tmed.BrickGridMedium(table=table, bricks=bricks, background=0.1)])
    jb = jmed.pack_media([jmed.BrickGridMedium(table=table, bricks=bricks, background=0.1)])
    assert tb.has_brick and jb.has_brick and not tb.has_grid
    for name in ("brick_table", "brick_vals", "brick_tab_off", "brick_base", "brick_bg",
                 "grid_res", "maj", "max_density"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), err_msg=name)


def _rays(seed: int):
    """N_TRACK rays from inside and around the media's box, a tenth with an
    infinite t_max, a tenth inactive, a fifth at the depth limit."""
    rng = np.random.RandomState(seed)
    n = N_TRACK
    o = ((rng.rand(n, 3) * 2 - 1) * 0.9).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = (rng.rand(n) * 3).astype(np.float32)
    t_max[::10] = np.inf
    lam = (360.0 + rng.rand(n, 4) * 470.0).astype(np.float32)
    active = rng.rand(n) > 0.1
    return o, d, t_max, lam, active, rng.rand(n) < 0.2


@pytest.fixture(scope="module")
def tracked(banks):
    """delta_track and ratio_track_tr of both packages on the same rays,
    lane i in medium i % 4; and the port's compacted and full-width
    schedules of both loops, capped at SCHEDULE_STEPS."""
    jb, tb = banks
    o, d, t_max, lam, active, mdh = _rays(10)
    mi = (np.arange(N_TRACK) % len(MEDIA)).astype(np.int32)
    ones = np.ones((N_TRACK, 4), np.float32)
    j_in = [jnp.asarray(x) for x in (mi, o, d, t_max, lam)]
    t_in = [_t(x) for x in (mi, o, d, t_max, lam)]
    t_path = [_t(ones)] * 3 + [_t(active), _t(mdh)]

    def port_delta(**kw):
        return tms.delta_track(tb, t_table(), *t_in, *t_path, **kw)

    def port_ratio(**kw):
        return [x.numpy() for x in tms.ratio_track_tr(tb, t_table(), *t_in, _t(active), **kw)]

    return dict(
        medium=mi,
        jd=jms.delta_track(jb, j_table(), *j_in, *[jnp.asarray(ones)] * 3,
                           jnp.asarray(active), jnp.asarray(mdh)),
        td=port_delta(),
        jr=[np.asarray(x) for x in jms.ratio_track_tr(jb, j_table(), *j_in,
                                                        jnp.asarray(active))],
        tr=port_ratio(),
        schedules={"delta": [port_delta(max_steps=SCHEDULE_STEPS, compact=c)
                             for c in (True, False)],
                   "ratio": [port_ratio(max_steps=SCHEDULE_STEPS, compact=c)
                             for c in (True, False)]})


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b) / np.maximum(np.abs(a), 1e-30)
    return err.reshape(err.shape[0], -1).max(-1)


def _assert_close(errs, medium):
    if medium == "rgb grid":
        assert (errs <= 1e-4).mean() >= 0.98 and errs.max() <= 1e-2, np.sort(errs)[-20:]
    else:
        assert errs.max() <= 1e-4, np.sort(errs)[-5:]


@pytest.mark.parametrize("medium", MEDIA)
def test_delta_track_matches_jax(tracked, medium):
    lanes = tracked["medium"] == MEDIA.index(medium)
    jd, td = tracked["jd"], tracked["td"]
    status = td.status.numpy()
    agree = (status == np.asarray(jd.status)) & lanes
    assert agree.sum() >= 0.995 * lanes.sum(), agree.sum() / lanes.sum()
    assert {1, 2, 3} <= set(np.unique(status[agree]).tolist())
    scattered = agree & (status == tms.SCATTERED)
    errs = np.concatenate([_rel_err(getattr(jd, k), getattr(td, k).numpy())[agree]
                           for k in ("beta", "r_u", "r_l")]
                          + [_rel_err(jd.t_scatter, td.t_scatter.numpy())[scattered]])
    _assert_close(errs, medium)


@pytest.mark.parametrize("medium", MEDIA)
def test_ratio_track_matches_jax(tracked, medium):
    lanes = tracked["medium"] == MEDIA.index(medium)
    jr, tr = tracked["jr"], tracked["tr"]
    j_on, t_on = jr[0].max(-1) > 1e-3, tr[0].max(-1) > 1e-3
    assert (j_on == t_on)[lanes].mean() >= 0.995, (j_on == t_on)[lanes].mean()
    both = j_on & t_on & lanes
    assert both.sum() > 0.2 * lanes.sum() and (lanes & ~t_on).any()
    _assert_close(np.concatenate([_rel_err(a, b)[both] for a, b in zip(jr, tr)]), medium)


@pytest.mark.parametrize("loop", ["delta", "ratio"])
def test_compacted_schedule_equals_full_width(tracked, loop):
    compact, full = tracked["schedules"][loop]
    if loop == "delta":
        for f in fields(tms.DeltaTrackResult):
            assert torch.equal(getattr(compact, f.name), getattr(full, f.name)), f.name
    else:
        for a, b in zip(compact, full):
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_tracking_stats_count_steps(banks):
    _, tb = banks
    o, d, t_max, lam, active, mdh = _rays(20)
    mi = torch.full((N_TRACK,), 1, dtype=torch.int32)
    stats = {}
    ones = torch.ones(N_TRACK, 4)
    res = tms.delta_track(tb, t_table(), mi, _t(o), _t(d), _t(t_max), _t(lam), ones, ones,
                          ones, _t(active), _t(mdh), stats=stats)
    steps = stats["lane_steps"]
    assert stats["steps"] == int(steps.max()) > 1
    assert not steps[~_t(active)].any()
    assert (steps[res.status == tms.SCATTERED] >= 1).all()
    capped = tms.delta_track(tb, t_table(), mi, _t(o), _t(d), _t(t_max), _t(lam), ones, ones,
                             ones, _t(active), _t(mdh), max_steps=2)
    assert (capped.status == tms.PASSED).sum() >= (res.status == tms.PASSED).sum()


def _jax_media_arrays(js) -> dict:
    out = jax_scene_arrays(js)
    for f in fields(tmed.MediumBanks):
        if f.name != "has_rgb":
            out[f"media.{f.name}"] = np.asarray(getattr(js.media, f.name))
    out["camera_medium"] = np.asarray(js.camera_medium)
    out["has_media"] = np.asarray(js.has_media)
    return out


def test_bridge_carries_the_jax_fog_scene():
    import bench
    from hikari_tpu_torch.scene.bridge import scene_from_numpy
    from hikari_tpu_torch.scenes import fog_scene

    ts = fog_scene().build(device="cpu")
    bs = scene_from_numpy(_jax_media_arrays(bench.build_fog_scene()), "cpu")
    np.testing.assert_array_equal(bs.face_rows.numpy(), ts.face_rows.numpy())
    assert bs.present_materials == ts.present_materials
    assert jmt.INTERFACE in ts.present_materials
    assert (bs.camera_medium, bs.has_media) == (ts.camera_medium, ts.has_media) == (-1, True)
    words = (ts.face_rows[:, 15] * 65536 + ts.face_rows[:, 16]).long()
    assert sorted(set(words.tolist())) == [0, 1 << 16]  # box: fog inside; walls: vacuum
    for f in fields(tmed.MediumBanks):
        got, want = getattr(ts.media, f.name), getattr(bs.media, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_RTOL, atol=1e-7,
                                       err_msg=f.name)
        else:
            assert got == want, f.name


def _two_boxes(m, instanced: bool):
    """A floor, a fog box and a grid-medium box (camera inside the fog),
    through package m's API (m: a dict of constructors)."""
    fog = m["HomogeneousMedium"](sigma_a=(0.05,) * 3, sigma_s=(0.4,) * 3, g=0.2)
    rng = np.random.RandomState(5)
    grid = m["GridMedium"](density=rng.rand(8, 8, 8).astype(np.float32),
                           bounds_lo=(0.2, 0.0, 0.2), bounds_hi=(0.8, 0.6, 0.8),
                           sigma_s=(3.0,) * 3)
    s = m["Scene"]()
    s.add(m["make_quad"]((-3, 0, -3), (3, 0, -3), (3, 0, 3), (-3, 0, 3)), m["Matte"]())
    s.add(m["make_box"]((-0.8, 0.0, -0.8), (0.0, 0.8, 0.0)), m["Interface"](),
          inside_medium=fog)
    box = m["make_box"]((0.0, 0.0, 0.0), (0.6, 0.6, 0.6))
    if instanced:
        tr = np.eye(4, dtype=np.float32)[None]
        tr[0, :3, 3] = 0.2
        s.add_instanced(box, tr, m["Interface"](), inside_medium=grid, outside_medium=fog)
    else:
        s.add(m["make_box"]((0.2, 0.0, 0.2), (0.8, 0.6, 0.8)), m["Interface"](),
              inside_medium=grid, outside_medium=fog)
    s.set_camera_medium(fog)
    s.add_light(m["PointLight"](position=(0.5, 2.0, -1.0), intensity=(6.0,) * 3))
    return s


def _api(pkg):
    if pkg == "jax":
        from hikari_tpu.lights.types import PointLight
        from hikari_tpu.scene.mesh import make_box, make_quad
        from hikari_tpu.scene.scene import Scene

        return dict(HomogeneousMedium=jmed.HomogeneousMedium, GridMedium=jmed.GridMedium,
                    Scene=Scene, make_quad=make_quad, make_box=make_box, Matte=jmt.Matte,
                    Interface=jmt.Interface, PointLight=PointLight)
    import hikari_tpu_torch as hk

    return {k: getattr(hk, k) for k in ("HomogeneousMedium", "GridMedium", "Scene",
                                        "make_quad", "make_box", "Matte", "Interface",
                                        "PointLight")}


@pytest.mark.parametrize("instanced", [False, True], ids=["flat", "instanced"])
def test_medium_words_and_camera_medium_match_jax(instanced):
    js = _two_boxes(_api("jax"), instanced).build(
        traversal="packets_interp" if instanced else "skiplink")
    ts = _two_boxes(_api("torch"), instanced).build(device="cpu")
    np.testing.assert_array_equal(ts.face_rows[:, 12:17].numpy(),
                                  np.asarray(js.face_rows)[:, 12:17])
    assert ts.camera_medium == int(js.camera_medium) == 0
    assert ts.media.n_media == js.media.n_media == 2
    assert ts.has_instances == instanced


def _tiny_render(scene, res=8, spp=2, depth=4, **vp_kw):
    import hikari_tpu_torch as hk

    cam = hk.make_perspective_camera((0.3, 1.2, -2.0), (0.2, 0.3, 0.2), (res, res))
    lanes = torch.arange(res * res).repeat(spp)
    si = torch.arange(spp).repeat_interleave(res * res)
    rgb, _, stats = hk.render_lanes(hk.VolPath(max_depth=depth, samples_per_pixel=spp,
                                               **vp_kw),
                                    scene, cam, hk.make_filter(), si, lanes % res,
                                    lanes // res)
    return rgb, stats


@pytest.mark.parametrize("kind", ["homogeneous", "grid", "rgb grid", "cloud", "preset",
                                  "camera medium", "instanced"])
def test_every_medium_renders_on_the_cpu(kind):
    import hikari_tpu_torch as hk

    if kind in ("camera medium", "instanced"):
        scene = _two_boxes(_api("torch"), kind == "instanced").build(device="cpu")
    else:
        rng = np.random.RandomState(6)
        box = dict(bounds_lo=(-0.5, 0.0, -0.5), bounds_hi=(0.5, 1.0, 0.5))
        medium = {
            "homogeneous": lambda: hk.HomogeneousMedium(sigma_s=(2.0, 1.5, 1.0), g=0.5),
            "grid": lambda: hk.GridMedium(density=rng.rand(6, 6, 6).astype(np.float32),
                                          sigma_s=(4.0,) * 3, **box),
            "rgb grid": lambda: hk.RGBGridMedium(
                sigma_s_grid=rng.rand(4, 5, 6, 3).astype(np.float32) * 4,
                le_grid=rng.rand(4, 5, 6, 3).astype(np.float32), **box),
            "cloud": lambda: hk.CloudVolume(resolution=16, sigma_s=(20.0,) * 3, **box),
            "preset": lambda: hk.Milk(scale=0.5),
        }[kind]()
        s = hk.Scene()
        s.add(hk.make_quad((-3, 0, -3), (3, 0, -3), (3, 0, 3), (-3, 0, 3)), hk.Matte())
        s.add(hk.make_box((-0.5, 0.0, -0.5), (0.5, 1.0, 0.5)), hk.Interface(),
              inside_medium=medium)
        s.add_light(hk.PointLight(position=(0.5, 2.0, -1.0), intensity=(6.0,) * 3))
        scene = s.build(device="cpu")
    assert scene.has_media
    rgb, stats = _tiny_render(scene)
    assert float(stats["nonfinite_lanes"]) == 0.0
    assert torch.isfinite(rgb).all() and float(rgb.mean()) > 0.0
