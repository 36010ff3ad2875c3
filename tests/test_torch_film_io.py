"""Port parity: the film extras (ROADMAP A16's aux pass, A17, A18's
RenderMeter) against the JAX package.

* postprocess under every tonemap, with and without a FilmSensor (ISO,
  exposure, white balance), within 1e-6 absolute on seeded HDR images;
* denoise (every DenoiseConfig switch) and its passes on seeded images
  within 1e-5 relative (+ 1e-6 absolute);
* image I/O: a PNG written by either package decodes to the same pixels in
  both, the bytes are equal (the same filter rows and zlib level), and
  PFM / .npy / .npz round-trip through load_image;
* checkpoints: a film saved by the port loads in the JAX package and one
  saved by the JAX package loads in the port, key for key; a render
  resumed from such a checkpoint for one more sample batch equals the
  unbroken render;
* render_aux on a small textured scene against the JAX package's (the
  file's one JAX render compile): the same surface hit on >= 99.9% of the
  pixels, and albedo, normal and depth within 1e-5 there;
* render_aux of the Cornell and textured scenes at 64x64 against the JAX
  package's stored pixel for pixel (data/aux_ref.npz): every pixel on the
  reference's face or on a tie of two faces at one t; on Cornell's ties
  the JAX package's packet engine keeps one of the two faces, not always
  the one its render_aux kept;
* RenderMeter's laps and summary; time_device_fn refuses to time without a
  card;
* the README Quickstart's pipeline on the port at 16x16, 2 spp: render,
  render_aux, denoise, postprocess, write_png, read_png: finite and not
  black.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu
from hikari_tpu.film import denoise as jd
from hikari_tpu.film import film as jf
from hikari_tpu.film import imageio as jio
from hikari_tpu.film import postprocess as jp
from hikari_tpu.integrators.volpath import scene_closest_hit as j_closest_hit
from hikari_tpu.utils import metrics as jm
import hikari_tpu_torch as hk
from hikari_tpu_torch.film import denoise as td
from hikari_tpu_torch.film import film as tf
from hikari_tpu_torch.film import imageio as tio
from hikari_tpu_torch.film import postprocess as tp
from hikari_tpu_torch.integrators.volpath import pixel_centre_rays, render_sample
from hikari_tpu_torch.scenes import BUILDERS, aux_against_reference, checker_image, scene_camera
from hikari_tpu_torch.utils import metrics as tm


def _hdr(seed=0, h=24, w=20):
    rng = np.random.RandomState(seed)
    return (rng.lognormal(-0.5, 1.5, (h, w, 3))).astype(np.float32)


@pytest.mark.parametrize("tonemap", ["none", "clamp", "reinhard", "reinhard_extended", "aces",
                                     "uncharted2", "filmic"])
@pytest.mark.parametrize("sensor", [None, (200.0, 0.5, None), (100.0, 1.0, 3200.0)],
                         ids=["no-sensor", "iso-exposure", "white-balance"])
def test_postprocess_matches_jax(tonemap, sensor):
    """Within 1e-6 absolute; under white balance within 1e-6 times the
    pixel's largest input channel (at least 1), times 12.92, the steepest
    slope of the sRGB gamma and of every tonemap (filmic's is 8.3): the
    three chained 3x3 products of the white balance cancel, and XLA rounds
    them as fused multiply-adds."""
    img = _hdr()
    jsen = None if sensor is None else jp.FilmSensor(*sensor)
    tsen = None if sensor is None else tp.FilmSensor(*sensor)
    for gamma in (True, False):
        atol = 1e-6
        if sensor is not None and sensor[2] is not None:
            atol = 1e-6 * np.maximum(img.max(-1, keepdims=True), 1.0) * 12.92
        want = np.asarray(jp.postprocess(img, 0.8, tonemap, gamma, jsen))
        got = tp.postprocess(torch.from_numpy(img), 0.8, tonemap, gamma, tsen).numpy()
        assert (np.abs(got - want) <= atol).all(), float(np.abs(got - want).max())
    with pytest.raises(ValueError):
        tp.postprocess(torch.from_numpy(img), tonemap="sepia")


def _aux(seed=1, h=24, w=20):
    rng = np.random.RandomState(seed)
    n = rng.randn(h, w, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[:3, :4] = 0.0  # background: no hit
    return (_hdr(seed, h, w) * 0.3, rng.rand(h, w, 3).astype(np.float32), n,
            rng.uniform(1.0, 5.0, (h, w)).astype(np.float32))


@pytest.mark.parametrize("cfg", [dict(), dict(iterations=2, use_variance=False),
                                 dict(demodulate_albedo=False, sigma_normal=32.0)],
                         ids=["default", "no-variance", "no-demodulation"])
def test_denoise_matches_jax(cfg):
    color, albedo, normal, depth = _aux()
    want = np.asarray(jd.denoise(color, albedo, normal, depth, jd.DenoiseConfig(**cfg)))
    got = td.denoise(*(torch.from_numpy(x) for x in (color, albedo, normal, depth)),
                     td.DenoiseConfig(**cfg)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    var_j = np.asarray(jd.estimate_variance(color))
    np.testing.assert_allclose(td.estimate_variance(torch.from_numpy(color)).numpy(), var_j,
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(td.atrous_pass(*(torch.from_numpy(x) for x in (color, var_j, normal, depth)),
                                   2, td.DenoiseConfig(**cfg)),
                    jd.atrous_pass(color, var_j, normal, depth, 2, jd.DenoiseConfig(**cfg))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_png_across_packages(tmp_path):
    img = np.clip(_hdr(2) * 0.4, 0.0, 1.0)
    tp.write_png(tmp_path / "port.png", torch.from_numpy(img))
    jp.write_png(str(tmp_path / "jax.png"), img)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    for name in ("port.png", "jax.png"):
        got = tio.read_png(tmp_path / name)
        np.testing.assert_array_equal(got, jio.read_png(str(tmp_path / name)))
        np.testing.assert_allclose(got, img, atol=0.5 / 255 + 1e-6)
    np.testing.assert_array_equal(tio.load_image(tmp_path / "port.png"),
                                  tio.read_png(tmp_path / "port.png"))


def test_pfm_npy_npz_round_trips(tmp_path):
    img = _hdr(3)
    tio.write_pfm(tmp_path / "a.pfm", img)
    jio.write_pfm(str(tmp_path / "b.pfm"), img)
    assert (tmp_path / "a.pfm").read_bytes() == (tmp_path / "b.pfm").read_bytes()
    np.testing.assert_array_equal(tio.read_pfm(tmp_path / "a.pfm"), img)
    np.testing.assert_array_equal(tio.load_image(tmp_path / "a.pfm"),
                                  jio.load_image(str(tmp_path / "a.pfm")))
    np.save(tmp_path / "c.npy", img)
    np.savez(tmp_path / "d.npz", image=img)
    for name in ("c.npy", "d.npz"):
        np.testing.assert_array_equal(tio.load_image(tmp_path / name), img)
    with pytest.raises(ValueError):
        tio.load_image(tmp_path / "e.exr")
    with pytest.raises(ValueError):
        tio.read_png(tmp_path / "a.pfm")


def _small_scene(m):
    """A textured floor, a vertex-coloured wall and two spheres under a point
    light: render_aux's scene."""
    s = m.Scene()
    s.add(m.make_quad((-2, 0, -2), (2, 0, -2), (2, 0, 2), (-2, 0, 2)),
          m.Matte(kd=m.ImageTexture(checker_image(32), uv_scale=(2.0, 2.0))))
    wall = m.make_quad((-2, 0, 2), (2, 0, 2), (2, 2, 2), (-2, 2, 2))
    wall.colors = np.asarray([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32)
    s.add(wall, m.Matte(kd=m.VertexColorTexture()))
    s.add(m.make_sphere((-0.6, 0.5, 0.5), 0.5, 8, 16), m.Gold(roughness=0.2))
    s.add(m.make_sphere((0.6, 0.5, 0.5), 0.5, 8, 16),
          m.CoatedDiffuse(reflectance=m.ImageTexture(checker_image(16, cells=4))))
    s.add_light(m.PointLight(position=(0, 3, -1), intensity=(10, 10, 10)))
    return s


CAMERA = ((0.0, 1.0, -3.0), (0.0, 0.5, 0.5))


def test_checkpoint_across_packages_resumes(tmp_path):
    sc = _small_scene(hk).build(device="cpu")
    cam = hk.make_perspective_camera(*CAMERA, (12, 10))
    vp = hk.VolPath(max_depth=2, samples_per_pixel=2, sample_batch=1)
    filt = hk.make_filter()
    whole = hk.render(vp, sc, cam)
    film = render_sample(vp, sc, cam, hk.make_film(12, 10, device="cpu"), filt, 0)
    albedo, normal, depth = hk.render_aux(sc, cam)
    tf.film_add_aux(film, albedo, normal, depth, torch.ones(10, 12))
    tf.film_save(tmp_path / "port.npz", film)
    jfilm = jf.film_load(str(tmp_path / "port.npz"))
    for k in ("rgb_sum", "weight_sum", "albedo", "normal", "depth", "aux_weight"):
        np.testing.assert_array_equal(np.asarray(getattr(jfilm, k)), getattr(film, k).numpy())
    assert int(jfilm.iteration) == film.iteration == 1 and jfilm.width == 12
    jf.film_save(str(tmp_path / "jax.npz"), jfilm)
    back = tf.film_load(tmp_path / "jax.npz", device="cpu")
    resumed = render_sample(vp, sc, cam, back, filt, 1)
    assert resumed.iteration == whole.iteration == 2
    torch.testing.assert_close(hk.framebuffer(resumed), hk.framebuffer(whole), rtol=0, atol=0)
    for got, want in zip(hk.aux_buffers(back), (albedo, normal, depth)):
        torch.testing.assert_close(got, want)


def test_render_aux_matches_jax():
    res = 24
    js, ts = _small_scene(hikari_tpu).build(), _small_scene(hk).build(device="cpu")
    ja, jn, jz = (np.asarray(x) for x in hikari_tpu.render_aux(
        js, hikari_tpu.make_perspective_camera(*CAMERA, (res, res))))
    ta, tn, tz = (x.numpy() for x in hk.render_aux(ts, hk.make_perspective_camera(*CAMERA,
                                                                                  (res, res))))
    same = ((jz > 0) == (tz > 0)) & (np.abs(tz - jz) <= 1e-5 * np.maximum(jz, 1.0))
    assert same.mean() >= 0.999, f"{(~same).sum()} pixels hit another surface"
    for got, want in ((ta, ja), (tn, jn)):
        np.testing.assert_allclose(got[same], want[same], rtol=1e-5, atol=1e-5)
    assert (tz > 0).mean() > 0.5 and ta[tz > 0].max() > 0.5


@pytest.fixture(scope="module")
def aux_vs_stored():
    return {which: aux_against_reference(BUILDERS[which]().build(device="cpu"), which)
            for which in ("cornell", "textured")}


@pytest.mark.parametrize("which", ["cornell", "textured"])
def test_render_aux_against_stored_jax(aux_vs_stored, which):
    """Every pixel on the reference's face or on a tie (both faces hold the
    hit point, t within AUX_TIE_RTOL); depth within 1e-5 on every pixel;
    normal and the mean albedo within 1e-5 on the pixels of the same face
    (scenes.aux_against_reference: the textured scene's Mix and texel
    edges move single pixels' albedo, not its mean). Cornell has neither:
    there its albedo holds per pixel."""
    r = aux_vs_stored[which]
    assert r["unexplained"] == 0, r
    assert max(r["depth_err"], r["normal_err"], r["albedo_mean_err"]) <= 1e-5, r
    if which == "cornell":
        assert r["albedo_err"] <= 1e-5, r


def test_cornell_aux_ties_are_broken_either_way(aux_vs_stored):
    """The Cornell camera looks along the box's axis, so the box's edges and
    its quads' diagonals run through pixel centres: there a ray meets two
    faces at one t (to 1e-6), and a traversal keeps one by its own rule.
    The JAX package breaks these ties both ways itself: its packet engine
    (interpret mode) keeps one of the two faces on every such pixel, and
    another face than its own render_aux kept on some of them."""
    r = aux_vs_stored["cornell"]
    assert r["ties"] > 0 and r["same"] + r["ties"] == r["pixels"]
    idx = torch.tensor([y * r["res"] + x for y, x in r["tie_pixels"]])
    o, d = pixel_centre_rays(scene_camera("cornell", r["res"]), "cpu")
    js = BUILDERS["cornell"](api=hikari_tpu).build(traversal="packets_interp")
    rec = j_closest_hit(js, jnp.asarray(o[idx].numpy()), jnp.asarray(d[idx].numpy()),
                        jnp.full((len(idx),), jnp.inf))
    packets = np.asarray(rec.tri).tolist()
    assert all(f in pair for f, pair in zip(packets, r["tie_faces"])), (packets, r["tie_faces"])
    assert any(f != ref for f, (_, ref) in zip(packets, r["tie_faces"])), packets


def test_render_meter_and_device_timer(monkeypatch):
    for meter in (tm.RenderMeter().start(), jm.RenderMeter().start()):
        lap = meter.lap(2e6)
        assert lap["sample"] == 1 and lap["mray_s"] > 0
        meter.lap(1e6)
        s = meter.summary()
        assert s["samples"] == 2 and s["total_rays"] == 3_000_000
        assert meter.report().startswith("{") and meter.mray_s > 0
    assert set(tm.RenderMeter().summary()) == set(jm.RenderMeter().summary())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.time_device_fn(lambda: None)


def test_readme_quickstart_pipeline(tmp_path):
    """README.md's Quickstart, on the port at 16x16 and 2 spp."""
    scene = hk.Scene()
    scene.add(hk.make_quad((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5)),
              hk.Matte(kd=(0.6, 0.6, 0.6)))
    scene.add(hk.make_sphere((0, 0.5, 0), 0.5, 8, 16), hk.Plastic(kd=(0.8, 0.1, 0.1)))
    scene.add(hk.make_sphere((1.2, 0.4, 0.3), 0.4, 8, 16), hk.Gold(roughness=0.2))
    env, sun = hk.sunsky_environment(direction=(0.4, 0.3, 1.0))
    scene.add_light(env)
    scene.add_light(sun)
    cam = hk.make_perspective_camera((0, 1.2, -4), (0, 0.5, 0), (16, 16))
    built = scene.build(device="cpu")
    img = hk.framebuffer(hk.render(hk.VolPath(samples_per_pixel=2, max_depth=3), built, cam))
    albedo, normal, depth = hk.render_aux(built, cam)
    img = hk.denoise(img, albedo, normal, depth)
    out = hk.postprocess(img, tonemap="aces")
    hk.write_png(tmp_path / "out.png", out)
    back = hk.read_png(tmp_path / "out.png")
    assert back.shape == (16, 16, 3) and np.isfinite(back).all() and back.mean() > 0.05
    assert torch.isfinite(img).all() and float(img.mean()) > 0.0
