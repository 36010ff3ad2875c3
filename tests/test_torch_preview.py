"""Port parity: the preview integrators, Whitted and FastWavefront.

* The 3x4 map from radiance at the preview wavelengths to linear sRGB
  equals the JAX package's fit within 1e-6 of its largest entry.
* _direct_light_rgb and _direct_light_bsdf on 1024 seeded lanes of the
  quickstart scene (coarse sphere; the Plastic's NEE runs its layered
  evaluation walk), both packages called eagerly on the same hit points,
  normals and uniforms: within 1e-4 relative (1e-6 absolute) on >= 99.5%
  of lanes, the tolerance of tests/test_torch_layered.py's walks.
* Whitted and FastWavefront of the quickstart scene (examples/quickstart.py's
  integrators) and of the specular scene (glass, mirror, smooth gold over
  a textured floor: Whitted's primary hits filter it through their ray
  differentials) at 16x16 against the JAX package's stored images
  (hikari_tpu_torch/data/probe_ref.json, tools/gen_probe_ref.py --renders):
  per pixel within 1e-4 relative (1e-6 absolute) on >= 99.5% of pixels
  and the mean within 1e-4 against the JAX preview lanes run eagerly, and
  the mean within 0.5% of the JAX package's jitted render_preview. The
  image is held to the eager run because XLA contracts the layered walks'
  arithmetic under jit: 6% of the Plastic's jitted evaluations differ from
  its eager ones by more than 1e-4 (see gen_probe_ref.render_preview_ref),
  and the JAX package's own jitted quickstart Whitted mean is 0.23% from
  its eager one (the other three cases: < 1e-7).
* The four scenes of tests/test_preview.py, rendered by the port, with
  that file's checks.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu
import hikari_tpu_torch as hk
from hikari_tpu.integrators import preview as jp
from hikari_tpu.integrators import volpath as jv
from hikari_tpu_torch.integrators import preview as tp
from hikari_tpu_torch.integrators import volpath as tv
from hikari_tpu_torch.scenes import PROBE_REF, quickstart_scene, scene_camera

RTOL, ATOL, SHARE = 1e-4, 1e-6, 0.995
MEAN_RTOL = 1e-4
# the JAX package's jitted render_preview against its own eager lanes: its
# quickstart Whitted mean differs by 0.23% (the Plastic's walks), the others
# by < 1e-7
JIT_MEAN_RTOL = 5e-3
COARSE = (12, 24)
N = 1024


def _close_share(a, b):
    ok = (np.abs(a - b) <= ATOL + RTOL * np.abs(b)).all(-1)
    return ok.mean()


def test_preview_rgb_map_equals_jax():
    m_j = np.asarray(jp._preview_rgb_m())
    m_t = tp._fit_preview_rgb_m()
    assert m_t.shape == (3, 4)
    np.testing.assert_allclose(m_t, m_j, rtol=0, atol=1e-6 * np.abs(m_j).max())
    L4 = np.random.RandomState(0).rand(64, 4).astype(np.float32)
    np.testing.assert_allclose(tp.preview_spec_to_rgb(torch.from_numpy(L4)).numpy(),
                               np.asarray(jp._preview_spec_to_rgb(jnp.asarray(L4))),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def lanes():
    """The quickstart scene in both packages and N seeded lanes: camera rays
    through random film points, their JAX hit records and surface data."""
    js = quickstart_scene(COARSE, api=hikari_tpu).build()
    ts = quickstart_scene(COARSE).build(device="cpu")
    rng = np.random.RandomState(3)
    cam = scene_camera("quickstart", 32)
    o, d = cam.generate_rays(hk.camera.camera.CameraSample(
        p_film=torch.from_numpy(rng.rand(N, 2).astype(np.float32) * 32),
        lens=torch.zeros((N, 2)), time=torch.zeros(N), filter_weight=torch.ones(N)))
    rec = jv.scene_closest_hit(js, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                               jnp.full((N,), jnp.inf))
    sd_j = jv._surface_data(js, rec, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    flip = np.sum(np.asarray(sd_j["ns"]) * d.numpy(), -1) > 0.0
    sd_j["ns"] = jnp.where(flip[:, None], -sd_j["ns"], sd_j["ns"])
    sd_j["ng"] = jnp.where(flip[:, None], -sd_j["ng"], sd_j["ng"])
    sd_t = {k: torch.from_numpy(np.array(sd_j[k])) for k in ("p", "ns", "ng", "mat_type",
                                                              "mat_idx")}
    sd_t["tex"] = None
    u = {k: rng.rand(N, *s).astype(np.float32) for k, s in (("ul", ()), ("u2", (2,)),
                                                           ("u2e", (2,)), ("uce", ()))}
    return dict(js=js, ts=ts, sd_j=sd_j, sd_t=sd_t, d=d, u=u,
                hit=np.asarray(rec.hit), albedo=rng.rand(N, 3).astype(np.float32))


def test_direct_light_rgb_equals_jax(lanes):
    s = lanes
    u, hit = s["u"], s["hit"]
    got = tp._direct_light_rgb(s["ts"], s["sd_t"]["p"], s["sd_t"]["ns"],
                               torch.from_numpy(s["albedo"]), torch.from_numpy(u["ul"]),
                               torch.from_numpy(u["u2"]), torch.from_numpy(hit)).numpy()
    ref = np.asarray(jp._direct_light_rgb(s["js"], s["sd_j"]["p"], s["sd_j"]["ns"],
                                          jnp.asarray(s["albedo"]), jnp.asarray(u["ul"]),
                                          jnp.asarray(u["u2"]), jnp.asarray(hit)))
    assert (ref.sum(-1) > 0).mean() > 0.3
    assert _close_share(got, ref) >= SHARE


def test_direct_light_bsdf_equals_jax(lanes):
    s = lanes
    u, hit = s["u"], s["hit"]
    wo = -s["d"]
    got = tp._direct_light_bsdf(s["ts"], s["sd_t"], wo, *(torch.from_numpy(u[k]) for k in (
        "ul", "u2", "u2e", "uce")), torch.from_numpy(hit)).numpy()
    sd_j = dict(s["sd_j"], tex=None)
    ref = np.asarray(jp._direct_light_bsdf(s["js"], sd_j, jnp.asarray(wo.numpy()),
                                           *(jnp.asarray(u[k]) for k in (
                                               "ul", "u2", "u2e", "uce")), jnp.asarray(hit)))
    on_plastic = np.asarray(sd_j["mat_type"]) == hikari_tpu.materials.types.COATED_DIFFUSE
    assert (hit & on_plastic).sum() > 50 and (ref.sum(-1) > 0).mean() > 0.3
    assert _close_share(got, ref) >= SHARE


def _stored(which):
    return json.loads(PROBE_REF.read_text())["renders"][f"preview {which}"]


@pytest.mark.parametrize("which", ["quickstart", "specular"])
@pytest.mark.parametrize("name", ["whitted", "fast"])
def test_render_preview_equals_jax(which, name):
    ref = _stored(which)
    cfg = ref[name]["integrator"]
    integ = (tp.Whitted(**cfg) if name == "whitted"
             else tp.FastWavefront(samples_per_pixel=cfg["samples_per_pixel"]))
    res = ref["res"]
    sc = hk.scenes.BUILDERS[which]().build(device="cpu")
    film = hk.render_preview(integ, sc, scene_camera(which, res))
    img = hk.framebuffer(film).numpy()
    eager = np.asarray(ref[name]["eager_rgb"], np.float32)
    assert img.shape == eager.shape == (res, res, 3) and np.isfinite(img).all()
    assert eager.mean() > 0.01
    share = _close_share(img.reshape(-1, 3), eager.reshape(-1, 3))
    assert share >= SHARE, share
    assert abs(img.mean() / eager.mean() - 1) <= MEAN_RTOL, (img.mean(), eager.mean())
    jitted = ref[name]["render_preview_mean"]
    assert abs(img.mean() / jitted - 1) <= JIT_MEAN_RTOL, (img.mean(), jitted)


def test_whitted_takes_ray_differentials_on_textured_scenes(monkeypatch):
    """On a textured scene Whitted's primary hits (and only they) read
    their uv footprints from the ray differentials."""
    calls = []
    orig = tv._uv_diff_derivatives

    def counted(*args, **kw):
        calls.append(args[1].shape[0])
        return orig(*args, **kw)

    monkeypatch.setattr(tv, "_uv_diff_derivatives", counted)
    sc = hk.scenes.specular_scene().build(device="cpu")
    hk.render_preview(hk.Whitted(max_depth=3, samples_per_pixel=2), sc,
                      scene_camera("specular", 8))
    assert calls == [64, 64]
    calls.clear()
    hk.render_preview(hk.Whitted(max_depth=3, samples_per_pixel=1), quickstart_scene(COARSE)
                      .build(device="cpu"), scene_camera("quickstart", 8))
    assert calls == []


# --- tests/test_preview.py's scenes, on the port -----------------------------------------


def _preview_scene():
    s = hk.Scene()
    s.add(hk.make_quad((-2, 0, -2), (2, 0, -2), (2, 0, 2), (-2, 0, 2)),
          hk.Matte(kd=(0.6, 0.6, 0.6)))
    s.add(hk.make_sphere((-0.5, 0.5, 0), 0.5, 10, 20), hk.Matte(kd=(0.8, 0.2, 0.2)))
    s.add(hk.make_sphere((0.7, 0.4, -0.3), 0.4, 10, 20), hk.Mirror())
    s.add(hk.make_quad((-0.3, 2.0, -0.3), (0.3, 2.0, -0.3), (0.3, 2.0, 0.3), (-0.3, 2.0, 0.3)),
          hk.Emissive(le=(1, 1, 1), scale=5.0))
    s.add_light(hk.PointLight(position=(1.5, 2.5, -1.5), intensity=(10, 10, 10)))
    return s.build(device="cpu")


def _img(integ, scene, cam):
    return hk.framebuffer(hk.render_preview(integ, scene, cam)).numpy()


def test_fast_wavefront_preview():
    cam = hk.make_perspective_camera((0, 2.2, -2.4), (0, 0.0, 0.6), (32, 32), fov_deg=55.0)
    img = _img(hk.FastWavefront(samples_per_pixel=2), _preview_scene(), cam)
    assert np.isfinite(img).all() and img.max() > 0.05
    lit = img.sum(-1) > 1e-3
    assert lit.mean() > 0.3, lit.mean()
    floor = img[20:, :, :].sum(-1)  # hard shadows: a wide range over the floor band
    assert floor.max() > 5 * max(floor.min(), 1e-4)


def test_whitted_mirror_reflection():
    scene = _preview_scene()
    cam = hk.make_perspective_camera((0.7, 0.6, -2.2), (0.7, 0.35, 0), (32, 32), fov_deg=30.0)
    img_d1 = _img(hk.Whitted(max_depth=1, samples_per_pixel=2), scene, cam)
    img_d3 = _img(hk.Whitted(max_depth=3, samples_per_pixel=2), scene, cam)
    assert np.isfinite(img_d3).all()
    assert img_d3.sum() - img_d1.sum() > 0.1  # the mirror shows the scene at depth 3


def test_whitted_glass_refraction():
    def build(pane):
        s = hk.Scene()
        s.add(hk.make_quad((-2, -2, 3), (2, -2, 3), (2, 2, 3), (-2, 2, 3)),
              hk.Emissive(le=(1, 1, 1), scale=4.0))
        s.add(hk.make_quad((-1.5, -1.5, 1), (1.5, -1.5, 1), (1.5, 1.5, 1), (-1.5, 1.5, 1)), pane)
        s.add_light(hk.PointLight(position=(0, 0, -2), intensity=(1, 1, 1)))
        return s.build(device="cpu")

    cam = hk.make_perspective_camera((0, 0, -2.5), (0, 0, 0), (24, 24), fov_deg=35.0)
    vp = hk.Whitted(max_depth=4, samples_per_pixel=8)
    glass = _img(vp, build(hk.Glass(eta=1.5)), cam)[8:16, 8:16].mean()
    mirror = _img(vp, build(hk.Mirror()), cam)[8:16, 8:16].mean()
    assert glass > 0.2 and glass > 3.0 * mirror, (glass, mirror)


def test_whitted_smooth_conductor_fresnel_tint():
    s = hk.Scene()
    s.add(hk.make_quad((-3, -3, -3), (3, -3, -3), (3, 3, -3), (-3, 3, -3)),
          hk.Emissive(le=(1, 1, 1), scale=4.0))
    s.add(hk.make_sphere((0, 0, 0), 0.6, 16, 32), hk.Gold(roughness=0.0))
    s.add_light(hk.PointLight(position=(0, 2, -2), intensity=(5, 5, 5)))
    cam = hk.make_perspective_camera((0, 0, -2.2), (0, 0, 0), (24, 24), fov_deg=30.0)
    sphere = _img(hk.Whitted(max_depth=3, samples_per_pixel=4), s.build(device="cpu"),
                  cam)[8:16, 8:16]
    assert sphere.sum() > 0.05
    assert sphere[..., 0].sum() > 1.3 * sphere[..., 2].sum(), "not gold-tinted"


def test_render_preview_rejects_other_integrators():
    sc = quickstart_scene((4, 8)).build(device="cpu")
    with pytest.raises(TypeError):
        hk.render_preview(hk.VolPath(), sc, scene_camera("quickstart", 4))
