"""Port parity: every material on the render path (VolPath render_lanes).

* bench.py's materials scene (the default scene's 16 spheres cycling
  through the ten BSDF-bearing materials, the three layered coats among
  them) with coarse spheres at 32x32, 1 spp, depth 5: the JAX package's
  render (stored in hikari_tpu_torch/data/probe_ref.json by
  tools/gen_probe_ref.py --renders) against the port's, rays within 0.5%
  and mean RGB within 2% (the transport probe's tolerances) and >= 97% of
  pixels within 1e-3 relative + 1e-5 absolute (a layered walk that takes
  the other side of a comparison walks on differently, see
  tests/test_torch_layered.py); the port's material_coherence modes
  'none', 'gated' and 'sorted' against each other, rays equal and mean RGB
  within 1e-5 relative (torch's vectorised and scalar log / exp may round
  a lane's walk apart on the CPU); and the JAX package's build of the
  scene carried over by bridge.scene_from_numpy renders as the port's
  build;
* (slow) the full scene's 64x64 depth-5 probe against the JAX package's
  stored in hikari_tpu_torch/data/probe_ref.json (tools/gen_probe_ref.py),
  rays within 0.5% and mean RGB within 2%, under each of the three modes,
  which agree as above;
* Mix: the hash that picks a child equals the JAX package's bit for bit;
  the Mix floor (tests/test_materials_ext.py's) shows both children on
  0.2-0.8 of its lit pixels each; a Mix with an emissive child is neither
  refused on an instance nor a light, as in the JAX package;
* the JAX package's quickstart scene (a Plastic sphere under the sun and
  sky) renders on the port;
* an instanced scene whose instances override to CoatedConductor and to a
  Mix renders finite through the plain instanced sweeps; a
  CoatedDiffuseTransmission sphere in a homogeneous medium renders finite,
  and its transmissive exits switch the path's medium (JAX
  volpath.py:1386-1388: a transmission enters the medium on the far side
  of the surface from the exit direction);
* port-only properties of the walk: a CoatedDiffuse with ior 1 and no slab
  is the Lambertian base (tests/test_furnace.py:47), and each coated
  material's white-furnace albedo is at most 1 (tests/test_layered.py:38,
  :182).
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu as jhk
from hikari_tpu.sampling import u64 as ju64
from hikari_tpu.sampling.hashes import hash_u32x2 as j_hash_u32x2
from hikari_tpu.scene.scene import Scene as JScene
import hikari_tpu_torch as hk
from hikari_tpu_torch.integrators.volpath import mix_u
from hikari_tpu_torch.materials import layered as tl
from hikari_tpu_torch.materials import types as tmt
from hikari_tpu_torch.scene.bridge import scene_from_numpy
from hikari_tpu_torch.scenes import (PROBE_REF, SCENE_DEFS, materials_scene, mix_scene,
                                     probe_reference, transport_probe)
from test_torch_lights_render import _assert_invariants
from test_torch_scene import SPHERE_RES, jax_scene_arrays

RES = 32
MODES = ("none", "gated", "sorted")
CAMERA = SCENE_DEFS["materials"][0]


def _materials_scene(m, sphere_res):
    """bench.py build_materials_scene through API m, spheres at sphere_res."""
    s = m.Scene()
    white = m.Matte(kd=(0.73, 0.73, 0.73))
    s.add(m.make_quad((-3, 0, -1), (3, 0, -1), (3, 0, 5), (-3, 0, 5)), white)
    s.add(m.make_quad((-3, 0, 5), (3, 0, 5), (3, 4, 5), (-3, 4, 5)), white)
    s.add(m.make_quad((-3, 0, -1), (-3, 0, 5), (-3, 4, 5), (-3, 4, -1)),
          m.Matte(kd=(0.65, 0.05, 0.05)))
    s.add(m.make_quad((3, 0, -1), (3, 4, -1), (3, 4, 5), (3, 0, 5)),
          m.Matte(kd=(0.12, 0.45, 0.15)))
    mats = [m.Matte(kd=(0.3, 0.4, 0.8)), m.Mirror(), m.Glass(eta=1.5), m.Gold(roughness=0.15),
            m.ThinDielectric(), m.DiffuseTransmission(), m.CoatedDiffuse(),
            m.CoatedConductor(), m.CoatedDiffuseTransmission(), m.Glass(eta=1.33)]
    for k, (ix, iz) in enumerate((ix, iz) for ix in range(4) for iz in range(4)):
        s.add(m.make_sphere((-1.8 + 1.2 * ix, 0.45, 0.2 + 1.2 * iz), 0.42, *sphere_res),
              mats[k % len(mats)])
    s.add(m.make_quad((-1.0, 3.99, 1.0), (1.0, 3.99, 1.0), (1.0, 3.99, 3.0),
                      (-1.0, 3.99, 3.0)), m.Emissive(le=(1.0, 0.95, 0.85), scale=25.0))
    s.add_light(m.PointLight(position=(0.0, 3.0, -0.5), intensity=(8.0, 8.0, 8.0)))
    return s


JAX_API = SimpleNamespace(Scene=JScene, **{n: getattr(jhk, n) for n in (
    "make_quad", "make_sphere", "Matte", "Mirror", "Glass", "Gold", "ThinDielectric",
    "DiffuseTransmission", "CoatedDiffuse", "CoatedConductor", "CoatedDiffuseTransmission",
    "Emissive", "PointLight")})


def _render(ts, depth=5, res=RES, camera=CAMERA, spp=1, **vp_kw):
    """Port render_lanes of samples 0 .. spp-1: (rgb (spp * res^2, 3),
    rays traced)."""
    eye, at, fov = camera
    lanes = torch.arange(res * res).repeat(spp)
    si = torch.arange(spp).repeat_interleave(res * res)
    rgb, _, st = hk.render_lanes(hk.VolPath(max_depth=depth, samples_per_pixel=spp, **vp_kw),
                                 ts, hk.make_perspective_camera(eye, at, (res, res), fov_deg=fov),
                                 hk.make_filter(), si, lanes % res, lanes // res)
    assert float(st["nonfinite_lanes"]) == 0.0
    return rgb.numpy(), float(st["rays_traced"])


@pytest.fixture(scope="module")
def coarse():
    """(JAX build, port build) of the coarse materials scene."""
    return (_materials_scene(JAX_API, SPHERE_RES).build(),
            materials_scene(SPHERE_RES).build(device="cpu"))


@pytest.fixture(scope="module")
def port_modes(coarse):
    return {mode: _render(coarse[1], material_coherence=mode) for mode in MODES}


def _assert_modes_agree(results):
    rgb0, rays0 = results["none"]
    for mode, (rgb, rays) in results.items():
        assert rays == rays0, (mode, rays, rays0)
        assert abs(rgb.mean() - rgb0.mean()) <= 1e-5 * abs(rgb0.mean()), mode


def test_coarse_scene_matches_jax(coarse, port_modes):
    """Against the JAX package's render of the same scene and samples,
    stored by tools/gen_probe_ref.py --renders (its render_lanes at 32x32,
    depth 5, sample 0)."""
    js, ts = coarse
    ref = json.loads(PROBE_REF.read_text())["renders"]["materials coarse"]
    assert (ref["res"], ref["depth"], ref["spp"]) == (RES, 5, 1)
    jrgb, jrays = np.asarray(ref["rgb"], np.float32), float(ref["rays_traced"])
    trgb, trays = port_modes["none"]
    _assert_invariants(jrgb, jrays, trgb, trays)
    close = (np.abs(trgb - jrgb) <= 1e-3 * np.abs(jrgb) + 1e-5).all(-1)
    assert close.mean() >= 0.97, f"{(~close).sum()} of {close.size} pixels differ"
    assert ts.present_materials == tuple(int(t) for t in js.present_materials)


def test_coarse_scene_modes_agree(port_modes):
    _assert_modes_agree(port_modes)


def test_bridge_carries_the_materials_scene(coarse, port_modes):
    js, _ = coarse
    bs = scene_from_numpy(jax_scene_arrays(js), "cpu")
    rgb, rays = _render(bs)
    trgb, trays = port_modes["none"]
    assert rays == trays
    assert abs(rgb.mean() - trgb.mean()) <= 1e-5 * abs(trgb.mean())


@pytest.mark.slow
def test_materials_probe_against_jax():
    """The full scene's 64x64 depth-5 1-spp probe under each mode against
    the JAX package's stored probe; the modes agree with each other."""
    sc = materials_scene().build(device="cpu")
    ref = probe_reference("materials")
    results = {}
    for mode in MODES:
        rays, mean_rgb = transport_probe(sc, "materials", material_coherence=mode)
        assert abs(rays - ref["rays_traced"]) <= 0.005 * ref["rays_traced"], (mode, rays)
        assert abs(mean_rgb - ref["mean_rgb"]) <= 0.02 * ref["mean_rgb"], (mode, mean_rgb)
        results[mode] = (np.asarray([mean_rgb]), rays)
    _assert_modes_agree(results)


# --- Mix ------------------------------------------------------------------------------


def test_mix_hash_matches_jax():
    rng = np.random.RandomState(3)
    n = 4096
    b1 = rng.rand(n).astype(np.float32)
    b2 = (rng.rand(n) * (1.0 - b1)).astype(np.float32)
    b1[:4] = [0.0, 1.0, 0.5, 1e-30]
    b2[:4] = [0.0, 0.0, 0.5, 0.0]
    tri = rng.randint(0, 2 ** 31 - 1, n).astype(np.int32)
    tri[:3] = [0, 1, 2 ** 31 - 1]
    h = j_hash_u32x2(
        jax.lax.bitcast_convert_type(jnp.asarray(b1) + 0.123, jnp.uint32)
        ^ jnp.asarray(tri).astype(jnp.uint32),
        jax.lax.bitcast_convert_type(jnp.asarray(b2) + 0.456, jnp.uint32))
    want = ju64.to_u32(ju64.shr(h, 32)).astype(jnp.float32) * jnp.float32(2.3283064e-10)
    got = mix_u(torch.from_numpy(b1), torch.from_numpy(b2), torch.from_numpy(tri).long())
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want).view(np.uint32))


def test_mix_floor_shows_both_children():
    """tests/test_materials_ext.py::test_mix_material_render on the port."""
    (eye, at, fov), _ = SCENE_DEFS["mix"]
    cam = hk.make_perspective_camera(eye, at, (32, 32), fov_deg=fov)
    img = hk.framebuffer(hk.render(hk.VolPath(max_depth=2, samples_per_pixel=4),
                                   mix_scene().build(device="cpu"), cam)).numpy()
    assert np.all(np.isfinite(img))
    lit = img.sum(-1) > 1e-3
    red_frac = (img[..., 0] > 2 * img[..., 1])[lit].mean()
    green_frac = (img[..., 1] > 2 * img[..., 0])[lit].mean()
    assert 0.2 < red_frac < 0.8, red_frac
    assert 0.2 < green_frac < 0.8, green_frac


def _mix_emissive_scene(m):
    """A Mix with an emissive child on a flat quad and as an instance
    override, under a point light."""
    mix = m.Mix(m1=m.Emissive(le=(1.0, 1.0, 1.0), scale=5.0), m2=m.Matte(), amount=0.5)
    s = m.Scene()
    s.add(m.make_quad((-2, 0, -2), (2, 0, -2), (2, 0, 2), (-2, 0, 2)), mix)
    tr = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    tr[:, 0, 3] = (-0.6, 0.6)
    tr[:, 1, 3] = 0.5
    s.add_instanced(m.make_sphere((0, 0, 0), 0.4, 6, 12), tr, m.Matte(),
                    materials=[mix, m.Matte()])
    s.add_light(m.PointLight(position=(0, 3, 0), intensity=(10, 10, 10)))
    return s


def test_mix_with_emissive_child_is_no_light():
    """The JAX package refuses emissive instance materials by tag and
    registers area lights on faces whose own tag is EMISSIVE only; so
    does the port."""
    jmods = SimpleNamespace(Scene=JScene, Mix=jhk.Mix, Emissive=jhk.Emissive, Matte=jhk.Matte,
                            make_quad=jhk.make_quad, make_sphere=jhk.make_sphere,
                            PointLight=jhk.PointLight)
    js = _mix_emissive_scene(jmods).build()
    ts = _mix_emissive_scene(hk).build(device="cpu")
    assert ts.n_lights == js.n_lights == 1
    assert tmt.MIX in ts.present_materials and tmt.EMISSIVE in ts.present_materials
    bad = hk.Scene()
    bad.add_instanced(hk.make_sphere((0, 0, 0), 0.4, 6, 12), np.eye(4)[None], hk.Matte(),
                      materials=[hk.Emissive()])
    with pytest.raises(ValueError, match="emissive"):
        bad.build(device="cpu")
    rgb, _ = _render(ts, depth=3, res=16, camera=((0.0, 2.0, -3.0), (0.0, 0.3, 0.0), 45.0))
    assert rgb.mean() > 0.0


def test_mix_beside_more_rows_of_other_types():
    """A Mix whose scene holds more rows of another type than of Mix: the
    other tags' indices pass the Mix bank and are clamped, as XLA's gather
    clamps them (they indexed past it and raised before)."""
    s = hk.Scene()
    for k, kd in enumerate(((0.7, 0.2, 0.2), (0.2, 0.7, 0.2), (0.2, 0.2, 0.7))):
        x = -1.5 + k
        s.add(hk.make_quad((x, 0, -1), (x + 1, 0, -1), (x + 1, 0, 1), (x, 0, 1)),
              hk.Matte(kd=kd))
    s.add(hk.make_quad((-1.5, 0, 1), (1.5, 0, 1), (1.5, 1, 1), (-1.5, 1, 1)),
          hk.Mix(m1=hk.Matte(kd=(0.9, 0.9, 0.1)), m2=hk.Mirror(), amount=0.5))
    s.add_light(hk.PointLight(position=(0, 2, -1), intensity=(8, 8, 8)))
    ts = s.build(device="cpu")
    assert int(ts.materials.mix_amount.shape[0]) == 1 and int(ts.mat_idx.max()) >= 2
    rgb, rays = _render(ts, depth=2, res=16, camera=((0.0, 1.0, -3.0), (0.0, 0.3, 0.5), 50.0))
    assert np.isfinite(rgb).all() and rgb.mean() > 0.0 and rays > 0


def test_quickstart_plastic_sphere_renders():
    """The JAX package's quickstart scene (hikari_tpu/__init__.py: a
    Plastic sphere on a floor under the sun and sky) on the port."""
    s = hk.Scene()
    s.add(hk.make_sphere((0, 0.5, 0), 0.5), hk.Plastic(kd=(0.8, 0.1, 0.1)))
    s.add(hk.make_quad((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5)),
          hk.Matte(kd=(0.6, 0.6, 0.6)))
    for light in hk.sunsky_environment(direction=(0.4, 0.3, 1.0)):
        s.add_light(light)
    rgb, rays = _render(s.build(device="cpu"), depth=3, res=16,
                        camera=((0.0, 1.0, -4.0), (0.0, 0.5, 0.0), 45.0))
    assert np.isfinite(rgb).all() and rgb.mean() > 0.0 and rays > 0


# --- instanced and medium paths ------------------------------------------------------------


def test_instanced_coated_and_mix_overrides_render():
    s = hk.Scene()
    s.add(hk.make_quad((-3, 0, -3), (3, 0, -3), (3, 0, 3), (-3, 0, 3)), hk.Matte())
    tr = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    tr[:, 0, 3] = (-1.0, 0.0, 1.0)
    tr[:, 1, 3] = 0.5
    mix = hk.Mix(m1=hk.Matte(kd=(0.8, 0.1, 0.1)), m2=hk.CoatedDiffuse(roughness=0.2))
    s.add_instanced(hk.make_sphere((0, 0, 0), 0.45, 8, 16), tr, hk.Matte(),
                    materials=[hk.CoatedConductor(), mix, hk.Plastic()])
    s.add_light(hk.PointLight(position=(0, 3, -1), intensity=(10, 10, 10)))
    ts = s.build(device="cpu")
    assert ts.has_instances
    assert {tmt.COATED_CONDUCTOR, tmt.MIX, tmt.COATED_DIFFUSE} <= set(ts.present_materials)
    for mode in ("none", "sorted"):
        rgb, rays = _render(ts, depth=3, res=16, camera=((0.0, 1.5, -3.5), (0.0, 0.4, 0.0), 45.0),
                            material_coherence=mode)
        assert np.isfinite(rgb).all() and rgb.mean() > 0.0 and rays > 0


CDT_CENTRE = (0.0, 0.6, 0.0)
CDT_RADIUS = 0.5


def _cdt_medium_scene():
    """A CoatedDiffuseTransmission sphere holding a dense medium (id 1, the
    second registered) in a thin fog (id 0) that the camera sits in, over a
    floor."""
    dense = hk.HomogeneousMedium(sigma_a=(0.5,) * 3, sigma_s=(2.0,) * 3, g=0.2)
    fog = hk.HomogeneousMedium(sigma_a=(0.01,) * 3, sigma_s=(0.05,) * 3, g=0.0)
    s = hk.Scene()
    s.add(hk.make_quad((-3, 0, -3), (3, 0, -3), (3, 0, 3), (-3, 0, 3)), hk.Matte(),
          outside_medium=fog)
    s.add(hk.make_sphere(CDT_CENTRE, CDT_RADIUS, 12, 24),
          hk.CoatedDiffuseTransmission(transmittance=(0.6, 0.6, 0.6), roughness=0.1),
          inside_medium=dense, outside_medium=fog)
    s.set_camera_medium(fog)
    s.add_light(hk.PointLight(position=(0.5, 3, -1.5), intensity=(12, 12, 12)))
    return s.build(device="cpu")


CDT_CAMERA = ((0.0, 0.9, -2.0), (0.0, 0.6, 0.0), 40.0)


def test_coated_transmission_in_a_medium_renders():
    rgb, rays = _render(_cdt_medium_scene(), depth=5, res=16, camera=CDT_CAMERA)
    assert np.isfinite(rgb).all() and rgb.mean() > 0.0 and rays > 0


def test_coated_transmission_switches_medium():
    """After the first bounce, a path that left the sphere's surface into
    it (a transmission) carries the sphere's medium, one that left outward
    the fog's."""
    sc = _cdt_medium_scene()
    res = 32
    eye, at, fov = CDT_CAMERA
    lanes = torch.arange(res * res)
    st, _ = hk.render_lanes(hk.VolPath(max_depth=1, samples_per_pixel=1), sc,
                            hk.make_perspective_camera(eye, at, (res, res), fov_deg=fov),
                            hk.make_filter(), 0, lanes % res, lanes // res, depth_lo=0,
                            depth_hi=1, return_carry=True)
    rel = st["o"] - torch.tensor(CDT_CENTRE)
    on_sphere = st["alive"] & ((rel.norm(dim=-1) - CDT_RADIUS).abs() < 2e-2)
    inward = (st["d"] * rel).sum(-1) < 0.0
    med = st["med"]
    assert int((on_sphere & inward).sum()) > 20 and int((on_sphere & ~inward).sum()) > 20
    assert bool((med[on_sphere & inward] == 1).all())
    assert bool((med[on_sphere & ~inward] == 0).all())


# --- port-only properties of the walk --------------------------------------------------------


def _walk_throughput(banks, sample, n=16384, wo_z=0.8, seed=0):
    """f cos / pdf of n samples at one wo, their validity and wi."""
    rng = np.random.RandomState(seed)
    wo = torch.tensor([[np.sqrt(1 - wo_z ** 2), 0.0, wo_z]], dtype=torch.float32).repeat(n, 1)
    lam = torch.tensor([[480.0, 530.0, 590.0, 650.0]]).repeat(n, 1)
    s = sample(banks, torch.zeros(n, dtype=torch.int32), wo, lam,
               torch.from_numpy(rng.rand(n, 2).astype(np.float32)),
               torch.from_numpy(rng.rand(n).astype(np.float32)))
    thr = s.f * (s.wi[:, 2].abs() / s.pdf.clamp(min=1e-9))[:, None]
    return thr.numpy(), s.valid.numpy(), s.wi.numpy()


def test_coated_diffuse_ior1_thickness0_is_matte():
    banks = tmt.pack_materials([tmt.CoatedDiffuse(reflectance=(1.0, 1.0, 1.0), ior=1.0,
                                                  thickness=0.0)])[0]
    thr, ok, wi = _walk_throughput(banks, tl.sample_coated_diffuse)
    assert ok.mean() > 0.99, ok.mean()
    assert abs(thr[ok].mean() - 1.0) < 0.02, thr[ok].mean()
    assert abs(wi[ok, 2].mean() - 2.0 / 3.0) < 0.02  # cosine-distributed


@pytest.mark.parametrize("material,sample", [
    (tmt.CoatedDiffuse(reflectance=(1.0,) * 3, thickness=0.0), tl.sample_coated_diffuse),
    (tmt.CoatedConductor(conductor_roughness=0.2), tl.sample_coated_conductor),
    (tmt.CoatedDiffuseTransmission(reflectance=(0.6,) * 3, transmittance=(0.4,) * 3,
                                   thickness=0.0), tl.sample_coated_diffuse_transmission),
], ids=["CoatedDiffuse", "CoatedConductor", "CoatedDiffuseTransmission"])
def test_white_furnace_albedo_at_most_one(material, sample):
    banks = tmt.pack_materials([material])[0]
    thr, ok, _ = _walk_throughput(banks, sample)
    assert ok.mean() > 0.5, ok.mean()  # walks cut at MAX_WALK or by a failed event
    assert 0.3 < thr[ok].mean() <= 1.02, thr[ok].mean()
