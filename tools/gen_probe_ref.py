#!/usr/bin/env python
"""Compute the JAX package's probes of the port's scenes, on the CPU.

    python tools/gen_probe_ref.py [--only KEY ...] [--reseeds N]
    python tools/gen_probe_ref.py --renders [KEY ...]

(KEY as hikari_tpu_torch.scenes.probe_key writes it, e.g. "sparse_cloud 32x32
depth 12 16 spp" or "default 64x64 depth 5 1 spp, mitchell filter".)

Writes hikari_tpu_torch/data/probe_ref.json, the stored side of every port
probe that tools/transport_ref.json does not hold (hikari_tpu_torch/scenes.py
probe_reference; chip_smoke.py phase 4; tests/test_torch_media_render.py,
tests/test_torch_lights_render.py). Each probe is
hikari_tpu_torch.scenes.transport_probe's computation on a scene of the
port's SCENE_DEFS under a light sampler and a filter: VolPath(max_depth=depth,
samples_per_pixel=spp) rendered for samples 0 .. spp-1, rays traced and
mean framebuffer RGB averaged over the samples.

Scenes without a medium render deterministically given the sampler, so
one draw is stored and the port matches it to rounding. Media draw from
per-lane LCG streams seeded from the bits of each ray, and the two
packages' rays differ in their last bits (XLA contracts a * b + c into
FMAs, PyTorch does not), so their streams are independent: a medium probe
is a comparison of averages, and its sample count is chosen so that the
tolerance is several standard errors of the difference. Each medium probe
is rendered N times (--reseeds, default 6) with every lane's LCG seed
XORed with the k-th salt of hikari_tpu_torch.tools.media_check.salt (k = 0
is the probe as is; media_check reseeds the port with the same salts).
The stored "rays_traced" and "mean_rgb" are the means over the draws,
beside the draws themselves and the relative spread of one draw
("draw_rel_std"); the per-sample spread is draw 0's.

--renders stores instead the JAX results that the quick tests compare
with (RENDERS below: whole renders, per-band means, an escape share), so
that those tests compile no JAX render, and the JAX package's render_aux
images, pixel for pixel, in hikari_tpu_torch/data/aux_ref.npz.

The scenes are built through the JAX API: the fog, the sun-sky cloud and
the materials scene by bench.build_fog_scene / build_cloud_scene /
build_materials_scene, and the grid cloud, the default
scene under a light sampler, the lights scene and the sparse cloud (written
to a NanoVDB file by the JAX package and read back as its BrickGridMedium)
by the jax_*_scene builders below (the same scenes as the port's scenes.py
builds). Draw 0's
port value on the CPU is printed beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

# (scene, light sampler, res, depth, spp, samples per JAX call[, filter type,
# hikari_tpu_torch.film.filters' numbering; Gaussian when absent])
PROBES = [
    ("fog", "power", 64, 5, 512, 16),         # chip_smoke.py phase 4, against 2%
    ("cloud_grid", "power", 32, 12, 16, 16),  # the bench cloud probe's configuration, 10%
    ("cloud", "power", 32, 12, 16, 16),       # the bench cloud probe, 10%
    ("fog", "power", 16, 5, 256, 64),         # tests/test_torch_media_render.py, 5%
    ("cloud_grid", "power", 16, 4, 64, 64),   # tests/test_torch_media_render.py, 5%
    ("default", "uniform", 64, 5, 1, 1),      # chip_smoke.py phase 4, tests (slow)
    ("default", "bvh", 64, 5, 1, 1),          # chip_smoke.py phase 4, tests (slow)
    ("lights", "power", 64, 5, 1, 1),         # chip_smoke.py phase 4, tests (slow)
    ("lights", "bvh", 32, 5, 4, 4),           # tests/test_torch_lights_render.py
    ("sparse_cloud", "power", 32, 12, 16, 16),  # chip_smoke.py phase 4, tests (slow), 10%
    ("default", "power", 64, 5, 1, 1, 3),     # Mitchell: chip_smoke.py phase 4, tests (slow)
    ("default", "power", 64, 5, 1, 1, 4),     # Lanczos: the same
    ("materials", "power", 64, 5, 1, 1),      # chip_smoke.py phase 4, tests (slow)
    ("triangle", "power", 64, 5, 1, 1),       # chip_smoke.py phase 4, tests
    ("textured", "power", 64, 5, 4, 4),       # chip_smoke.py phase 4, tests (slow)
    ("cornell", "power", 64, 6, 1, 1),        # chip_smoke.py phase 4, tests (slow)
]
# scenes the port's scenes.py builds through either package's API
API_SCENES = ("triangle", "textured", "cornell", "foliage", "swatch", "materials",
              "quickstart", "specular", "box")
# the coarse spheres (n_theta, n_phi) of the quick tests' scenes
COARSE = (8, 16)
MEDIUM_SCENES = ("fog", "cloud", "cloud_grid", "sparse_cloud")
OUT = os.path.join(ROOT, "hikari_tpu_torch", "data", "probe_ref.json")
AUX_OUT = os.path.join(ROOT, "hikari_tpu_torch", "data", "aux_ref.npz")


def jax_cloud_grid_scene():
    """hikari_tpu_torch.scenes.cloud_grid_scene through the JAX API."""
    from hikari_tpu.lights.types import PointLight
    from hikari_tpu.materials.types import Emissive, Interface, Matte
    from hikari_tpu.media.types import CloudVolume
    from hikari_tpu.scene.mesh import make_box, make_quad
    from hikari_tpu.scene.scene import Scene

    s = Scene()
    s.add(make_quad((-8, -0.5, -8), (8, -0.5, -8), (8, -0.5, 8), (-8, -0.5, 8)),
          Matte(kd=(0.3, 0.35, 0.4)))
    cloud = CloudVolume(resolution=64, bounds_lo=(-1.6, 0.1, -1.2),
                        bounds_hi=(1.6, 1.8, 1.2), sigma_s=(60.0,) * 3,
                        sigma_a=(0.4,) * 3, g=0.877)
    s.add(make_box((-1.6, 0.1, -1.2), (1.6, 1.8, 1.2)), Interface(), inside_medium=cloud)
    s.add(make_quad((-2.0, 3.5, -1.5), (2.0, 3.5, -1.5), (2.0, 3.5, 1.5), (-2.0, 3.5, 1.5)),
          Emissive(le=(0.85, 0.9, 1.0), scale=4.0))
    s.add_light(PointLight(position=(2.5, 4.0, -2.5), intensity=(40.0, 38.0, 34.0)))
    return s.build()


def jax_default_scene(sampler: str):
    """bench.py build_scene through the JAX API, under a light sampler."""
    from hikari_tpu.lights.types import PointLight
    from hikari_tpu.materials.types import Emissive, Glass, Gold, Matte, Mirror
    from hikari_tpu.scene.mesh import make_quad, make_sphere
    from hikari_tpu.scene.scene import Scene

    s = Scene()
    s.set_light_sampler(sampler)
    white = Matte(kd=(0.73, 0.73, 0.73))
    s.add(make_quad((-3, 0, -1), (3, 0, -1), (3, 0, 5), (-3, 0, 5)), white)
    s.add(make_quad((-3, 0, 5), (3, 0, 5), (3, 4, 5), (-3, 4, 5)), white)
    s.add(make_quad((-3, 0, -1), (-3, 0, 5), (-3, 4, 5), (-3, 4, -1)),
          Matte(kd=(0.65, 0.05, 0.05)))
    s.add(make_quad((3, 0, -1), (3, 4, -1), (3, 4, 5), (3, 0, 5)),
          Matte(kd=(0.12, 0.45, 0.15)))
    mats = [Gold(roughness=0.15), Glass(eta=1.5), Mirror(), Matte(kd=(0.3, 0.4, 0.8)),
            Matte(kd=(0.8, 0.6, 0.2))]
    for k, (ix, iz) in enumerate((ix, iz) for ix in range(4) for iz in range(4)):
        s.add(make_sphere((-1.8 + 1.2 * ix, 0.45, 0.2 + 1.2 * iz), 0.42, 32, 64),
              mats[k % len(mats)])
    s.add(make_quad((-1.0, 3.99, 1.0), (1.0, 3.99, 1.0), (1.0, 3.99, 3.0), (-1.0, 3.99, 3.0)),
          Emissive(le=(1.0, 0.95, 0.85), scale=25.0))
    s.add_light(PointLight(position=(0.0, 3.0, -0.5), intensity=(8.0, 8.0, 8.0)))
    return s.build()


def jax_lights_scene(sampler: str):
    """hikari_tpu_torch.scenes.lights_scene through the JAX API."""
    from hikari_tpu.lights.types import (AmbientLight, DistantLight, EnvironmentLight,
                                         SpotLight, equirect_to_equal_area)
    from hikari_tpu.materials.types import Gold, Matte
    from hikari_tpu.scene.mesh import make_box, make_quad, make_sphere
    from hikari_tpu.scene.scene import Scene
    from hikari_tpu_torch.scenes import latlong_sky

    s = Scene()
    s.set_light_sampler(sampler)
    s.add(make_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4)), Matte(kd=(0.6, 0.6, 0.6)))
    s.add(make_quad((-4, 0, 3), (4, 0, 3), (4, 3, 3), (-4, 3, 3)), Matte(kd=(0.5, 0.3, 0.2)))
    s.add(make_sphere((-0.6, 0.5, 0.8), 0.5, 16, 32), Gold(roughness=0.2))
    s.add(make_box((0.3, 0.0, 0.2), (1.1, 0.8, 1.0)), Matte(kd=(0.2, 0.4, 0.7)))
    s.add_light(SpotLight(position=(0.0, 2.5, -1.0), direction=(0.0, -1.0, 0.6),
                          intensity=(12.0, 11.0, 9.0), cone_angle_deg=35.0,
                          falloff_start_deg=20.0))
    s.add_light(DistantLight(direction=(-0.4, -1.0, 0.5), radiance=(1.2, 1.1, 1.0)))
    s.add_light(AmbientLight(radiance=(0.05, 0.05, 0.06)))
    s.add_light(EnvironmentLight(image=equirect_to_equal_area(latlong_sky(), 64), scale=0.8))
    return s.build()


def jax_sparse_cloud_scene():
    """hikari_tpu_torch.scenes.sparse_cloud_scene through the JAX API: the
    JAX package writes the cloud's NanoVDB file and reads it back sparse."""
    import tempfile

    from hikari_tpu.lights.sunsky import sunsky_environment
    from hikari_tpu.materials.types import Interface, Matte
    from hikari_tpu.media.nanovdb import nanovdb_medium, save_nanovdb
    from hikari_tpu.media.noise import generate_cloud_density
    from hikari_tpu.scene.mesh import make_box, make_quad
    from hikari_tpu.scene.scene import Scene
    from hikari_tpu_torch.scenes import SPARSE_CLOUD_BOX

    lo, hi = SPARSE_CLOUD_BOX
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cloud.nvdb")
        save_nanovdb(path, generate_cloud_density(96), origin=lo,
                     extent=tuple(b - a for a, b in zip(lo, hi)))
        cloud = nanovdb_medium(path, sigma_s=(55.0,) * 3, sigma_a=(0.3,) * 3, g=0.877,
                               sparse=True)
    s = Scene()
    s.add(make_quad((-12, 0, -12), (12, 0, -12), (12, 0, 12), (-12, 0, 12)),
          Matte(kd=(0.3, 0.34, 0.4)))
    s.add(make_box(lo, hi), Interface(), inside_medium=cloud)
    for light in sunsky_environment(direction=(0.55, 0.4, 0.35)):
        s.add_light(light)
    return s.build()


def jax_scene(which: str, sampler: str = "power"):
    """The JAX package's build of a scene of the port's SCENE_DEFS."""
    import bench
    import hikari_tpu
    from hikari_tpu_torch.scenes import BUILDERS

    if which in API_SCENES and which != "materials":
        return BUILDERS[which](api=hikari_tpu).build()
    if which == "default":
        return jax_default_scene(sampler)
    if which == "lights":
        return jax_lights_scene(sampler)
    assert sampler == "power", (which, sampler)
    if which == "fog":
        return bench.build_fog_scene()
    if which == "materials":
        return bench.build_materials_scene()
    if which == "cloud":
        return bench.build_cloud_scene()
    if which == "sparse_cloud":
        return jax_sparse_cloud_scene()
    return jax_cloud_grid_scene()


def jax_reseeded(k: int):
    """The JAX package's LCG seeds XORed with media_check.reseeded's k-th
    salt, while JAX traces (each jax_probe call traces anew)."""
    from hikari_tpu.media import sample as jms
    from hikari_tpu.sampling import u64
    from hikari_tpu_torch.tools.media_check import salt

    @contextlib.contextmanager
    def patched():
        orig = jms.lcg_init
        jms.lcg_init = lambda o, d, t_max: u64.xor(orig(o, d, t_max),
                                                    u64.from_int(salt(k), like=o[..., 0]))
        try:
            yield
        finally:
            jms.lcg_init = orig

    return patched()


def jax_probe(js, which: str, res: int, depth: int, spp: int, batch: int, ftype: int):
    """(rays traced per sample, mean RGB, per-sample mean RGB (spp,)) of the
    JAX package through filter ftype, `batch` samples per compiled call."""
    from hikari_tpu.camera.camera import make_perspective_camera
    from hikari_tpu.film.filters import make_filter
    from hikari_tpu.integrators.volpath import VolPath, render_lanes
    from hikari_tpu_torch.scenes import SCENE_DEFS

    assert spp % batch == 0, (spp, batch)
    (eye, at, fov), _ = SCENE_DEFS[which]
    camera = make_perspective_camera(eye, at, (res, res), fov_deg=fov)
    vp = VolPath(max_depth=depth, samples_per_pixel=spp)
    lanes = jnp.arange(res * res, dtype=jnp.uint32)
    px, py = jnp.tile(lanes % res, batch), jnp.tile(lanes // res, batch)

    @jax.jit
    def run(s0):
        si = s0 + jnp.repeat(jnp.arange(batch, dtype=jnp.uint32), res * res)
        rgb, _, stats = render_lanes(vp, js, camera, make_filter(ftype), si, px, py)
        return stats["rays_traced"], rgb.reshape(batch, -1).mean(1)

    rays, means = 0.0, []
    for s0 in range(0, spp, batch):
        r, m = run(jnp.uint32(s0))
        rays += float(r)
        means.append(np.asarray(m, np.float64))
    means = np.concatenate(means)
    return rays / spp, float(means.mean()), means


def jax_lanes(js, which: str, res: int, depth: int, spp: int):
    """The JAX package's render_lanes of samples 0 .. spp-1 of a scene at
    res x res through SCENE_DEFS's camera, in one compiled call through
    depth segment [0, depth) as the tests' JAX renders run: (rgb (spp *
    res^2, 3), rays traced per sample)."""
    from hikari_tpu.camera.camera import make_perspective_camera
    from hikari_tpu.film.filters import make_filter
    from hikari_tpu.integrators.volpath import VolPath, render_lanes
    from hikari_tpu_torch.scenes import SCENE_DEFS

    (eye, at, fov), _ = SCENE_DEFS[which]
    camera = make_perspective_camera(eye, at, (res, res), fov_deg=fov)
    lanes = jnp.arange(res * res, dtype=jnp.uint32)
    si = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), res * res)
    rgb, _, stats = jax.jit(lambda: render_lanes(
        VolPath(max_depth=depth, samples_per_pixel=spp), js, camera, make_filter(), si,
        jnp.tile(lanes % res, spp), jnp.tile(lanes // res, spp), depth_lo=jnp.int32(0),
        depth_hi=jnp.int32(depth)))()
    return np.asarray(rgb, np.float64), float(stats["rays_traced"]) / spp


def render_materials_coarse():
    """tests/test_torch_materials_render.py's JAX render: the materials scene
    with coarse spheres, 32x32, depth 5, sample 0 (every pixel's RGB)."""
    import hikari_tpu
    from hikari_tpu_torch.scenes import materials_scene

    rgb, rays = jax_lanes(materials_scene(COARSE, api=hikari_tpu).build(), "materials", 32, 5,
                          1)
    return {"res": 32, "depth": 5, "spp": 1, "rays_traced": rays,
            "rgb": np.asarray(rgb, np.float32).tolist()}


def render_textured_coarse():
    """tests/test_torch_textures.py: the textured scene with coarse spheres,
    32x32, depth 5, samples 0-3: rays per sample and mean RGB."""
    import hikari_tpu
    from hikari_tpu_torch.scenes import textured_scene

    rgb, rays = jax_lanes(textured_scene(COARSE, api=hikari_tpu).build(), "textured", 32, 5, 4)
    return {"res": 32, "depth": 5, "spp": 4, "rays_traced": rays,
            "mean_rgb": float(rgb.mean())}


def render_swatch():
    """tests/test_torch_textures.py and test_torch_alpha.py: the swatch
    scene's probe (SCENE_DEFS), the mean RGB of each of its four bands of
    columns (scenes.SWATCH_BANDS) over the samples, and the spread of a
    band's pixel-sample means (the standard error of the band mean)."""
    import hikari_tpu
    from hikari_tpu_torch.scenes import SWATCH_BANDS, probe_config, swatch_scene

    res, depth, spp = probe_config("swatch")
    rgb, rays = jax_lanes(swatch_scene(api=hikari_tpu).build(), "swatch", res, depth, spp)
    px = rgb.reshape(spp, res, res, 3).mean(-1)  # (sample, row, column)
    bands = np.split(px, len(SWATCH_BANDS), axis=2)
    return {"res": res, "depth": depth, "spp": spp, "rays_traced": rays,
            "band_mean": [float(b.mean()) for b in bands],
            "band_sem": [float(b.std(ddof=1) / np.sqrt(b.size)) for b in bands]}


def render_foliage_escape():
    """tests/test_torch_alpha.py: the share of tests/test_alpha_mix.py's
    8192 rays (origins RandomState(0) uniform over [-3, 3]^2 at z = 0, along
    +z) that escape the foliage stack in the JAX package's
    _closest_hit_surface."""
    import hikari_tpu
    from hikari_tpu.integrators.volpath import _closest_hit_surface
    from hikari_tpu_torch.scenes import foliage_scene

    js = foliage_scene(api=hikari_tpu).build()
    n = 8192
    rng = np.random.RandomState(0)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-3, 3, (n, 2))
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    rec = _closest_hit_surface(js, jnp.asarray(o), d, jnp.full((n,), jnp.inf),
                               active=jnp.ones((n,), bool))
    return {"rays": n, "escape": 1.0 - float(np.asarray(rec.hit).mean())}


def render_aux_ref(which: str, res: int = 64):
    """chip_smoke.py phase 4 and tests/test_torch_film_io.py: the JAX
    package's render_aux of a scene at res x res through SCENE_DEFS's
    camera, pixel for pixel, with the leaf-order face of each pixel's
    closest hit, written to AUX_OUT as <which>_albedo / _normal / _depth /
    _face; returns the means of the first three (for the record in
    probe_ref.json). The face comes from one jitted program that computes
    render_aux's body and keeps rec.tri; its images must equal
    render_aux's bit for bit, because where a ray meets the shared edge of
    two faces at one t, another program (the closest hit alone, say) can
    round to the other face."""
    import hikari_tpu
    from hikari_tpu.camera.camera import CameraSample, make_perspective_camera
    from hikari_tpu.integrators import volpath as jv
    from hikari_tpu_torch.scenes import BUILDERS, SCENE_DEFS

    (eye, at, fov), _ = SCENE_DEFS[which]
    js = BUILDERS[which](api=hikari_tpu).build()
    cam = make_perspective_camera(eye, at, (res, res), fov_deg=fov)

    @jax.jit
    def aux_and_face(scene, camera):
        n = res * res
        lanes = jnp.arange(n, dtype=jnp.uint32)
        p_film = jnp.stack([(lanes % res).astype(jnp.float32),
                            (lanes // res).astype(jnp.float32)], -1) + 0.5
        o, d = camera.generate_rays(CameraSample(
            p_film=p_film, lens=jnp.zeros((n, 2)), time=jnp.zeros((n,)),
            filter_weight=jnp.ones((n,))))
        rec = jv.scene_closest_hit(scene, o, d, jnp.full((n,), jnp.inf))
        sd = jv._surface_data(scene, rec, o, d)
        albedo = jv._albedo_rgb_dispatch(scene, sd["mat_type"], sd["mat_idx"], sd["tex"])
        hit = rec.hit
        return (jnp.where(hit[..., None], albedo, 0.0).reshape(res, res, 3),
                jnp.where(hit[..., None], sd["ns"], 0.0).reshape(res, res, 3),
                jnp.where(hit, rec.t, 0.0).reshape(res, res),
                jnp.where(hit, rec.tri, -1).reshape(res, res))

    albedo, normal, depth = (np.asarray(x, np.float32) for x in jv.render_aux(js, cam))
    *same, face = (np.asarray(x) for x in aux_and_face(js, cam))
    for a, b in zip(same, (albedo, normal, depth)):
        assert np.array_equal(a, b), "the face's program renders another aux image"
    arrays = {}
    if os.path.exists(AUX_OUT):
        with np.load(AUX_OUT) as z:
            arrays = dict(z)
    arrays.update({f"{which}_albedo": albedo, f"{which}_normal": normal,
                   f"{which}_depth": depth, f"{which}_face": face.astype(np.int32)})
    np.savez_compressed(AUX_OUT, **arrays)


# the preview integrators' references: (scene, Whitted(...) fields) at PREVIEW_RES
PREVIEW_RES = 16
PREVIEW_CASES = {"quickstart": dict(max_depth=3, samples_per_pixel=4),
                 "specular": dict(max_depth=5, samples_per_pixel=4)}
# SPPM's: tests/test_sppm.py's box and its radius test's configuration
SPPM_RES = 16
SPPM_CONFIG = dict(iterations=4, photons_per_iteration=8192, initial_radius=0.3, max_depth=3)


def render_preview_ref(which: str):
    """tests/test_torch_preview.py: Whitted (PREVIEW_CASES) and
    FastWavefront() of a scene at PREVIEW_RES through SCENE_DEFS's camera.
    For each, the image of the JAX package's preview lanes run eagerly
    (jax.disable_jit, the mean over the samples: the port is held to it
    pixel for pixel) and the mean of its jitted render_preview (the port's
    mean is held to it too). Eager, because XLA contracts the layered
    walks' arithmetic under jit: on the quickstart's Plastic 6% of jitted
    layered evaluations differ from the same function run eagerly by more
    than 1e-4, and a walk that takes the other side of a comparison walks
    on differently."""
    import hikari_tpu
    from hikari_tpu.camera.camera import make_perspective_camera
    from hikari_tpu.film.film import framebuffer
    from hikari_tpu.integrators import preview as jp
    from hikari_tpu_torch.scenes import BUILDERS, SCENE_DEFS

    (eye, at, fov), _ = SCENE_DEFS[which]
    js = BUILDERS[which](api=hikari_tpu).build()
    cam = make_perspective_camera(eye, at, (PREVIEW_RES, PREVIEW_RES), fov_deg=fov)
    out = {"res": PREVIEW_RES}
    for name, integ, lanes in (
            ("whitted", jp.Whitted(**PREVIEW_CASES[which]), jp._whitted_lanes),
            ("fast", jp.FastWavefront(), jp._preview_lanes)):
        depth = integ.max_depth if name == "whitted" else 2
        with jax.disable_jit():
            img = np.mean([np.asarray(lanes(js, cam, jnp.uint32(s), integ.samples_per_pixel,
                                            integ.seed, depth))
                           for s in range(integ.samples_per_pixel)], axis=0)
        jitted = np.asarray(framebuffer(jp.render_preview(integ, js, cam)))
        out[name] = {"integrator": {"max_depth": depth,
                                    "samples_per_pixel": integ.samples_per_pixel},
                     "eager_rgb": img.reshape(PREVIEW_RES, PREVIEW_RES, 3).tolist(),
                     "render_preview_mean": float(jitted.mean())}
    return out


def render_sppm_ref():
    """tests/test_torch_sppm.py: the box scene at SPPM_RES under
    SPPM(**SPPM_CONFIG): the state (r2, n, tau, direct per pixel) after the
    first jitted _sppm_iteration, and the mean of render_sppm's image."""
    import hikari_tpu
    from hikari_tpu.camera.camera import make_perspective_camera
    from hikari_tpu.integrators import sppm as js_
    from hikari_tpu_torch.scenes import SCENE_DEFS, box_scene

    (eye, at, fov), _ = SCENE_DEFS["box"]
    scene = box_scene(api=hikari_tpu).build()
    cam = make_perspective_camera(eye, at, (SPPM_RES, SPPM_RES), fov_deg=fov)
    integ = js_.SPPM(**SPPM_CONFIG)
    n = SPPM_RES * SPPM_RES
    state = dict(r2=jnp.full((n,), integ.initial_radius ** 2), n=jnp.zeros((n,)),
                 tau=jnp.zeros((n, 3)), direct=jnp.zeros((n, 3)),
                 iters=jnp.zeros((), jnp.int32))
    state = js_._sppm_iteration(integ, scene, cam, state, jnp.int32(0))
    img = np.asarray(js_.render_sppm(integ, scene, cam))
    return {"res": SPPM_RES, "config": SPPM_CONFIG,
            "state_after_1": {k: np.asarray(state[k]).tolist()
                              for k in ("r2", "n", "tau", "direct")},
            "render_mean": float(img.mean())}


RENDERS = {"materials coarse": render_materials_coarse,
           "aux textured": lambda: render_aux_ref("textured"),
           "aux cornell": lambda: render_aux_ref("cornell"),
           "textured coarse": render_textured_coarse,
           "swatch": render_swatch, "foliage escape": render_foliage_escape,
           "preview quickstart": lambda: render_preview_ref("quickstart"),
           "preview specular": lambda: render_preview_ref("specular"),
           "sppm box": render_sppm_ref}


def main():
    from hikari_tpu_torch.film.filters import GAUSSIAN
    from hikari_tpu_torch.scenes import BUILDERS, FILTER_NAMES, probe_key, transport_probe

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", help="probe keys to recompute (default: all)")
    ap.add_argument("--reseeds", type=int, default=6, help="LCG draws of each medium probe")
    ap.add_argument("--renders", nargs="*", help="RENDERS keys to recompute, then stop")
    args = ap.parse_args()
    refs = {"probes": {}}
    if os.path.exists(OUT):
        with open(OUT) as f:
            refs = json.load(f)
    if args.renders is not None:
        renders = refs.setdefault("renders", {})
        for key in args.renders or RENDERS:
            t0 = time.perf_counter()
            out = RENDERS[key]()
            if out is not None:  # None: the result went to AUX_OUT
                renders[key] = out
            print(f"render {key!r}: {time.perf_counter() - t0:.0f} s", flush=True)
            with open(OUT, "w") as f:
                json.dump(refs, f, indent=1)
                f.write("\n")
        return
    scenes, ports = {}, {}
    for which, sampler, res, depth, spp, batch, *ft in PROBES:
        ftype = ft[0] if ft else GAUSSIAN
        key = probe_key(which, res, depth, spp, sampler, ftype)
        if args.only and key not in args.only:
            continue
        if (which, sampler) not in scenes:
            scenes[which, sampler] = jax_scene(which, sampler)
            s = BUILDERS[which]()
            s.set_light_sampler(sampler)
            ports[which, sampler] = s.build(device="cpu")
        draws = []
        for k in range(args.reseeds if which in MEDIUM_SCENES else 1):
            t0 = time.perf_counter()
            with jax_reseeded(k):
                rays, mean_rgb, means = jax_probe(scenes[which, sampler], which, res, depth,
                                                  spp, batch, ftype)
            secs = time.perf_counter() - t0
            draws.append((rays, mean_rgb))
            port = ""
            if k == 0:
                spread = float(means.std(ddof=1) / means.mean()) if spp > 1 else None
                p = transport_probe(ports[which, sampler], which, res=res, depth=depth, spp=spp,
                                    ftype=ftype)
                port = f"; port on the CPU {p[0]:.4f} rays, {p[1]:.7f}"
            print(f"{key}, draw {k}: JAX {rays:.4f} rays, mean RGB {mean_rgb:.7f} ({secs:.0f} "
                  f"s){port}", flush=True)
        j = np.array(draws)
        rel = j.std(0, ddof=1) / j.mean(0) if len(j) > 1 else [None, None]
        refs["probes"][key] = {
            "scene": which, "sampler": sampler, "filter": FILTER_NAMES[ftype], "res": res,
            "depth": depth, "spp": spp,
            "rays_traced": float(j[:, 0].mean()), "mean_rgb": float(j[:, 1].mean()),
            "draws": {"rays_traced": j[:, 0].tolist(), "mean_rgb": j[:, 1].tolist()},
            "draw_rel_std": {"rays_traced": None if rel[0] is None else float(rel[0]),
                             "mean_rgb": None if rel[1] is None else float(rel[1])},
            "sample_mean_rel_std": spread, "backend": jax.default_backend(),
        }
        print(f"{key}, {len(j)} draw(s): mean rays {j[:, 0].mean():.4f}, mean RGB "
              f"{j[:, 1].mean():.7f}, rel std of a draw {rel[0]}, {rel[1]}", flush=True)
        with open(OUT, "w") as f:
            json.dump(refs, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main()
