"""The harness driven end to end on the CPU at test size: sound runs come
out correct, the control and each planted fault come out not correct, a
cell added as files alone is found, and the window and bound arithmetic
hold."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import bound, harness
from portbench.control import main as control_main
from portbench.tests.tiny import CELLS, overrides, traffic

ROOT = Path(__file__).resolve().parents[2]


def run_cell(cell, seed=12345, trace=0, root=None, ov=None):
    lines = []
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                       "--trace", str(trace)], device="cpu", root=root,
                      overrides=ov or overrides(cell), emit=lines.append)
    assert rc == 0
    return json.loads(lines[-1])


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def listed(cell, kind, host_only=False):
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {m["name"] for m in manifest[kind] if cell in m.get("workloads", [cell])
            and not (host_only and m["source"] == "device_trace")}


# per-layer metrics a CPU run can read: the stage timers, the plain units'
# wall time and the build; the device's come from the card's profiler trace
# alone
CPU_LAYER = ("traversal_ms", "sampler_ms", "shading_ms", "lights_ms", "integrator_ms",
             "wall_ms", "build_s")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(cell, trace):
    out = run_cell(cell, seed=2**31 + 77, trace=trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    if trace:
        want = {m for m in listed(cell, "per_layer") if m.split(".")[0] in CPU_LAYER}
        assert set(out["metrics"]) == want
    else:
        assert set(out["metrics"]) == listed(cell, "end_to_end", host_only=True)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    limits = json.loads((ROOT / "portbench" / "workloads" / f"{cell}.json").read_text())["limits"]
    lines = control_main(["--workload", cell, "--seconds", "0.5", "--seeds", "11"],
                         device="cpu", overrides=overrides(cell))
    prog, ctrl = lines[0]["program"], lines[0]["control"]
    assert all(prog[k] <= limits[k] for k in limits)
    assert any(ctrl[k] > limits[k] for k in limits)


def _unchanged_bounce(hk_mod):
    vp = hk_mod.integrators.volpath
    orig = vp._bounce_core
    vp._bounce_core = lambda vp_, scene, zcfg, depth, st, rays, *a, **k: (dict(st), rays)
    return lambda: setattr(vp, "_bounce_core", orig)


def _half_batch(hk_mod):
    """render_sample traces the first half of its lanes and takes their
    mean over the whole film's weight."""
    vp = hk_mod.integrators.volpath
    orig = vp.render_sample

    def half(vp_, scene, camera, film, filt, sample_idx):
        w, h = film.width, film.height
        n = w * h
        k = vp_.sample_batch
        lanes = torch.arange(n, device=scene.device)
        px, py = (lanes % w).repeat(k), (lanes // w).repeat(k)
        si = sample_idx + torch.arange(k, device=scene.device).repeat_interleave(n)
        m = n * k // 2
        rgb, fw, _ = vp.render_lanes(vp_, scene, camera, filt, si[:m], px[:m], py[:m])
        rgb_full = torch.cat([rgb, rgb])[: n * k]
        fw_full = torch.cat([fw, fw])[: n * k]
        rgbw = (rgb_full * fw_full[:, None]).reshape(k, h, w, 3).sum(0)
        return hk_mod.film.film.film_add_weighted(film, rgbw, fw_full.reshape(k, h, w).sum(0),
                                                  n_samples=k)
    vp.render_sample = half
    return lambda: setattr(vp, "render_sample", orig)


def _altered_hits(hk_mod):
    """The closest-hit sweep drops every other lane's hit."""
    wf = hk_mod.geometry.wavefront
    orig = wf.closest_tiles

    def altered(*args):
        key, tr = orig(*args)
        tr = tr.clone()
        tr[::2] = -1
        return key, tr
    wf.closest_tiles = altered
    return lambda: setattr(wf, "closest_tiles", orig)


def _preview_unchanged(hk_mod):
    pv = hk_mod.integrators.preview
    orig = pv._preview_lanes
    pv._preview_lanes = lambda scene, camera, *a, **k: torch.zeros(
        (camera.resolution[0] * camera.resolution[1], 3), device=scene.device)
    return lambda: setattr(pv, "_preview_lanes", orig)


def _preview_half(hk_mod):
    """Half the frame's pixels traced, the rest given their mean."""
    pv = hk_mod.integrators.preview
    orig = pv.preview_lanes

    def half(integ, scene, camera, sample_idx, stats=None):
        img = orig(integ, scene, camera, sample_idx, stats)
        h = img.shape[0] // 2
        out = img.clone()
        out[h:] = img[:h].mean((0, 1))
        return out
    pv.preview_lanes = half
    return lambda: setattr(pv, "preview_lanes", orig)


def _camera_carry(hk_mod):
    """render_lanes hands every bounce the camera's state: each bounce is
    right from its own input, and the chain between them is broken."""
    vp = hk_mod.integrators.volpath
    orig = vp.render_lanes

    def carry(vp_, scene, camera, filt, si, px, py, **kw):
        if kw:
            return orig(vp_, scene, camera, filt, si, px, py, **kw)
        cam = orig(vp_, scene, camera, filt, si, px, py, depth_hi=0, return_carry=True)
        for d in range(vp_.max_depth - 1):
            orig(vp_, scene, camera, filt, si, px, py, depth_lo=d, depth_hi=d + 1,
                 carry_in=cam, return_carry=True)
        return orig(vp_, scene, camera, filt, si, px, py, depth_lo=vp_.max_depth - 1,
                    carry_in=cam)
    vp.render_lanes = carry
    return lambda: setattr(vp, "render_lanes", orig)


def _coat_run_unchanged(hk_mod):
    """The sorted dispatch leaves CoatedDiffuseTransmission's run as it
    found it: its lanes keep the dispatch's initial outputs (an invalid
    sample, a zero evaluation), as if the walk had returned its state
    unchanged."""
    import hikari_tpu_torch.materials.types as mt

    vp = hk_mod.integrators.volpath
    orig = vp._sorted_type_dispatch

    def skip(mat_type, per_lane, out_init, present, run_type):
        return orig(mat_type, per_lane, out_init,
                    [t for t in present if t != mt.COATED_DIFFUSE_TRANSMISSION], run_type)
    vp._sorted_type_dispatch = skip
    return lambda: setattr(vp, "_sorted_type_dispatch", orig)


# the faults a cell can have, by its traffic's kind; a wavefronts cell under
# sorted dispatch can also drop a material's run
FAULTS = {
    "wavefronts": [_unchanged_bounce, _half_batch, _altered_hits, _camera_carry],
    "frames": [_preview_unchanged, _preview_half, _altered_hits],
}
SORTED_FAULTS = [_coat_run_unchanged]


def faults(cell):
    mix = traffic(cell)
    extra = SORTED_FAULTS if mix.get("volpath", {}).get("material_coherence") == "sorted" else []
    return FAULTS[mix["kind"]] + extra


@pytest.mark.parametrize("cell,fault", [(c, f.__name__) for c in CELLS for f in faults(c)])
def test_planted_fault_is_caught(cell, fault):
    import hikari_tpu_torch as hk_mod
    import hikari_tpu_torch.geometry.wavefront  # noqa: F401
    import hikari_tpu_torch.integrators.preview  # noqa: F401
    import hikari_tpu_torch.integrators.volpath  # noqa: F401

    undo = {f.__name__: f for f in faults(cell)}[fault](hk_mod)
    try:
        out = run_cell(cell, seed=424242)
    finally:
        undo()
    assert not out["correct"], out["checks"]


# a throwaway configuration's scene maker, written as a new file: a floor
# under Mix(CoatedConductor, Matte) and a CoatedConductor sphere. The Mix's
# amount 1 takes its first child on every hit: mix_u hashes the hit's face
# row, in the program's BVH leaf order, and the reference (no BVH) keeps the
# input order, so a split amount picks other children on the two sides.
THROWAWAY_SCENE = '''"""A test's scene: coats and a Mix, under a point light."""

from .meshes import make_quad, make_sphere


def make(cfg):
    coat = ("CoatedConductor", {})
    mix = ("Mix", {"m1": coat, "m2": ("Matte", {"kd": (0.8, 0.2, 0.2)}), "amount": 1.0})
    meshes = [(make_quad((-2, 0, -2), (2, 0, -2), (2, 0, 2), (-2, 0, 2)), mix),
              (make_sphere((0.0, 0.5, 0.0), 0.5, *cfg["sphere_res"]), coat)]
    return {"meshes": [dict(mesh=m, material=mat) for m, mat in meshes],
            "lights": [("PointLight", {"position": (0.0, 3.0, -1.0),
                                       "intensity": (20.0, 20.0, 20.0)})],
            "sunsky": None}
'''
THROWAWAY_CONFIG = {"name": "throwaway", "scene": "throwaway", "resolution": [16, 16],
                    "max_depth": 3, "sphere_res": [8, 16], "light_sampler": "power",
                    "camera": {"eye": [0.0, 2.0, -3.0], "look_at": [0.0, 0.3, 0.0],
                               "fov_deg": 45.0}}
# the run, in a fresh interpreter whose portbench is the copy's
RUN_IN_COPY = """
import json, sys
import portbench
from portbench.harness import main
print("portbench from", portbench.__file__, file=sys.stderr)
sys.exit(main(sys.argv[1:-1], device="cpu", overrides=json.loads(sys.argv[-1])))
"""


@pytest.mark.parametrize("new_config", [False, True])
def test_cell_added_as_files_is_found(tmp_path, new_config):
    """A cell of an existing configuration and traffic, or of a new
    configuration with its own scene maker, found from its files and its
    manifest entries alone."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = tmp_path / "portbench"
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    if new_config:
        name, like = "throwaway.final", "mesh_scene.final"
        (bench / "scenes/throwaway.py").write_text(THROWAWAY_SCENE)
        (bench / "configs/throwaway.json").write_text(json.dumps(THROWAWAY_CONFIG))
        manifest["configs"].append({"name": "throwaway", "source": "a test",
                                    "file": "portbench/configs/throwaway.json", "reduced": [],
                                    "why": "a test's configuration"})
        cell = {"config": "throwaway", "traffic": "final",
                "traffic_params": {"volpath": {"samples_per_pixel": 8, "sample_batch": 2,
                                               "material_coherence": "sorted"}}}
    else:
        name, like = "mesh_scene.throwaway", "mesh_scene.preview"
        cell = {"config": "mesh_scene", "traffic": "preview"}
    manifest["workloads"].append(dict(name=name, chips=1, why="a test's cell",
                                      **{k: cell[k] for k in ("config", "traffic")}))
    manifest["end_to_end"].append({"name": "sample_ms.throwaway", "unit": "ms", "better": "lower",
                                   "bound": 0.25, "source": "host_clock", "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    spec = json.loads((bench / f"workloads/{like}.json").read_text())
    (bench / f"workloads/{name}.json").write_text(json.dumps(dict(spec, **cell)))
    if not new_config:
        out = run_cell(name, root=tmp_path, ov=overrides(like))
    else:
        ov = overrides(name, root=tmp_path)
        assert ov["traffic"]["volpath"]["material_coherence"] == "sorted"
        # a checkout: the copy's portbench beside the program
        (tmp_path / "hikari_tpu_torch").symlink_to(ROOT / "hikari_tpu_torch")
        env = dict(os.environ, USE_FLAX="0")
        env.pop("PYTHONPATH", None)
        proc = subprocess.run([sys.executable, "-c", RUN_IN_COPY, "--workload", name, "--seed",
                               "2147483701", "--seconds", "0.5", "--trace", "0",
                               json.dumps(ov)], cwd=tmp_path, env=env, capture_output=True,
                              text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        assert f"portbench from {bench / '__init__.py'}" in proc.stderr
        out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"sample_ms.throwaway", "setup_s"}


def test_window_arithmetic(monkeypatch):
    class Fake:
        units = 0

        def unit(self):
            self.units += 1
            return 4

    run = harness.Run.__new__(harness.Run)
    run.cell = {"check": {"bounce_wave_range": 3, "bounce_waves": 1}}
    run.kind = "frames"
    run.pixels = None
    run.preview = type("M", (), {"preview_lanes": staticmethod(lambda *a: None)})
    run.rng = __import__("numpy").random.default_rng(0)
    clock = iter(range(0, 10000))
    monkeypatch.setattr(harness.time, "perf_counter", lambda: float(next(clock)))
    fake = Fake()
    run.unit = fake.unit
    run.window(10.0)
    # each unit reads one tick; the next starts only while elapsed + mean <= 10
    assert run.attempted == fake.units >= 2 and run.samples == 4 * fake.units
    assert all(t == 1.0 for t in run.unit_s)
    m = harness.end_to_end(run.window_s, run.samples, run.unit_s, 3.0,
                           ["sample_ms", "sample_ms.split", "setup_s"])
    assert m["sample_ms"]["value"] == pytest.approx(run.window_s * 1e3 / run.samples)
    assert m["sample_ms.split"] == m["sample_ms"] and m["setup_s"]["value"] == 3.0
    times = [i / 1000 for i in range(1, 201)]
    m = harness.end_to_end(1.0, 200, times, 1.0, ["frame_ms_p95"])
    assert list(m) == ["frame_ms_p95"] and m["frame_ms_p95"]["value"] == pytest.approx(190.05)


def test_device_ms_over_the_window():
    m = harness.end_to_end(2.0, 8, [1.0, 1.0], 3.0, ["device_ms.split", "sample_ms", "setup_s"],
                           busy_s=0.4)
    assert m["device_ms.split"] == {"value": pytest.approx(50.0), "unit": "ms"}
    assert m["sample_ms"]["value"] == pytest.approx(250.0)
    # a run with no device clock (a CPU run) reports no device_ms
    assert "device_ms" not in harness.end_to_end(2.0, 8, [1.0], 3.0, ["device_ms", "setup_s"])


@pytest.mark.parametrize("seed", range(4))
def test_union_of_device_intervals(seed):
    import random

    from portbench import profile_read

    rng = random.Random(seed)
    iv = [(a, a + rng.randint(0, 60)) for a in (rng.randint(0, 900) for _ in range(50))]
    want = sum(e - s for s, e in profile_read._merge(iv)) * 1e-9
    got = profile_read.union_s([s for s, _ in iv], [e for _, e in iv])
    assert got == pytest.approx(want, rel=0, abs=1e-15)
    assert profile_read.union_s([], []) == 0.0
    assert profile_read.union_s([0, 10, 20], [10, 20, 25]) == pytest.approx(25e-9)


def test_device_clock_counts_device_operations_alone():
    from torch.autograd import DeviceType

    from portbench import profile_read

    class Event:
        def __init__(self, dev, start, dur):
            self.dev, self.start, self.dur = dev, start, dur

        def device_type(self):
            return self.dev

        def start_ns(self):
            return self.start

        def duration_ns(self):
            return self.dur

    events = [Event(DeviceType.CUDA, 0, 10), Event(DeviceType.CPU, 5, 100),
              Event(DeviceType.CUDA, 5, 10), Event(DeviceType.CUDA, 40, 5)]
    clock = profile_read.DeviceClock()
    clock.prof = type("P", (), {"profiler": type("R", (), {"kineto_results": type(
        "K", (), {"events": staticmethod(lambda: events)})})})
    clock.stop_s = 0.0
    assert clock.busy_s() == pytest.approx(20e-9)
    assert not hasattr(clock, "prof")


def test_bound_on_a_hand_made_sweep_call():
    # two tiles of 1024 lanes; tile 0 lists pairs at entry bits 10 and 100,
    # tile 1 one pair at 50
    seg = torch.tensor([0, 2, 3], dtype=torch.int32)
    tn_bits = torch.tensor([10, 100, 50], dtype=torch.int32)
    final = torch.zeros(2048, dtype=torch.int32)
    final[:5] = 60      # above pair 0 only
    final[5:7] = 200    # above pairs 0 and 1
    final[1024:1027] = 51  # above tile 1's pair
    assert bound.tests_from_final(final, tn_bits, seg) == (5 + 2 * 2 + 3) * bound.TREELET
    key = torch.full((2048,), 0x40000000, dtype=torch.int32)
    assert torch.equal(bound.closest_final_bits(key), key | 255)
    occ = torch.tensor([0, 1], dtype=torch.int32)
    tmax = torch.tensor([2.0, 3.0])
    assert bound.occlusion_final_bits(occ, tmax).tolist() == [tmax[:1].view(torch.int32).item(), 0]
    args = (torch.zeros(2048, 3), torch.zeros(2048, 3))
    n_bytes = bound.call_bytes(args, (key,))
    assert n_bytes == 2 * 2048 * 3 * 4 + 2048 * 4
    assert bound.bound_ms(n_bytes, 0) == pytest.approx(n_bytes / 3.35e12 * 1e3)
    tests = 10**9
    assert bound.bound_ms(0, tests) == pytest.approx(tests * 40 / 67e12 * 1e3)


def test_reference_traversal_agrees_with_the_program_on_a_tiny_scene():
    import hikari_tpu_torch as hk

    from portbench.ref import api as rapi
    from portbench.ref.hk.integrators import volpath as rvp
    from portbench.scenes.build import build_scene, make_spec

    cfg = json.loads((ROOT / "portbench/configs/mesh_scene.json").read_text())
    cfg.update(icosphere_subdiv=3)
    spec = make_spec(cfg)
    prog = build_scene(hk, spec, cfg).build(device="cpu")
    ref = build_scene(rapi, spec, cfg).build(device="cpu")
    g = torch.Generator().manual_seed(5)
    o = torch.rand(512, 3, generator=g) * torch.tensor([5.0, 3.5, 5.0]) + torch.tensor(
        [-2.5, 0.2, -0.8])
    d = torch.nn.functional.normalize(torch.randn(512, 3, generator=g), dim=-1)
    t_inf = torch.full((512,), float("inf"))
    a = hk.scene_closest_hit(prog, o, d, t_inf)
    b = rvp.scene_closest_hit(ref, o, d, t_inf)
    assert torch.equal(a.hit, b.hit)
    assert torch.allclose(a.t[a.hit], b.t[b.hit], rtol=1e-5)
    t_max = torch.rand(512, generator=g) * 3
    assert torch.equal(hk.scene_any_hit(prog, o, d, t_max), rvp.scene_any_hit(ref, o, d, t_max))


# the program's modules whose exported names build a scene
SCENE_MODULES = ("scene.", "core.transform", "materials.", "lights.", "media.", "camera.",
                 "textures.")


def test_reference_has_every_scene_building_name():
    """Each scene-building name of the program resolves in the reference's
    api to its frozen copy, or the api's docstring names it as having none."""
    import hikari_tpu_torch as hk

    from portbench.ref import api as rapi

    names = [n for n in hk.__all__
             if getattr(getattr(hk, n), "__module__", "").removeprefix(
                 "hikari_tpu_torch.").startswith(SCENE_MODULES)]
    assert {"CoatedConductor", "Mix", "Plastic", "Gold", "SpotLight", "HomogeneousMedium",
            "make_sphere", "ImageTexture"} <= set(names)
    missing = [n for n in names if not hasattr(rapi, n)]
    assert all(f"``{n}``" in rapi.__doc__ for n in missing), missing
    for n in set(names) - set(missing):
        assert getattr(rapi, n).__module__.startswith("portbench.ref.hk."), n
        assert getattr(rapi, n).__name__ == getattr(hk, n).__name__, n


def test_sphere_is_the_programs():
    """The scene maker's sphere is the program's make_sphere, array for array."""
    import numpy as np

    from hikari_tpu_torch.scene.mesh import make_sphere as prog_sphere
    from portbench.scenes.meshes import make_sphere

    a, b = make_sphere((0.6, 0.45, 0.2), 0.42, 32, 64), prog_sphere((0.6, 0.45, 0.2), 0.42, 32, 64)
    for k in ("vertices", "faces", "normals", "uvs"):
        assert np.array_equal(a[k], getattr(b, k)), k


@pytest.mark.parametrize("subdiv", [0, 1, 3])
def test_icosphere_is_the_programs(subdiv):
    """The scene maker's numpy edge loop gives scenes.py's arrays."""
    import numpy as np

    from hikari_tpu_torch.scenes import _displaced_icosphere
    from portbench.scenes.mesh_scene import displaced_icosphere

    (v, f), (v0, f0) = displaced_icosphere(subdiv), _displaced_icosphere(subdiv)
    assert np.array_equal(v, v0) and np.array_equal(f, f0)


def test_control_clamps_an_index_past_its_table():
    from portbench.ref.bf16 import control

    table = torch.arange(4.0)
    # 0.999999 rounds to 1.0 in bfloat16, so its index 4 lies past the table
    out, moved = control(lambda x: table[(x * 4).long()], torch.tensor([0.999999, 0.5]))
    assert out.tolist() == [3.0, 2.0] and moved == 1
