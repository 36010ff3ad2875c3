"""The harness driven end to end on the CPU at test size: sound runs come
out correct, the control and each planted fault come out not correct, a
cell added as files alone is found, and the window and bound arithmetic
hold."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from portbench import bound, harness
from portbench.control import main as control_main
from portbench.tests.tiny import CELLS, overrides

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


def listed(cell, kind):
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {m["name"] for m in manifest[kind] if cell in m.get("workloads", [cell])}


# per-layer metrics a CPU run can read: the stage timers and the build;
# the device's come from the card's profiler trace alone
CPU_LAYER = ("traversal_ms", "sampler_ms", "shading_ms", "lights_ms", "integrator_ms",
             "build_s")


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
        assert set(out["metrics"]) == listed(cell, "end_to_end")


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


FAULTS = {
    "mesh_scene.final": [_unchanged_bounce, _half_batch, _altered_hits, _camera_carry],
    "mesh_scene.preview": [_preview_unchanged, _preview_half, _altered_hits],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in range(len(FAULTS[c]))])
def test_planted_fault_is_caught(cell, fault):
    import hikari_tpu_torch as hk_mod
    import hikari_tpu_torch.geometry.wavefront  # noqa: F401
    import hikari_tpu_torch.integrators.preview  # noqa: F401
    import hikari_tpu_torch.integrators.volpath  # noqa: F401

    undo = FAULTS[cell][fault](hk_mod)
    try:
        out = run_cell(cell, seed=424242)
    finally:
        undo()
    assert not out["correct"], out["checks"]


def test_cell_added_as_files_is_found(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "mesh_scene.throwaway", "config": "mesh_scene",
                                  "traffic": "preview", "chips": 1, "why": "a test's cell"})
    manifest["end_to_end"].append({"name": "sample_ms.throwaway", "unit": "ms", "better": "lower",
                                   "bound": 0.25, "source": "host_clock",
                                   "workloads": ["mesh_scene.throwaway"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = json.loads((ROOT / "portbench/workloads/mesh_scene.preview.json").read_text())
    (tmp_path / "portbench/workloads/mesh_scene.throwaway.json").write_text(json.dumps(cell))
    out = run_cell("mesh_scene.throwaway", root=tmp_path,
                   ov=overrides("mesh_scene.preview"))
    assert out["correct"] and set(out["metrics"]) == {"sample_ms.throwaway", "setup_s"}


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
