"""The port's sharded render and its profiling helpers, on the CPU.

* make_render_mesh: the ('dp', 'sp') mesh shapes of the JAX package's rule
  (dp 2 on an even count above 1, else 1) and of a given dp, over four
  ranks and over one; a dp that does not divide the ranks raises.
* render_sharded over four gloo processes, as dp = 2 x sp = 2 and as four
  row shards (dp = 1), against the port's render of the same scene in one
  process: rgb_sum and weight_sum within 1e-6 relative on every pixel
  (the dp ranks' samples are summed in another order), the iteration
  count equal; and at world size 1 (without a group and without a card,
  make_render_mesh raises).
* profiling.time_fn, stage_timings and trace on the CPU.
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import hikari_tpu_torch as hk
from hikari_tpu_torch.scenes import default_scene, scene_camera
from hikari_tpu_torch.utils import profiling

RES = 16
RTOL = 1e-6
SPHERES = (6, 12)


def _vp():
    return hk.VolPath(max_depth=3, samples_per_pixel=4, sample_batch=2)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        sc = default_scene(sphere_res=SPHERES).build(device="cpu")
        cam = scene_camera("default", RES)
        result = {}
        for dp in (None, 1, 4):
            mesh = hk.make_render_mesh(dp=dp)
            result[f"shape dp={dp}"] = tuple(mesh.mesh.shape)
            result[f"names dp={dp}"] = mesh.mesh_dim_names
        for dp in (2, 1):
            film = hk.render_sharded(_vp(), sc, cam, hk.make_render_mesh(dp=dp))
            result[f"film dp={dp}"] = (film.rgb_sum.numpy(), film.weight_sum.numpy(),
                                       film.iteration)
        try:
            hk.make_render_mesh(dp=3)
            result["dp=3"] = "no error"
        except ValueError:
            result["dp=3"] = "ValueError"
        torch.save(result, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _reference():
    sc = default_scene(sphere_res=SPHERES).build(device="cpu")
    return hk.render(_vp(), sc, scene_camera("default", RES))


def _same_film(rgb, wgt, ref):
    np.testing.assert_allclose(rgb, ref.rgb_sum.numpy(), rtol=RTOL, atol=0)
    np.testing.assert_allclose(wgt, ref.weight_sum.numpy(), rtol=RTOL, atol=0)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    mp.start_processes(_rank, args=(4, _free_port(), str(out)), nprocs=4, start_method="spawn")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)]


def test_mesh_shapes_over_four_ranks(four_ranks):
    for r in four_ranks:
        assert r["shape dp=None"] == (2, 2)
        assert r["shape dp=1"] == (1, 4)
        assert r["shape dp=4"] == (4, 1)
        assert r["names dp=None"] == ("dp", "sp")
        assert r["dp=3"] == "ValueError"


@pytest.mark.parametrize("dp", [2, 1], ids=["dp2 x sp2", "four row shards"])
def test_render_sharded_over_four_ranks_equals_render(four_ranks, dp):
    ref = _reference()
    assert float(ref.rgb_sum.mean()) > 0.0
    for r in four_ranks:  # every rank returns the whole film
        rgb, wgt, it = r[f"film dp={dp}"]
        _same_film(rgb, wgt, ref)
        assert it == ref.iteration == 4


def test_render_sharded_world_size_one():
    """A one-process gloo group: a (1, 1) mesh whose render equals render's
    bit for bit."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = hk.make_render_mesh()
        assert tuple(mesh.mesh.shape) == (1, 1)
        sc = default_scene(sphere_res=SPHERES).build(device="cpu")
        film = hk.render_sharded(_vp(), sc, scene_camera("default", RES), mesh)
        ref = _reference()
        assert torch.equal(film.rgb_sum, ref.rgb_sum)  # the same wavefronts, summed alike
        assert torch.equal(film.weight_sum, ref.weight_sum)
    finally:
        dist.destroy_process_group()


def test_make_render_mesh_without_a_group_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("with a card, make_render_mesh starts an NCCL group")
    with pytest.raises(RuntimeError):
        hk.make_render_mesh()


def test_render_sharded_rows_must_divide():
    class Mesh:  # a ('dp', 'sp') mesh of shape (1, 3); 16 rows do not divide by 3
        def size(self, dim):
            return (1, 3)[dim]

    sc = default_scene(sphere_res=(4, 8)).build(device="cpu")
    with pytest.raises(ValueError):
        hk.render_sharded(_vp(), sc, scene_camera("default", 16), Mesh())


def test_time_fn_and_stage_timings():
    calls = []
    secs = profiling.time_fn(lambda x: calls.append(x), 7, iters=3, reps=3)
    assert secs >= 0.0 and calls == [7] * 10  # one warm-up and 3 x 3 timed
    sc = default_scene(sphere_res=(4, 8)).build(device="cpu")
    out = profiling.stage_timings(sc, scene_camera("default", 8),
                                  vp=hk.VolPath(max_depth=2, samples_per_pixel=1),
                                  iters=1, reps=1)
    assert set(out) == {"step", "closest_primary", "anyhit_primary"}
    assert all(v > 0.0 for v in out.values())


def test_trace_writes_a_chrome_trace(tmp_path):
    sc = default_scene(sphere_res=(4, 8)).build(device="cpu")
    with profiling.trace(str(tmp_path)):
        hk.render_preview(hk.FastWavefront(), sc, scene_camera("default", 8))
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 1000
