"""Rendering across processes: a sample-parallel x spatial-parallel mesh.

Port of ``hikari_tpu/parallel/sharding.py`` on ``torch.distributed``, one
process per device:

- 'sp' (spatial): the film's rows are split into blocks, one per sp rank;
  each rank traces the paths of its block. The scene is replicated.
- 'dp' (sample): the ranks along 'dp' trace different sample indices of
  the same pixels (sample s * dp + dp rank); their films are summed with
  one all_reduce over 'dp' at the end of the render.

Then one all_gather over 'sp' assembles the rows, so every rank returns
the whole film. The mesh is a ``DeviceMesh`` of the default process group's
ranks; nothing tells a program of a cluster, so the caller initialises the
group (``torch.distributed.init_process_group`` with its address, world size
and rank: NCCL on the card, gloo on the CPU), or ``make_render_mesh`` starts
a one-process NCCL group on a free localhost port.
"""

from __future__ import annotations

import socket

import torch
import torch.distributed as dist

from ..camera.camera import PerspectiveCamera
from ..film.film import Film, make_film
from ..film.filters import FilterSampler, make_filter
from ..integrators.volpath import VolPath, render_lanes
from ..scene.scene import SceneData


def make_render_mesh(devices=None, dp: int | None = None):
    """A ('dp', 'sp') DeviceMesh over `devices`, ranks of the default
    process group (default: all of them). dp defaults to 2 when the count
    is even and above 1 (sample parallelism), else 1 (pure spatial). The
    mesh is on the card for an NCCL group and on the CPU for any other;
    without a group, an NCCL group of this process alone is started on a
    free localhost port (on the CPU, initialise a gloo group first)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; to render on the CPU, "
                               "initialise a gloo process group first")
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                                rank=0)
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    n = len(ranks)
    if dp is None:
        dp = 2 if n % 2 == 0 and n > 1 else 1
    sp = n // dp
    if dp * sp != n:
        raise ValueError(f"dp={dp} does not divide {n} ranks")
    return DeviceMesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                      torch.tensor(ranks).reshape(dp, sp), mesh_dim_names=("dp", "sp"))


def render_sharded(vp: VolPath, scene: SceneData, camera: PerspectiveCamera, mesh,
                   filt: FilterSampler | None = None) -> Film:
    """samples_per_pixel samples spread over the 'dp' ranks (each traces
    samples_per_pixel // dp, at least one), rows over the 'sp' ranks; every
    rank of the mesh calls it with the same arguments (its scene on its own
    device) and gets the whole film. Each rank traces vp.sample_batch of its
    samples per wavefront, as render does."""
    if filt is None:
        filt = make_filter()
    w, h = camera.resolution
    dp, sp = mesh.size(0), mesh.size(1)
    if h % sp:
        raise ValueError(f"film height {h} must be divisible by the spatial mesh axis sp={sp}")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    dp_i, sp_i = coord
    rows = h // sp
    n = rows * w
    dev = scene.device
    lanes = torch.arange(n, device=dev)
    px, py = lanes % w, lanes // w + sp_i * rows
    n_steps = max(1, vp.samples_per_pixel // dp)
    k = max(1, int(vp.sample_batch))
    rgb_sum = torch.zeros((rows, w, 3), device=dev)
    weight_sum = torch.zeros((rows, w), device=dev)
    for s0 in range(0, n_steps, k):
        steps = torch.arange(s0, min(s0 + k, n_steps), device=dev)
        si = (steps * dp + dp_i).repeat_interleave(n)
        m = steps.numel()
        rgb, wgt, _ = render_lanes(vp, scene, camera, filt, si, px.repeat(m), py.repeat(m))
        rgb_sum += (rgb * wgt[:, None]).reshape(m, rows, w, 3).sum(0)
        weight_sum += wgt.reshape(m, rows, w).sum(0)
    # one all_reduce of the block over 'dp', then the blocks over 'sp'
    block = torch.cat([rgb_sum.reshape(-1), weight_sum.reshape(-1)])
    if dp > 1:
        dist.all_reduce(block, group=mesh.get_group("dp"))
    blocks = [block]
    if sp > 1:
        blocks = [torch.empty_like(block) for _ in range(sp)]
        dist.all_gather(blocks, block, group=mesh.get_group("sp"))
    film = make_film(w, h, device=dev)
    for i, b in enumerate(blocks):
        film.rgb_sum[i * rows:(i + 1) * rows] = b[:n * 3].reshape(rows, w, 3)
        film.weight_sum[i * rows:(i + 1) * rows] = b[n * 3:].reshape(rows, w)
    film.iteration = n_steps * dp
    return film
