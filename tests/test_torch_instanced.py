"""Port parity: the instanced (two-level, TLAS/BLAS) path.

* build_instanced_treelets and the whole instanced Scene.build against the
  JAX package's tables (through the bridge);
* the plain instanced sweeps (the kernels' CPU versions) against the
  Pallas kernels ``_closest_inst_kernel`` / ``_occlusion_inst_kernel`` run
  in interpret mode on the port's pair list;
* closest_hit_instanced / any_hit_instanced against the JAX functions in
  interpret mode, with inactive lanes and NEE groups, on a 3x3 instanced
  sphere grid (renders of the grid: tests/test_torch_instanced_render.py).

Tolerances: as in test_torch_wavefront.py the allowed differences are edge
flips (the JAX kernels evaluate the affine form through a 3-way bf16 split,
the port directly in float32): tri equal on >= 99.5% of live lanes, t
within 1e-5 relative plus 4e-6 absolute and b1 / b2 within 1e-4 absolute
where tri is equal, occlusion flags equal on >= 99.5%. The instanced path
has no Moller-Trumbore resolve, so its t is the affine form's
-(n.o + dw) / (n.d): near a surface n.o and dw cancel, and the two
evaluations differ by a few float32 ulps of n.o (about 1e-6 at the grid's
scale of a few units), which is more than 1e-5 of a short t.
"""

from dataclasses import fields

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.geometry import instanced as jinst
from hikari_tpu.geometry import wavefront as jwf
from hikari_tpu.lights.types import PointLight as JPointLight
from hikari_tpu.materials import types as jmt
from hikari_tpu.scene.mesh import make_quad as j_quad
from hikari_tpu.scene.mesh import make_sphere as j_sphere
from hikari_tpu.scene.scene import Scene as JScene
import hikari_tpu_torch as hk
from hikari_tpu_torch.geometry import instanced as tinst
from hikari_tpu_torch.geometry import sweep_inst
from hikari_tpu_torch.geometry import wavefront as twf
from hikari_tpu_torch.lights.types import LightBanks
from hikari_tpu_torch.materials.types import MaterialBanks
from hikari_tpu_torch.scene.bridge import coef_from_bw, scene_from_numpy

AGREE = 0.995
T_RTOL = 1e-5
T_ATOL = 4e-6
B_ATOL = 1e-4
RES = 24
EYE, AT, FOV = (0.0, 2.2, -3.4), (0.0, 0.3, 0.0), 50.0


def _grid_transforms():
    """3x3 grid of 0.4-scaled unit spheres (tests/test_instancing.py); the
    centre instance is rotated about y and scaled non-uniformly."""
    out = []
    for ix in range(3):
        for iz in range(3):
            m = np.eye(4, dtype=np.float32)
            m[0, 0] = m[1, 1] = m[2, 2] = 0.4
            m[:3, 3] = (-1.2 + 1.2 * ix, 0.4, -0.6 + 1.2 * iz)
            out.append(m)
    th = 0.7
    rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    out[4][:3, :3] = rot @ np.diag([0.5, 0.3, 0.4])
    return np.stack(out).astype(np.float32)


def _build_grid(pk, flatten: bool = False):
    """The grid scene through a package's public API: `pk` supplies Scene,
    the mesh makers, the materials and PointLight."""
    s = pk["Scene"]()
    s.add(pk["make_quad"]((-3, 0, -3), (3, 0, -3), (3, 0, 3), (-3, 0, 3)),
          pk["Matte"](kd=(0.7, 0.7, 0.7)))
    s.add(pk["make_quad"]((-0.5, 2.5, -0.5), (0.5, 2.5, -0.5), (0.5, 2.5, 0.5),
                          (-0.5, 2.5, 0.5)),
          pk["Emissive"](le=(1.0, 0.9, 0.8), scale=8.0))
    s.add_light(pk["PointLight"](position=(0.0, 4.0, -2.0), intensity=(40.0, 40.0, 40.0)))
    sphere = pk["make_sphere"]((0, 0, 0), 1.0, 10, 20)
    tr = _grid_transforms()
    mats = [pk["Gold"](roughness=0.15), pk["Matte"](kd=(0.2, 0.4, 0.8)),
            pk["Matte"](kd=(0.8, 0.3, 0.2))]
    per_inst = [mats[k % 3] for k in range(len(tr))]
    if flatten:
        for m, mat in zip(tr, per_inst):
            s.add(pk["TriangleMesh"](vertices=sphere.vertices, faces=sphere.faces,
                                     normals=sphere.normals, transform=m), mat)
    else:
        s.add_instanced(sphere, tr, mats[1], materials=per_inst)
    return s


JAX_API = dict(Scene=JScene, make_quad=j_quad, make_sphere=j_sphere, Matte=jmt.Matte,
               Gold=jmt.Gold, Emissive=jmt.Emissive, PointLight=JPointLight)
PORT_API = dict(Scene=hk.Scene, make_quad=hk.make_quad, make_sphere=hk.make_sphere,
                Matte=hk.Matte, Gold=hk.Gold, Emissive=hk.Emissive,
                PointLight=hk.PointLight, TriangleMesh=hk.TriangleMesh)


def jax_instanced_arrays(js) -> dict:
    """Flatten an instanced JAX SceneData to the dict scene_from_numpy takes."""
    out = {k: np.asarray(getattr(js, k)) for k in (
        "face_rows", "mat_type", "mat_idx", "world_lo", "world_hi", "scene_radius",
        "present_materials", "inst_nrm", "inst_l2w", "inst_mat_packed")}
    for k in ("lo", "hi", "ti_obj", "ti_inst", "inst_a"):
        out[f"inst.{k}"] = np.asarray(getattr(js.inst, k))
    out["inst.bw"] = np.asarray(js.inst.bw).astype(np.float32)
    for f in fields(MaterialBanks):
        out[f"materials.{f.name}"] = np.asarray(getattr(js.materials, f.name))
    for f in fields(LightBanks):
        out[f"lights.{f.name}"] = np.asarray(getattr(js.lights, f.name))
    return out


@pytest.fixture(scope="module")
def grid():
    js = _build_grid(JAX_API).build(traversal="packets_interp")
    ts = _build_grid(PORT_API).build(device="cpu")
    return js, ts


N_RAYS = 5120


# the grid's extent (the scene's world box is inflated: ROADMAP C notes that
# the reference's BLAS padding leaks into treelet bounds)
BOX_LO, BOX_HI = np.array([-3.0, 0.0, -3.0]), np.array([3.0, 2.5, 3.0])


def _rays(seed=0, eye=EYE, dy=(0.8, 0.9), box=(BOX_LO, BOX_HI)):
    """1024 camera-like rays from `eye` (direction y = U(0, 1) * dy[0] -
    dy[1], z = 1), 3072 random rays inside `box` (four live tiles
    together), 1024 inactive lanes, shuffled; and shadow distances.
    Defaults: the grid's."""
    n = N_RAYS
    rng = np.random.RandomState(seed)
    o = np.empty((n, 3), np.float32)
    d = np.empty((n, 3), np.float32)
    o[:1024] = eye
    d[:1024] = np.stack([rng.rand(1024) * 1.2 - 0.6, rng.rand(1024) * dy[0] - dy[1],
                         np.ones(1024)], -1)
    box_lo, box_hi = box
    o[1024:] = box_lo + rng.rand(n - 1024, 3) * (box_hi - box_lo)
    d[1024:] = rng.randn(n - 1024, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    active = np.ones(n, bool)
    active[n - 1024:] = False
    perm = rng.permutation(n)
    t_shadow = (rng.rand(n) * 3 + 0.2).astype(np.float32)
    return o[perm], d[perm], active[perm], t_shadow


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def test_build_instanced_treelets_matches_jax():
    rng = np.random.RandomState(1)
    p = 600  # padded to three treelets, as the scene build pads a BLAS
    c = rng.rand(p, 3).astype(np.float32) * 2 - 1
    p0, p1, p2 = (c + rng.rand(p, 3).astype(np.float32) * 0.3 for _ in range(3))
    pad = np.full((768 - p, 3), 3.0e37, np.float32)
    blas0 = tuple(np.concatenate([q, pad]) for q in (p0, p1, p2))
    blas1 = tuple(q[:256].copy() for q in blas0)  # a one-treelet BLAS
    th = 1.1
    rot = np.eye(4)
    rot[:3, :3] = np.array([[1, 0, 0], [0, np.cos(th), -np.sin(th)],
                            [0, np.sin(th), np.cos(th)]]) @ np.diag([2.0, 0.5, 1.25])
    rot[:3, 3] = (0.3, -1.0, 2.0)
    shift = np.eye(4)
    shift[:3, 3] = (5.0, 0.0, 0.0)
    instances = [(0, np.eye(4)), (0, rot), (1, shift), (1, rot)]
    instances = [(b, m.astype(np.float32)) for b, m in instances]
    jt = jinst.build_instanced_treelets([blas0, blas1], instances)
    tt = tinst.build_instanced_treelets([blas0, blas1], instances)
    for k in ("lo", "hi", "ti_obj", "ti_inst", "inst_a"):
        np.testing.assert_array_equal(getattr(tt, k).numpy(), np.asarray(getattr(jt, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(tt.coef.numpy(),
                                  coef_from_bw(np.asarray(jt.bw).astype(np.float32)))
    assert tt.lo.shape[0] == 3 + 3 + 1 + 1 and tt.coef.shape[0] == 4


def test_instanced_scene_build_matches_jax(grid):
    js, ts = grid
    bs = scene_from_numpy(jax_instanced_arrays(js), "cpu")
    assert ts.has_instances and bs.has_instances and ts.treelets is None
    for k in ("face_rows", "mat_type", "mat_idx", "world_lo", "world_hi", "inst_nrm",
              "inst_l2w", "inst_mat_packed"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(), getattr(bs, k).numpy(),
                                      err_msg=k)
    for k in ("lo", "hi", "ti_obj", "ti_inst", "inst_a", "coef"):
        np.testing.assert_array_equal(getattr(ts.inst, k).numpy(),
                                      getattr(bs.inst, k).numpy(), err_msg=f"inst.{k}")
    for k in ("light_type", "light_idx", "pmf", "alias_j", "area_p0", "area_p1",
              "area_p2", "area_le"):
        np.testing.assert_array_equal(getattr(ts.lights, k).numpy(),
                                      getattr(bs.lights, k).numpy(), err_msg=k)
    assert ts.present_materials == bs.present_materials
    assert ts.n_lights == js.n_lights == 3  # the point light + 2 emissive faces
    assert ts.n_faces == js.n_faces
    assert ts.inst.lo.shape[0] == 9 * 2 + 1


def _pairs(ps):
    """The port's pair list in the Pallas kernels' packed form."""
    n_tiles = ps.seg.numel() - 1
    tile = torch.repeat_interleave(torch.arange(n_tiles), (ps.seg[1:] - ps.seg[:-1]).long())
    meta = (tile.to(torch.int32) << jwf.TILE_SHIFT) | ps.tre
    o4, d4 = jinst._ray_blocks(jnp.asarray(ps.os.numpy()), jnp.asarray(ps.ds.numpy()))
    return (jnp.asarray(meta.numpy()), int(ps.tre.numel()),
            jnp.asarray(ps.tn_bits.view(torch.float32).numpy()), o4, d4, n_tiles)


def _sweep_args(tl):
    return tl.ti_obj, tl.ti_inst, tl.coef, tl.inst_a


def test_plain_closest_inst_matches_pallas_interpret(grid):
    js, ts = grid
    o, d, act, _ = _torch(*_rays())
    ps = twf.prepare_closest(ts.inst, o, d, torch.full((N_RAYS,), float("inf")),
                             ts.world_lo, ts.world_hi, active=act)
    assert ps.tre.numel() > 0 and ps.seg.numel() - 1 == 4
    t, tri, b1, b2 = sweep_inst.closest_inst_plain(ps.os, ps.ds, ps.ts, ps.tre,
                                                   ps.tn_bits, ps.seg, *_sweep_args(ts.inst))
    meta, n_pairs, tn, o4, d4, n_tiles = _pairs(ps)
    sz = ps.ts.numel()
    carry = (jnp.asarray(ps.ts.numpy()), jnp.full((sz,), -1, jnp.int32),
             jnp.zeros((sz,), jnp.float32), jnp.zeros((sz,), jnp.float32))
    jt, jtri, jb1, jb2 = (np.asarray(x).reshape(-1) for x in jinst._sweep_chunks_inst(
        jinst._closest_inst_kernel, meta, n_pairs, tn, js.inst, o4, d4, carry, [],
        n_tiles, True))
    live = ps.ts.numpy() > 0
    same = tri.numpy() == jtri
    assert same[live].mean() >= AGREE, f"{(~same & live).sum()} of {live.sum()} differ"
    assert (tri.numpy()[live] >= 0).mean() > 0.1  # the wavefront does hit
    both = same & live
    np.testing.assert_allclose(t.numpy()[both], jt[both], rtol=T_RTOL, atol=T_ATOL)
    hit = both & (jtri >= 0)
    np.testing.assert_allclose(b1.numpy()[hit], jb1[hit], atol=B_ATOL)
    np.testing.assert_allclose(b2.numpy()[hit], jb2[hit], atol=B_ATOL)


def test_plain_closest_inst_is_the_lexicographic_minimum(grid):
    """closest_inst_plain (a walk in pair order with the early-out) equals
    the minimum over every listed pair, swept without early-out, of the
    word (t, pair rank, column), the rank a pair's index in its tile's
    segment and the carried-in reach at rank -1: the order the closest_inst
    kernel's 64-bit carry relies on, ties included."""
    _, ts = grid
    o, d, act, _ = _torch(*_rays(seed=5))
    ps = twf.prepare_closest(ts.inst, o, d, torch.full((N_RAYS,), float("inf")),
                             ts.world_lo, ts.world_hi, active=act)
    args = _sweep_args(ts.inst)
    t, tri, b1, b2 = sweep_inst.closest_inst_plain(ps.os, ps.ds, ps.ts, ps.tre, ps.tn_bits,
                                                   ps.seg, *args)
    n_tiles, n_pairs = ps.seg.numel() - 1, ps.tre.numel()
    o_t, d_t = ps.os.view(n_tiles, 1024, 3), ps.ds.view(n_tiles, 1024, 3)
    tile = torch.repeat_interleave(torch.arange(n_tiles), (ps.seg[1:] - ps.seg[:-1]).long())
    start = ps.seg.long()
    assert int((start[1:] - start[:-1]).max()) > 1 and n_tiles > 1  # ranks are not indices
    # bits(t) << 32 | rank * 256 + column + 1 (the kernel's word); reach: rank -1
    assert (ps.ts >= 0).all()
    best = (ps.ts.view(torch.int32).long() << 32).view(n_tiles, 1024)
    ub, vb = torch.zeros(n_tiles, 1024), torch.zeros(n_tiles, 1024)
    cols = torch.arange(256)
    for p0 in range(0, n_pairs, 8):
        p = torch.arange(p0, min(p0 + 8, n_pairs))
        _, (tt, u, v, hit) = sweep_inst._pair_blocks(o_t, d_t, tile[p], p, ps.tre, *args)
        word = torch.where(hit, (tt.view(torch.int32).long() << 32)
                           | ((p - start[tile[p]])[:, None, None] * 256 + cols + 1),
                           torch.iinfo(torch.int64).max)
        w_min, j = word.min(-1)
        for c, i in enumerate(tile[p].tolist()):
            better = w_min[c] < best[i]
            best[i] = torch.where(better, w_min[c], best[i])
            ub[i] = torch.where(better, u[c].gather(-1, j[c][:, None])[:, 0], ub[i])
            vb[i] = torch.where(better, v[c].gather(-1, j[c][:, None])[:, 0], vb[i])
    best = best.view(-1)
    low = best & 0xFFFFFFFF
    rank, col = (low - 1) >> 8, (low - 1) & 255
    pair = start[:-1].repeat_interleave(1024) + rank.clamp(min=0)
    exp_tri = torch.where(low > 0, ps.tre[pair].long() * 256 + col, -1)
    assert (tri >= 0).sum() > 1000  # the wavefront does hit
    assert torch.equal(tri.long(), exp_tri)
    assert torch.equal(t.view(torch.int32).long(), best >> 32)
    assert torch.equal(b1, ub.view(-1)) and torch.equal(b2, vb.view(-1))


def test_plain_occlusion_inst_matches_pallas_interpret(grid):
    js, ts = grid
    o, d, act, tmax = _torch(*_rays(seed=1))
    ps = twf.prepare_occlusion(ts.inst, o, d, tmax, ts.world_lo, ts.world_hi, active=act)
    occ0 = (ps.ts <= 0.0).to(torch.int32)
    occ = sweep_inst.occlusion_inst_plain(ps.os, ps.ds, ps.ts, occ0, ps.tre, ps.tn_bits,
                                          ps.seg, *_sweep_args(ts.inst))
    meta, n_pairs, tn, o4, d4, n_tiles = _pairs(ps)
    (jocc,) = jinst._sweep_chunks_inst(
        jinst._occlusion_inst_kernel, meta, n_pairs, tn, js.inst, o4, d4,
        (jnp.asarray(occ0.numpy()),), [jnp.asarray(ps.ts.numpy())], n_tiles, True)
    live = ps.ts.numpy() > 0
    same = occ.numpy() == np.asarray(jocc).reshape(-1)
    assert same[live].mean() >= AGREE
    assert 0.05 < occ.numpy()[live].mean() < 0.95


def test_closest_hit_instanced_matches_jax(grid):
    js, ts = grid
    o, d, act, _ = _rays(seed=2)
    to, td, tact = _torch(o, d, act)
    rec = tinst.closest_hit_instanced(ts.inst, to, td, torch.full((N_RAYS,), float("inf")),
                                      ts.world_lo, ts.world_hi, active=tact)
    jrec = jinst.closest_hit_instanced(js.inst, jnp.asarray(o), jnp.asarray(d),
                                       jnp.full((N_RAYS,), jnp.inf), js.world_lo,
                                       js.world_hi, interpret=True,
                                       active=jnp.asarray(act))
    tri, jtri = rec.tri.numpy(), np.asarray(jrec.tri)
    same = tri == jtri
    assert same[act].mean() >= AGREE, f"{(~same & act).sum()} tri mismatches"
    assert (tri[~act] == -1).all() and (tri[act] >= 0).mean() > 0.1
    assert (rec.hit.numpy() == (tri >= 0)).all()
    both = same & act
    np.testing.assert_allclose(rec.t.numpy()[both], np.asarray(jrec.t)[both], rtol=T_RTOL,
                               atol=T_ATOL)
    for a, b in ((rec.b1, jrec.b1), (rec.b2, jrec.b2)):
        np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both], atol=B_ATOL)


@pytest.mark.parametrize("grouped", [False, True])
def test_any_hit_instanced_matches_jax(grid, grouped):
    js, ts = grid
    o, d, act, tmax = _rays(seed=3)
    group = (np.arange(N_RAYS) % 3).astype(np.int32) if grouped else None
    occ = tinst.any_hit_instanced(ts.inst, *_torch(o, d, tmax), ts.world_lo, ts.world_hi,
                                  active=torch.from_numpy(act),
                                  group=None if group is None else torch.from_numpy(group))
    jocc = jinst.any_hit_instanced(js.inst, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tmax), js.world_lo, js.world_hi,
                                   interpret=True, active=jnp.asarray(act),
                                   group=None if group is None else jnp.asarray(group))
    occ = occ.numpy()
    assert (occ == np.asarray(jocc)).mean() >= AGREE
    assert not occ[~act].any()
    assert 0.05 < occ[act].mean() < 0.95


def test_emissive_instanced_material_is_refused():
    s = hk.Scene()
    s.add_instanced(hk.make_sphere((0, 0, 0), 1.0, 6, 8), np.eye(4)[None],
                    hk.Matte(kd=(0.5, 0.5, 0.5)), materials=[hk.Emissive(le=(1, 1, 1))])
    with pytest.raises(ValueError, match="emissive"):
        s.build(device="cpu")
    s = hk.Scene()
    s.add_instanced(hk.make_sphere((0, 0, 0), 1.0, 6, 8), np.eye(4)[None],
                    hk.Emissive(le=(1, 1, 1)))
    with pytest.raises(ValueError, match="emissive"):
        s.build(device="cpu")


def test_set_instance_transforms_moves_the_instance():
    s = hk.Scene()
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (-1.0, 0.0, 0.0)
    h = s.add_instanced(hk.make_sphere((0, 0, 0), 0.5, 8, 16), m[None], hk.Matte())
    before = s.build(device="cpu")
    m[:3, 3] = (1.0, 0.0, 0.0)
    s.set_instance_transforms(h, m[None])
    after = s.build(device="cpu")
    real = before.inst.lo[:, 0] < 1e37
    np.testing.assert_allclose((after.inst.lo - before.inst.lo)[real].numpy(),
                               np.tile([2.0, 0.0, 0.0], (int(real.sum()), 1)), atol=1e-6)
    o = torch.tensor([[1.0, 0.0, -3.0], [-1.0, 0.0, -3.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    hits = [tinst.closest_hit_instanced(sc.inst, o, d, torch.full((2,), float("inf")),
                                        sc.world_lo, sc.world_hi).hit.tolist()
            for sc in (before, after)]
    assert hits == [[False, True], [True, False]]


def test_make_box_matches_jax():
    from hikari_tpu.scene.mesh import make_box as j_box

    j, t = j_box((-0.08, 0.0, -0.08), (0.08, 0.8, 0.08)), hk.make_box((-0.08, 0.0, -0.08),
                                                                      (0.08, 0.8, 0.08))
    np.testing.assert_array_equal(t.vertices, j.vertices)
    np.testing.assert_array_equal(t.faces, j.faces)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["grid", "forest"])
def test_cuda_instanced_sweeps_match_plain(request, scene):
    """On the card: both instanced kernels against their plain versions, on
    the grid and on the 400-tree forest, whose padded BLAS treelets have
    unbounded boxes (entry distance 0 in every tile that lists them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the instanced sweep kernels have no CPU mode")
    dev = torch.device("cuda")
    if scene == "grid":
        sc = request.getfixturevalue("grid")[1].to(dev)
        rays = _rays()
    else:
        from hikari_tpu_torch.scenes import forest_scene

        sc = forest_scene().build(device=dev)
        assert bool((sc.inst.hi > 1e37).any())
        rays = _rays(eye=(0.0, 3.0, -8.0), dy=(0.6, 0.45),
                     box=(np.array([-15.0, 0.0, -2.0]), np.array([15.0, 3.0, 30.0])))
    o, d, act, tmax = (x.to(dev) for x in _torch(*rays))
    ps = twf.prepare_closest(sc.inst, o, d, torch.full((N_RAYS,), float("inf"), device=dev),
                             sc.world_lo, sc.world_hi, active=act)
    args = (ps.os, ps.ds, ps.ts, ps.tre, ps.tn_bits, ps.seg, *_sweep_args(sc.inst))
    k, p = sweep_inst.closest_inst(*args), sweep_inst.closest_inst_plain(*args)
    live = ps.ts > 0
    same = k[1] == p[1]
    assert float(same[live].float().mean()) >= 0.999
    assert float((k[1][live] >= 0).float().mean()) > 0.1  # the wavefront does hit
    both = same & live
    assert bool(((k[0] - p[0]).abs() <= T_RTOL * p[0].abs())[both].all())
    hit = both & (k[1] >= 0)
    assert float((k[2] - p[2]).abs()[hit].max()) <= B_ATOL
    assert float((k[3] - p[3]).abs()[hit].max()) <= B_ATOL
    ps = twf.prepare_occlusion(sc.inst, o, d, tmax, sc.world_lo, sc.world_hi, active=act)
    args = (ps.os, ps.ds, ps.ts, (ps.ts <= 0).to(torch.int32), ps.tre, ps.tn_bits,
            ps.seg, *_sweep_args(sc.inst))
    same = sweep_inst.occlusion_inst(*args) == sweep_inst.occlusion_inst_plain(*args)
    assert float(same[ps.ts > 0].float().mean()) >= 0.999
