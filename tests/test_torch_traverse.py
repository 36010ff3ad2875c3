"""Port parity: the skip-link BVH walk and Scene.build(traversal=...).

The scene is the default scene with coarse spheres (3,082 triangles); 4096
rays from seeded origins inside its world box in seeded directions. The
walk is held

* to brute_force_closest_hit, every ray against every triangle: hit, t and
  tri equal on every lane (the walk tests a triangle only where it could
  improve the best t, the brute force takes the first least t; on these
  rays no two faces tie), and any_hit to the brute force's hit flag;
* to the JAX package's walk (traverse.closest_hit / any_hit) over the same
  BVH: tri and the flags equal on every lane, t within 1e-6 relative
  (1e-7 absolute, for hits just off the origin), b1
  and b2 within 1e-5 (XLA contracts the walk's products into FMAs: 2% of
  the barycentrics differ by up to 3e-6);
* to the packet engine (the plain sweeps) on the first N_PACKETS rays (the
  plain sweeps are slow on incoherent rays on the CPU): the hit flag
  equal, t within 1e-6 relative, and the same face but where two faces
  tie (both hold the hit point within 1e-6 in float64, scenes.face_hits).

Then the build's four traversal values, and the 16x16 transport probe of
the full default scene (61,450 triangles) under 'skiplink' against the
packets': the same rays and mean RGB within 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu_torch as hk
from hikari_tpu.geometry import traverse as jtr
from hikari_tpu_torch.geometry import traverse as ttr
from hikari_tpu_torch.integrators.volpath import (pixel_centre_rays, scene_any_hit,
                                                  scene_closest_hit)
from hikari_tpu_torch.scenes import default_scene, face_hits, scene_camera, transport_probe

COARSE = (8, 16)
N = 4096
N_PACKETS = 1024
T_RTOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    s = default_scene(sphere_res=COARSE)
    sk = s.build(traversal="skiplink", device="cpu")
    pk = s.build(traversal="packets", device="cpu")
    rng = np.random.RandomState(0)
    lo, hi = sk.world_lo.numpy(), sk.world_hi.numpy()
    o = rng.uniform(lo, hi, (N, 3)).astype(np.float32)
    d = rng.randn(N, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_shadow = rng.uniform(0.1, 3.0, N).astype(np.float32)
    return dict(sk=sk, pk=pk, o=torch.from_numpy(o), d=torch.from_numpy(d),
                t_shadow=torch.from_numpy(t_shadow),
                inf=torch.full((N,), float("inf")))


def _brute(s, t_max):
    b = s["sk"].bvh
    return ttr.brute_force_closest_hit(b.p0, b.p1, b.p2, s["o"], s["d"], t_max)


def test_skiplink_equals_brute_force(setup):
    s = setup
    rec = ttr.closest_hit(s["sk"].bvh, s["o"], s["d"], s["inf"])
    ref = _brute(s, s["inf"])
    assert 0.3 < float(rec.hit.float().mean()) < 1.0
    assert torch.equal(rec.hit, ref.hit)
    assert torch.equal(rec.tri, ref.tri)
    assert torch.equal(rec.t[rec.hit], ref.t[ref.hit])
    assert torch.equal(rec.b1[rec.hit], ref.b1[ref.hit])


def test_any_hit_equals_brute_force(setup):
    s = setup
    found = ttr.any_hit(s["sk"].bvh, s["o"], s["d"], s["t_shadow"])
    ref = _brute(s, s["t_shadow"])
    assert 0.1 < float(found.float().mean()) < 0.9
    assert torch.equal(found, ref.hit)
    # a lane with reach 0 finds nothing
    assert not ttr.any_hit(s["sk"].bvh, s["o"], s["d"], torch.zeros(N)).any()


def _jax_bvh(scene):
    b = scene.bvh
    return jtr.DeviceBVH(lo=jnp.asarray(b.lo.numpy()), hi=jnp.asarray(b.hi.numpy()),
                         first=jnp.asarray(b.first.numpy().astype(np.int32)),
                         count=jnp.asarray(b.count.numpy().astype(np.int32)),
                         skip=jnp.asarray(b.skip.numpy().astype(np.int32)),
                         p0=jnp.asarray(b.p0.numpy()), p1=jnp.asarray(b.p1.numpy()),
                         p2=jnp.asarray(b.p2.numpy()))


def test_skiplink_equals_jax_walk(setup):
    """The JAX package's walk over the same BVH gives the same hits, lane
    for lane."""
    s = setup
    bvh = _jax_bvh(s["sk"])
    o, d = jnp.asarray(s["o"].numpy()), jnp.asarray(s["d"].numpy())
    jrec = jtr.closest_hit(bvh, o, d, jnp.full((N,), jnp.inf))
    rec = ttr.closest_hit(s["sk"].bvh, s["o"], s["d"], s["inf"])
    np.testing.assert_array_equal(np.asarray(jrec.tri), rec.tri.numpy())
    hit = rec.hit.numpy()
    np.testing.assert_allclose(np.asarray(jrec.t)[hit], rec.t.numpy()[hit], rtol=1e-6,
                               atol=1e-7)
    for f in ("b1", "b2"):
        np.testing.assert_allclose(np.asarray(getattr(jrec, f))[hit],
                                   getattr(rec, f).numpy()[hit], rtol=0, atol=1e-5,
                                   err_msg=f)
    jocc = jtr.any_hit(bvh, o, d, jnp.asarray(s["t_shadow"].numpy()))
    np.testing.assert_array_equal(np.asarray(jocc),
                                  ttr.any_hit(s["sk"].bvh, s["o"], s["d"],
                                              s["t_shadow"]).numpy())


def test_skiplink_equals_packets(setup):
    s = {k: v[:N_PACKETS] if isinstance(v, torch.Tensor) else v for k, v in setup.items()}
    rec = scene_closest_hit(s["sk"], s["o"], s["d"], s["inf"])
    ref = scene_closest_hit(s["pk"], s["o"], s["d"], s["inf"])
    assert torch.equal(rec.hit, ref.hit)
    h = rec.hit
    assert bool(((rec.t[h] - ref.t[h]).abs() <= T_RTOL * ref.t[h]).all())
    other = h & (rec.tri != ref.tri)
    if other.any():  # a tie: both faces hold the hit point
        for tri in (rec.tri, ref.tri):
            _, on = face_hits(s["pk"].treelets, tri[other], s["o"][other], s["d"][other])
            assert bool(on.all())
    assert float(other.float().mean()) <= 0.001
    # inactive lanes find nothing, on both engines
    active = torch.arange(N_PACKETS) % 3 > 0
    for sc in (s["sk"], s["pk"]):
        r = scene_closest_hit(sc, s["o"], s["d"], s["inf"], active=active)
        assert not r.hit[~active].any()
        assert not scene_any_hit(sc, s["o"], s["d"], s["t_shadow"], active=active)[~active].any()


def test_build_traversal_values():
    s = default_scene(sphere_res=(4, 8))
    assert s.build(device="cpu").traversal == "packets"  # 'auto'
    for value in ("packets", "skiplink", "packets_interp"):
        sc = s.build(traversal=value, device="cpu")
        assert sc.traversal == value
        assert sc.bvh is not None and sc.bvh.p0.shape[0] == sc.n_faces
    with pytest.raises(ValueError):
        s.build(traversal="bvh", device="cpu")
    # an instanced scene has no skip-link walk: the packets, as in the JAX package
    inst = hk.Scene()
    inst.add_instanced(hk.make_sphere((0, 0, 0), 0.5, 4, 8), np.eye(4, dtype=np.float32)[None],
                       hk.Matte())
    sc = inst.build(traversal="skiplink", device="cpu")
    assert sc.traversal == "packets" and sc.bvh is None


def test_packets_interp_traces_as_packets():
    s = default_scene(sphere_res=(4, 8))
    o, d = pixel_centre_rays(scene_camera("default", 16), "cpu")
    t = torch.full((256,), float("inf"))
    a = scene_closest_hit(s.build(traversal="packets_interp", device="cpu"), o, d, t)
    b = scene_closest_hit(s.build(device="cpu"), o, d, t)
    for f in ("hit", "t", "tri", "b1", "b2"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.cuda
def test_packets_interp_raises_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: on the CPU packets_interp is the plain sweeps")
    with pytest.raises(ValueError):
        default_scene(sphere_res=(4, 8)).build(traversal="packets_interp", device="cuda")


def test_default_probe_under_skiplink():
    """The full default scene's 16x16 depth-5 probe: the walk traces the
    same rays as the packet engine, and mean RGB within 1e-5."""
    s = default_scene()
    rays_s, rgb_s = transport_probe(s.build(traversal="skiplink", device="cpu"), "default",
                                    res=16)
    rays_p, rgb_p = transport_probe(s.build(device="cpu"), "default", res=16)
    assert rays_s == rays_p
    assert abs(rgb_s / rgb_p - 1) <= 1e-5, (rgb_s, rgb_p)
