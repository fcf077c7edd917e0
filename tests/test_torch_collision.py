"""Parity of the port's capsule collision (``ops/collision.py``) with the JAX
package on the CPU: the cases of ``tests/test_physics.py`` through both
packages, the Morton order and padded scene of the collision accel, and the
clearance gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage3d_tpu.ops import collision as jcol
from sage3d_tpu.renderer.scene import make_scene as jmake_scene
from sage3d_tpu.renderer.scene import synthetic_room
from sage3d_tpu_torch.ops import collision as tcol
from sage3d_tpu_torch.renderer.scene import make_scene as tmake_scene
from sage3d_tpu_torch.renderer.scene import scene_from_numpy

CLEAR_TOL = 1e-5
GRAD_REL = 1e-4
EXACT = ("hit", "hit_count", "nearest_id")


def _to_torch(js):
    return scene_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                            device="cpu")


def _both_scenes(**kw):
    return jmake_scene(**kw), tmake_scene(**kw, device="cpu")


def _capsules(xy):
    xy = np.asarray(xy, np.float32)
    return jcol.agent_capsule(jnp.asarray(xy)), tcol.agent_capsule(
        xy, device="cpu")


def _assert_same(got, want, keys=EXACT + ("clearance",)):
    for k in keys:
        w = np.asarray(want[k])
        g = got[k].detach().numpy()
        if k == "clearance":
            np.testing.assert_allclose(g, w, rtol=CLEAR_TOL, atol=CLEAR_TOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_capsule_query_hits_near_gaussian():
    js, ts = _both_scenes(
        means=[[0.0, 0.0, 0.4], [3.0, 0.0, 0.4]],
        scales=[[0.2, 0.2, 0.2], [0.2, 0.2, 0.2]],
        quats=[[1, 0, 0, 0]] * 2, opacities=[0.9, 0.9],
        colors=[[1, 0, 0]] * 2, semantic_ids=[11, 22])
    (jp0, jp1, jr), (tp0, tp1, tr) = _capsules([[0.05, 0.0], [1.5, 0.0]])
    want = jcol.capsule_query(js, jp0, jp1, jr, chunk=2)
    got = tcol.capsule_query(ts, tp0, tp1, tr, chunk=2, device="cpu")
    _assert_same(got, want)
    assert bool(got["hit"][0]) and int(got["nearest_id"][0]) == 11
    assert not bool(got["hit"][1])
    assert float(got["clearance"][1]) > 0 > float(got["clearance"][0])


def test_capsule_query_opacity_threshold():
    js, ts = _both_scenes(means=[[0.0, 0.0, 0.4]], scales=[[0.2] * 3],
                          quats=[[1, 0, 0, 0]], opacities=[0.1],
                          colors=[[1, 0, 0]], semantic_ids=[5])
    (jp0, jp1, jr), (tp0, tp1, tr) = _capsules([[0.0, 0.0]])
    want = jcol.capsule_query(js, jp0, jp1, jr, chunk=1)
    got = tcol.capsule_query(ts, tp0, tp1, tr, chunk=1, device="cpu")
    _assert_same(got, want)
    assert not bool(got["hit"][0])          # transparent: not solid
    assert int(got["nearest_id"][0]) == -1
    assert float(got["clearance"][0]) == tcol.BIG


@pytest.mark.parametrize("n,b,chunk", [(600, 8, 128), (2000, 16, 700),
                                       (1500, 12, 65536), (3000, 12, None)])
def test_capsule_query_matches_jax_on_room(n, b, chunk):
    """``chunk=None``: the port sizes its pass from B (one pass here), the
    JAX package takes its default."""
    js = synthetic_room(n, seed=11)
    ts = _to_torch(js)
    xy = np.random.default_rng(n).uniform(-4.5, 4.5, (b, 2))
    (jp0, jp1, jr), (tp0, tp1, tr) = _capsules(xy)
    want = jcol.capsule_query(js, jp0, jp1, jr, chunk=chunk or 65536)
    got = tcol.capsule_query(ts, tp0, tp1, tr, chunk=chunk, device="cpu")
    _assert_same(got, want)
    assert got["hit_count"].dtype == torch.int32
    assert got["nearest_id"].dtype == torch.int32
    # the room's walls are solid: every query finds a solid Gaussian
    assert float(got["clearance"].max()) < tcol.BIG


def test_capsule_clearance_gradient_matches_jax():
    """d(sum clearance)/d(p0, p1) through the chunked query against
    jax.grad, relative to the largest gradient entry."""
    js = synthetic_room(800, seed=4)
    ts = _to_torch(js)
    rng = np.random.default_rng(3)
    p0 = np.concatenate([rng.uniform(-4, 4, (8, 2)), np.full((8, 1), 0.1)], 1)
    p1 = p0 + np.concatenate([rng.normal(0, 0.1, (8, 2)),
                              np.full((8, 1), 0.6)], 1)
    p0, p1 = p0.astype(np.float32), p1.astype(np.float32)

    def jloss(a, b):
        return jnp.sum(jcol.capsule_query(js, a, b, 0.1, chunk=256)
                       ["clearance"])

    jg0, jg1 = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(p0),
                                               jnp.asarray(p1))
    t0 = torch.tensor(p0, requires_grad=True)
    t1 = torch.tensor(p1, requires_grad=True)
    out = tcol.capsule_query(ts, t0, t1, 0.1, chunk=256, device="cpu")
    np.testing.assert_allclose(out["clearance"].detach().numpy(),
                               np.asarray(jcol.capsule_query(
                                   js, p0, p1, 0.1, chunk=256)["clearance"]),
                               rtol=CLEAR_TOL, atol=CLEAR_TOL)
    tg0, tg1 = torch.autograd.grad(out["clearance"].sum(), (t0, t1))
    for got, want in ((tg0, jg0), (tg1, jg1)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 1e-3
        np.testing.assert_allclose(got.numpy() / scale, want / scale,
                                   atol=GRAD_REL)


def test_capsule_clearance_gradient_sign():
    js, ts = _both_scenes(means=[[2.0, 0.0, 0.4]], scales=[[0.2] * 3],
                          quats=[[1, 0, 0, 0]], opacities=[0.9],
                          colors=[[1, 0, 0]], semantic_ids=[5])
    x = torch.zeros((), requires_grad=True)
    p0, p1, r = tcol.agent_capsule(torch.stack([x, torch.zeros(())])[None],
                                   device="cpu")
    c = tcol.capsule_query(ts, p0, p1, r, chunk=1, device="cpu")["clearance"]
    (g,) = torch.autograd.grad(c[0], x)

    def jc(v):
        a, b, rr = jcol.agent_capsule(jnp.stack([v, jnp.zeros_like(v)])[None])
        return jcol.capsule_query(js, a, b, rr, chunk=1)["clearance"][0]

    want = float(jax.grad(jc)(jnp.float32(0.0)))
    assert float(g) < 0       # moving toward the Gaussian lowers clearance
    assert float(g) == pytest.approx(want, rel=GRAD_REL)


def test_morton16_wraps_as_jax():
    """Codes of 2^31 and above wrap negative in the JAX package's int32
    cast (and so sort first); the port reproduces the wrap."""
    a = np.array([65535, 40000, 0, 32768, 12345, 32767], np.int32)
    b = np.array([65535, 40000, 32768, 0, 54321, 32767], np.int32)
    want = np.asarray(jcol._morton16(jnp.asarray(a), jnp.asarray(b)))
    got = tcol._morton16(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy()[:2].tolist() == [-1, -1007669248]


@pytest.mark.parametrize("n,chunk", [(3000, 256), (1024, 512)])
def test_build_collision_accel_matches_jax(n, chunk):
    js = synthetic_room(n, seed=3)
    want = jcol.build_collision_accel(js, chunk=chunk)
    got = tcol.build_collision_accel(_to_torch(js), chunk=chunk, device="cpu")
    # the room spans its y range, so codes cross 2^31: half are negative
    m = np.asarray(js.means)
    lo, span = m.min(0), np.maximum(m.max(0) - m.min(0), 1e-6)
    qy = np.clip((m[:, 1] - lo[1]) / span[1] * 65535.0, 0, 65535)
    assert (qy >= 32768).any() and (qy < 32768).any()
    for f in js._fields:
        w = np.asarray(getattr(want.scene, f))
        g = getattr(got.scene, f).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    np.testing.assert_array_equal(got.aabb_min.numpy(),
                                  np.asarray(want.aabb_min))
    np.testing.assert_array_equal(got.aabb_max.numpy(),
                                  np.asarray(want.aabb_max))
    # exp differs by an ulp between XLA and torch on some inputs
    np.testing.assert_allclose(got.max_scale.numpy(),
                               np.asarray(want.max_scale), rtol=1e-6)


@pytest.mark.parametrize("margin", [1.0, 2.0])
def test_pruned_query_matches_jax_and_dense(margin):
    js = synthetic_room(4000, seed=3)
    ts = _to_torch(js)
    jacc = jcol.build_collision_accel(js, chunk=256)
    tacc = tcol.build_collision_accel(ts, chunk=256, device="cpu")
    xy = np.random.default_rng(1).uniform(-1.5, 1.5, (9, 2))
    (jp0, jp1, jr), (tp0, tp1, tr) = _capsules(xy)
    want = jcol.capsule_query_pruned(jacc, jp0, jp1, jr, prune_margin=margin)
    got = tcol.capsule_query_pruned(tacc, tp0, tp1, tr, prune_margin=margin,
                                    device="cpu")
    _assert_same(got, want)
    assert int(got["chunks_visited"]) == int(want["chunks_visited"])
    assert int(got["chunks_visited"]) < tacc.aabb_min.shape[0]

    dense = tcol.capsule_query(ts, tp0, tp1, tr, chunk=512, device="cpu")
    for k in ("hit", "hit_count"):
        assert torch.equal(got[k], dense[k]), k
    below = dense["clearance"] < margin
    torch.testing.assert_close(got["clearance"][below],
                               dense["clearance"][below], rtol=CLEAR_TOL,
                               atol=CLEAR_TOL)
    assert torch.equal(got["nearest_id"][below], dense["nearest_id"][below])
    assert bool((got["clearance"][~below] == margin).all())


@pytest.mark.parametrize("query_pairs", [1, 3 * 9 * 256])
def test_pruned_query_in_passes_matches_one_pass_and_jax(monkeypatch,
                                                        query_pairs):
    """The visited chunks swept in passes of one chunk, or of three, give the
    one-pass answer (the first minimum across passes) and the JAX
    package's."""
    js = synthetic_room(4000, seed=3)
    ts = _to_torch(js)
    jacc = jcol.build_collision_accel(js, chunk=256)
    tacc = tcol.build_collision_accel(ts, chunk=256, device="cpu")
    xy = np.random.default_rng(2).uniform(-2.5, 2.5, (9, 2))
    (jp0, jp1, jr), (tp0, tp1, tr) = _capsules(xy)
    want = jcol.capsule_query_pruned(jacc, jp0, jp1, jr, prune_margin=2.0)
    one = tcol.capsule_query_pruned(tacc, tp0, tp1, tr, prune_margin=2.0,
                                    device="cpu")
    monkeypatch.setattr(tcol, "QUERY_PAIRS", query_pairs)
    got = tcol.capsule_query_pruned(tacc, tp0, tp1, tr, prune_margin=2.0,
                                    device="cpu")
    assert int(got["chunks_visited"]) > 3
    _assert_same(got, want)
    for k, v in one.items():
        assert torch.equal(got[k], v), k


def test_pruned_query_skips_far_chunks():
    js = synthetic_room(1000, seed=5)
    tacc = tcol.build_collision_accel(_to_torch(js), chunk=256, device="cpu")
    jacc = jcol.build_collision_accel(js, chunk=256)
    (jp0, jp1, jr), (tp0, tp1, tr) = _capsules([[500.0, 500.0]])
    want = jcol.capsule_query_pruned(jacc, jp0, jp1, jr, prune_margin=0.5)
    got = tcol.capsule_query_pruned(tacc, tp0, tp1, tr, prune_margin=0.5,
                                    device="cpu")
    _assert_same(got, want)
    assert int(got["chunks_visited"]) == 0
    assert float(got["clearance"][0]) == 0.5
    assert not bool(got["hit"][0]) and int(got["nearest_id"][0]) == -1


def test_collision_entry_points_default_to_the_card():
    """Without ``device`` the query and the accel ask for the card: on a
    machine without one they raise, and a CPU scene is never taken as is."""
    ts = _to_torch(synthetic_room(100, seed=1))
    p0, p1, r = tcol.agent_capsule([[0.0, 0.0]], device="cpu")
    with pytest.raises((RuntimeError, ValueError)):
        tcol.capsule_query(ts, p0, p1, r)
    with pytest.raises((RuntimeError, ValueError)):
        tcol.build_collision_accel(ts)
