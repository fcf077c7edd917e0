"""K6's plain twin (``capsule_best_plain`` in
``sage3d_tpu_torch/ops/collision.py``, the CPU path of ``capsule_best``,
with its result assembly ``_finish_plain`` and its solid test on the
opacity logits) against the JAX package's ``capsule_query`` and
``capsule_query_pruned`` on the CPU: indices and counts equal, the
clearance within NAV_CLEAR_TOL (chip_smoke.py's 1e-5), on the cases where
the packed-key reduction decides (duplicated Gaussians, exact ties, no solid
Gaussian, a degenerate capsule, a pruned query that visits nothing), on
rooms at B = 1, 4, 64 and 257 (across K6's 256-query tile), and on the
adversarial room of ``tests/capsule_cases.py`` (copies, a mirrored tie,
a far needle that touches, opacities at the threshold); the key's order;
the wrapper's device rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage3d_tpu.ops import collision as jcol
from sage3d_tpu.renderer.scene import GaussianScene as JGaussianScene
from sage3d_tpu.renderer.scene import make_scene as jmake_scene
from sage3d_tpu.renderer.scene import synthetic_room
from sage3d_tpu_torch.ops import collision as tcol
from sage3d_tpu_torch.renderer.scene import synthetic_room as tsynthetic_room
from sage3d_tpu_torch.renderer.scene import make_scene as tmake_scene
from sage3d_tpu_torch.renderer.scene import scene_from_numpy
from capsule_cases import adversarial_room, capsules

CLEAR_TOL = 1e-5
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


def _twin(ts, tp0, tp1, tr):
    """The plain twin's raw outputs (clearance, index, contacts)."""
    q = tcol._queries(tp0, tp1, tr, torch.device("cpu"))
    return tcol.capsule_best(q, tcol._columns(ts))[:4]


def test_duplicated_gaussians_first_index_wins():
    """Three copies of one Gaussian (ids 11, 22, 33) and a farther one: the
    least clearance is reached three times, and the first copy wins."""
    js, ts = _both_scenes(
        means=[[2.0, 0.0, 0.4], [0.3, 0.0, 0.4], [0.3, 0.0, 0.4],
               [0.3, 0.0, 0.4]],
        scales=[[0.1] * 3] * 4, quats=[[1, 0, 0, 0]] * 4,
        opacities=[0.9] * 4, colors=[[1, 0, 0]] * 4,
        semantic_ids=[44, 11, 22, 33])
    (jp0, jp1, jr), (tp0, tp1, tr) = _capsules([[0.0, 0.0]])
    for chunk in (1, 2, 4):
        want = jcol.capsule_query(js, jp0, jp1, jr, chunk=chunk)
        got = tcol.capsule_query(ts, tp0, tp1, tr, chunk=chunk, device="cpu")
        _assert_same(got, want)
        assert int(got["nearest_id"][0]) == 11
    assert int(_twin(ts, tp0, tp1, tr)[1][0]) == 1


def test_exact_tie_between_distinct_gaussians():
    """Two Gaussians mirrored about the capsule's axis have bitwise equal
    clearances; the one listed first wins, whichever side it is on."""
    for xs, ids in (([1.0, -1.0], [7, 9]), ([-1.0, 1.0], [9, 7])):
        js, ts = _both_scenes(
            means=[[xs[0], 0.0, 0.4], [xs[1], 0.0, 0.4]],
            scales=[[0.2, 0.3, 0.25]] * 2, quats=[[1, 0, 0, 0]] * 2,
            opacities=[0.9, 0.9], colors=[[1, 0, 0]] * 2, semantic_ids=ids)
        (jp0, jp1, jr), (tp0, tp1, tr) = _capsules([[0.0, 0.0]])
        q = tcol._queries(tp0, tp1, tr, torch.device("cpu"))
        clear = tcol._clearance(*q, *(c[None] for c in tcol._columns(ts)),
                                0.5, 2.0)[0]
        assert float(clear[0, 0]) == float(clear[0, 1])
        want = jcol.capsule_query(js, jp0, jp1, jr, chunk=2)
        got = tcol.capsule_query(ts, tp0, tp1, tr, device="cpu")
        _assert_same(got, want)
        assert int(got["nearest_id"][0]) == ids[0]
        assert int(_twin(ts, tp0, tp1, tr)[1][0]) == 0


def test_no_solid_gaussian():
    js, ts = _both_scenes(means=[[0.0, 0.0, 0.4], [1.0, 0.0, 0.4]],
                          scales=[[0.2] * 3] * 2, quats=[[1, 0, 0, 0]] * 2,
                          opacities=[0.1, 0.3], colors=[[1, 0, 0]] * 2,
                          semantic_ids=[5, 6])
    (jp0, jp1, jr), (tp0, tp1, tr) = _capsules([[0.0, 0.0], [3.0, 0.0]])
    want = jcol.capsule_query(js, jp0, jp1, jr, chunk=2)
    got = tcol.capsule_query(ts, tp0, tp1, tr, device="cpu")
    _assert_same(got, want)
    assert (got["nearest_id"] == -1).all() and (got["hit_count"] == 0).all()
    assert (got["clearance"] == tcol.BIG).all()
    clear, idx, hits, visited = _twin(ts, tp0, tp1, tr)
    assert (idx == -1).all() and (clear == tcol.BIG).all()
    assert int(visited) == 0


def test_degenerate_capsule_is_a_sphere():
    """p0 == p1: |d|^2 = 0 takes the safe divisor, t = 0, and the capsule is
    a sphere about p0."""
    js = synthetic_room(700, seed=8)
    ts = _to_torch(js)
    p = np.array([[0.5, -0.5, 0.4], [3.9, 0.0, 1.0], [0.0, 4.2, 0.2]],
                 np.float32)
    want = jcol.capsule_query(js, jnp.asarray(p), jnp.asarray(p), 0.3,
                              chunk=256)
    got = tcol.capsule_query(ts, torch.from_numpy(p), torch.from_numpy(p),
                             0.3, device="cpu")
    _assert_same(got, want)
    assert bool(got["hit"][1])           # beside the +x wall


@pytest.mark.parametrize("b", [1, 4, 64, 257])
def test_dense_and_pruned_match_jax_on_a_room(b):
    js = synthetic_room(3000, seed=b)
    ts = _to_torch(js)
    xy = np.random.default_rng(b).uniform(-4.5, 4.5, (b, 2))
    (jp0, jp1, jr), (tp0, tp1, tr) = _capsules(xy)
    want = jcol.capsule_query(js, jp0, jp1, jr, chunk=1024)
    got = tcol.capsule_query(ts, tp0, tp1, tr, chunk=1024, device="cpu")
    _assert_same(got, want)
    jacc = jcol.build_collision_accel(js, chunk=256)
    tacc = tcol.build_collision_accel(ts, chunk=256, device="cpu")
    want = jcol.capsule_query_pruned(jacc, jp0, jp1, jr, prune_margin=1.0)
    got = tcol.capsule_query_pruned(tacc, tp0, tp1, tr, prune_margin=1.0,
                                    device="cpu")
    _assert_same(got, want)
    assert int(got["chunks_visited"]) == int(want["chunks_visited"]) > 0


def test_pruned_query_that_visits_no_chunk():
    js = synthetic_room(1500, seed=6)
    tacc = tcol.build_collision_accel(_to_torch(js), chunk=512, device="cpu")
    jacc = jcol.build_collision_accel(js, chunk=512)
    (jp0, jp1, jr), (tp0, tp1, tr) = _capsules([[80.0, -90.0], [-70.0, 60.0]])
    want = jcol.capsule_query_pruned(jacc, jp0, jp1, jr, prune_margin=1.5)
    got = tcol.capsule_query_pruned(tacc, tp0, tp1, tr, prune_margin=1.5,
                                    device="cpu")
    _assert_same(got, want)
    assert int(got["chunks_visited"]) == int(want["chunks_visited"]) == 0
    assert (got["clearance"] == 1.5).all() and (got["nearest_id"] == -1).all()


def test_packed_key_order():
    """Monotone over negative, zero, positive and BIG clearances (ties
    broken by the index), -0.0 and +0.0 one key, and unpacked exactly."""
    vals = torch.tensor([-3e38, -1e9, -2.5, -1e-30, -0.0, 0.0, 1e-30, 0.5,
                         1.0, 2.0, 1e6, tcol.BIG, 3e38], dtype=torch.float32)
    keys = tcol.pack_key(vals, torch.zeros(len(vals), dtype=torch.int64))
    assert bool((keys[1:] >= keys[:-1]).all())
    assert int(keys[4]) == int(keys[5])
    assert bool((keys[[*range(4), *range(5, 13)]].diff() > 0).all())
    idx = torch.tensor([0, 1, 2**32 - 1], dtype=torch.int64)
    same = tcol.pack_key(torch.full((3,), 0.25), idx)
    assert bool((same.diff() > 0).all())
    assert int(tcol.pack_key(torch.tensor([0.25]), idx[2:])[0]) < int(
        tcol.pack_key(torch.tensor([0.2500001]), idx[:1])[0])
    clear, back = tcol.unpack_key(tcol.pack_key(vals, torch.arange(13)))
    assert torch.equal(clear.view(torch.int32),
                       torch.where(vals == 0, 0.0, vals).view(torch.int32))
    assert torch.equal(back, torch.arange(13))
    clear, back = tcol.unpack_key(torch.tensor([tcol.NONE]))
    assert float(clear[0]) == tcol.BIG and int(back[0]) == -1
    rand = torch.from_numpy(np.random.default_rng(0).normal(
        0, 10, 4000).astype(np.float32))
    order = torch.argsort(tcol.pack_key(rand, torch.arange(4000)))
    assert bool((rand[order].diff() >= 0).all())


def test_capsule_best_takes_the_plain_path_only_on_the_cpu():
    ts = _to_torch(synthetic_room(200, seed=2))
    q = tcol._queries(*tcol.agent_capsule([[0.0, 0.0], [1.0, 1.0]],
                                          device="cpu"), torch.device("cpu"))
    cols = tcol._columns(ts)
    before = tcol.capsule_best.launches
    out = tcol.capsule_best(q, cols)
    assert tcol.capsule_best.launches == before     # the plain twin ran
    assert out.hit is out.nearest_id is out.clearance is None
    for a, b in zip(out[:4], tcol.capsule_best_plain(q, cols)[:4]):
        assert torch.equal(a, b)
    ids = ts.semantic_ids
    full = tcol.capsule_best(q, cols, ids=ids)
    for a, b in zip(full, tcol.capsule_best_plain(q, cols, ids=ids)):
        assert torch.equal(a, b)
    assert full.clearance is full.clear         # dense: nothing clipped
    meta = lambda ts_: tuple(t.to("meta") for t in ts_)   # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        tcol.capsule_best(meta(q), meta(cols))
    p0, p1, r = q
    assert torch.equal(tcol.capsule_best((p0, p1, r[:1].expand(2)),
                                         cols).clear, out.clear)
    bad = [((p0[:, :2], p1, r), cols), ((p0, p1, r[:1]), cols),
           ((p0.double(), p1, r), cols), (q, (cols[0][:, :2],) + cols[1:]),
           (q, cols[:3] + (cols[3][:-1],)), (q, meta(cols))]
    for bq, bc in bad:
        with pytest.raises(ValueError):
            tcol.capsule_best(bq, bc)
    for bad_ids in (ids.long(), ids[:-1]):
        with pytest.raises(ValueError, match="ids"):
            tcol.capsule_best(q, cols, ids=bad_ids)
    acc = tcol.build_collision_accel(ts, chunk=64, device="cpu")
    with pytest.raises(ValueError, match="fill"):
        tcol.capsule_best(q, tuple(c[:-1] for c in tcol._columns(acc.scene)),
                          prune=(acc.aabb_min, acc.aabb_max, acc.max_scale,
                                 2.0))


def _adversarial(n_base=2000):
    """The adversarial room on a port room of ``n_base`` Gaussians, as a
    port scene and the same numbers as a JAX scene."""
    ts = adversarial_room(tsynthetic_room(n_base, seed=11, device="cpu"))
    js = JGaussianScene(**{f: jnp.asarray(getattr(ts, f).numpy())
                           for f in ts._fields})
    return js, ts


@pytest.mark.parametrize("pruned", [False, True])
def test_adversarial_room_matches_jax(pruned):
    """Copies, a mirrored tie, a far needle that touches and opacities at
    the threshold: the same winners, counts and clearances as the JAX
    package, and the winner the construction puts at each special capsule;
    through ``capsule_best`` with the ids (K6's result assembly) too."""
    js, ts = _adversarial()
    (jp0, jp1, jr), (tp0, tp1, tr) = _capsules(capsules(64))
    if pruned:
        jacc = jcol.build_collision_accel(js, chunk=256)
        tacc = tcol.build_collision_accel(ts, chunk=256, device="cpu")
        want = jcol.capsule_query_pruned(jacc, jp0, jp1, jr, prune_margin=1.0)
        got = tcol.capsule_query_pruned(tacc, tp0, tp1, tr, prune_margin=1.0,
                                        device="cpu")
        assert int(got["chunks_visited"]) == int(want["chunks_visited"])
        scene, prune = tacc.scene, (tacc.aabb_min, tacc.aabb_max,
                                    tacc.max_scale, 1.0)
    else:
        want = jcol.capsule_query(js, jp0, jp1, jr, chunk=512)
        got = tcol.capsule_query(ts, tp0, tp1, tr, chunk=512, device="cpu")
        scene, prune = ts, None
    _assert_same(got, want)
    # the first of the copies and of the mirrored pair in the scene's order
    order = scene.semantic_ids.tolist()
    first = [min(ids, key=order.index) for ids in ((901, 902, 903),
                                                   (911, 912))]
    assert first == ([901, 911] if pruned else [901, 912])
    assert got["nearest_id"][:4].tolist() == [*first, 921, 933]
    assert bool(got["hit"][:4].all())
    q = tcol._queries(tp0, tp1, tr, torch.device("cpu"))
    best = tcol.capsule_best(q, tcol._columns(scene), prune=prune,
                             ids=scene.semantic_ids)
    _assert_same({"clearance": best.clearance, "hit": best.hit,
                  "hit_count": best.hits, "nearest_id": best.nearest_id},
                 want)


def test_solid_test_at_the_opacity_threshold():
    """K6's solid test, sigmoid(logit) >= opacity_thresh, on the logits
    (``capsule_sigmoid`` on the CPU is ``torch.sigmoid``) decides as the
    JAX package's ``opacities >= opacity_thresh`` at the boundary: exactly
    0 and -1e-9 are solid at 0.5 (both round to 0.5), -1e-6 is not."""
    logits = np.concatenate([
        np.array([0.0, -1e-9, 1e-9, -1e-6, 1e-6, -3e-8, 3e-8], np.float32),
        np.random.default_rng(3).normal(0, 3, 4000).astype(np.float32)])
    got = tcol.capsule_sigmoid(torch.from_numpy(logits))
    assert torch.equal(got, torch.sigmoid(torch.from_numpy(logits)))
    want = np.asarray(jax.nn.sigmoid(jnp.asarray(logits)))
    for thresh in (0.5, 0.3, 0.9):
        np.testing.assert_array_equal(got.numpy() >= thresh, want >= thresh)
    assert (got[:5] >= 0.5).tolist() == [True, True, True, False, True]
