"""The port's sharded path (``sage3d_tpu_torch/parallel/``: mesh, band
rendering, the sharded train step, the audit, the multi-host run) against
the JAX package's, on the CPU.

The port's ranks are processes spawned by ``spawn_mesh`` (or started by
``dryrun_multihost``) and joined over gloo; the JAX side runs on the
conftest's 8 virtual CPU devices with the ``xla`` backend, the port with
``torch``. Both take the same numpy inputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sage3d_tpu.parallel import train as jtrain
from sage3d_tpu.parallel.audit import audit_sharded_step as jax_audit
from sage3d_tpu.parallel.mesh import make_mesh as jax_mesh
from sage3d_tpu.parallel.sharded_render import \
    render_tile_sharded as jax_sharded
from sage3d_tpu.parallel.trainer import make_orbit_targets as jorbit
from sage3d_tpu.renderer.camera import make_camera as jcamera
from sage3d_tpu.renderer.scene import synthetic_room
from sage3d_tpu_torch.parallel import audit, mesh as tmesh, train as ttrain
from sage3d_tpu_torch.parallel.multihost import dryrun_multihost
from sage3d_tpu_torch.parallel.sharded_render import render_tile_sharded
from sage3d_tpu_torch.renderer import camera as tcam
from sage3d_tpu_torch.renderer.render import render
from sage3d_tpu_torch.renderer.scene import scene_from_numpy

TIMEOUT = 240           # a spawned mesh
RENDER_KW = dict(pair_capacity=1 << 14, tile_capacity=256)
EPS = 1e-4              # Adam's eps on both sides (see test_torch_train.py)


def _scene_to_torch(js):
    return scene_from_numpy({f: np.array(getattr(js, f)) for f in js._fields},
                            device="cpu")


def _cams_to_torch(jcams):
    n = jcams.position.shape[0]
    return tcam.stack_cameras([tcam.camera_from_numpy(
        {f: np.asarray(getattr(jcams, f))[i] for f in
         ("position", "cam_to_world", "fx", "fy", "cx", "cy")}
        | {"width": jcams.width, "height": jcams.height}, device="cpu")
        for i in range(n)])


@pytest.fixture(scope="module")
def band_scene():
    js = synthetic_room(num_gaussians=512, seed=21)
    jc = jcamera(position=[0.0, -4.0, 1.2], forward=[0.0, 1.0, -0.1],
                 width=64, height=64)
    tc = tcam.make_camera([0.0, -4.0, 1.2], [0.0, 1.0, -0.1], width=64,
                          height=64, device="cpu")
    return js, jc, _scene_to_torch(js), tc


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_render_tile_sharded_matches_jax(shape, band_scene):
    js, jc, ts, tc = band_scene
    want = jax_sharded(js, jc, jax_mesh(shape), backend="xla")
    got = tmesh.spawn_mesh(functools.partial(render_tile_sharded,
                                             backend="torch"),
                           shape, ts, tc, device="cpu", timeout_s=TIMEOUT)
    for k in ("rgb", "alpha"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert got["rgb"].shape == (64, 64, 3)
    assert int(got["overflow"]) == int(want["overflow"])
    assert (got["semantic"].numpy() == np.asarray(want["semantic"])).mean() \
        > 0.99
    # and against the port's own unsharded frame
    ref = render(ts, tc, backend="torch")
    np.testing.assert_allclose(got["rgb"].numpy(), ref["rgb"].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_bucketed_gather_matches_monolithic_and_jax():
    x = np.arange(64.0 * 3, dtype=np.float32).reshape(64, 3)
    got = tmesh.spawn_mesh(audit.audit_bucketed_gather, (1, 4),
                           torch.from_numpy(x), 4, device="cpu",
                           timeout_s=TIMEOUT)
    b, m = got["bucketed"], got["monolithic"]
    assert b["gathers"] == 4 and m["gathers"] == 1
    assert torch.equal(b["full"], m["full"])
    assert torch.equal(b["full"], torch.from_numpy(x))
    np.testing.assert_allclose(b["grad"].numpy(), m["grad"].numpy(),
                               rtol=1e-6)

    from functools import partial
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    mesh = jax_mesh((1, 4))

    @partial(shard_map, mesh=mesh, in_specs=(P("tile"),),
             out_specs=P("tile"), check_vma=False)
    def f(xs):
        full = jtrain.all_gather_bucketed(xs, "tile", 4)
        loc = jax.lax.axis_index("tile")
        return jnp.sum(full ** 2) * (loc + 1.0) * jnp.ones((1,))

    with mesh:
        jgrad = jax.grad(lambda v: jnp.sum(f(v)))(jnp.asarray(x))
    np.testing.assert_allclose(b["grad"].numpy(), np.asarray(jgrad),
                               rtol=1e-6)


def _record_grads():
    """An optax stage that passes the gradients on unchanged and keeps the
    last ones in its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


@pytest.fixture(scope="module")
def fit_setup():
    """test_torch_train.py's fixture, padded for a (2, 2) mesh with 4
    buckets: a 300-Gaussian room, its renders from two orbit cameras
    (48x48), and the start with noise on opacity and colour."""
    gt = synthetic_room(300, seed=4)
    jcams, targets = jorbit(gt, n_views=2, radius=4.0, width=48, height=48)
    rng = np.random.default_rng(0)
    start = jtrain.pad_scene_to(gt._replace(
        opacity_logits=gt.opacity_logits + rng.normal(
            0, 0.3, gt.opacity_logits.shape).astype(np.float32),
        sh=gt.sh + rng.normal(0, 0.1, gt.sh.shape).astype(np.float32)), 8)
    return (start, jcams, targets, _scene_to_torch(start),
            _cams_to_torch(jcams), torch.from_numpy(np.array(targets)))


def _trace(fit_setup, buckets):
    _, _, _, tstart, tcams, ttargets = fit_setup
    lrs = ttrain.make_group_optimizer(extent=4.0).group_lrs
    return tmesh.spawn_mesh(
        functools.partial(audit.trace_sharded_steps, n_steps=3,
                          backend="torch", grad_buckets=buckets, **RENDER_KW),
        (2, 2), tstart, tcams, ttargets,
        ttrain.Optimizer(group_lrs=lrs, eps=EPS), device="cpu",
        timeout_s=TIMEOUT)


def test_sharded_step_matches_jax(fit_setup):
    start, jcams, jtargets = fit_setup[:3]
    lrs = ttrain.make_group_optimizer(extent=4.0).group_lrs
    mesh = jax_mesh((2, 2))
    jopt = optax.chain(_record_grads(), optax.multi_transform(
        {k: optax.adam(lr, eps=EPS) for k, lr in lrs.items()},
        {k: k for k in lrs}))
    jstep, _ = jtrain.make_train_step(start, jcams, mesh, optimizer=jopt,
                                      backend="xla", grad_buckets=4,
                                      **RENDER_KW)
    params = jtrain.scene_params(start)
    js = jtrain.TrainState(params, jopt.init(params),
                           jnp.zeros((), jnp.int32))
    jlosses = []
    with mesh:
        for i in range(3):
            js, jloss = jstep(js, jcams, jtargets)
            jlosses.append(float(jloss))
            if i == 0:
                jgrads = {k: np.asarray(js.opt_state[0][k])
                          for k in ttrain.TRAINABLE}

    got = _trace(fit_setup, 4)
    losses = got["losses"]
    assert losses.shape == (4, 3)
    assert all(torch.equal(losses[0], losses[r]) for r in range(4))
    np.testing.assert_allclose(losses[0].numpy(), jlosses, atol=1e-5)
    assert got["counts"] == [{"all_gather": 20, "reduce_scatter": 20,
                              "all_reduce": 5, "loss_all_reduce": 1}] * 3
    for k in ttrain.TRAINABLE:
        scale = np.abs(jgrads[k]).max()
        assert scale > 0, k
        np.testing.assert_allclose(got["grads"][k].numpy() / scale,
                                   jgrads[k] / scale, atol=5e-4, err_msg=k)
        diff = np.abs(got["params"][k].numpy() - np.asarray(js.params[k]))
        assert diff.max() < 1e-5, (k, diff.max())

    # grad_buckets=4 against one gather and one reduce-scatter a group
    mono = _trace(fit_setup, 1)
    assert mono["counts"][0] == {"all_gather": 5, "reduce_scatter": 5,
                                 "all_reduce": 5, "loss_all_reduce": 1}
    np.testing.assert_allclose(mono["losses"][0].numpy(),
                               losses[0].numpy(), atol=1e-6)
    for k in ttrain.TRAINABLE:
        np.testing.assert_allclose(mono["params"][k].numpy(),
                                   got["params"][k].numpy(), atol=1e-6)


def test_audit_counts_match_jax():
    want = jax_audit(jax_mesh((2, 2)), grad_buckets=4)
    got = tmesh.spawn_mesh(audit.audit_sharded_step, (2, 2), device="cpu",
                           timeout_s=TIMEOUT)
    for kind in ("all_gather", "reduce_scatter", "all_reduce"):
        assert got["written_collectives"][kind] == \
            want["written_collectives"][kind], kind
    assert got["written_collectives"]["loss_all_reduce"] == 1
    assert got["expected_written_per_kind"] == \
        want["expected_written_per_kind"] == 20
    assert got["param_shards"] == want["param_shards"]
    for k in ("param_bytes", "wire_bytes_per_step_per_device"):
        assert got["comm_model"][k] == want["comm_model"][k], k
    assert got["optimized_all_gather"]["count"] == 20
    assert got["comm_model"]["collective_ms"] > 0
    assert got["comm_model"]["transport"] == "gloo"


def test_dryrun_multihost_two_hosts():
    report = dryrun_multihost(num_hosts=2, ranks_per_host=2, n_gauss=128,
                              image=32, steps=2, device="cpu",
                              timeout_s=TIMEOUT)
    assert report["ok"]
    assert report["written_collectives"] == {
        "all_gather": 20, "reduce_scatter": 20, "all_reduce": 5,
        "loss_all_reduce": 1}
    assert report["episodes_by_host"] == [["ep-000", "ep-002"],
                                          ["ep-001", "ep-003"]]
    ranks = report["ranks"]
    assert [r["host"] for r in ranks] == [0, 0, 1, 1]
    assert all(r["mesh"] == {"data": 2, "tile": 2} for r in ranks)
    assert all(r["shard_rows"]["means"] * 2 == r["total_rows"] for r in ranks)
    assert all(r["overflow_first_last"] == [0] * 8 for r in ranks)
    assert np.isfinite(report["losses"]).all()


def test_one_rank_collective_path_is_bitwise_direct(fit_setup):
    """``force_shard_map`` on a one-rank mesh (no process group): the
    gather, reduce-scatter and all-reduces are identities, so three steps
    leave the parameters bitwise those of the direct step."""
    _, _, _, tstart, tcams, ttargets = fit_setup
    opt = ttrain.make_group_optimizer(extent=4.0)
    mesh = tmesh.make_mesh((1, 1), device="cpu")
    runs = []
    for kw in ({}, {"mesh": mesh, "force_shard_map": True}):
        step, _ = ttrain.make_train_step(tstart, tcams, optimizer=opt,
                                         **kw, **RENDER_KW)
        state = ttrain.init_train_state(tstart, opt, kw.get("mesh"))
        losses = [float(step(state, tcams, ttargets)[1]) for _ in range(3)]
        runs.append((losses, state.params))
    assert runs[0][0] == runs[1][0]
    for k in ttrain.TRAINABLE:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k
    assert mesh.counter.counts() == {"all_gather": 60, "reduce_scatter": 60,
                                     "all_reduce": 18}


def test_episodes_batches_and_shards():
    eps = [f"ep{i}" for i in range(10)]
    parts = [tmesh.process_local_episodes(eps, process_index=i,
                                          process_count=3) for i in range(3)]
    assert sorted(sum(parts, [])) == sorted(eps)
    assert {len(p) for p in parts} == {3, 4}
    assert tmesh.process_local_episodes(eps) == eps     # no process group

    one = tmesh.make_mesh((1, 1), device="cpu")
    local = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    rows = tmesh.global_batch_from_local(one, local)
    assert torch.equal(rows, torch.from_numpy(local))
    assert one.counter.counts() == {"all_gather": 1}
    with pytest.raises(ValueError, match="spawn_mesh"):
        tmesh.make_mesh((1, 2), device="cpu")

    # rank 5 of a (2, 4) mesh: data index 1, tile index 1
    mesh = tmesh.Mesh({"data": 2, "tile": 4}, 5, torch.device("cpu"), {},
                      "none")
    assert (mesh.axis_index("data"), mesh.axis_index("tile")) == (1, 1)
    x = torch.arange(16)
    assert torch.equal(tmesh.shard_rows(x, mesh, "tile"), x[4:8])
    assert torch.equal(tmesh.shard_rows(x, mesh, "data"), x[8:])
    cams = tcam.stack_cameras([tcam.make_camera(
        [float(i), 0.0, 1.0], [0.0, 1.0, 0.0], 32, 32, device="cpu")
        for i in range(4)])
    mine = tmesh.shard_rows(cams, mesh, "data")
    assert mine.position[:, 0].tolist() == [2.0, 3.0] and mine.width == 32
    with pytest.raises(ValueError, match="do not split"):
        tmesh.shard_rows(torch.arange(6), mesh, "tile")
