"""Parity of the port's rollouts (``env/rollout.py``) with the JAX package on
the CPU: the four cases of ``tests/test_rollout.py`` through both packages
(JAX ``xla`` backend, the port's ``torch`` backend), and the in-graph policy.

The policy's branches (``center < 1``, ``left > right``) are discontinuous:
a rendering difference near a threshold would flip a step. Each rollout is
therefore replayed step by step through the port's pieces, recording every
step's margins ``|center - 1|`` and, where the agent brakes, ``|left -
right|``; they must exceed ``MARGIN_MIN``, so a flip fails loudly here
instead of the comparison passing or failing by luck."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage3d_tpu.env import rollout as jroll
from sage3d_tpu.ops.collision import build_collision_accel as jaccel
from sage3d_tpu.physics.occupancy import grid_from_mask as jgrid
from sage3d_tpu.renderer.scene import importance_subset as jsubset
from sage3d_tpu.renderer.scene import synthetic_room
from sage3d_tpu_torch.env import rollout as troll
from sage3d_tpu_torch.ops.collision import build_collision_accel as taccel
from sage3d_tpu_torch.physics.agent import apply_cmd, init_agent
from sage3d_tpu_torch.physics.occupancy import grid_from_mask as tgrid
from sage3d_tpu_torch.renderer.camera import agent_camera_t
from sage3d_tpu_torch.renderer.render import render
from sage3d_tpu_torch.renderer.scene import importance_subset as tsubset
from sage3d_tpu_torch.renderer.scene import scene_from_numpy

POS_TOL = 1e-5      # positions, goal_distance, min_clearance
DEPTH_TOL = 1e-4    # mean_depth
MARGIN_MIN = 1e-3   # the policy's branch margins, in depth units (meters)
BUDGETS = dict(pair_capacity=1 << 14, tile_capacity=512)


def _to_torch(js):
    return scene_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                            device="cpu")


def _walls(shape, border, bounds):
    m = np.zeros(shape, np.uint8)
    m[:border, :] = m[-border:, :] = 1
    m[:, :border] = m[:, -border:] = 1
    return jgrid(m, bounds=bounds), tgrid(m, bounds=bounds, device="cpu")


def _assert_rollouts_match(got, want):
    assert int(got["total_collisions"]) == int(want["total_collisions"])
    np.testing.assert_array_equal(got["collisions"].numpy(),
                                  np.asarray(want["collisions"]))
    for k in ("positions", "final_pos", "goal_distance", "min_clearance"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=POS_TOL, atol=POS_TOL, err_msg=k)
    np.testing.assert_allclose(got["mean_depth"].numpy(),
                               np.asarray(want["mean_depth"]),
                               rtol=DEPTH_TOL, atol=DEPTH_TOL)
    assert abs(float(got["final_yaw"]) - float(want["final_yaw"])) <= POS_TOL


def _replay_margins(scene, grid, start_xy, start_yaw, goal_xy, n_steps,
                    width, height, render_scene=None, positions=None):
    """The rollout's loop through the port's pieces, returning each step's
    branch margins; its positions must be the rollout's."""
    render_scene = scene if render_scene is None else render_scene
    goal = torch.tensor(goal_xy, dtype=torch.float32)
    st = init_agent([*start_xy, 0.5], start_yaw, device="cpu")
    centers, sides = [], []
    with torch.no_grad():
        for i in range(n_steps):
            cam = agent_camera_t(st.pos[:2], st.yaw, width=width,
                                 height=height)
            depth = render(render_scene, cam, backend="torch",
                           **BUDGETS)["depth"]
            h, w = depth.shape
            band = depth[h // 3:2 * (h // 3)]
            t = w // 3
            left, center, right = (float(band[:, :t].mean()),
                                   float(band[:, t:2 * t].mean()),
                                   float(band[:, 2 * t:].mean()))
            centers.append(abs(center - 1.0))
            if center < 1.0:
                sides.append(abs(left - right))
            vx, wr = troll.depth_seek_policy(depth, st.pos[:2], st.yaw, goal)
            st = apply_cmd(st, grid, vx, 0.0, wr, 1.0)
            if positions is not None:
                assert torch.equal(st.pos, positions[i]), i
    return min(centers), min(sides, default=np.inf)


def test_rollout_runs_moves_and_matches_jax():
    js = synthetic_room(num_gaussians=400, seed=13)
    ts = _to_torch(js)
    jg, tg = _walls((200, 200), 2, [-5.0, 5.0, -5.0, 5.0])
    kw = dict(start_xy=[2.0, 2.0], start_yaw=0.0, goal_xy=[-2.0, -2.0],
              n_steps=12, width=64, height=48, use_capsule=True, **BUDGETS)
    want = jroll.rollout(js, jg, backend="xla", **kw)
    got = troll.rollout(ts, tg, device="cpu", **kw)
    assert got["positions"].shape == (12, 3)
    assert int(got["total_overflow"]) == 0
    _assert_rollouts_match(got, want)
    moved = float(torch.linalg.norm(got["final_pos"][:2]
                                    - torch.tensor([2.0, 2.0])))
    assert moved > 0.3
    gd = got["goal_distance"].numpy()
    assert gd[-1] < gd[0] + 0.5
    c, s = _replay_margins(ts, tg, [2.0, 2.0], 0.0, [-2.0, -2.0], 12, 64, 48,
                           positions=got["positions"])
    assert c > MARGIN_MIN and s > MARGIN_MIN, (c, s)


def test_rollout_batch_both_modes_match_jax_and_single():
    js = synthetic_room(num_gaussians=500, seed=2)
    ts = _to_torch(js)
    jg, tg = _walls((100, 100), 3, [-5.0, 5.0, -4.0, 4.0])
    starts = np.array([[0.0, -3.0], [0.5, -2.5]], np.float32)
    yaws = np.array([1.57, 1.3], np.float32)
    goals = np.array([[2.0, 2.0], [-2.0, 2.0]], np.float32)
    kw = dict(n_steps=5, width=64, height=48, use_capsule=True, **BUDGETS)
    want = jroll.rollout_batch(js, jg, starts, yaws, goals, backend="xla",
                               **kw)
    got = {mode: troll.rollout_batch(ts, tg, starts, yaws, goals,
                                     batch_mode=mode, device="cpu", **kw)
           for mode in ("vmap", "map")}
    for k in got["vmap"]:
        assert torch.equal(got["vmap"][k], got["map"][k]), k
    for b in range(2):
        single = troll.rollout(ts, tg, starts[b], yaws[b], goals[b],
                               device="cpu", **kw)
        for k in single:
            assert torch.equal(got["map"][k][b], single[k]), (b, k)
        _assert_rollouts_match(single, {k: np.asarray(v)[b]
                                        for k, v in want.items()})
        c, s = _replay_margins(ts, tg, starts[b].tolist(), float(yaws[b]),
                               goals[b].tolist(), 5, 64, 48,
                               positions=single["positions"])
        assert c > MARGIN_MIN and s > MARGIN_MIN, (b, c, s)
    assert got["map"]["goal_distance"].shape == (2, 5)
    assert got["map"]["total_overflow"].shape == (2,)
    with pytest.raises(ValueError):
        troll.rollout_batch(ts, tg, starts, yaws, goals, batch_mode="scan",
                            device="cpu", **kw)


def test_rollout_with_lod_render_scene_matches_jax():
    js = synthetic_room(800, seed=5)
    ts = _to_torch(js)
    jlod, tlod = jsubset(js, 256), tsubset(ts, 256)
    for f in js._fields:
        np.testing.assert_array_equal(getattr(tlod, f).numpy(),
                                      np.asarray(getattr(jlod, f)), err_msg=f)
    jg, tg = _walls((200, 200), 2, [-5.0, 5.0, -5.0, 5.0])
    kw = dict(start_xy=[0.0, 0.0], start_yaw=0.0, goal_xy=[2.0, 0.0],
              n_steps=4, width=64, height=64, pair_capacity=1 << 14,
              tile_capacity=256)
    want = jroll.rollout(js, jg, backend="xla", render_scene=jlod, **kw)
    got = troll.rollout(ts, tg, render_scene=tlod, device="cpu", **kw)
    assert got["positions"].shape == (4, 3)
    assert bool(torch.isfinite(got["min_clearance"]).all())
    _assert_rollouts_match(got, want)
    c, s = _replay_margins(ts, tg, [0.0, 0.0], 0.0, [2.0, 0.0], 4, 64, 64,
                           render_scene=tlod, positions=got["positions"])
    assert c > MARGIN_MIN and s > MARGIN_MIN, (c, s)


def test_rollout_pruned_collision_matches_dense_and_jax():
    js = synthetic_room(num_gaussians=600, seed=4)
    ts = _to_torch(js)
    jg, tg = _walls((200, 200), 2, [-5.0, 5.0, -5.0, 5.0])
    kw = dict(start_xy=[1.0, 1.0], start_yaw=0.5, goal_xy=[-2.0, -2.0],
              n_steps=8, width=64, height=48, use_capsule=True, **BUDGETS)
    tacc = taccel(ts, chunk=256, device="cpu")
    want = jroll.rollout(js, jg, backend="xla",
                         collision_accel=jaccel(js, chunk=256), **kw)
    dense = troll.rollout(ts, tg, device="cpu", **kw)
    pruned = troll.rollout(ts, tg, collision_accel=tacc, device="cpu", **kw)
    _assert_rollouts_match(pruned, want)
    torch.testing.assert_close(pruned["positions"], dense["positions"],
                               rtol=0, atol=POS_TOL)
    dc, pc = dense["min_clearance"], pruned["min_clearance"]
    below = dc < 2.0     # the default prune_margin
    torch.testing.assert_close(pc[below], dc[below], rtol=POS_TOL,
                               atol=POS_TOL)
    assert bool((pc <= 2.0 + 1e-6).all())
    c, s = _replay_margins(ts, tg, [1.0, 1.0], 0.5, [-2.0, -2.0], 8, 64, 48,
                           positions=dense["positions"])
    assert c > MARGIN_MIN and s > MARGIN_MIN, (c, s)


def test_depth_seek_policy_equal_on_seeded_depth_maps():
    """Seeded depth maps on a 1/64 m grid, so every band sum is exact in
    f32 whatever the summation order: vx and yaw_rate must be equal, on
    both sides of both branches."""
    rng = np.random.default_rng(9)
    seen = set()
    for i in range(40):
        h, w = [(48, 64), (30, 40), (120, 160)][i % 3]
        lo, hi = (0.1, 1.7) if i % 2 else (1.5, 6.0)
        depth = (np.round(rng.uniform(lo, hi, (h, w)) * 64) / 64).astype(
            np.float32)
        pos = rng.uniform(-4, 4, 2).astype(np.float32)
        goal = rng.uniform(-4, 4, 2).astype(np.float32)
        yaw = np.float32(rng.uniform(-4, 4))
        jvx, jwr = jroll.depth_seek_policy(jnp.asarray(depth), jnp.asarray(pos),
                                           jnp.asarray(yaw), jnp.asarray(goal))
        tvx, twr = troll.depth_seek_policy(torch.from_numpy(depth),
                                           torch.from_numpy(pos),
                                           torch.tensor(yaw),
                                           torch.from_numpy(goal))
        assert float(tvx) == float(jvx) and float(twr) == float(jwr), i
        seen.add((float(tvx) == np.float32(0.05),
                  abs(float(twr)) == np.float32(0.8)))
    # braking (and turning at +-0.8), or cruising with the turn clipped or not
    assert seen == {(True, True), (False, True), (False, False)}, seen


def test_rollout_defaults_to_the_card():
    js = synthetic_room(num_gaussians=100, seed=1)
    _, tg = _walls((50, 50), 2, [-5.0, 5.0, -5.0, 5.0])
    with pytest.raises((RuntimeError, ValueError)):
        troll.rollout(_to_torch(js), tg, [0.0, 0.0], 0.0, [1.0, 1.0],
                      n_steps=1)
