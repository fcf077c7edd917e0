"""Parity of the port's occupancy grid and kinematic agent
(``physics/occupancy.py``, ``physics/agent.py``) with the JAX package on the
CPU: the cases of ``tests/test_physics.py`` through both packages, on seeded
point clouds and a seeded command sequence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage3d_tpu.physics import agent as jagent
from sage3d_tpu.physics import occupancy as jocc
from sage3d_tpu_torch.physics import agent as tagent
from sage3d_tpu_torch.physics import occupancy as tocc

POS_TOL = 1e-5
YAW_TOL = 1e-6
CLEAR_TOL = 1e-6


def simple_map_instances():
    """A 10x10 m map-frame room with one wall strip (tests/test_physics.py)."""
    coords_wall = [[5.0, x / 10.0] for x in range(0, 101)]
    coords_floor = [[y / 10.0, x / 10.0] for y in range(0, 101, 10)
                    for x in range(0, 101, 10)]
    return [
        {"category_label": "Wall", "instance_id": 0, "mask_coords_m": coords_wall},
        {"category_label": "floor", "instance_id": 1, "mask_coords_m": coords_floor},
    ]


def to_world(mx, my, bounds):
    min_x, max_x, min_y, max_y = bounds
    return -((min_x + max_x) - mx), -((min_y + max_y) - my)


@pytest.fixture(scope="module")
def grids():
    inst = simple_map_instances()
    return (jocc.grid_from_semantic_map(inst, robot_radius_m=0.08),
            tocc.grid_from_semantic_map(inst, robot_radius_m=0.08,
                                        device="cpu"))


def _mask():
    m = np.zeros((120, 90), np.uint8)
    m[:2, :] = m[-2:, :] = 1
    m[:, :2] = m[:, -2:] = 1
    m[50:70, 30:33] = 1
    return m


@pytest.mark.parametrize("build", ["semantic_map", "mask"])
def test_grid_arrays_equal(build, grids):
    if build == "semantic_map":
        jg, tg = grids
    else:
        kw = dict(bounds=[-2.0, 2.5, -3.0, 3.0], robot_radius_m=0.1)
        jg = jocc.grid_from_mask(_mask(), **kw)
        tg = tocc.grid_from_mask(_mask(), **kw, device="cpu")
    for f in jg._fields:
        w = np.asarray(getattr(jg, f))
        g = getattr(tg, f).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert int(tg.obstacle.sum()) > 0
    assert (tg.height, tg.width) == (jg.height, jg.width)


def _cloud(bounds, n=4000, seed=0):
    """Seeded world points over the grid and 1 m beyond it (out of bounds),
    plus points around the 2-px tolerance edge, drawn in map coordinates."""
    min_x, max_x, min_y, max_y = bounds
    rng = np.random.default_rng(seed)
    mx = rng.uniform(min_x - 1, max_x + 1, n)
    my = rng.uniform(min_y - 1, max_y + 1, n)
    edge = np.array([(min_x - d, 5.0) for d in (0.05, 0.09, 0.11, 0.2)]
                    + [(5.0, max_y + d) for d in (0.05, 0.09, 0.11, 0.2)]
                    + [(1000.0, 1000.0)])
    mx, my = np.concatenate([mx, edge[:, 0]]), np.concatenate([my, edge[:, 1]])
    return np.stack(to_world(mx, my, bounds), -1).astype(np.float32)


def test_check_collision_world_equal(grids):
    jg, tg = grids
    b = np.asarray(jg.bounds)
    pts = _cloud(b)
    want = np.asarray(jocc.check_collision_world(jg, jnp.asarray(pts)))
    got = tocc.check_collision_world(tg, torch.from_numpy(pts))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    # a (4, 10, 2) batch, as the agent's lateral marches ask
    pts3 = pts[:40].reshape(4, 10, 2)
    np.testing.assert_array_equal(
        tocc.check_collision_world(tg, torch.from_numpy(pts3)).numpy(),
        np.asarray(jocc.check_collision_world(jg, jnp.asarray(pts3))))
    # the JAX test's landmarks
    for (mx, my), hit in (((5.0, 5.0), True), ((5.0, 2.0), False),
                          ((5.0, 5.05), True), ((5.0, 5.2), False)):
        assert bool(tocc.check_collision_world(
            tg, list(to_world(mx, my, b)))) == hit


def test_check_path_collision_world_equal(grids):
    jg, tg = grids
    b = np.asarray(jg.bounds)
    rng = np.random.default_rng(7)
    seen = set()
    for i in range(60):
        s = np.array(to_world(*rng.uniform(-0.5, 10.5, 2), b), np.float32)
        e = (s + rng.normal(0, 2.0, 2)).astype(np.float32)
        n = (3, 10)[i % 2]      # each sample count compiles the JAX side once
        want = bool(jocc.check_path_collision_world(
            jg, jnp.asarray(s), jnp.asarray(e), num_samples=n))
        got = tocc.check_path_collision_world(tg, torch.from_numpy(s),
                                              torch.from_numpy(e),
                                              num_samples=n)
        assert bool(got) == want, i
        seen.add(want)
    assert seen == {True, False}
    s = to_world(5.0, 2.0, b)
    assert bool(tocc.check_path_collision_world(tg, s, to_world(5.0, 8.0, b)))
    assert not bool(tocc.check_path_collision_world(tg, s,
                                                    to_world(8.0, 2.0, b)))


def test_clearance_world_close(grids):
    jg, tg = grids
    pts = _cloud(np.asarray(jg.bounds), seed=2)
    want = np.asarray(jocc.clearance_world(jg, jnp.asarray(pts)))
    got = tocc.clearance_world(tg, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=CLEAR_TOL, atol=CLEAR_TOL)
    b = np.asarray(jg.bounds)
    far = float(tocc.clearance_world(tg, list(to_world(5.0, 2.0, b))))
    near = float(tocc.clearance_world(tg, list(to_world(5.0, 4.7, b))))
    assert far > near > 0.0


def _commands(bounds):
    """A seeded sequence of 30 (vx, vy, yaw_rate, duration) commands from a
    start 0.35 m (map) from the wall, heading for it at an angle: free
    motion, the 20 cm cap, wall hits with lateral sliding, yaw wraps."""
    rng = np.random.default_rng(42)
    cmds = []
    for i in range(30):
        if i < 4:        # toward the wall, fast: the cap, then the hit
            cmds.append((1.0, 0.0, 0.0, 1.0))
        elif i < 8:      # sideways along it: slides
            cmds.append((0.6, float(rng.uniform(-0.3, 0.3)), 0.0, 0.5))
        else:
            cmds.append((float(rng.uniform(0.0, 0.8)),
                         float(rng.uniform(-0.2, 0.2)),
                         float(rng.uniform(-3.0, 3.0)),
                         float(rng.uniform(0.2, 1.2))))
    return cmds


def test_apply_cmd_sequence_matches_jax(grids):
    jg, tg = grids
    b = np.asarray(jg.bounds)
    wx, wy = to_world(5.0, 4.65, b)
    tx, ty = to_world(5.6, 6.0, b)
    yaw0 = float(np.arctan2(ty - wy, tx - wx))
    js = jagent.init_agent([wx, wy, 0.5], yaw0)
    ts = tagent.init_agent([wx, wy, 0.5], yaw0, device="cpu")
    japply = jax.jit(jagent.apply_cmd)
    events, slides, wraps = 0, 0, 0
    for i, (vx, vy, wr, dt) in enumerate(_commands(b)):
        prev = np.asarray(js.pos)
        js = japply(js, jg, vx, vy, wr, dt)
        ts = tagent.apply_cmd(ts, tg, vx, vy, wr, dt)
        np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos),
                                   atol=POS_TOL, err_msg=f"step {i}")
        assert abs(float(ts.yaw) - float(js.yaw)) <= YAW_TOL, i
        for f in ("consecutive_collisions", "total_collisions",
                  "collision_detected"):
            g, w = getattr(ts, f), np.asarray(getattr(js, f))
            assert g.dtype == {"collision_detected": torch.bool}.get(
                f, torch.int32), f
            assert g.item() == w.item(), (i, f)
        assert float(ts.time_s) == pytest.approx(float(js.time_s), abs=1e-6)
        moved = float(np.linalg.norm(np.asarray(js.pos)[:2] - prev[:2]))
        assert moved <= tagent.MAX_STEP_DISTANCE + 1e-6
        hit = bool(js.collision_detected)
        events += hit
        slides += hit and moved > 0.005
        wraps += abs(float(js.yaw) - yaw0) > np.pi
        yaw0 = float(js.yaw)
        assert not bool(tocc.check_collision_world(tg, ts.pos[:2]))
    assert events >= 2 and slides >= 1 and wraps >= 1, (events, slides, wraps)


def test_agent_free_motion_and_cap(grids):
    jg, tg = grids
    b = np.asarray(jg.bounds)
    wx, wy = to_world(5.0, 2.0, b)
    st = tagent.init_agent([wx, wy, 0.5], 0.0, device="cpu")
    st2 = tagent.apply_cmd(st, tg, 0.5, 0.0, 0.0, 0.3)
    assert float(torch.linalg.norm(st2.pos[:2] - st.pos[:2])) == \
        pytest.approx(0.15, abs=0.02)
    assert int(st2.total_collisions) == 0 and not bool(st2.collision_detected)
    st3 = tagent.apply_cmd(st, tg, 1.0, 0.0, 0.0, 1.0)
    assert float(torch.linalg.norm(st3.pos[:2] - st.pos[:2])) == \
        pytest.approx(0.20, abs=0.011)
    st4 = tagent.apply_cmd(tagent.init_agent([wx, wy, 0.5], 3.0,
                                             device="cpu"),
                           tg, 0.0, 0.0, 0.5, 1.0)
    assert float(st4.yaw) == pytest.approx(3.5 - 2 * np.pi, abs=1e-5)


def test_physics_builders_default_to_the_card():
    """Without ``device`` the grid and the agent go to the card, and raise
    where there is none."""
    def build():
        return (tocc.grid_from_mask(_mask(), bounds=[-2.0, 2.5, -3.0, 3.0]),
                tagent.init_agent([0.0, 0.0, 0.5], 0.0))

    if torch.cuda.is_available():
        grid, state = build()
        assert grid.device.type == state.pos.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
