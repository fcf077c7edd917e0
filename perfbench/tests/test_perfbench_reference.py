"""The plain reference against ``sage3d_tpu_torch``'s CPU path at 400
Gaussians and 64 x 48: images, a fit step's loss and gradients, the
occupancy grid, the motion, the policy and the capsule clearance."""

import math

import numpy as np
import pytest
import torch

from perfbench.harness import port, scene as hs
from perfbench.reference import nav as rn
from perfbench.reference import render as rr
from perfbench.reference import train as rt

W, H = 64, 48


@pytest.fixture(scope="module")
def room():
    return hs.room_fields(400, 11, 5.0, 3, 8, 0, torch.device("cpu"))


@pytest.fixture(scope="module")
def views():
    return hs.orbit_views(4, 5.0, 0)


@pytest.mark.parametrize("view", range(4))
def test_render_agrees(room, views, view):
    from sage3d_tpu_torch.renderer.render import render
    prog, ref = port.cameras(views, W, H, 14.0, "cpu")
    cam = prog._replace(**{f: getattr(prog, f)[view] for f in
                           ("position", "cam_to_world", "fx", "fy", "cx",
                            "cy")})
    out = render(port.gaussian_scene(room), cam, backend="cuda")
    r = rr.render(room, ref[view])
    # the program stops a tile at T <= 1e-4: the rest is under 1e-4 of a
    # colour and 1e-4 of the far plane's 50 m in depth
    assert float((out["rgb"] - r["rgb"]).abs().max()) < 2e-3
    assert float((out["alpha"] - r["alpha"]).abs().max()) < 2e-3
    assert float((out["depth"] - r["depth"]).abs().max()) < 0.25
    assert float((out["semantic"].long() != r["semantic"]).float().mean()) \
        < 0.01


def test_fit_step_agrees(room, views):
    from sage3d_tpu_torch.parallel.train import (Optimizer, init_train_state,
                                                 make_train_step)
    target = dict(room, sh=room["sh"] + 0.1)
    prog, ref = port.cameras(views, W, H, 14.0, "cpu")
    lrs = {"means": 8e-4, "log_scales": 5e-3, "quats": 1e-3,
           "opacity_logits": 5e-2, "sh": 2.5e-3}
    scene = port.gaussian_scene(room)
    from sage3d_tpu_torch.renderer.camera import slice_cameras
    from sage3d_tpu_torch.renderer.render import render_batch
    tgt = render_batch(port.gaussian_scene(target), prog, backend="cuda")["rgb"]
    opt = Optimizer(group_lrs=lrs)
    step, _ = make_train_step(scene, prog, backend="cuda", optimizer=opt)
    state = init_train_state(scene, opt)
    losses = []
    for v in (1, 2):
        state, loss = step(state, slice_cameras(prog, slice(v, v + 1)),
                           tgt[v:v + 1].detach())
        losses.append(float(loss))
    change = {k: float(torch.linalg.vector_norm(
        (state.params[k].detach() - room[k]).double())) for k in rt.GROUPS}
    r = rt.fit_steps(room, target, [ref[1], ref[2]], lrs)
    assert rt.loss_gap(losses, r["loss"]) < 1e-3
    assert rt.worst_leaf_gap(change, r["change"], ref_grad=r["grad"]) < 1e-3


def test_occupancy_grid_agrees():
    from sage3d_tpu_torch.physics.occupancy import grid_from_semantic_map
    inst = hs.semantic_map(5.0, 8, 0, 0.4, 0.05)
    mask, bounds = rn.occupancy(inst, 0.05, 0.08)
    g = grid_from_semantic_map(inst, robot_radius_m=0.08, scale=0.05,
                               device="cpu")
    assert np.array_equal(g.obstacle.numpy(), mask)
    assert np.allclose(g.bounds.numpy(), bounds)


def test_motion_policy_and_clearance_agree(room):
    from sage3d_tpu_torch.env.rollout import depth_seek_policy
    from sage3d_tpu_torch.ops.collision import agent_capsule, capsule_query
    from sage3d_tpu_torch.physics.agent import apply_cmd, init_agent
    from sage3d_tpu_torch.physics.occupancy import grid_from_semantic_map
    inst = hs.semantic_map(5.0, 8, 0, 0.4, 0.05)
    mask, bounds = rn.occupancy(inst, 0.05, 0.08)
    g = rn.Grid(mask, bounds, 0.05, "cpu")
    grid = grid_from_semantic_map(inst, robot_radius_m=0.08, scale=0.05,
                                  device="cpu")
    rng = np.random.default_rng(3)
    xy = rng.uniform(-5.2, 5.2, (64, 2)).astype(np.float32)
    yaw = rng.uniform(-math.pi, math.pi, 64).astype(np.float32)
    vx = rng.uniform(0.0, 0.5, 64).astype(np.float32)
    yr = rng.uniform(-0.8, 0.8, 64).astype(np.float32)
    pos = torch.tensor(np.c_[xy, np.full(64, 0.5, np.float32)])
    state = init_agent(pos, torch.tensor(yaw), device="cpu")
    out = apply_cmd(state, grid, torch.tensor(vx), 0.0, torch.tensor(yr), 1.0)
    p, w, c, hit = rn.move(g, pos, torch.tensor(yaw),
                           torch.zeros(64, dtype=torch.int32),
                           torch.tensor(vx), 0.0, torch.tensor(yr), 1.0)
    assert torch.equal(p, out.pos) and torch.equal(w, out.yaw)
    assert torch.equal(hit, out.collision_detected)

    depth = torch.tensor(rng.uniform(0.3, 6.0, (64, 48, 64)),
                         dtype=torch.float32)
    goal = torch.tensor(rng.uniform(-4, 4, (64, 2)), dtype=torch.float32)
    a = depth_seek_policy(depth, torch.tensor(xy), torch.tensor(yaw), goal)
    b = rn.policy(depth, torch.tensor(xy), torch.tensor(yaw), goal)
    assert all(torch.equal(u, v) for u, v in zip(a, b))

    p0, p1, r = agent_capsule(torch.tensor(xy[:8]), device="cpu")
    q = capsule_query(port.gaussian_scene(room), p0, p1, r, device="cpu")
    c = rn.clearance(room, p0, p1, r)
    assert float((c - q["clearance"].double()).abs().max()) < 1e-5
