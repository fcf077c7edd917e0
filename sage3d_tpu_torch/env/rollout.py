"""Closed-loop rollouts on the device: render + policy + physics each step.

PyTorch counterpart of ``sage3d_tpu/env/rollout.py``. An N-step episode
(camera build, 3DGS render, an in-graph policy, collision-safe motion,
capsule queries, metric accumulation) is a Python loop whose pose and
metrics stay on the device: no step reads the agent's state back to the host
(the render's binning syncs twice a frame for its buffer sizes). The JAX
package compiles the same loop into one ``lax.scan``.

The in-graph policy is a depth-aware goal seeker (turn toward goal, brake and
steer away when the forward depth band is close): enough to produce meaningful
CR/ICP/PS-style statistics without any external model. External VLM policies
use the per-step env/runner path (``bench/runner.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..ops.collision import (BIG, CollisionAccel, agent_capsule,
                             capsule_query, capsule_query_pruned)
from ..physics.agent import apply_cmd, init_agent
from ..physics.occupancy import OccupancyGrid
from ..renderer.camera import agent_camera_t
from ..renderer.render import render
from ..renderer.scene import GaussianScene, resolve_device


def depth_seek_policy(depth: torch.Tensor, pos_xy: torch.Tensor,
                      yaw: torch.Tensor, goal_xy: torch.Tensor,
                      speed: float = 0.4):
    """Goal pursuit with depth-band obstacle avoidance, on the device."""
    h, w = depth.shape
    band = depth[h // 3:h // 3 + h // 3, :]
    thirds = w // 3
    left = torch.mean(band[:, :thirds])
    center = torch.mean(band[:, thirds:2 * thirds])
    right = torch.mean(band[:, 2 * thirds:])

    to_goal = goal_xy - pos_xy
    heading = torch.atan2(to_goal[1], to_goal[0])
    # jnp.mod takes the divisor's sign: torch.remainder, not torch.fmod
    dyaw = torch.remainder(heading - yaw + math.pi, 2 * math.pi) - math.pi

    blocked = center < 1.0
    vx = torch.where(blocked, torch.full_like(center, 0.05),
                     speed * torch.clamp(center / 3.0, 0.3, 1.0))
    avoid = torch.where(left > right, torch.full_like(left, 0.8),
                        torch.full_like(left, -0.8))
    yaw_rate = torch.where(blocked, avoid, torch.clamp(dyaw, -0.8, 0.8))
    return vx, yaw_rate


def rollout(
    scene: GaussianScene,
    grid: OccupancyGrid,
    start_xy,
    start_yaw,
    goal_xy,
    n_steps: int = 100,
    width: int = 160,
    height: int = 120,
    backend: Optional[str] = None,
    pair_capacity: int = 1 << 20,
    tile_capacity: int = 1024,
    use_capsule: bool = True,
    duration_s: float = 1.0,
    k_small: int = 16,
    m_big: int = 8192,
    k_big: int = 256,
    m_mid: int = 0,
    k_mid: int = 0,
    grad_capacity: int = 0,   # accepted for budget_kwargs(...) compatibility;
                              # forward-only rollouts never build grad buffers
    render_scene: GaussianScene | None = None,
    collision_accel: CollisionAccel | None = None,
    prune_margin: float = 2.0,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Run one episode of ``n_steps`` steps. ``device=None`` means the card;
    the scene, grid (and accel) must lie there. ``backend=None`` renders
    with ``"cuda"`` on the card and ``"torch"`` on the CPU.

    Policy frames may render a reduced scene (``render_scene``, e.g.
    ``renderer.scene.importance_subset``) while collision queries always run
    against the full geometry. Returns ``final_pos``, ``final_yaw``,
    ``total_collisions``, the per-step ``positions`` (N, 3), ``collisions``,
    ``min_clearance`` (margin-clipped with a ``collision_accel``),
    ``goal_distance`` and ``mean_depth``, and ``total_overflow``: the pairs
    the step renders dropped, summed (0 in a correct run).
    """
    del grad_capacity
    dev = resolve_device(device)
    for what, t in (("scene", scene.means), ("grid", grid.obstacle)):
        if t.device.type != dev.type:
            raise ValueError(f"the {what} lies on {t.device}, not on {dev}")
    if backend is None:
        backend = "cuda" if dev.type == "cuda" else "torch"
    if render_scene is None:
        render_scene = scene
    budgets = dict(pair_capacity=pair_capacity, tile_capacity=tile_capacity,
                   k_small=k_small, m_big=m_big, k_big=k_big, m_mid=m_mid,
                   k_mid=k_mid)
    goal_xy = torch.as_tensor(goal_xy, dtype=torch.float32, device=dev)
    start = torch.as_tensor(start_xy, dtype=torch.float32, device=dev)
    state = init_agent(torch.cat([start, torch.full((1,), 0.5, device=dev)]),
                       start_yaw, device=dev)
    metrics = {k: [] for k in ("positions", "collisions", "min_clearance",
                               "goal_distance", "mean_depth")}
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    with torch.no_grad():
        for _ in range(n_steps):
            cam = agent_camera_t(state.pos[:2], state.yaw, width=width,
                                 height=height)
            out = render(render_scene, cam, backend=backend, **budgets)
            overflow = overflow + out["overflow"]
            vx, yaw_rate = depth_seek_policy(out["depth"], state.pos[:2],
                                             state.yaw, goal_xy)
            state = apply_cmd(state, grid, vx, 0.0, yaw_rate, duration_s)
            if use_capsule:
                p0, p1, r = agent_capsule(state.pos[None, :2], device=dev)
                if collision_accel is not None:
                    # spatially-pruned query: only chunks near the agent run;
                    # clearance is margin-clipped
                    q = capsule_query_pruned(collision_accel, p0, p1, r,
                                             prune_margin=prune_margin,
                                             device=dev)
                else:
                    q = capsule_query(scene, p0, p1, r, device=dev)
                clearance = q["clearance"][0]
            else:
                clearance = torch.full((), BIG, device=dev)
            metrics["positions"].append(state.pos)
            metrics["collisions"].append(state.collision_detected)
            metrics["min_clearance"].append(clearance)
            metrics["goal_distance"].append(
                torch.linalg.vector_norm(state.pos[:2] - goal_xy))
            metrics["mean_depth"].append(torch.mean(out["depth"]))
    result = {"final_pos": state.pos, "final_yaw": state.yaw,
              "total_collisions": state.total_collisions}
    result.update({k: torch.stack(v) for k, v in metrics.items()})
    result["total_overflow"] = overflow
    return result


def rollout_batch(scene, grid, start_xy, start_yaw, goal_xy,
                  batch_mode: str = "vmap", **kw) -> Dict[str, torch.Tensor]:
    """Batched episodes: (B, 2) starts / (B,) yaws / (B, 2) goals; every
    output carries a leading episode axis. Takes ``rollout``'s keywords.

    Both ``batch_mode``s run the episodes one after the other, as
    ``render_batch`` renders its cameras: the JAX package's ``"vmap"``
    (lockstep) and ``"map"`` (``lax.map``) are execution strategies of one
    compiled program, with the same results.
    """
    if batch_mode not in ("vmap", "map"):
        raise ValueError(f"unknown batch_mode: {batch_mode}")
    outs = [rollout(scene, grid, s, y, g, **kw)
            for s, y, g in zip(start_xy, start_yaw, goal_xy)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
