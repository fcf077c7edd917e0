"""Closed-loop rollouts on the device: render + policy + physics each step.

PyTorch counterpart of ``sage3d_tpu/env/rollout.py``. An N-step episode
(camera build, 3DGS render, an in-graph policy, collision-safe motion,
capsule queries, metric accumulation) is a Python loop whose pose and
metrics stay on the device: no step reads the agent's state back to the host
(the render's binning syncs twice a frame for its buffer sizes). The JAX
package compiles the same loop into one ``lax.scan``.

``rollout_batch(batch_mode="vmap")`` runs B agents in lockstep, the JAX
package's ``vmap``: a step is one batched render of the B agent cameras
(one K1 and one K2 launch on the card), the policy over (B, H, W), one
batched ``apply_cmd`` and one capsule query of B (one K6 launch). Every
agent's arithmetic is the single episode's, so each episode is bitwise its
``rollout``; ``batch_mode="map"`` runs the episodes one after the other.

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
from ..renderer.render import render_batch
from ..renderer.scene import GaussianScene, resolve_device
from ..utils.profiling import span


def _exact_mean(x: torch.Tensor) -> torch.Tensor:
    """f32 mean over the last two axes, its sum taken in f64 and rounded to
    f32 once before the division: the sum of a depth band's f32 values
    (about 0.05 to 50 m, some 10^5 of them) is exact in f64 in any order,
    so a frame gives the same mean alone or in a batch, on the card or the
    CPU (a reduction's order follows its shape)."""
    n = x.shape[-1] * x.shape[-2]
    return x.to(torch.float64).sum((-2, -1)).to(torch.float32) / n


def depth_seek_policy(depth: torch.Tensor, pos_xy: torch.Tensor,
                      yaw: torch.Tensor, goal_xy: torch.Tensor,
                      speed: float = 0.4):
    """Goal pursuit with depth-band obstacle avoidance, on the device. One
    agent: depth (H, W), pos (2,), yaw (); B agents: (B, H, W), (B, 2), (B,)
    (goal (2,) or (B, 2))."""
    h, w = depth.shape[-2:]
    band = depth[..., h // 3:h // 3 + h // 3, :]
    thirds = w // 3
    left = _exact_mean(band[..., :thirds])
    center = _exact_mean(band[..., thirds:2 * thirds])
    right = _exact_mean(band[..., 2 * thirds:])

    to_goal = goal_xy - pos_xy
    heading = torch.atan2(to_goal[..., 1], to_goal[..., 0])
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
    out = _lockstep(
        scene, grid, [start_xy], [start_yaw], [goal_xy], n_steps=n_steps,
        width=width, height=height, backend=backend,
        pair_capacity=pair_capacity, tile_capacity=tile_capacity,
        use_capsule=use_capsule, duration_s=duration_s, k_small=k_small,
        m_big=m_big, k_big=k_big, m_mid=m_mid, k_mid=k_mid,
        grad_capacity=grad_capacity, render_scene=render_scene,
        collision_accel=collision_accel, prune_margin=prune_margin,
        device=device)
    return {k: v[0] for k, v in out.items()}


def _lockstep(scene, grid, start_xy, start_yaw, goal_xy, n_steps=100,
              width=160, height=120, backend=None, pair_capacity=1 << 20,
              tile_capacity=1024, use_capsule=True, duration_s=1.0,
              k_small=16, m_big=8192, k_big=256, m_mid=0, k_mid=0,
              grad_capacity=0, render_scene=None, collision_accel=None,
              prune_margin=2.0, device=None):
    """B episodes in lockstep from (B, 2) starts, (B,) yaws and (B, 2)
    goals, with ``rollout``'s keywords; every output has a leading episode
    axis."""
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

    def values(v, shape):   # a tensor, an array, or a list of either
        if isinstance(v, (list, tuple)):
            v = torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                             device=dev) for x in v])
        return torch.as_tensor(v, dtype=torch.float32,
                               device=dev).reshape(-1, *shape)

    start, goal = values(start_xy, (2,)), values(goal_xy, (2,))
    yaw0 = values(start_yaw, ())
    n_ep = start.shape[0]
    state = init_agent(torch.cat([start, torch.full((n_ep, 1), 0.5,
                                                    device=dev)], -1),
                       yaw0, device=dev)
    metrics = {k: [] for k in ("positions", "collisions", "min_clearance",
                               "goal_distance", "mean_depth")}
    overflow = torch.zeros((n_ep,), dtype=torch.int32, device=dev)
    with torch.no_grad():
        for _ in range(n_steps):
            with span("rollout.step", unit=True):
                with span("rollout.camera"):
                    cams = agent_camera_t(state.pos[:, :2], state.yaw,
                                          width=width, height=height)
                out = render_batch(render_scene, cams, backend=backend,
                                   **budgets)
                overflow = overflow + out["overflow"]
                with span("rollout.policy"):
                    vx, yaw_rate = depth_seek_policy(
                        out["depth"], state.pos[:, :2], state.yaw, goal)
                with span("rollout.motion"):
                    state = apply_cmd(state, grid, vx, 0.0, yaw_rate,
                                      duration_s)
                with span("rollout.collision"):
                    if use_capsule:
                        p0, p1, r = agent_capsule(state.pos[:, :2],
                                                  device=dev)
                        if collision_accel is not None:
                            # spatially-pruned query: only chunks near the
                            # agents run; clearance is margin-clipped
                            q = capsule_query_pruned(
                                collision_accel, p0, p1, r,
                                prune_margin=prune_margin, device=dev)
                        else:
                            q = capsule_query(scene, p0, p1, r, device=dev)
                        clearance = q["clearance"]
                    else:
                        clearance = torch.full((n_ep,), BIG, device=dev)
                with span("rollout.metrics"):
                    to_goal = state.pos[:, :2] - goal
                    metrics["positions"].append(state.pos)
                    metrics["collisions"].append(state.collision_detected)
                    metrics["min_clearance"].append(clearance)
                    metrics["goal_distance"].append(torch.sqrt(
                        to_goal[:, 0] * to_goal[:, 0]
                        + to_goal[:, 1] * to_goal[:, 1]))
                    metrics["mean_depth"].append(_exact_mean(out["depth"]))
    result = {"final_pos": state.pos, "final_yaw": state.yaw,
              "total_collisions": state.total_collisions}
    result.update({k: torch.stack(v, 1) for k, v in metrics.items()})
    result["total_overflow"] = overflow
    return result


def rollout_batch(scene, grid, start_xy, start_yaw, goal_xy,
                  batch_mode: str = "vmap", **kw) -> Dict[str, torch.Tensor]:
    """Batched episodes: (B, 2) starts / (B,) yaws / (B, 2) goals; every
    output carries a leading episode axis. Takes ``rollout``'s keywords.

    ``"vmap"`` (the JAX package's default) runs the B agents in lockstep:
    each step renders the B cameras in one batched render (on the card one
    K1 and one K2 launch; ``camera_groups`` above 2^24 Gaussian rows), runs
    the policy and ``apply_cmd`` over the batch and makes one capsule query
    of B (one K6 launch). ``"map"`` (``lax.map``) runs the episodes one
    after the other. Both give each episode bitwise its ``rollout``.
    """
    if batch_mode not in ("vmap", "map"):
        raise ValueError(f"unknown batch_mode: {batch_mode}")
    if batch_mode == "map":
        outs = [rollout(scene, grid, s, y, g, **kw)
                for s, y, g in zip(start_xy, start_yaw, goal_xy)]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    return _lockstep(scene, grid, start_xy, start_yaw, goal_xy, **kw)
