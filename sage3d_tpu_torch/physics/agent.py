"""Kinematic agent: the 1 cm micro-step motion loop as a few batched tensor ops.

PyTorch counterpart of ``sage3d_tpu/physics/agent.py``. The reference executes
motion as a Python loop of 1 cm physics micro-steps with collision pre-checks
and a 4-direction lateral-exploration fallback (simple_env.py:1987-2234).
Those semantics shape the benchmark's CR/ICP/PS metrics, so they are
reproduced exactly, but all candidate micro-step positions of a march are
tested in one occupancy gather (the four lateral marches together, a
(4, 10, 2) point set), and the stop/slide outcome is recovered with
first-index reductions. An env step runs on the state's device with no host
round trip.

Semantics mirrored (file:line):
  * robot->world velocity rotation by yaw      simple_env.py:1996-2003
  * per-command travel cap 0.20 m              :2096 (max_distance)
  * direct motion: 1 cm steps, stop at first
    colliding step                             :2116-2159
  * direct progress <= 0.01 m => try 4 lateral
    directions (perp, -perp, +-45deg blends),
    5 mm steps, 0.05 m cap, keep best if
    > 0.005 m                                  :2161-2234
  * efficiency bookkeeping: consecutive
    collision counter +1 if actual/intended
    < 0.3 with intended > 0.05; reset if > 0.6 :2033-2047
  * yaw integrate + wrap to (-pi, pi]          :2051-2053
  * collision event counting for CR            :1854-1864
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..renderer.scene import resolve_device
from ..utils.profiling import span
from .occupancy import OccupancyGrid, check_collision_world

MAX_STEP_DISTANCE = 0.20     # meters per command (simple_env.py:2096)
DIRECT_STEP = 0.01           # 1 cm micro-step
N_DIRECT_STEPS = 20          # 0.20 / 0.01
EXPLORE_STEP = 0.005         # 5 mm micro-step
EXPLORE_MAX = 0.05
N_EXPLORE_STEPS = 10         # 0.05 / 0.005
MIN_MOVE = 0.001


class AgentState(NamedTuple):
    """Agent state, tensors on one device. B agents in lockstep (the JAX
    package's ``vmap`` over agents) carry a leading axis on every field:
    pos (B, 3), the rest (B,)."""

    pos: torch.Tensor                    # (3,) world position
    yaw: torch.Tensor                    # () heading
    consecutive_collisions: torch.Tensor  # () int32
    total_collisions: torch.Tensor       # () int32 (CR metric source)
    collision_detected: torch.Tensor     # () bool (this-step flag, for ICP)
    time_s: torch.Tensor                 # () episode sim time


def init_agent(pos, yaw, device=None) -> AgentState:
    """A fresh agent at ``pos`` (3,) heading ``yaw``, or B agents at (B, 3)
    and (B,); ``device=None`` means the card."""
    dev = resolve_device(device)
    with span("motion.read_start"):
        yaw = torch.as_tensor(yaw, dtype=torch.float32, device=dev)
        pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    return AgentState(
        pos=pos,
        yaw=yaw,
        consecutive_collisions=torch.zeros(yaw.shape, dtype=torch.int32,
                                           device=dev),
        total_collisions=torch.zeros(yaw.shape, dtype=torch.int32,
                                     device=dev),
        collision_detected=torch.zeros(yaw.shape, dtype=torch.bool,
                                       device=dev),
        time_s=torch.zeros(yaw.shape, dtype=torch.float32, device=dev),
    )


def _march(grid: OccupancyGrid, start_xy, directions, step: float,
           n_steps: int, max_distance) -> Tuple[torch.Tensor, torch.Tensor]:
    """March from ``start_xy`` (..., 2) along each of ``directions``
    (..., D, 2) in fixed micro-steps, stopping at the first colliding (or
    beyond-max) step; ``max_distance`` () or (...). Returns
    (distance_moved, hit_obstacle), each (..., D).

    All candidate positions are tested at once; the serial early stop of the
    reference loop is the first blocked step.
    """
    ks = torch.arange(1, n_steps + 1, dtype=torch.float32,
                      device=start_xy.device)
    md = max_distance[..., None]
    dists = torch.minimum(ks * step, md)                           # (..., n)
    pts = (start_xy[..., None, None, :]
           + directions[..., :, None, :] * dists[..., None, :, None])  # (..., D, n, 2)
    unsafe = check_collision_world(grid, pts)
    in_range = dists <= md + 1e-9
    blocked = unsafe & in_range[..., None, :]
    any_block = torch.any(blocked, dim=-1)
    # first blocked step (torch.argmax refuses bool; on ints it returns the
    # first maximum, as jnp.argmax does)
    first_block = torch.argmax(blocked.to(torch.int32), dim=-1)
    before = torch.gather(dists[..., None, :].expand(blocked.shape), -1,
                          torch.clamp(first_block - 1, min=0)[..., None])
    moved = torch.where(
        any_block,
        torch.where(first_block > 0, before[..., 0],
                    torch.zeros((), device=dists.device)),
        torch.minimum(md, dists[..., -1:]))
    return moved, any_block


def apply_cmd(state: AgentState, grid: OccupancyGrid, vx, vy, yaw_rate,
              duration_s) -> AgentState:
    """Execute one velocity command with collision-safe motion, on the
    state's device. Mirrors SimpleVLNEnv.apply_cmd_for +
    _safe_gradual_movement semantics. A lockstep state of B agents takes
    (B,) commands (or scalars for all): the same arithmetic per agent, so
    each agent moves bitwise as it would alone."""
    dev = state.pos.device

    def f32(v):
        with span("motion.read_scalar"):
            return torch.as_tensor(v, dtype=torch.float32, device=dev)

    vx, vy = f32(vx), f32(vy)
    yaw_rate, duration_s = f32(yaw_rate), f32(duration_s)

    cos_y = torch.cos(state.yaw)
    sin_y = torch.sin(state.yaw)
    world_vx = vx * cos_y - vy * sin_y
    world_vy = vx * sin_y + vy * cos_y
    total_dx = world_vx * duration_s
    total_dy = world_vy * duration_s
    intended = torch.sqrt(total_dx * total_dx + total_dy * total_dy)

    start_xy = state.pos[..., :2]
    moving = intended > MIN_MOVE
    safe_intended = torch.where(moving, intended, f32(1.0))
    direction = torch.stack([total_dx, total_dy], -1) / safe_intended[..., None]
    max_dist = torch.minimum(f32(MAX_STEP_DISTANCE), intended)

    moved_d, hit_d = _march(grid, start_xy, direction[..., None, :],
                            DIRECT_STEP, N_DIRECT_STEPS, max_dist)
    direct_moved, direct_hit = moved_d[..., 0], hit_d[..., 0]

    # Lateral exploration when direct motion is (near-)fully blocked: the
    # four directions march in one call, a (4, 10, 2) point set an agent.
    perp = torch.stack([-direction[..., 1], direction[..., 0]], -1)
    dirs = torch.stack([
        perp,
        -perp,
        perp * 0.707 + direction * 0.707,
        -perp * 0.707 + direction * 0.707,
    ], -2)
    # the norm written out: a two-element sum, in one order for any batch
    norm = torch.sqrt(dirs[..., 0:1] * dirs[..., 0:1]
                      + dirs[..., 1:2] * dirs[..., 1:2])
    dirs = dirs / (norm + 1e-12)
    ex_moved, _ = _march(grid, start_xy, dirs, EXPLORE_STEP, N_EXPLORE_STEPS,
                         f32(EXPLORE_MAX))
    best_i = torch.argmax(ex_moved, dim=-1, keepdim=True)
    best_ex = torch.gather(ex_moved, -1, best_i)[..., 0]
    best_dir = torch.gather(dirs, -2, best_i[..., None].expand(
        *best_i.shape, 2))[..., 0, :]

    use_direct = direct_moved > 0.01
    use_explore = (~use_direct) & (best_ex > 0.005)
    moved = torch.where(use_direct, direct_moved,
                        torch.where(use_explore, best_ex, f32(0.0)))
    move_dir = torch.where(use_direct[..., None], direction, best_dir)
    new_xy = torch.where(moving[..., None], start_xy + move_dir
                         * moved[..., None], start_xy)

    # Collision accounting: a blocked direct march is the collision event that
    # the reference records via check_collision_3d inside _is_position_safe
    # (simple_env.py:1854-1864 increments the CR counter on a positive check).
    collision_event = moving & direct_hit
    efficiency = torch.where(intended > 0, moved / safe_intended, f32(1.0))
    stuck = (efficiency < 0.3) & (intended > 0.05)
    cc0 = state.consecutive_collisions
    cc = torch.where(
        moving,
        torch.where(stuck, cc0 + 1,
                    torch.where(efficiency > 0.6, torch.zeros_like(cc0), cc0)),
        cc0)

    new_yaw = state.yaw + yaw_rate * duration_s
    # jnp.mod takes the divisor's sign: torch.remainder, not torch.fmod
    new_yaw = torch.remainder(new_yaw + math.pi, 2.0 * math.pi) - math.pi

    return AgentState(
        pos=torch.cat([new_xy, state.pos[..., 2:3]], -1),
        yaw=new_yaw,
        consecutive_collisions=cc.to(torch.int32),
        total_collisions=state.total_collisions
        + collision_event.to(torch.int32),
        collision_detected=collision_event,
        time_s=state.time_s + duration_s,
    )
