"""The plain reference of a SAGE-Bench env step: the occupancy grid of a
semantic map, the agent's collision-safe motion, the depth-seek policy and
the capsule clearance against the Gaussians.

Frozen copies of the arithmetic that the SAGE-Bench environment defines
(simple_env.py and collision_detector.py, as the JAX package and its port
reproduce them): the grid at 0.05 m a cell, obstacles the ``wall`` and
``unable area`` instances, inflated by the robot radius (a cell within the
radius of an obstacle cell's centre); a command of (vx, vy, yaw rate) for
``duration`` s moved in 1 cm steps up to 0.20 m, stopped at the first cell
that collides, with four lateral 5 mm marches when the direct one gets no
further than 1 cm; the clearance of a capsule against each Gaussian's 2 sigma
ellipsoid where its opacity is at least 0.5. Imports nothing of the
program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

OBSTACLES = ("wall", "unable area")
OOB_PX = 2
BIG = 1e9


# -- the occupancy grid (NumPy, host) ----------------------------------------

def occupancy(instances: list, scale: float, radius: float):
    """(inflated obstacle mask (H, W) uint8, bounds [min_x, max_x, min_y,
    max_y]) of a semantic map. A cell is an obstacle where its centre lies
    within ``radius`` of an obstacle cell's centre (the float32 distance)."""
    xs = [float(x) for inst in instances for _, x in inst["mask_coords_m"]]
    ys = [float(y) for inst in instances for y, _ in inst["mask_coords_m"]]
    min_x, max_x, min_y, max_y = min(xs), max(xs), min(ys), max(ys)
    h = int(np.ceil((max_y - min_y) / scale)) + 1
    w = int(np.ceil((max_x - min_x) / scale)) + 1
    obst = np.zeros((h, w), np.uint8)
    for inst in instances:
        if str(inst.get("category_label", "")).lower() not in OBSTACLES:
            continue
        for y, x in inst["mask_coords_m"]:
            px = int(round((float(x) - min_x) / scale))
            py = int(round((float(y) - min_y) / scale))
            if 0 <= py < h and 0 <= px < w:
                obst[py, px] = 1
    r = int(math.ceil(radius / scale)) + 1
    padded = np.pad(obst, r)
    out = np.zeros_like(obst)
    lim = np.float32(radius)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if np.float32(math.sqrt(dx * dx + dy * dy) * scale) <= lim:
                out |= padded[r + dy:r + dy + h, r + dx:r + dx + w]
    return out, [min_x, max_x, min_y, max_y]


class Grid:
    """The mask and its bounds on a device, for the motion."""

    def __init__(self, mask: np.ndarray, bounds, scale: float, device):
        self.mask = torch.as_tensor(mask, device=device)
        self.bounds = torch.tensor(np.asarray(bounds, np.float32),
                                   device=device)
        self.scale = torch.tensor(np.float32(scale), device=device)

    def blocked(self, xy: torch.Tensor) -> torch.Tensor:
        """Collision at world (..., 2) points: the map frame mirrors the
        world about the bounds' centre, half-to-even rounding to a cell,
        2 cells of tolerance outside the grid."""
        b = self.bounds
        mx = (b[0] + b[1]) + xy[..., 0]
        my = (b[2] + b[3]) + xy[..., 1]
        px = torch.round((mx - b[0]) / self.scale).to(torch.int64)
        py = torch.round((my - b[2]) / self.scale).to(torch.int64)
        h, w = self.mask.shape
        out = ((py < -OOB_PX) | (py >= h + OOB_PX) | (px < -OOB_PX)
               | (px >= w + OOB_PX))
        return out | (self.mask[py.clamp(0, h - 1), px.clamp(0, w - 1)] == 1)


# -- the agent's motion ------------------------------------------------------

def _march(grid, start, dirs, step, n, max_d):
    """Distance moved along each direction (..., D, 2) in ``n`` steps of
    ``step`` up to ``max_d`` (...,), stopping before the first blocked
    point, and whether one was blocked."""
    ks = torch.arange(1, n + 1, dtype=start.dtype, device=start.device)
    md = max_d[..., None]
    d = torch.minimum(ks * step, md)
    pts = start[..., None, None, :] + dirs[..., :, None, :] * d[..., None, :, None]
    blocked = grid.blocked(pts) & (d <= md + 1e-9)[..., None, :]
    anyb = blocked.any(-1)
    first = torch.argmax(blocked.to(torch.int32), -1)
    before = torch.gather(d[..., None, :].expand(blocked.shape), -1,
                          (first - 1).clamp(min=0)[..., None])[..., 0]
    moved = torch.where(anyb, torch.where(first > 0, before,
                                          torch.zeros_like(before)),
                        torch.minimum(md, d[..., -1:]))
    return moved, anyb


def move(grid: Grid, pos, yaw, coll, vx, vy, yaw_rate, duration: float,
         dtype=torch.float32):
    """The pose after one command: pos (B, 3), yaw (B,), the collision
    count (B,) int, commands (B,), computed in ``dtype``. Returns (pos,
    yaw, count, collided)."""
    f32 = dict(dtype=dtype, device=pos.device)
    pos, yaw = pos.to(dtype), yaw.to(dtype)
    vx, vy, yaw_rate = (torch.as_tensor(v, **f32) for v in (vx, vy, yaw_rate))
    dur = torch.tensor(duration, **f32)
    c, s = torch.cos(yaw), torch.sin(yaw)
    dx = (vx * c - vy * s) * dur
    dy = (vx * s + vy * c) * dur
    want = torch.sqrt(dx * dx + dy * dy)
    moving = want > 0.001
    safe = torch.where(moving, want, torch.ones_like(want))
    dirn = torch.stack([dx, dy], -1) / safe[..., None]
    max_d = torch.minimum(torch.tensor(0.20, **f32), want)
    start = pos[..., :2]
    dm, dh = _march(grid, start, dirn[..., None, :], 0.01, 20, max_d)
    dm, dh = dm[..., 0], dh[..., 0]
    perp = torch.stack([-dirn[..., 1], dirn[..., 0]], -1)
    dirs = torch.stack([perp, -perp, perp * 0.707 + dirn * 0.707,
                        -perp * 0.707 + dirn * 0.707], -2)
    dirs = dirs / (torch.sqrt(dirs[..., 0:1] ** 2 + dirs[..., 1:2] ** 2)
                   + 1e-12)
    em, _ = _march(grid, start, dirs, 0.005, 10,
                   torch.full(max_d.shape, 0.05, **f32))
    bi = torch.argmax(em, -1, keepdim=True)
    best = torch.gather(em, -1, bi)[..., 0]
    bdir = torch.gather(dirs, -2, bi[..., None].expand(*bi.shape, 2))[..., 0, :]
    direct = dm > 0.01
    explore = ~direct & (best > 0.005)
    moved = torch.where(direct, dm, torch.where(explore, best,
                                                torch.zeros_like(best)))
    mdir = torch.where(direct[..., None], dirn, bdir)
    xy = torch.where(moving[..., None], start + mdir * moved[..., None], start)
    hit = moving & dh
    new_yaw = torch.remainder(yaw + yaw_rate * dur + math.pi,
                              2 * math.pi) - math.pi
    return (torch.cat([xy, pos[..., 2:3]], -1), new_yaw,
            coll + hit.to(coll.dtype), hit)


# -- the depth-seek policy -----------------------------------------------------

def band_means(depth: torch.Tensor):
    """Mean depth of the left, centre and right thirds of the image's
    middle third of rows, each summed in float64."""
    h, w = depth.shape[-2:]
    band = depth[..., h // 3:h // 3 + h // 3, :].double()
    t = w // 3
    return tuple(x.sum((-2, -1)).float() / (x.shape[-1] * x.shape[-2])
                 for x in (band[..., :t], band[..., t:2 * t],
                           band[..., 2 * t:]))


def policy(depth, xy, yaw, goal, speed: float = 0.4, dtype=torch.float32):
    """Turn toward the goal at up to 0.8 rad/s and go at up to ``speed``,
    slowing as the centre band nears; under 1 m ahead, creep at 0.05 m/s
    and turn toward the deeper side. Returns (vx, yaw_rate), computed in
    ``dtype``."""
    left, centre, right = (x.to(dtype) for x in band_means(depth))
    xy, yaw, goal = xy.to(dtype), yaw.to(dtype), goal.to(dtype)
    to_goal = goal - xy
    dyaw = torch.remainder(torch.atan2(to_goal[..., 1], to_goal[..., 0])
                           - yaw + math.pi, 2 * math.pi) - math.pi
    blocked = centre < 1.0
    vx = torch.where(blocked, torch.full_like(centre, 0.05),
                     speed * torch.clamp(centre / 3.0, 0.3, 1.0))
    avoid = torch.where(left > right, torch.full_like(left, 0.8),
                        torch.full_like(left, -0.8))
    return vx, torch.where(blocked, avoid, torch.clamp(dyaw, -0.8, 0.8))


def policy_np(depth: np.ndarray, xy, yaw: float, goal, speed: float = 0.4):
    """``policy`` in NumPy, on the host: one agent's (vx, yaw_rate)."""
    h, w = depth.shape
    band = depth[h // 3:h // 3 + h // 3].astype(np.float64)
    t = w // 3
    left, centre, right = (float(np.float32(x.mean())) for x in
                           (band[:, :t], band[:, t:2 * t], band[:, 2 * t:]))
    dyaw = (math.atan2(goal[1] - xy[1], goal[0] - xy[0]) - yaw + math.pi) \
        % (2 * math.pi) - math.pi
    if centre < 1.0:
        return 0.05, (0.8 if left > right else -0.8)
    return speed * min(max(centre / 3.0, 0.3), 1.0), min(max(dyaw, -0.8), 0.8)


# -- the capsule clearance -----------------------------------------------------

def clearance(fields: dict, p0, p1, radius: float, thresh: float = 0.5,
              sigma_cut: float = 2.0, block: int = 1 << 18,
              dtype=torch.float32) -> torch.Tensor:
    """(B,) least clearance of B capsules against every solid Gaussian:
    the distance from its centre to the capsule's axis, less the capsule's
    radius and the 2 sigma support along that direction."""
    rows = max(1, (1 << 24) // block)      # queries a pass
    if p0.shape[0] > rows:
        return torch.cat([clearance(fields, p0[i:i + rows], p1[i:i + rows],
                                    radius, thresh, sigma_cut, block, dtype)
                          for i in range(0, p0.shape[0], rows)])
    best = torch.full((p0.shape[0],), BIG, dtype=torch.float64,
                      device=p0.device)
    p0, p1 = p0.to(dtype), p1.to(dtype)
    d = p1 - p0
    dd = (d * d).sum(-1)
    inv = (1.0 / torch.where(dd > 1e-12, dd, torch.ones_like(dd)))[:, None]
    n = fields["means"].shape[0]
    for s in range(0, n, block):
        mu = fields["means"][s:s + block].to(dtype)
        q = fields["quats"][s:s + block].to(dtype)
        ls = fields["log_scales"][s:s + block].to(dtype)
        solid = torch.sigmoid(fields["opacity_logits"][s:s + block]
                              .to(dtype)) >= thresh
        r = mu[None] - p0[:, None]                              # (B, C, 3)
        t = torch.clamp((r * d[:, None]).sum(-1) * inv, 0.0, 1.0)
        f = r - t[..., None] * d[:, None]
        dist = torch.sqrt((f * f).sum(-1) + 1e-20)
        qn = q / torch.sqrt((q * q).sum(-1, keepdim=True))
        w, x, y, z = qn.unbind(-1)
        R = torch.stack([
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], -1)], 1)    # (C, 3, 3)
        loc = torch.einsum("cji,bcj->bci", R, f) * torch.exp(-ls)[None]
        maha = torch.sqrt((loc * loc).sum(-1) + 1e-20)
        clear = dist - sigma_cut * dist / torch.clamp(maha, min=1e-6) - radius
        clear = torch.where(solid[None], clear, torch.full_like(clear, BIG))
        best = torch.minimum(best, clear.amin(1).double())
    return best
