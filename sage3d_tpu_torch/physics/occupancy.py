"""2D occupancy-grid collision queries: the primary physics query of SAGE-Bench.

PyTorch counterpart of ``sage3d_tpu/physics/occupancy.py``, a re-design of the
reference's SemanticMap2DCollisionDetector (collision_detector.py:26-288).
Grid construction (instance rasterization + EDT inflation) is one-time host
preprocessing with NumPy and SciPy, the same arrays as the JAX package's; the
query path is a gather on the grid's device, called in bulk by the agent step
(physics/agent.py) instead of once per 1 cm micro-step.

Parity notes (each pinned by tests):
  * obstacle categories: only 'wall' and 'unable area' (collision_detector.py:107)
  * inflation: euclidean distance transform <= robot_radius (:119-127)
  * world->map: negate then mirror about bounds (:146-189)
  * pixel mapping: round half to even, origin at (min_x, min_y), 0.05 m/px
    (:134-138)
  * out-of-bounds: 2-px tolerance clamps, beyond that counts as collision (:213-225)

Builders take ``device=None``, which means the card; queries run where the
grid's tensors are.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..renderer.scene import resolve_device

DEFAULT_SCALE = 0.05
RUNTIME_ROBOT_RADIUS = 0.08   # simple_env.py:136-141
PLANNING_ROBOT_RADIUS = 0.2   # vln_trajectory_generator.py:64-65
OOB_MARGIN_PX = 2

OBSTACLE_CATEGORIES = ("wall", "unable area")


class OccupancyGrid(NamedTuple):
    """Static scene collision data, on one device."""

    obstacle: torch.Tensor   # (H, W) uint8 inflated obstacle mask
    dist_m: torch.Tensor     # (H, W) float32 distance-to-obstacle (meters)
    bounds: torch.Tensor     # (4,) float32: min_x, max_x, min_y, max_y
    scale: torch.Tensor      # () float32 meters/pixel

    @property
    def height(self) -> int:
        return self.obstacle.shape[0]

    @property
    def width(self) -> int:
        return self.obstacle.shape[1]

    @property
    def device(self) -> torch.device:
        return self.obstacle.device


def _edt(mask_free: np.ndarray, sampling: float) -> np.ndarray:
    from scipy.ndimage import distance_transform_edt
    return distance_transform_edt(mask_free, sampling=sampling).astype(np.float32)


def _grid(obstacle: np.ndarray, bounds, scale: float, robot_radius_m: float,
          device) -> OccupancyGrid:
    dev = resolve_device(device)
    dist_m = _edt(obstacle == 0, sampling=scale)
    inflated = ((dist_m <= robot_radius_m).astype(np.uint8)
                if robot_radius_m > 0 else obstacle)
    return OccupancyGrid(
        obstacle=torch.from_numpy(np.ascontiguousarray(inflated)).to(dev),
        dist_m=torch.from_numpy(dist_m).to(dev),
        bounds=torch.tensor(np.asarray(bounds, np.float32), device=dev),
        scale=torch.tensor(np.float32(scale), device=dev),
    )


def grid_from_semantic_map(
    map_json,
    robot_radius_m: float = RUNTIME_ROBOT_RADIUS,
    scale: float = DEFAULT_SCALE,
    device=None,
) -> OccupancyGrid:
    """Build the inflated occupancy grid from a 2D semantic-map JSON.

    Accepts a path or the loaded list of instance dicts (the schema produced by
    the semantic-map builder, matching the reference semantic_map_builder
    output).
    """
    if isinstance(map_json, (str, Path)):
        with open(map_json) as f:
            instances = json.load(f)
    else:
        instances = map_json

    all_x, all_y = [], []
    for inst in instances:
        for y, x in inst.get("mask_coords_m", []):
            all_y.append(float(y))
            all_x.append(float(x))
    if not all_x:
        raise ValueError("semantic map contains no coordinates")
    min_x, max_x = min(all_x), max(all_x)
    min_y, max_y = min(all_y), max(all_y)

    h = int(np.ceil((max_y - min_y) / scale)) + 1
    w = int(np.ceil((max_x - min_x) / scale)) + 1

    obstacle = np.zeros((h, w), np.uint8)
    for inst in instances:
        if str(inst.get("category_label", "")).lower() in OBSTACLE_CATEGORIES:
            for y, x in inst.get("mask_coords_m", []):
                px = int(round((float(x) - min_x) / scale))
                py = int(round((float(y) - min_y) / scale))
                if 0 <= py < h and 0 <= px < w:
                    obstacle[py, px] = 1
    return _grid(obstacle, [min_x, max_x, min_y, max_y], scale,
                 robot_radius_m, device)


def grid_from_mask(obstacle: np.ndarray, bounds, scale: float = DEFAULT_SCALE,
                   robot_radius_m: float = RUNTIME_ROBOT_RADIUS,
                   device=None) -> OccupancyGrid:
    """Build a grid directly from a raw obstacle mask (tests, synthetic scenes)."""
    return _grid(np.asarray(obstacle, np.uint8), bounds, scale,
                 robot_radius_m, device)


def _points(grid: OccupancyGrid, pos_xy) -> torch.Tensor:
    return torch.as_tensor(pos_xy, dtype=torch.float32, device=grid.device)


def world_to_map_xy_t(grid: OccupancyGrid, wx, wy):
    """World (x, y) -> map-frame meters (negate, then mirror), on tensors
    (``world_to_map_xy_jnp`` in the JAX package)."""
    b = grid.bounds
    return (b[0] + b[1]) + wx, (b[2] + b[3]) + wy


def check_collision_world(grid: OccupancyGrid, pos_xy) -> torch.Tensor:
    """Collision test for world-frame positions, vectorized over points.

    pos_xy: (..., 2). Returns bool (...,). Reproduces check_collision_3d
    (collision_detector.py:191-237) including the 2-px out-of-bounds tolerance.
    """
    pos_xy = _points(grid, pos_xy)
    mx, my = world_to_map_xy_t(grid, pos_xy[..., 0], pos_xy[..., 1])
    px = torch.round((mx - grid.bounds[0]) / grid.scale).to(torch.int32)
    py = torch.round((my - grid.bounds[2]) / grid.scale).to(torch.int32)
    h, w = grid.obstacle.shape
    severely_out = ((py < -OOB_MARGIN_PX) | (py >= h + OOB_MARGIN_PX)
                    | (px < -OOB_MARGIN_PX) | (px >= w + OOB_MARGIN_PX))
    pyc = torch.clamp(py, 0, h - 1).long()
    pxc = torch.clamp(px, 0, w - 1).long()
    hit = grid.obstacle[pyc, pxc] == 1
    return severely_out | hit


def check_path_collision_world(grid: OccupancyGrid, start_xy, end_xy,
                               num_samples: int = 10) -> torch.Tensor:
    """Swept path test via linear sampling (collision_detector.py:239-261)."""
    start_xy, end_xy = _points(grid, start_xy), _points(grid, end_xy)
    t = (torch.arange(1, num_samples + 1, dtype=torch.float32,
                      device=grid.device) / num_samples)
    pts = start_xy[None, :] * (1.0 - t[:, None]) + end_xy[None, :] * t[:, None]
    return torch.any(check_collision_world(grid, pts))


def clearance_world(grid: OccupancyGrid, pos_xy) -> torch.Tensor:
    """Distance-to-nearest-obstacle (meters) at world positions (bilinear).

    Not in the reference (it only has the boolean test); used by planners
    that want gradients of clearance.
    """
    pos_xy = _points(grid, pos_xy)
    mx, my = world_to_map_xy_t(grid, pos_xy[..., 0], pos_xy[..., 1])
    fx = (mx - grid.bounds[0]) / grid.scale
    fy = (my - grid.bounds[2]) / grid.scale
    h, w = grid.dist_m.shape
    x0 = torch.clamp(torch.floor(fx).to(torch.int32), 0, w - 2)
    y0 = torch.clamp(torch.floor(fy).to(torch.int32), 0, h - 2)
    tx = torch.clamp(fx - x0, 0.0, 1.0)
    ty = torch.clamp(fy - y0, 0.0, 1.0)
    x0, y0 = x0.long(), y0.long()
    d00 = grid.dist_m[y0, x0]
    d01 = grid.dist_m[y0, x0 + 1]
    d10 = grid.dist_m[y0 + 1, x0]
    d11 = grid.dist_m[y0 + 1, x0 + 1]
    return ((1 - ty) * ((1 - tx) * d00 + tx * d01)
            + ty * ((1 - tx) * d10 + tx * d11))
