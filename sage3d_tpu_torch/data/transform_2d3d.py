"""Trajectory 2D->3D transform: map-frame trajectories into world frame.

Re-implementation of the reference transform (trajectory_2d_to_3d.py:124-270)
on top of the centralized transform chain in utils/transforms.py: mirror about
the map bounds, negate, yaw+pi with the z->-x quaternion remap, identity
rotation on the last point; writes ``*_trans.json`` next to the input with
skip-if-exists resume.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..utils.transforms import (map_to_world_xy, world_quat_from_map_yaw,
                                yaw_from_quaternion_xyzw)


def extract_map_bounds(map_data: List[Dict]) -> Optional[Tuple[float, float, float, float]]:
    """(min_x, max_x, min_y, max_y) from semantic-map mask coords
    (trajectory_2d_to_3d.py:94-121)."""
    xs, ys = [], []
    for inst in map_data:
        for y, x in inst.get("mask_coords_m", []):
            try:
                ys.append(float(y))
                xs.append(float(x))
            except (TypeError, ValueError):
                continue
    if not xs:
        return None
    return min(xs), max(xs), min(ys), max(ys)


def transform_trajectory_points(points: List[Dict], bounds,
                                flip_x: bool = True, flip_y: bool = True,
                                negate_xy: bool = True) -> None:
    """In-place point transform (trajectory_2d_to_3d.py:124-171)."""
    for idx, pt in enumerate(points):
        px, py, pz = pt["position"]
        wx, wy = map_to_world_xy(px, py, bounds, flip_x, flip_y, negate_xy)
        pt["position"] = [wx, wy, pz]
        if idx == len(points) - 1:
            pt["rotation"] = [0.0, 0.0, 0.0, 1.0]
        else:
            yaw = yaw_from_quaternion_xyzw(*pt["rotation"])
            pt["rotation"] = list(world_quat_from_map_yaw(yaw))


def transform_file(traj_path, map_data, force: bool = False) -> Optional[Path]:
    """Transform one trajectories_*.json -> *_trans.json (resume-aware)."""
    traj_path = Path(traj_path)
    out = traj_path.with_name(traj_path.name.replace(".json", "_trans.json"))
    if out.exists() and not force:
        return out
    bounds = extract_map_bounds(map_data)
    if bounds is None:
        return None
    with open(traj_path) as f:
        data = json.load(f)
    for scene in data.get("scenes", []):
        for sample in scene.get("samples", []):
            pts = sample.get("points", [])
            if pts:
                transform_trajectory_points(pts, bounds)
    with open(out, "w") as f:
        json.dump(data, f, indent=2, ensure_ascii=False)
    return out


def process_scene(scene_dir, map_root, force: bool = False) -> int:
    """All non-_trans trajectory files of one scene (trajectory_2d_to_3d.py:
    174-270: map file matched by `_{scene}_` in its name)."""
    scene_dir = Path(scene_dir)
    map_root = Path(map_root)
    scene_id = scene_dir.name
    traj_files = [f for f in scene_dir.iterdir() if f.is_file()
                  and f.name.startswith("trajectories_")
                  and f.name.endswith(".json") and "_trans" not in f.name]
    if not traj_files:
        return 0
    candidates = [f for f in map_root.iterdir() if f.is_file()
                  and f.suffix == ".json" and f"_{scene_id}_" in f.name]
    if not candidates:
        return 0
    with open(candidates[0]) as f:
        map_data = json.load(f)
    count = 0
    for tf in traj_files:
        if transform_file(tf, map_data, force=force) is not None:
            count += 1
    return count
