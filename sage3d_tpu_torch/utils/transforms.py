"""Coordinate transforms between the 2D semantic-map frame and the 3D world frame.

This module centralizes the flip/negate/quaternion-remap chain that the reference
spreads across several files (see SAGE-3D reference: trajectory_2d_to_3d.py:33-63
``flip_position``, :66-91 quaternion helpers, :124-171 in-place point transform;
collision_detector.py:146-189 ``forward_position_mapping``;
object_based_success.py:15-59 ``reverse_position_mapping``). Getting this chain
exactly right is required for benchmark-metric parity, so every function here is
covered by golden round-trip tests.

Conventions
-----------
* "map" frame: the 2D semantic-map world coordinates (meters), y-down image grid at
  ``scale`` m/px with origin at (min_x, min_y).
* "world" frame: the 3D simulation world (z-up). The map->world chain is
  (1) mirror about the map bounds (flip_x / flip_y), then (2) negate x and y.
* Quaternions are (x, y, z, w) in trajectory JSON (reference order) unless noted.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

__all__ = [
    "flip_position",
    "map_to_world_xy",
    "world_to_map_xy",
    "yaw_from_quaternion_xyzw",
    "quaternion_from_yaw_xyzw",
    "world_quat_from_map_yaw",
    "yaw_from_world_quat",
    "world_to_pixel",
    "pixel_to_world",
]


def flip_position(
    px: float,
    py: float,
    min_x: float,
    max_x: float,
    min_y: float,
    max_y: float,
    flip_x: bool = True,
    flip_y: bool = True,
    negate: bool = False,
):
    """Mirror a point about the map bounds, optionally negating afterwards.

    Matches reference trajectory_2d_to_3d.py:33-63. Works on scalars or arrays.
    """
    if flip_x:
        px = (min_x + max_x) - px
    if flip_y:
        py = (min_y + max_y) - py
    if negate:
        px = -px
        py = -py
    return px, py


def map_to_world_xy(px, py, bounds, flip_x=True, flip_y=True, negate_xy=True):
    """Map-frame (x, y) -> world-frame (x, y).

    ``bounds`` is (min_x, max_x, min_y, max_y). This is the transform applied to
    generated trajectories before they are executed in the 3D world
    (reference trajectory_2d_to_3d.py:124-171).
    """
    min_x, max_x, min_y, max_y = bounds
    return flip_position(px, py, min_x, max_x, min_y, max_y, flip_x, flip_y, negate_xy)


def world_to_map_xy(wx, wy, bounds, flip_x=True, flip_y=True, negate_xy=True):
    """World-frame (x, y) -> map-frame (x, y): exact inverse of map_to_world_xy.

    Matches reference collision_detector.py:146-189 ``forward_position_mapping``
    (negate first, then mirror again — mirroring is an involution).
    """
    min_x, max_x, min_y, max_y = bounds
    px, py = wx, wy
    if negate_xy:
        px = -px
        py = -py
    if flip_x:
        px = (min_x + max_x) - px
    if flip_y:
        py = (min_y + max_y) - py
    return px, py


def yaw_from_quaternion_xyzw(qx: float, qy: float, qz: float, qw: float) -> float:
    """Yaw (rotation about +Z) from an (x, y, z, w) quaternion.

    Matches reference trajectory_2d_to_3d.py:66-77.
    """
    siny_cosp = 2.0 * (qw * qz + qx * qy)
    cosy_cosp = 1.0 - 2.0 * (qy * qy + qz * qz)
    return math.atan2(siny_cosp, cosy_cosp)


def quaternion_from_yaw_xyzw(yaw: float) -> Tuple[float, float, float, float]:
    """(x, y, z, w) quaternion for a pure yaw rotation about +Z.

    Matches reference trajectory_2d_to_3d.py:80-91.
    """
    return 0.0, 0.0, math.sin(yaw / 2.0), math.cos(yaw / 2.0)


def world_quat_from_map_yaw(map_yaw: float) -> Tuple[float, float, float, float]:
    """Map-frame yaw -> the remapped world quaternion stored in _trans trajectories.

    The reference adds pi to the yaw, builds a z-quaternion, then moves qz into the
    (negated) x slot (trajectory_2d_to_3d.py:155-171). The resulting quaternion is
    NOT a rotation about z; the environment decodes it back with
    ``yaw_from_world_quat`` below (reference simple_env.py:1164-1182).
    """
    yaw_new = map_yaw + math.pi
    if yaw_new > math.pi:
        yaw_new -= 2.0 * math.pi
    _, _, qz_tmp, qw_tmp = quaternion_from_yaw_xyzw(yaw_new)
    return (-qz_tmp, 0.0, 0.0, qw_tmp)


def yaw_from_world_quat(qx: float, qy: float, qz: float, qw: float) -> float:
    """Decode the agent heading from a remapped world quaternion.

    Inverse of ``world_quat_from_map_yaw``: the stored quaternion has the yaw
    half-angle sine in (negated) qx, so yaw = 2*atan2(-qx, qw). The environment
    then subtracts pi to undo the +pi applied at generation time (reference
    simple_env.py:1164-1182; generate_actions.py:117-133 uses the same decode).
    Returns the map-frame yaw, wrapped to (-pi, pi].
    """
    yaw = 2.0 * math.atan2(-qx, qw) - math.pi
    while yaw <= -math.pi:
        yaw += 2.0 * math.pi
    while yaw > math.pi:
        yaw -= 2.0 * math.pi
    return yaw


def world_to_pixel(x, y, min_x: float, min_y: float, scale: float = 0.05):
    """Map-frame meters -> integer pixel (row py, col px).

    Matches reference collision_detector.py:134-138 (round-to-nearest).
    """
    px = np.rint((np.asarray(x, dtype=np.float64) - min_x) / scale).astype(np.int64)
    py = np.rint((np.asarray(y, dtype=np.float64) - min_y) / scale).astype(np.int64)
    return py, px


def pixel_to_world(px, py, min_x: float, min_y: float, scale: float = 0.05):
    """Pixel (col px, row py) -> map-frame meters at the pixel center.

    Matches reference collision_detector.py:140-144.
    """
    x = min_x + (np.asarray(px, dtype=np.float64) + 0.5) * scale
    y = min_y + (np.asarray(py, dtype=np.float64) + 0.5) * scale
    return x, y
