"""In-process policies: oracle path-follower and socket/HTTP-backed policies.

The oracle follows the episode's ground-truth waypoints using privileged agent
state — the model-free closed-loop policy the reference lacked (its only test
path required a live GPU VLM server). Used for harness tests, metric sanity
(oracle should score SR ~= 1 on clean episodes) and renderer-in-the-loop
benchmarks.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .client import create_vlm_client


class OraclePolicy:
    """Follows gt_locations with simple pursuit control.

    Call signature matches the runner's policy contract:
    (images, instruction, current_yaw, depth_images) -> action dict.
    """

    def __init__(self, env, episode: Dict[str, Any], speed: float = 0.4,
                 waypoint_radius: float = 0.3, goal_radius: float = 0.4):
        self.env = env
        self.waypoints = [np.asarray(p, float) for p in
                          episode.get("gt_locations", [])]
        self.speed = speed
        self.waypoint_radius = waypoint_radius
        self.goal_radius = goal_radius
        self.next_idx = 1 if len(self.waypoints) > 1 else 0

    def __call__(self, images=None, instruction: str = "",
                 current_yaw: float = 0.0, depth_images=None, **kw) -> Dict[str, Any]:
        if not self.waypoints:
            return {"vx": 0.0, "vy": 0.0, "yaw_rate": 0.0, "duration_s": 1.0,
                    "stop": True}
        pos = np.asarray(self.env.get_agent_pos(), float)[:2]
        goal = self.waypoints[-1][:2]
        if np.linalg.norm(goal - pos) < self.goal_radius:
            return {"vx": 0.0, "vy": 0.0, "yaw_rate": 0.0, "duration_s": 1.0,
                    "stop": True}
        # advance past reached waypoints
        while (self.next_idx < len(self.waypoints) - 1
               and np.linalg.norm(self.waypoints[self.next_idx][:2] - pos)
               < self.waypoint_radius):
            self.next_idx += 1
        target = self.waypoints[self.next_idx][:2]
        heading = math.atan2(target[1] - pos[1], target[0] - pos[0])
        dyaw = heading - current_yaw
        while dyaw > math.pi:
            dyaw -= 2 * math.pi
        while dyaw < -math.pi:
            dyaw += 2 * math.pi
        if abs(dyaw) > 0.5:
            return {"vx": 0.0, "vy": 0.0,
                    "yaw_rate": float(np.clip(dyaw, -1.0, 1.0)),
                    "duration_s": 1.0, "stop": False}
        dist = float(np.linalg.norm(target - pos))
        vx = min(self.speed, max(dist, 0.05))
        return {"vx": vx, "vy": 0.0,
                "yaw_rate": float(np.clip(dyaw, -0.5, 0.5)),
                "duration_s": 1.0, "stop": False}


def make_socket_policy(model_type: Optional[str] = None, host: str = "localhost",
                       port: int = 55221, **kw) -> Callable:
    """Policy backed by a wire-protocol server (scripted or a real VLM)."""
    client = create_vlm_client(model_name=model_type or "scripted", host=host,
                               port=port, **kw)

    def policy(images: List, instruction: str, current_yaw: float = 0.0,
               depth_images=None, **kwargs) -> Dict[str, Any]:
        return client.query(images, instruction, current_yaw=current_yaw,
                            depth_images=depth_images)

    return policy


class MLLMActionPolicy:
    """Maps the 4-action MLLM vocabulary to velocity commands.

    Matches the discretization the reference uses when driving MLLM servers:
    MOVE_FORWARD 0.25 m, TURN_LEFT/RIGHT 30 deg over 1 s (navid_server.py:342-376
    velocity mapping; generate_actions.py presets).
    """

    def __init__(self, inner: Callable):
        self.inner = inner

    def __call__(self, images, instruction, current_yaw=0.0, depth_images=None,
                 **kw) -> Dict[str, Any]:
        resp = self.inner(images=images, instruction=instruction,
                          current_yaw=current_yaw, depth_images=depth_images)
        return resp
