"""Action ground-truth generation: trajectory points -> discrete VLN actions.

Re-implementation of the reference generator (generate_actions.py:36-852) with
the same presets and algorithm:

  * presets vlnce (0.25 m/15 deg), navila_small (0.35 m/30 deg), navila_large
    (0.75 m/15 deg), custom_small (0.50 m/30 deg) (:36-85);
  * yaw decoded from the remapped world quaternion: yaw = 2*atan2(-qx, qw)
    (:117-133 — see utils/transforms.yaw_from_world_quat for the chain);
  * feature-aware sampling: dense on turning segments (interval 1), sparse on
    straight (interval 5), turn detected at |d yaw| > 0.1 rad (:135-243);
  * action synthesis: >=15 deg angle change emits <=4 TURN actions; distance
    accumulates into <=5 MOVE_FORWARD per segment at the preset step; trailing
    half-step becomes one extra MOVE; STOP appended (:245-310);
  * SLERP interpolation forces a 1:1 action<->point correspondence (:312-453);
  * batch output: per-scene action_groundtruth.json + summary, process pool
    across scenes (:710-767).
"""

from __future__ import annotations

import copy
import json
import math
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_PRESET = "vlnce"

_PRESETS = {
    "vlnce": {"move_distance_per_action": 0.25, "turn_angle_per_action": 15,
              "max_actions_per_trajectory": 50},
    "navila_small": {"move_distance_per_action": 0.35,
                     "turn_angle_per_action": 30,
                     "max_actions_per_trajectory": 50},
    "navila_large": {"move_distance_per_action": 0.75,
                     "turn_angle_per_action": 15,
                     "max_actions_per_trajectory": 30},
    "custom_small": {"move_distance_per_action": 0.50,
                     "turn_angle_per_action": 30,
                     "max_actions_per_trajectory": 60},
}

_BASE = {
    "use_smart_sampling": True,
    "straight_sample_interval": 5,
    "turn_sample_interval": 1,
    "turn_detection_threshold": 0.1,
    "min_distance_threshold": 0.05,
    "smooth_window": 2,
}


def get_preset_config(preset: str = DEFAULT_PRESET) -> Dict[str, Any]:
    if preset not in _PRESETS:
        raise ValueError(f"Unknown preset: {preset}. "
                         f"Available: {list(_PRESETS)}")
    cfg = dict(_BASE)
    cfg.update(_PRESETS[preset])
    return cfg


def yaw_from_quaternion(q: List[float]) -> float:
    """World-frame heading from the remapped quaternion (generate_actions.py:
    117-133): qx = -sin(yaw/2), qw = cos(yaw/2)."""
    qx, _, _, qw = q
    return 2.0 * math.atan2(-qx, qw)


def normalize_angle(a: float) -> float:
    while a > math.pi:
        a -= 2 * math.pi
    while a < -math.pi:
        a += 2 * math.pi
    return a


def slerp(q1: List[float], q2: List[float], t: float) -> List[float]:
    def norm(q):
        n = math.sqrt(sum(x * x for x in q))
        return [x / n for x in q] if n > 0 else q
    q1, q2 = norm(q1), norm(q2)
    dot = sum(a * b for a, b in zip(q1, q2))
    if dot < 0:
        q2 = [-x for x in q2]
        dot = -dot
    if dot > 0.9995:
        return norm([a + t * (b - a) for a, b in zip(q1, q2)])
    theta0 = math.acos(abs(dot))
    s_t0 = math.sin(theta0)
    theta = theta0 * t
    s0 = math.cos(theta) - dot * math.sin(theta) / s_t0
    s1 = math.sin(theta) / s_t0
    return [s0 * a + s1 * b for a, b in zip(q1, q2)]


class ActionGenerator:
    """Trajectory-to-action conversion with feature-aware sampling."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = config or get_preset_config()

    # -- sampling -----------------------------------------------------------
    def detect_features(self, points: List[Dict]) -> List[Dict]:
        if len(points) < 3:
            return [dict(p) for p in points]
        out = []
        for i, p in enumerate(points):
            p = dict(p)
            if i == 0:
                p["feature"] = "start"
            elif i == len(points) - 1:
                p["feature"] = "end"
            else:
                prev_yaw = yaw_from_quaternion(points[i - 1]["rotation"])
                next_yaw = yaw_from_quaternion(points[i + 1]["rotation"])
                change = abs(normalize_angle(next_yaw - prev_yaw))
                p["feature"] = ("turning" if change >
                                self.config["turn_detection_threshold"]
                                else "straight")
            out.append(p)
        return out

    def smart_sample(self, points: List[Dict]) -> List[Dict]:
        if not self.config["use_smart_sampling"] or len(points) < 3:
            return [dict(p) for p in points]
        featured = self.detect_features(points)
        sampled = [featured[0]]
        for i in range(1, len(featured) - 1):
            feature = featured[i]["feature"]
            interval = {"turning": self.config["turn_sample_interval"],
                        "straight": self.config["straight_sample_interval"]} \
                .get(feature, 2)
            if i % interval == 0:
                sampled.append(featured[i])
        sampled.append(featured[-1])
        return sampled

    # -- action synthesis ---------------------------------------------------
    def _segment_action_counts(self, p1: Dict, p2: Dict) -> Tuple[int, int, float]:
        pos1, pos2 = p1["position"], p2["position"]
        dist = math.dist(pos1, pos2)
        change = normalize_angle(yaw_from_quaternion(p2["rotation"])
                                 - yaw_from_quaternion(p1["rotation"]))
        num_turns = 0
        if abs(change) > math.radians(15):
            per_turn = math.radians(self.config["turn_angle_per_action"])
            num_turns = min(max(1, int(abs(change) / per_turn)), 4)
        num_moves = min(int(dist / self.config["move_distance_per_action"]), 5)
        return num_turns, num_moves, change

    def actions_from_sampled(self, sampled: List[Dict]) -> List[str]:
        actions: List[str] = []
        accumulated = 0.0
        move_step = self.config["move_distance_per_action"]
        for i in range(len(sampled) - 1):
            p1, p2 = sampled[i], sampled[i + 1]
            dist = math.dist(p1["position"], p2["position"])
            change = normalize_angle(yaw_from_quaternion(p2["rotation"])
                                     - yaw_from_quaternion(p1["rotation"]))
            if abs(change) > math.radians(15):
                per_turn = math.radians(self.config["turn_angle_per_action"])
                n = min(max(1, int(abs(change) / per_turn)), 4)
                actions.extend(["TURN_LEFT" if change > 0 else "TURN_RIGHT"] * n)
            accumulated += dist
            moves = min(int(accumulated / move_step), 5)
            actions.extend(["MOVE_FORWARD"] * moves)
            accumulated -= moves * move_step
            if len(actions) >= min(50, self.config["max_actions_per_trajectory"] * 2):
                break
        if accumulated > move_step * 0.5:
            actions.append("MOVE_FORWARD")
        actions.append("STOP")
        return actions

    def interpolate_points(self, sampled: List[Dict],
                           actions: List[str]) -> List[Dict]:
        """SLERP-interpolate so len(points) == len(actions) (:312-453)."""
        if len(actions) == len(sampled):
            return sampled
        out: List[Dict] = []
        action_idx = 0
        for i in range(len(sampled) - 1):
            cur, nxt = sampled[i], sampled[i + 1]
            out.append(copy.deepcopy(cur))
            action_idx += 1
            num_turns, num_moves, _ = self._segment_action_counts(cur, nxt)
            total = num_turns + num_moves
            if total > 1:
                for j in range(1, total):
                    ratio = j / total
                    p = copy.deepcopy(cur)
                    p["position"] = [a + (b - a) * ratio for a, b in
                                     zip(cur["position"], nxt["position"])]
                    p["rotation"] = slerp(cur["rotation"], nxt["rotation"],
                                          ratio)
                    if "point" in cur:
                        p["point"] = f"{cur['point']}_interp_{j}"
                    out.append(p)
                    action_idx += 1
            if action_idx >= len(actions) - 1:
                break
        out.append(copy.deepcopy(sampled[-1]))
        while len(out) < len(actions):
            out.append(copy.deepcopy(out[-1]))
        while len(out) > len(actions):
            out.pop(-2)
        return out[: len(actions)]

    def generate(self, points: List[Dict]) -> Tuple[List[str], List[Dict]]:
        """Full conversion: returns (actions, matched points), 1:1."""
        sampled = self.smart_sample(points)
        actions = self.actions_from_sampled(sampled)
        matched = self.interpolate_points(sampled, actions)
        assert len(matched) == len(actions), (len(matched), len(actions))
        return actions, matched


# ---------------------------------------------------------------------------
# Batch processing (per-scene action_groundtruth.json)
# ---------------------------------------------------------------------------

def process_trajectory_file(overall_json_path, output_dir,
                            config: Optional[Dict] = None,
                            overwrite: bool = False) -> Optional[Path]:
    overall_json_path = Path(overall_json_path)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    out = output_dir / "action_groundtruth.json"
    if out.exists() and not overwrite:
        return out

    gen = ActionGenerator(config)
    with open(overall_json_path) as f:
        data = json.load(f)
    results = []
    for scene in data.get("scenes", []):
        for sample in scene.get("samples", []):
            points = sample.get("points", [])
            if len(points) < 2:
                continue
            actions, matched = gen.generate(points)
            results.append({
                "trajectory_id": str(sample.get("trajectory_id", "0")),
                "actions": actions,
                "action_count": len(actions),
                "sampled_points": matched,
            })
    payload = {"config": gen.config, "trajectories": results,
               "total_trajectories": len(results),
               "total_actions": sum(r["action_count"] for r in results)}
    with open(out, "w") as f:
        json.dump(payload, f, indent=2)
    return out


def process_all(traj_root, output_root, preset: str = DEFAULT_PRESET,
                overwrite: bool = False, workers: Optional[int] = None,
                prefix: str = "gvln") -> List[Path]:
    """Process-pool batch over scenes (generate_actions.py:710-767)."""
    import os
    traj_root = Path(traj_root)
    output_root = Path(output_root)
    config = get_preset_config(preset)
    jobs = []
    for scene_dir in sorted(p for p in traj_root.iterdir() if p.is_dir()):
        overall = scene_dir / \
            f"trajectories_overall_{prefix}_{scene_dir.name}.json"
        if overall.exists():
            jobs.append((overall, output_root / scene_dir.name))
    workers = workers or min(os.cpu_count() or 1, 8)
    outputs: List[Optional[Path]] = []
    if workers <= 1 or len(jobs) <= 1:
        for overall, out_dir in jobs:
            outputs.append(process_trajectory_file(overall, out_dir, config,
                                                   overwrite))
    else:
        with ProcessPoolExecutor(max_workers=workers) as pool:
            futs = [pool.submit(process_trajectory_file, o, d, config, overwrite)
                    for o, d in jobs]
            outputs = [f.result() for f in futs]
    return [o for o in outputs if o is not None]
