"""SAGE-Bench episode runner: closed-loop evaluation harness.

Re-architecture of the reference driver (run_benchmark.py:572-2387) around the
port's environment (``env/vln_env.py``): same episode lifecycle (adapt -> task -> set pose -> warm-up
capture -> step loop querying the policy -> metrics -> per-episode measurement
JSON), same resilience behavior (smart fallback on policy failure, per-episode
isolation), same checkpoint/resume contract (skip episodes whose
measurements/{ep}.json exists and parses, run_benchmark.py:369-405), and the
no-goal STOP-override exploration semantics (:1594-1622).

The policy is any callable (images, instruction, yaw, depth) -> action dict —
usually serve.client.query_vlm against a socket/HTTP server (wire-compatible
with the reference's NaVILA/NaVid/MLLM servers), or an in-process function.
"""

from __future__ import annotations

import json
import random
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .measures import default_measures, nogoal_measures
from .tasks import TaskTypeManager, adapt_episode_for_task


def check_episode_completed(output_dir: Path, scene_name: str,
                            episode_id: str) -> bool:
    """Resume check: measurement file exists with the required fields
    (run_benchmark.py:369-405)."""
    return load_completed_measurements(output_dir, scene_name,
                                       episode_id) is not None


def load_completed_measurements(output_dir: Path, scene_name: str,
                                episode_id: str):
    """The measurements dict of a completed episode, or None if absent/
    invalid — the resume path's data source (aggregates must cover resumed
    episodes, not just freshly-run ones)."""
    path = Path(output_dir) / scene_name / episode_id / "measurements" / \
        f"{episode_id}.json"
    if not path.exists():
        return None
    try:
        with open(path) as f:
            data = json.load(f)
        if "measurements" in data and "episode_info" in data:
            return data["measurements"]
    except (json.JSONDecodeError, OSError):
        pass
    return None


class ProgressTracker:
    """Lightweight progress/ETA display (run_benchmark.py:97-276)."""

    def __init__(self, total: int, quiet: bool = False):
        self.total = total
        self.done = 0
        self.successes = 0
        self.start = time.time()
        self.quiet = quiet

    def update(self, success: bool) -> None:
        self.done += 1
        self.successes += int(success)
        if not self.quiet:
            elapsed = time.time() - self.start
            eta = elapsed / self.done * (self.total - self.done)
            sr = self.successes / self.done
            print(f"[PROGRESS] {self.done}/{self.total} "
                  f"SR={sr:.3f} elapsed={elapsed:.0f}s eta={eta:.0f}s")


def smart_fallback_action(last_resp: Optional[Dict]) -> Dict[str, Any]:
    """Policy-failure fallback: half-speed replay of the last response, else a
    gentle forward nudge — never aborts the episode (run_benchmark.py:1575-1591)."""
    if last_resp and not last_resp.get("stop", False):
        return {"vx": last_resp.get("vx", 0.0) * 0.5,
                "vy": last_resp.get("vy", 0.0) * 0.5,
                "yaw_rate": last_resp.get("yaw_rate", 0.0) * 0.5,
                "duration_s": last_resp.get("duration_s", 1.0),
                "stop": False, "parsed_from": "fallback_replay"}
    return {"vx": 0.1, "vy": 0.0, "yaw_rate": 0.0, "duration_s": 1.0,
            "stop": False, "parsed_from": "fallback_forward"}


def nogoal_explore_action(step: int) -> Dict[str, Any]:
    """STOP override for no-goal episodes: seeded random exploration command
    (run_benchmark.py:1600-1622)."""
    rng = random.Random(step)
    kind = rng.choice(["forward", "turn_left", "turn_right"])
    if kind == "forward":
        return {"vx": 0.2, "vy": 0.0, "yaw_rate": 0.0, "duration_s": 1.0,
                "stop": False}
    if kind == "turn_left":
        return {"vx": 0.1, "vy": 0.0, "yaw_rate": 0.5, "duration_s": 1.0,
                "stop": False}
    return {"vx": 0.1, "vy": 0.0, "yaw_rate": -0.5, "duration_s": 1.0,
            "stop": False}


def run_episode(
    env,
    episode: Dict[str, Any],
    policy: Callable[..., Dict[str, Any]],
    max_steps: int = 200,
    output_dir: Optional[str] = None,
    task_type: Optional[str] = None,
    use_depth: bool = False,
    record_video: bool = False,
    verbose: bool = False,
    map_file: Optional[str] = None,
    visualize: bool = True,
) -> Dict[str, Any]:
    """Run one closed-loop episode. Returns the measurement record.

    With ``output_dir`` set, also writes the reference's per-episode
    artifacts: measurements JSON, ``episode.log`` (run_benchmark.py:
    1075-1128) and — when ``map_file``/``visualize`` allow — the trajectory
    PNG (:1780-1795, :781-994).
    """
    # Loud contract check: the measures below read env members directly
    # (env/protocol.py VLNEnvProtocol) — fail here, not as a silent zero.
    from ..env.protocol import assert_conforms
    assert_conforms(env)
    # Imported here, outside the policy's try below: a missing Pillow must
    # fail the episode, not turn every step into a fallback action.
    from PIL import Image
    if task_type is None:
        task_type = TaskTypeManager.infer_task_type(episode)
    adapted = adapt_episode_for_task(episode, task_type)
    task = TaskTypeManager.create_task(task_type, {"goal_radius":
                                                   episode.get("goals", [{}])[0].get("radius", 0.5)
                                                   if episode.get("goals") else 0.5})

    env.set_start_pose(episode["start_position"], episode["start_rotation"])
    env.reset_episode_time()
    if record_video:
        env.start_video_recording()

    mm = nogoal_measures(episode) if task_type == "nogoalnav" \
        else default_measures(episode)
    mm.reset(env)

    instruction = task.get_instruction(adapted)
    trajectory_positions: List[np.ndarray] = [env.get_agent_pos()]
    last_resp: Optional[Dict] = None
    is_stop_called = False
    steps_run = 0
    stop_override_count = 0
    step_latencies: List[float] = []

    for step in range(max_steps):
        env.update_time_and_reset_collision()

        # no-goal termination check (timeout / collision)
        if task_type == "nogoalnav":
            if task.should_terminate_episode(
                    collision_detected=env.collision_detected,
                    episode_time=env.episode_time_s):
                break

        if use_depth:
            rgb, depth = env.get_rgbd()
            depth_images = [depth]
        else:
            rgb = env.get_rgb()
            depth_images = None
        mm.update(env)

        t0 = time.time()
        try:
            resp = policy(images=[Image.fromarray(rgb)], instruction=instruction,
                          current_yaw=env.get_yaw(), depth_images=depth_images)
            if resp.get("parsed_from") == "error":
                resp = smart_fallback_action(last_resp)
        except Exception:
            resp = smart_fallback_action(last_resp)
        step_latencies.append(time.time() - t0)

        if resp.get("stop", False):
            if task_type == "nogoalnav":
                stop_override_count += 1
                resp = nogoal_explore_action(steps_run)
            else:
                is_stop_called = True

        if not is_stop_called:
            env.apply_cmd_for(resp.get("vx", 0.0), resp.get("vy", 0.0),
                              resp.get("yaw_rate", 0.0),
                              resp.get("duration_s", 1.0))
            mm.update(env)
            last_resp = resp

        steps_run += 1
        trajectory_positions.append(env.get_agent_pos())

        if task_type == "nogoalnav":
            coverage = mm.measures.get("exploration_coverage")
            if task.is_success(
                    env.get_agent_pos(), adapted,
                    collision_detected=env.collision_detected,
                    episode_time=env.episode_time_s,
                    exploration_coverage=coverage.get() if coverage else 0.0):
                is_stop_called = True
        else:
            goal_radius = (episode["goals"][0].get("radius", 0.5)
                           if episode.get("goals") else 0.5)
            if mm.measures["distance_to_goal"].get() < goal_radius:
                is_stop_called = True

        if is_stop_called:
            break

    record = {
        "episode_info": {
            "episode_id": episode.get("episode_id", "0"),
            "scene_name": episode.get("scene_name", "scene"),
            "trajectory_id": episode.get("trajectory_id", "0"),
            "instruction": instruction,
            "instruction_type": episode.get("instruction_type", ""),
            "task_type": task_type,
            "steps_run": steps_run,
            "stop_called": bool(is_stop_called),
            "stop_override_count": stop_override_count,
            "mean_policy_latency_s": float(np.mean(step_latencies))
            if step_latencies else 0.0,
        },
        "measurements": mm.dump(),
        "trajectory": [list(map(float, p)) for p in trajectory_positions],
    }

    if output_dir is not None:
        ep_dir = Path(output_dir) / record["episode_info"]["scene_name"] / \
            record["episode_info"]["episode_id"]
        mdir = ep_dir / "measurements"
        mdir.mkdir(parents=True, exist_ok=True)
        with open(mdir / f"{record['episode_info']['episode_id']}.json", "w") as f:
            json.dump(record, f, indent=2)
        if record_video:
            env.write_video(str(ep_dir / "episode.mp4"))
        # per-episode episode.log (run_benchmark.py:1075-1128)
        from ..utils.logging import EpisodeLogger
        with EpisodeLogger(str(ep_dir / "episode.log"), quiet=True) as elog:
            info = record["episode_info"]
            elog.log(f"[EPISODE] id={info['episode_id']} "
                     f"scene={info['scene_name']} task={info['task_type']}")
            elog.log(f"[EPISODE] instruction: {info['instruction']}")
            elog.log(f"[EPISODE] steps={info['steps_run']} "
                     f"stop_called={info['stop_called']} "
                     f"mean_policy_latency_s="
                     f"{info['mean_policy_latency_s']:.3f}")
            for k, v in record["measurements"].items():
                elog.log(f"[MEASURE] {k}={v}")
        # per-episode trajectory PNG (run_benchmark.py:1780-1795, :781-994)
        map_path = map_file or getattr(env, "semantic_map_path", None)
        if visualize and map_path:
            try:
                from .visualize import visualize_trajectory
                with open(map_path) as f:
                    map_data = json.load(f)
                goal = (episode["goals"][0].get("position")
                        if episode.get("goals") else None)
                visualize_trajectory(
                    trajectory_positions, map_data,
                    ep_dir / f"trajectory_{record['episode_info']['episode_id']}.png",
                    gt_locations=episode.get("gt_locations"),
                    goal_world=goal,
                    title=record["episode_info"]["episode_id"],
                    measurements=record["measurements"])
            except Exception as e:  # visualization must never kill an episode
                if verbose:
                    print(f"[WARN] trajectory visualization failed: {e}")
    if verbose:
        print(f"[EPISODE] {record['episode_info']['episode_id']}: "
              f"{record['measurements']}")
    return record


def run_benchmark(
    env,
    episodes: List[Dict[str, Any]],
    policy: Callable[..., Dict[str, Any]],
    output_dir: Optional[str] = None,
    max_steps: int = 200,
    skip_completed: bool = True,
    max_episodes: Optional[int] = None,
    quiet: bool = True,
    summary_filename: str = "batch_test_summary.json",
    **episode_kw,
) -> Dict[str, Any]:
    """Run a batch of episodes with resume + per-episode failure isolation
    (run_benchmark.py:2137-2351). Returns an aggregate summary.

    Resumed (skipped) episodes load their existing measurement JSON so the
    aggregate metrics and success counts cover the WHOLE batch, not just the
    episodes run in this invocation."""
    if max_episodes is not None:
        episodes = episodes[:max_episodes]
    tracker = ProgressTracker(len(episodes), quiet=quiet)
    records, failures, skipped = [], [], 0

    for ep in episodes:
        if skip_completed and output_dir is not None:
            prior = load_completed_measurements(
                Path(output_dir), ep.get("scene_name", "scene"),
                ep.get("episode_id", "0"))
            if prior is not None:
                skipped += 1
                records.append({"measurements": prior, "resumed": True})
                continue
        try:
            rec = run_episode(env, ep, policy, max_steps=max_steps,
                              output_dir=output_dir, **episode_kw)
            records.append(rec)
            tracker.update(rec["measurements"].get("success", 0.0) >= 1.0)
        except Exception as e:  # episode isolation (run_benchmark.py:692-703)
            failures.append({"episode_id": ep.get("episode_id", "?"),
                             "error": str(e)})
            tracker.update(False)

    n_success = sum(1 for r in records
                    if r["measurements"].get("success", 0.0) >= 1.0)
    summary: Dict[str, Any] = {
        "num_episodes": len(records) - skipped,
        "num_failures": len(failures),
        "num_skipped": skipped,
        "num_success": n_success,      # exact, includes resumed episodes
        "failures": failures,
    }
    if records:
        # union of keys: resumed records may predate newly added measures
        keys = sorted({k for r in records for k in r["measurements"]})
        summary["metrics"] = {
            k: float(np.mean([r["measurements"][k] for r in records
                              if k in r["measurements"]]))
            for k in keys}
    if output_dir is not None:
        Path(output_dir).mkdir(parents=True, exist_ok=True)
        with open(Path(output_dir) / summary_filename, "w") as f:
            json.dump(summary, f, indent=2)
    return summary
