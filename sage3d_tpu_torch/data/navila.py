"""NaVILA SFT dataset assembly: action GT + rendered frames -> training samples.

Re-implementation of the reference creator (create_navila_dataset.py:26-455):
sliding-window samples (frames[0..t] -> "The next action is ..."), the
navila_small action phrase mapping (0.35 m / 30 deg), shuffled
annotations_part_NNN.json shards (10k samples each) and dataset_info.json.
"""

from __future__ import annotations

import json
import math
import random
from pathlib import Path
from typing import Any, Dict, List

SAMPLES_PER_PART = 10000

ACTION_FORMAT = {
    "MOVE_FORWARD": "move forward 0.35 meter",
    "TURN_LEFT": "turn left 30 degree",
    "TURN_RIGHT": "turn right 30 degree",
    "STOP": "stop",
}


def format_action_output(action: str) -> str:
    return f"The next action is {ACTION_FORMAT.get(action, action.lower())}."


def create_sliding_window_samples(instruction: str, actions: List[str],
                                  frame_files: List[str],
                                  video_id: str) -> List[Dict[str, Any]]:
    """One sample per step: frames[0..t] -> next action
    (create_navila_dataset.py:80-124)."""
    n = min(len(frame_files), len(actions))
    return [{
        "video_id": f"{video_id}-{t}",
        "q": instruction,
        "a": format_action_output(actions[t]),
        "frames": frame_files[: t + 1],
    } for t in range(n)]


def process_scene(actions_path, images_metadata_path, scene_id: str,
                  trajectories_path=None) -> List[Dict[str, Any]]:
    """Join action GT + frame metadata (+ instructions) into samples."""
    with open(actions_path) as f:
        gt = json.load(f)
    with open(images_metadata_path) as f:
        meta = json.load(f)

    instructions: Dict[str, List[str]] = {}
    if trajectories_path is not None and Path(trajectories_path).exists():
        with open(trajectories_path) as f:
            tdata = json.load(f)
        for scene in tdata.get("scenes", []):
            for sample in scene.get("samples", []):
                tid = str(sample.get("trajectory_id", "0"))
                texts = []
                for instr in sample.get("instructions", []):
                    if isinstance(instr, dict):
                        texts.append(instr.get("generated_instruction", ""))
                    else:
                        texts.append(str(instr))
                instructions[tid] = [t for t in texts if t]

    samples: List[Dict[str, Any]] = []
    for rec in gt.get("trajectories", []):
        tid = str(rec["trajectory_id"])
        tmeta = meta.get("trajectories", {}).get(tid)
        if tmeta is None:
            continue
        frames = [str(Path(scene_id) / f) for f in tmeta["frames"]]
        instr_list = instructions.get(tid) or ["Navigate to the destination."]
        for k, instr in enumerate(instr_list):
            samples.extend(create_sliding_window_samples(
                instr, rec["actions"], frames, f"{scene_id}_{tid}_{k}"))
    return samples


def save_in_parts(samples: List[Dict], output_dir,
                  samples_per_part: int = SAMPLES_PER_PART) -> List[str]:
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    num_parts = math.ceil(len(samples) / samples_per_part) if samples else 0
    names = []
    for i in range(num_parts):
        name = f"annotations_part_{i:03d}.json"
        with open(output_dir / name, "w") as f:
            json.dump(samples[i * samples_per_part:(i + 1) * samples_per_part],
                      f, indent=2, ensure_ascii=False)
        names.append(name)
    return names


def create_dataset(scene_jobs: List[Dict], output_dir,
                   samples_per_part: int = SAMPLES_PER_PART,
                   seed: int = 42) -> Dict:
    """Assemble the full dataset.

    scene_jobs: [{scene_id, actions_path, images_metadata_path,
                  trajectories_path?}].
    Returns dataset_info (also written to dataset_info.json).
    """
    output_dir = Path(output_dir)
    all_samples: List[Dict] = []
    for job in scene_jobs:
        all_samples.extend(process_scene(
            job["actions_path"], job["images_metadata_path"],
            job["scene_id"], job.get("trajectories_path")))
    random.Random(seed).shuffle(all_samples)
    part_files = save_in_parts(all_samples, output_dir, samples_per_part)
    info = {
        "dataset_name": "SAGE-Bench_NaVILA",
        "total_samples": len(all_samples),
        "num_parts": len(part_files),
        "samples_per_part": samples_per_part,
        "part_files": part_files,
        "data_format": {
            "move_distance": "0.35 meter",
            "turn_angle": "30 degree",
            "action_format": "The next action is {action}.",
        },
    }
    with open(output_dir / "dataset_info.json", "w") as f:
        json.dump(info, f, indent=2)
    return info
