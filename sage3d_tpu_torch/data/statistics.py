"""Trajectory statistics: per-scene + global summaries for split planning.

Re-implementation of the reference analyzer (trajectory_statistics.py:28-458):
path-length tercile categorization (short/middle/long at the 1/3 and 2/3 order
statistics), instruction counts/word counts/type histograms, unique start-end
pairs; emits trajectories_statistic_{scene}.json and
global_trajectory_summary.json consumed by the domain-aware splitter.
"""

from __future__ import annotations

import json
import statistics as pystats
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional


def calculate_length_thresholds(lengths: List[int]) -> Dict[str, int]:
    """1/3 and 2/3 order-statistic thresholds (trajectory_statistics.py:85-94)."""
    if not lengths:
        return {"short": 10, "long": 50}
    s = sorted(lengths)
    n = len(s)
    return {"short": s[n // 3] if n >= 3 else min(s),
            "long": s[2 * n // 3] if n >= 3 else max(s)}


def categorize_length(length: int, thresholds: Dict[str, int]) -> str:
    if length <= thresholds["short"]:
        return "short"
    if length <= thresholds["long"]:
        return "middle"
    return "long"


def extract_trajectory_info(sample: Dict) -> Dict:
    instructions = sample.get("instructions", [])
    type_counts: Counter = Counter()
    word_counts: List[int] = []
    pairs = []
    starts, ends = set(), set()
    for instr in instructions:
        if isinstance(instr, dict):
            type_counts[instr.get("instruction_type", "Unknown")] += 1
            word_counts.append(len(str(instr.get("generated_instruction", ""))
                                   .split()))
            s = instr.get("start", "")
            e = instr.get("end", "")
            if s or e:
                pairs.append(f"{s}->{e}")
                starts.add(s)
                ends.add(e)
        else:
            type_counts["Unknown"] += 1
            word_counts.append(len(str(instr).split()))
    return {
        "trajectory_id": str(sample.get("trajectory_id", "0")),
        "path_length": len(sample.get("points", [])),
        "total_instructions": len(instructions),
        "instruction_types_count": dict(type_counts),
        "instruction_word_counts": word_counts,
        "start_end_pairs": pairs,
        "unique_starts": starts,
        "unique_ends": ends,
    }


def analyze_trajectory_file(overall_json_path, scene_name: str) -> Optional[Dict]:
    """Per-scene statistics record (trajectory_statistics.py:106-270 schema)."""
    with open(overall_json_path) as f:
        data = json.load(f)
    scenes = data.get("scenes", [])
    samples = scenes[0].get("samples", []) if scenes else []

    details: Dict[str, Dict] = {}
    pair_counter: Counter = Counter()
    type_counter: Counter = Counter()
    unique_starts, unique_ends, unique_pairs = set(), set(), set()
    lengths, per_traj_instr, word_counts = [], [], []

    for sample in samples:
        info = extract_trajectory_info(sample)
        details[info["trajectory_id"]] = {
            "trajectory_id": info["trajectory_id"],
            "path_length": info["path_length"],
            "total_instructions": info["total_instructions"],
            "instruction_types_count": info["instruction_types_count"],
            "instruction_word_counts": info["instruction_word_counts"],
            "avg_words_per_instruction": (
                sum(info["instruction_word_counts"])
                / len(info["instruction_word_counts"])
                if info["instruction_word_counts"] else 0),
            "total_words": sum(info["instruction_word_counts"]),
            "start_end_pairs": info["start_end_pairs"],
            "unique_starts": list(info["unique_starts"]),
            "unique_ends": list(info["unique_ends"]),
        }
        for p in info["start_end_pairs"]:
            pair_counter[p] += 1
            unique_pairs.add(p)
        type_counter.update(info["instruction_types_count"])
        unique_starts |= info["unique_starts"]
        unique_ends |= info["unique_ends"]
        lengths.append(info["path_length"])
        per_traj_instr.append(info["total_instructions"])
        word_counts.extend(info["instruction_word_counts"])

    length_stats = {}
    categories = Counter()
    if lengths:
        length_stats = {
            "avg_length": pystats.mean(lengths),
            "min_length": min(lengths),
            "max_length": max(lengths),
            "median_length": pystats.median(lengths),
            "std_length": pystats.stdev(lengths) if len(lengths) > 1 else 0,
        }
        thresholds = calculate_length_thresholds(lengths)
        for traj in details.values():
            cat = categorize_length(traj["path_length"], thresholds)
            traj["length_category"] = cat
            categories[cat] += 1

    return {
        "scene_name": scene_name,
        "scene_summary": {
            "total_trajectories": len(samples),
            "trajectory_length_stats": length_stats,
            "length_categories": dict(categories),
            "instruction_stats": {
                "avg_instructions_per_trajectory": (
                    pystats.mean(per_traj_instr) if per_traj_instr else 0),
                "total_instructions": sum(per_traj_instr),
                "avg_words_per_instruction": (
                    pystats.mean(word_counts) if word_counts else 0),
                "total_words": sum(word_counts),
            },
            "location_stats": {
                "unique_starts": sorted(unique_starts),
                "unique_ends": sorted(unique_ends),
                "unique_start_count": len(unique_starts),
                "unique_end_count": len(unique_ends),
                "unique_pairs_count": len(unique_pairs),
            },
            "most_common_pairs": dict(pair_counter.most_common(10)),
            "most_common_instruction_types": dict(type_counter.most_common()),
        },
        "trajectory_details": details,
    }


def analyze_all(traj_root, prefix: str = "gvln",
                overwrite: bool = False) -> Dict:
    """All scenes + global summary (trajectory_statistics.py:307-409 resume)."""
    traj_root = Path(traj_root)
    global_summary = {"total_scenes": 0, "total_trajectories": 0,
                      "total_instructions": 0, "scenes": {}}
    for scene_dir in sorted(p for p in traj_root.iterdir() if p.is_dir()):
        overall = scene_dir / \
            f"trajectories_overall_{prefix}_{scene_dir.name}.json"
        if not overall.exists():
            continue
        out = scene_dir / f"trajectories_statistic_{scene_dir.name}.json"
        if out.exists() and not overwrite:
            with open(out) as f:
                stats = json.load(f)
        else:
            stats = analyze_trajectory_file(overall, scene_dir.name)
            with open(out, "w") as f:
                json.dump(stats, f, indent=2)
        summ = stats["scene_summary"]
        global_summary["total_scenes"] += 1
        global_summary["total_trajectories"] += summ["total_trajectories"]
        global_summary["total_instructions"] += \
            summ["instruction_stats"]["total_instructions"]
        global_summary["scenes"][scene_dir.name] = {
            "total_trajectories": summ["total_trajectories"],
            "total_instructions": summ["instruction_stats"]["total_instructions"],
            "length_categories": summ["length_categories"],
        }
    with open(traj_root / "global_trajectory_summary.json", "w") as f:
        json.dump(global_summary, f, indent=2)
    return global_summary
