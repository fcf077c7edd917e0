"""GVLN trajectory JSON -> flat episode dicts (one per instruction).

Re-implementation of the reference episode adapter (episodes_adapter.py:15-126)
with the same episode schema so trajectory files and measurement outputs are
interchangeable between the two frameworks. The `scene_usd` field is kept for
schema parity but points at whatever scene asset the TPU env loads (a 3DGS PLY).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Tuple


def parse_instructions(instr_list: List[Any]) -> List[Tuple[int, str, str, str, str]]:
    """(index, text, type, start_item, end_item) per instruction; supports the
    old string-array format and the new object format
    (episodes_adapter.py:94-126)."""
    if not instr_list:
        return [(0, "", "", "", "")]
    first = instr_list[0]
    if isinstance(first, str):
        return [(i, s, "", "", "") for i, s in enumerate(instr_list)]
    if isinstance(first, dict) and "generated_instruction" in first:
        out = []
        for i, obj in enumerate(instr_list):
            if isinstance(obj, dict):
                out.append((i, obj.get("generated_instruction", ""),
                            obj.get("instruction_type", ""),
                            obj.get("start", ""), obj.get("end", "")))
        return out or [(0, "", "", "", "")]
    return [(0, "", "", "", "")]


def adapt_gvln_to_episodes(
    gvln_json_path,
    scene_asset_path,
    goal_radius: float = 0.5,
    verbose: bool = False,
) -> List[Dict[str, Any]]:
    """Flatten a GVLN trajectory file into per-instruction episodes.

    Episode schema matches episodes_adapter.py:73-89: scene_usd, scene_id,
    scene_name, episode_id '{traj}-{instr}', start pose, goals
    [{radius, position}], gt_locations, reference_path.
    """
    if isinstance(gvln_json_path, (str, Path)):
        with open(gvln_json_path) as f:
            data = json.load(f)
    else:
        data = gvln_json_path

    assert "scenes" in data and data["scenes"], "Malformed GVLN JSON: missing scenes"
    scene = data["scenes"][0]
    episodes: List[Dict[str, Any]] = []

    for sample in scene.get("samples", []):
        points = sample.get("points", [])
        assert points, "Sample has no points"
        gt_locations = [p["position"] for p in points]
        start_position = points[0]["position"]
        start_rotation = points[0]["rotation"]
        goal_position = points[-1]["position"]

        for idx, text, itype, start_item, end_item in parse_instructions(
                sample.get("instructions", [""])):
            episodes.append({
                "scene_usd": str(scene_asset_path),
                "scene_id": scene.get("scene_id", 0),
                "scene_name": scene.get("scene_name", "scene"),
                "episode_id": f"{sample.get('trajectory_id', '0')}-{idx}",
                "trajectory_id": sample.get("trajectory_id", "0"),
                "instruction_index": idx,
                "instruction": {"instruction_text": text},
                "instruction_type": itype,
                "start_item": start_item,
                "end_item": end_item,
                "start_position": start_position,
                "start_rotation": start_rotation,
                "goals": [{"radius": goal_radius, "position": goal_position}],
                "gt_locations": gt_locations,
                "reference_path": gt_locations,
            })
    if verbose:
        print(f"[episodes] adapted {len(episodes)} episodes")
    return episodes
