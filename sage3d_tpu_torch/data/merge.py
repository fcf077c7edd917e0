"""Trajectory merge: per-scene part files -> trajectories_overall_*.json.

Re-implementation of the reference merger (trajectory_merge.py:28-295): collect
``trajectories_{prefix}_{scene}_partN_trans.json`` files per scene, renumber
trajectory_ids sequentially, and emit
``trajectories_overall_{prefix}_{scene}.json`` (skip-if-exists resume).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional


def find_part_files(scene_dir: Path, require_trans: bool = True) -> List[Path]:
    pat = re.compile(r"trajectories_.+_part\d+" +
                     (r"_trans" if require_trans else r"") + r"\.json$")
    return sorted(f for f in scene_dir.iterdir()
                  if f.is_file() and pat.match(f.name))


def merge_scene(scene_dir, prefix: str = "gvln", overwrite: bool = False,
                require_trans: bool = True) -> Optional[Path]:
    """Merge one scene's part files with sequential trajectory_id renumbering
    (trajectory_merge.py:73-127)."""
    scene_dir = Path(scene_dir)
    scene_id = scene_dir.name
    out = scene_dir / f"trajectories_overall_{prefix}_{scene_id}.json"
    if out.exists() and not overwrite:
        return out

    parts = find_part_files(scene_dir, require_trans=require_trans)
    if not parts:
        return None

    merged_samples: List[Dict] = []
    id_map: Dict[str, str] = {}
    scene_meta: Dict = {"scene_id": scene_id, "scene_name": scene_id}
    for part in parts:
        try:
            with open(part) as f:
                data = json.load(f)
        except (json.JSONDecodeError, OSError):
            continue
        for scene in data.get("scenes", []):
            scene_meta.setdefault("scene_id", scene.get("scene_id", scene_id))
            for sample in scene.get("samples", []):
                sample = dict(sample)
                old_id = str(sample.get("trajectory_id", ""))
                sample["trajectory_id"] = str(len(merged_samples))
                id_map[old_id] = sample["trajectory_id"]
                merged_samples.append(sample)

    if not merged_samples:
        return None
    payload = {"scenes": [{**scene_meta, "samples": merged_samples}]}
    with open(out, "w") as f:
        json.dump(payload, f, indent=2)
    organize_visualization_images(scene_dir, id_map)
    return out


def organize_visualization_images(scene_dir: Path,
                                  id_map: Dict[str, str]) -> int:
    """Rename per-trajectory visualization PNGs to the renumbered merged ids
    (trajectory_merge.py:129-192): visualization/trajectory_{old}.png ->
    visualization_merged/trajectory_{new}.png. Returns the count moved."""
    import shutil
    src_dir = Path(scene_dir) / "visualization"
    if not src_dir.is_dir():
        return 0
    dst_dir = Path(scene_dir) / "visualization_merged"
    dst_dir.mkdir(exist_ok=True)
    moved = 0
    for old_id, new_id in id_map.items():
        src = src_dir / f"trajectory_{old_id}.png"
        if src.exists():
            shutil.copy2(src, dst_dir / f"trajectory_{new_id}.png")
            moved += 1
    return moved


def merge_all(traj_root, prefix: str = "gvln", overwrite: bool = False,
              require_trans: bool = True) -> List[Path]:
    traj_root = Path(traj_root)
    outputs = []
    for scene_dir in sorted(p for p in traj_root.iterdir() if p.is_dir()):
        out = merge_scene(scene_dir, prefix=prefix, overwrite=overwrite,
                          require_trans=require_trans)
        if out is not None:
            outputs.append(out)
    return outputs
