"""Physical map converter: labels.json -> scene.json AABB strings.

Re-implementation of the reference converter (physical_map_converter.py:26-177):
each labeled object becomes  "label_N": "(min x,y,z),(max x,y,z)"  with values
rounded to 2 decimals — the text-map input for the LLM scene-description stage.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional


def bounds_from_bounding_box(poly3d: List[Dict]) -> tuple:
    xs = [v["x"] for v in poly3d]
    ys = [v["y"] for v in poly3d]
    zs = [v["z"] for v in poly3d]
    return (min(xs), min(ys), min(zs)), (max(xs), max(ys), max(zs))


def _fmt(v: float) -> str:
    return f"{round(float(v), 2)}"


def build_scene_entries(labels: List[Dict]) -> Dict[str, str]:
    """labels.json records -> {label_N: "(x,y,z),(x,y,z)"} AABB strings."""
    entries: Dict[str, str] = {}
    for i, obj in enumerate(labels):
        if "bounding_box" not in obj:
            continue
        lo, hi = bounds_from_bounding_box(obj["bounding_box"])
        key = f"label_{obj.get('ins_id', i)}"
        entries[key] = (f"({_fmt(lo[0])},{_fmt(lo[1])},{_fmt(lo[2])}),"
                        f"({_fmt(hi[0])},{_fmt(hi[1])},{_fmt(hi[2])})")
    return entries


def convert_scene(scene_dir, output_dir, overwrite: bool = False) -> Optional[Path]:
    scene_dir = Path(scene_dir)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    out = output_dir / "scene.json"
    if out.exists() and not overwrite:
        return out
    labels_path = scene_dir / "labels.json"
    if not labels_path.exists():
        return None
    with open(labels_path) as f:
        labels = json.load(f)
    with open(out, "w") as f:
        json.dump(build_scene_entries(labels), f, indent=2)
    return out


def convert_dataset(input_root, output_root, overwrite: bool = False,
                    max_scenes: Optional[int] = None) -> List[Path]:
    input_root = Path(input_root)
    scene_dirs = sorted(p for p in input_root.iterdir() if p.is_dir())
    if max_scenes is not None:
        scene_dirs = scene_dirs[:max_scenes]
    outputs = []
    for d in scene_dirs:
        out = convert_scene(d, Path(output_root) / d.name, overwrite=overwrite)
        if out is not None:
            outputs.append(out)
    return outputs
