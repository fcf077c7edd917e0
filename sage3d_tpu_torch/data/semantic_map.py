"""2D semantic map builder: InteriorGS annotations -> per-instance map JSON/PNG.

Re-implementation of the reference builder (semantic_map_builder.py:51-317)
producing the same output schema — per-instance records {category_id,
category_label, instance_id, item_id, bbox_m, bbox_xywh_m, area, height_m,
min_z_m, max_z_m, mask_coords_m} — with the rasterization vectorized (the
reference's per-pixel Python polygon loop, flagged HOT in SURVEY.md 3.3, is
replaced by one matplotlib-path containment test over the candidate rect).

Behavioral quirks preserved deliberately (downstream transforms compensate for
them, so "fixing" them would break benchmark parity):
  * object masks are flipped in BOTH axes (semantic_map_builder.py:154-163:
    mask[i_flip, j_flip]), wall/unable masks only vertically (:202, :246);
  * wall pixel value inferred as the most frequent occupancy value in (0, 250)
    (:91-101);
  * unable-area clusters below 5 px are dropped (:252-253);
  * coordinates serialized with 2-decimal formatting.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from scipy.ndimage import label as nd_label

PREDEFINED_CLASSES = [
    "door", "window", "chair", "table", "sofa", "bed", "wardrobe", "plant",
    "floor", "wall", "ceiling",
]


def format2(value) -> str:
    return f"{float(value):.2f}"


def normalize_label(label: str) -> str:
    return label.strip().lower().replace(" ", "_")


def infer_wall_value(occupancy: np.ndarray) -> int:
    pixels, counts = np.unique(occupancy.reshape(-1), return_counts=True)
    candidates = [(int(p), int(c)) for p, c in zip(pixels, counts)
                  if 0 < p < 250]
    if candidates:
        return max(candidates, key=lambda pc: pc[1])[0]
    return int(pixels[0])


def _polygon_mask(poly2d: np.ndarray, x_min: float, y_min: float, scale: float,
                  h: int, w: int) -> np.ndarray:
    """Boundary-inclusive polygon coverage over pixel centers, vectorized."""
    from matplotlib.path import Path as MplPath
    xs = poly2d[:, 0]
    ys = poly2d[:, 1]
    jx0 = int(np.clip(np.floor((xs.min() - x_min) / scale), 0, w - 1))
    jx1 = int(np.clip(np.floor((xs.max() - x_min) / scale), 0, w - 1))
    iy0 = int(np.clip(np.floor((ys.min() - y_min) / scale), 0, h - 1))
    iy1 = int(np.clip(np.floor((ys.max() - y_min) / scale), 0, h - 1))
    jj, ii = np.meshgrid(np.arange(jx0, jx1 + 1), np.arange(iy0, iy1 + 1))
    cx = x_min + (jj + 0.5) * scale
    cy = y_min + (ii + 0.5) * scale
    pts = np.stack([cx.ravel(), cy.ravel()], axis=1)
    # radius>0 makes the test boundary-inclusive (shapely `covers` semantics)
    inside = MplPath(poly2d).contains_points(pts, radius=1e-9) \
        | MplPath(poly2d).contains_points(pts, radius=-1e-9)
    mask = np.zeros((h, w), bool)
    mask[ii.ravel()[inside], jj.ravel()[inside]] = True
    return mask


def _mask_record(mask: np.ndarray, x_min: float, y_min: float, scale: float,
                 label: str, cat_id: int, instance_id, item_id: str,
                 height_m: float, min_z: float, max_z: float) -> Optional[Dict]:
    ys, xs = np.where(mask)
    if xs.size == 0:
        return None
    x_left = x_min + xs.min() * scale
    x_right = x_min + (xs.max() + 1) * scale
    y_bottom = y_min + ys.min() * scale
    y_top = y_min + (ys.max() + 1) * scale
    return {
        "category_id": int(cat_id),
        "category_label": label,
        "instance_id": instance_id,
        "item_id": item_id,
        "bbox_m": [format2(x_left), format2(y_bottom), format2(x_right),
                   format2(y_top)],
        "bbox_xywh_m": [format2(x_left), format2(y_bottom),
                        format2(x_right - x_left), format2(y_top - y_bottom)],
        "area": int(mask.sum()),
        "height_m": format2(height_m),
        "min_z_m": format2(min_z),
        "max_z_m": format2(max_z),
        "mask_coords_m": [[format2(y_min + (y + 0.5) * scale),
                           format2(x_min + (x + 0.5) * scale)]
                          for y, x in zip(ys, xs)],
    }


def build_semantic_map(
    occupancy: np.ndarray,
    labels: List[Dict],
    scale: float,
    x_min: float,
    y_min: float,
) -> List[Dict]:
    """Build the per-instance semantic map records for one scene."""
    h, w = occupancy.shape
    wall_value = infer_wall_value(occupancy)

    label2id = {cls: i + 1 for i, cls in enumerate(PREDEFINED_CLASSES)}
    next_id = len(label2id) + 1
    for obj in labels:
        if obj["label"] not in label2id:
            label2id[obj["label"]] = next_id
            next_id += 1

    records: List[Dict] = []
    item_counters: Dict[str, int] = defaultdict(int)

    for obj in labels:
        if "bounding_box" not in obj:
            continue
        label = obj["label"]
        poly3d = obj["bounding_box"]
        z_values = [v["z"] for v in poly3d]
        poly2d = np.array([[v["x"], v["y"]] for v in poly3d[:4]], float)
        mask = _polygon_mask(poly2d, x_min, y_min, scale, h, w)
        # reference quirk: object masks mirrored in both axes (:154-163)
        mask = np.flipud(np.fliplr(mask))
        if not mask.any():  # empty masks do not consume an item counter (:177)
            continue
        item_counters[label] += 1
        rec = _mask_record(mask, x_min, y_min, scale, label, label2id[label],
                           obj.get("ins_id", ""),
                           f"{normalize_label(label)}_{item_counters[label]}",
                           max(z_values) - min(z_values), min(z_values),
                           max(z_values))
        records.append(rec)

    # wall connected components (vertical flip only, :200-243)
    wall_flip = np.flipud(occupancy == wall_value)
    wall_labels, wall_count = nd_label(wall_flip, structure=np.ones((3, 3)))
    for idx in range(1, wall_count + 1):
        item_counters["wall"] += 1
        rec = _mask_record(wall_labels == idx, x_min, y_min, scale, "wall",
                           label2id["wall"], f"wall_{idx}",
                           f"wall_{item_counters['wall']}", 3.0, 0.0, 3.0)
        if rec is not None:
            records.append(rec)

    # unable-area clusters (occupancy==0, vertical flip, >=5 px, :245-296)
    unable_flip = np.flipud(occupancy == 0)
    un_labels, un_count = nd_label(unable_flip, structure=np.ones((3, 3)))
    for idx in range(1, un_count + 1):
        block = un_labels == idx
        if block.sum() < 5:
            continue
        item_counters["Unable Area"] += 1
        rec = _mask_record(
            block, x_min, y_min, scale, "Unable Area", -1,
            f"unable_area_{idx}",
            f"unable_area_{item_counters['Unable Area']}", 0.0, 0.0, 0.0)
        if rec is not None:
            records.append(rec)

    return records


def build_scene_dir(scene_dir, output_root, overwrite: bool = False,
                    save_png: bool = True) -> Optional[Path]:
    """Process one InteriorGS scene directory (occupancy.{json,png}+labels.json)."""
    from PIL import Image
    scene_dir = Path(scene_dir)
    output_root = Path(output_root)
    output_root.mkdir(parents=True, exist_ok=True)
    scene_name = scene_dir.name
    out_json = output_root / f"2D_Semantic_Map_{scene_name}_Complete.json"
    if out_json.exists() and not overwrite:
        return out_json

    with open(scene_dir / "occupancy.json") as f:
        meta = json.load(f)
    occupancy = np.array(Image.open(scene_dir / "occupancy.png").convert("L"))
    with open(scene_dir / "labels.json") as f:
        labels = json.load(f)

    records = build_semantic_map(occupancy, labels, meta["scale"],
                                 meta["min"][0], meta["min"][1])
    with open(out_json, "w") as f:
        json.dump(records, f, indent=2)

    if save_png:
        _save_visualization(occupancy, meta, output_root /
                            f"2D_Semantic_Map_{scene_name}_Complete.png")
    return out_json


def _save_visualization(occupancy, meta, out_png) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    h, w = occupancy.shape
    scale = meta["scale"]
    x_min, y_min = meta["min"][:2]
    wall_value = infer_wall_value(occupancy)
    extent = [x_min, x_min + w * scale, y_min, y_min + h * scale]
    plt.figure(figsize=(12, 12))
    bg = np.zeros((h, w, 4), float)
    bg[:, :] = (31 / 255, 119 / 255, 180 / 255, 1.0)
    plt.imshow(bg, origin="lower", extent=extent)
    overlay = np.zeros((h, w, 4), float)
    overlay[np.flipud(occupancy == 0)] = [1.0, 128 / 255, 128 / 255, 1.0]
    overlay[np.flipud(occupancy == wall_value)] = [158 / 255, 218 / 255,
                                                   229 / 255, 0.8]
    plt.imshow(overlay, origin="lower", extent=extent)
    plt.axis("off")
    plt.savefig(out_png, bbox_inches="tight", dpi=150)
    plt.close()


def build_all(input_root, output_root, overwrite: bool = False,
              max_scenes: Optional[int] = None) -> List[Path]:
    """Batch CLI entry (semantic_map_builder.py:51-77 resume semantics)."""
    input_root = Path(input_root)
    scene_dirs = sorted(p for p in input_root.iterdir() if p.is_dir())
    if max_scenes is not None:
        scene_dirs = scene_dirs[:max_scenes]
    outputs = []
    for d in scene_dirs:
        if not ((d / "occupancy.json").is_file() and (d / "labels.json").is_file()
                and (d / "occupancy.png").is_file()):
            continue
        out = build_scene_dir(d, output_root, overwrite=overwrite)
        if out is not None:
            outputs.append(out)
    return outputs
