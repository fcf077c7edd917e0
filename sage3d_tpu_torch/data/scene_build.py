"""Scene bundle builder: 3DGS PLY + labels -> executable scene assets.

PyTorch counterpart of ``sage3d_tpu/data/scene_build.py``; the bundles it
writes are the JAX package's (the same PLY layout and manifest), so either
package loads the other's. The equivalent of the reference's L1 asset chain
(sage3d_usda_builder.py:93-221 templated USDA binding a 3DGS USDZ + a collision
payload per scene; upstream: splat-transform decompression + 3DGRUT ply_to_usd,
README.md:194-266). No USD composition is needed here: the executable scene is
a semantic PLY (per-Gaussian instance IDs baked in from labels.json) plus a
manifest that binds it to its 2D semantic map — everything the env needs to
load, render and collide.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

from ..renderer.scene import attach_semantic_ids_from_labels, load_ply, save_ply


def labels_to_bbox_index(labels: List[Dict]) -> Dict[str, List]:
    """labels.json records -> {label_N: [min_xyz, max_xyz]} for semantic-ID
    attachment (same AABB parse as data/physical_map.py)."""
    out = {}
    for i, obj in enumerate(labels):
        if "bounding_box" not in obj:
            continue
        poly = obj["bounding_box"]
        xs = [v["x"] for v in poly]
        ys = [v["y"] for v in poly]
        zs = [v["z"] for v in poly]
        key = f"label_{obj.get('ins_id', i)}"
        out[key] = [[min(xs), min(ys), min(zs)], [max(xs), max(ys), max(zs)]]
    return out


def build_scene_bundle(
    ply_path,
    labels_json_path,
    semantic_map_path,
    output_dir,
    scene_id: Optional[str] = None,
    overwrite: bool = False,
    device=None,
) -> Optional[Path]:
    """Build {scene_id}/scene.ply + manifest.json (skip-if-exists resume,
    mirroring sage3d_usda_builder.py:195-197). The scene passes through
    ``device`` (None means the card)."""
    ply_path = Path(ply_path)
    scene_id = scene_id or ply_path.stem
    out_dir = Path(output_dir) / scene_id
    manifest_path = out_dir / "manifest.json"
    if manifest_path.exists() and not overwrite:
        return manifest_path
    out_dir.mkdir(parents=True, exist_ok=True)

    scene = load_ply(ply_path, device=device)
    with open(labels_json_path) as f:
        labels = json.load(f)
    scene = attach_semantic_ids_from_labels(scene,
                                            labels_to_bbox_index(labels))
    scene_out = out_dir / "scene.ply"
    save_ply(scene, scene_out)

    ids = scene.semantic_ids.cpu().numpy()
    manifest = {
        "scene_id": scene_id,
        "scene_ply": scene_out.name,
        "semantic_map": str(semantic_map_path),
        "num_gaussians": int(scene.num_gaussians),
        "num_labeled_gaussians": int((ids >= 0).sum()),
        "num_instances": int(len(set(ids[ids >= 0].tolist()))),
        "source_ply": str(ply_path),
        "source_labels": str(labels_json_path),
    }
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest_path


def load_scene_bundle(manifest_path, device=None):
    """Load a bundle -> (GaussianScene on ``device``, semantic_map_path);
    ``device`` None means the card."""
    manifest_path = Path(manifest_path)
    with open(manifest_path) as f:
        manifest = json.load(f)
    scene = load_ply(manifest_path.parent / manifest["scene_ply"],
                     device=device)
    return scene, manifest.get("semantic_map")


def build_all(ply_root, labels_root, map_root, output_dir,
              overwrite: bool = False,
              max_scenes: Optional[int] = None, device=None) -> List[Path]:
    """Batch bundle builder over scene directories (numeric-stem convention of
    sage3d_usda_builder.py:51-58)."""
    ply_root = Path(ply_root)
    outputs = []
    plys = sorted(p for p in ply_root.rglob("*.ply"))
    if max_scenes is not None:
        plys = plys[:max_scenes]
    for ply in plys:
        scene_id = ply.stem
        labels = Path(labels_root) / scene_id / "labels.json"
        if not labels.exists():
            continue
        sem_map = Path(map_root) / f"2D_Semantic_Map_{scene_id}_Complete.json"
        out = build_scene_bundle(ply, labels, sem_map, output_dir,
                                 scene_id=scene_id, overwrite=overwrite,
                                 device=device)
        if out is not None:
            outputs.append(out)
    return outputs
