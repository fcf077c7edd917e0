"""Domain-aware dataset splitting: 3-level unseen test splits + train/val.

Re-implementation of the reference splitter pair
(trajectory_split_domain_aware.py:38-709 produces split MAPPINGS;
benchmark_data_splitter.py:51-410 MATERIALIZES them into per-scene files).
Behavior mirrored:

  * scene types from scene_type.json (world_id -> design_type; scenes absent
    from the file are "home" — :53-97);
  * Scene-Unseen: 15 whole scenes, home/non-home balanced, medium-size
    preference (middle half by instruction-pair count — :195-218);
  * Val: 20 whole scenes from the remainder;
  * Trajectory-Unseen: ~30% of trajectories sampled from 15 training scenes
    (:257-334);
  * Instruction-Unseen: ~30% of instruction indices from scenes disjoint with
    the trajectory-unseen scenes (:336-424);
  * Train: the remainder after all exclusions (:426-504);
  * deterministic with seed 42; output filenames
    GSNav-Bench_{Train,Val,Test_*}_Split_Domain.json (:655-661).
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Dict, List, Tuple

SEED = 42
SCENE_UNSEEN_COUNT = 15
VAL_COUNT = 20
TRAJ_UNSEEN_SCENES = 15
TRAJ_UNSEEN_RATIO = 0.30
INSTR_UNSEEN_RATIO = 0.30

SPLIT_FILES = {
    "train": "GSNav-Bench_Train_Split_Domain.json",
    "val": "GSNav-Bench_Val_Split_Domain.json",
    "scene_unseen": "GSNav-Bench_Test_Scene_Unseen_Split_Domain.json",
    "trajectory_unseen": "GSNav-Bench_Test_Trajectory_Unseen_Split_Domain.json",
    "instruction_unseen": "GSNav-Bench_Test_Instruction_Unseen_Split_Domain.json",
}


def load_scene_types(scene_type_file, scene_ids) -> Tuple[List[str], List[str], Dict[str, str]]:
    """home/non-home classification; absent scenes are home (:53-97)."""
    design_map: Dict[str, str] = {}
    if scene_type_file is not None and Path(scene_type_file).exists():
        with open(scene_type_file) as f:
            items = json.load(f)
        for item in items:
            wid = str(item.get("world_id", ""))
            dt = item.get("design_type", "")
            if wid and dt:
                design_map[wid] = dt
    home, non_home = [], []
    scene_design: Dict[str, str] = {}
    for sid in scene_ids:
        if sid in design_map:
            non_home.append(sid)
            scene_design[sid] = design_map[sid]
        else:
            home.append(sid)
            scene_design[sid] = "Home"
    return home, non_home, scene_design


def _scene_pair_count(scene_stats: Dict) -> int:
    return int(scene_stats.get("total_instructions",
                               scene_stats.get("total_trajectories", 0)))


def select_scenes_by_size(scene_list: List[str], scene_stats: Dict[str, Dict],
                          target: int, rng: random.Random) -> List[str]:
    """Medium-size preference: sort by pair count, take the window starting at
    the 25th percentile, shuffle, pick target (:195-218)."""
    if not scene_list or target <= 0:
        return []
    pairs = sorted(((s, _scene_pair_count(scene_stats.get(s, {})))
                    for s in scene_list), key=lambda x: x[1])
    if len(pairs) <= target:
        return [s for s, _ in pairs]
    start = max(0, len(pairs) // 4)
    end = min(len(pairs), start + target * 2)
    candidates = pairs[start:end]
    rng.shuffle(candidates)
    return [s for s, _ in candidates[:target]]


def create_split_mappings(
    scene_stats: Dict[str, Dict],
    traj_ids_per_scene: Dict[str, List[str]],
    instr_counts: Dict[str, Dict[str, int]],
    scene_type_file=None,
    seed: int = SEED,
) -> Dict[str, Dict]:
    """Build the five split mappings.

    Args:
      scene_stats: {scene: {"total_trajectories": n, "total_instructions": m}}
        (from data/statistics.py global summary).
      traj_ids_per_scene: {scene: [trajectory_id, ...]}.
      instr_counts: {scene: {trajectory_id: n_instructions}}.

    Returns {split: {scene: {"mode": "full"} |
                     {"mode": "trajectories", "trajectory_ids": [...]} |
                     {"mode": "instructions",
                      "instruction_indices": {traj: [idx...]}}}}
    """
    rng = random.Random(seed)
    scene_ids = sorted(scene_stats.keys())
    home, non_home, scene_design = load_scene_types(scene_type_file, scene_ids)

    # --- Scene-Unseen: balanced home/non-home whole scenes
    n_scene_unseen = min(SCENE_UNSEEN_COUNT, max(len(scene_ids) // 3, 1))
    target_home = n_scene_unseen // 2
    target_non_home = n_scene_unseen - target_home
    sel_home = select_scenes_by_size(home, scene_stats, target_home, rng)
    sel_nh = select_scenes_by_size(non_home, scene_stats, target_non_home, rng)
    scene_unseen = sel_home + sel_nh
    if len(scene_unseen) < n_scene_unseen:
        remaining = [s for s in scene_ids if s not in scene_unseen]
        extra = rng.sample(remaining, min(n_scene_unseen - len(scene_unseen),
                                          len(remaining)))
        scene_unseen += extra

    # --- Val: whole scenes from the remainder
    remaining = [s for s in scene_ids if s not in scene_unseen]
    n_val = min(VAL_COUNT, max(len(remaining) // 4, 1)) if remaining else 0
    val_scenes = rng.sample(remaining, n_val) if n_val else []

    train_pool = [s for s in remaining if s not in val_scenes]

    # --- Trajectory-Unseen: ~30% of trajectories from up to 15 train scenes
    tu_scenes = rng.sample(train_pool, min(TRAJ_UNSEEN_SCENES, len(train_pool))) \
        if train_pool else []
    trajectory_unseen: Dict[str, Dict] = {}
    for s in tu_scenes:
        ids = list(traj_ids_per_scene.get(s, []))
        k = max(1, int(len(ids) * TRAJ_UNSEEN_RATIO)) if ids else 0
        if k:
            picked = sorted(rng.sample(ids, k))
            trajectory_unseen[s] = {"mode": "trajectories",
                                    "trajectory_ids": picked}

    # --- Instruction-Unseen: ~30% of instruction indices, disjoint scenes
    iu_pool = [s for s in train_pool if s not in tu_scenes]
    iu_scenes = rng.sample(iu_pool, min(TRAJ_UNSEEN_SCENES, len(iu_pool))) \
        if iu_pool else []
    instruction_unseen: Dict[str, Dict] = {}
    for s in iu_scenes:
        per_traj: Dict[str, List[int]] = {}
        for tid, n in sorted(instr_counts.get(s, {}).items()):
            k = max(1, int(n * INSTR_UNSEEN_RATIO)) if n else 0
            if k:
                per_traj[tid] = sorted(rng.sample(range(n), k))
        if per_traj:
            instruction_unseen[s] = {"mode": "instructions",
                                     "instruction_indices": per_traj}

    # --- Train: remainder with exclusions
    train: Dict[str, Dict] = {}
    for s in train_pool:
        exclude_traj = set(trajectory_unseen.get(s, {})
                           .get("trajectory_ids", []))
        exclude_instr = instruction_unseen.get(s, {}) \
            .get("instruction_indices", {})
        train[s] = {"mode": "train_filtered",
                    "exclude_trajectory_ids": sorted(exclude_traj),
                    "exclude_instruction_indices": exclude_instr}

    return {
        "scene_unseen": {s: {"mode": "full"} for s in scene_unseen},
        "val": {s: {"mode": "full"} for s in val_scenes},
        "trajectory_unseen": trajectory_unseen,
        "instruction_unseen": instruction_unseen,
        "train": train,
    }


def save_split_mappings(all_splits: Dict, output_dir) -> List[Path]:
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    out = []
    for split_name, filename in SPLIT_FILES.items():
        scenes = all_splits.get(split_name, {})
        payload = {
            "split_type": split_name,
            "scenes": scenes,
            "statistics": {"num_scenes": len(scenes)},
        }
        p = output_dir / filename
        with open(p, "w") as f:
            json.dump(payload, f, indent=2)
        out.append(p)
    return out


# ---------------------------------------------------------------------------
# Materialization (benchmark_data_splitter.py)
# ---------------------------------------------------------------------------

PREFIXES = {"train": "train", "val": "val", "scene_unseen": "test",
             "trajectory_unseen": "test", "instruction_unseen": "test"}


def materialize_split(split_name: str, mapping: Dict, traj_root, output_root,
                      prefix: str = "gvln") -> List[Path]:
    """Apply one split mapping to the merged trajectory files, writing
    {train,val,test}_{scene}.json per scene (benchmark_data_splitter.py:
    220-386: whole scenes for full splits, filtered samples/instruction
    indices otherwise)."""
    traj_root = Path(traj_root)
    out_dir = Path(output_root) / split_name
    out_dir.mkdir(parents=True, exist_ok=True)
    file_prefix = PREFIXES.get(split_name, "test")
    outputs = []

    for scene_id, spec in sorted(mapping.get("scenes", mapping).items()):
        src = traj_root / scene_id / \
            f"trajectories_overall_{prefix}_{scene_id}.json"
        if not src.exists():
            continue
        with open(src) as f:
            data = json.load(f)
        scenes = data.get("scenes", [])
        if not scenes:
            continue
        samples = scenes[0].get("samples", [])
        mode = spec.get("mode", "full")

        if mode == "full":
            kept = samples
        elif mode == "trajectories":
            ids = set(spec.get("trajectory_ids", []))
            kept = [s for s in samples if str(s.get("trajectory_id")) in ids]
        elif mode == "instructions":
            indices = spec.get("instruction_indices", {})
            kept = []
            for s in samples:
                tid = str(s.get("trajectory_id"))
                if tid in indices:
                    s2 = dict(s)
                    instrs = s.get("instructions", [])
                    s2["instructions"] = [instrs[i] for i in indices[tid]
                                          if i < len(instrs)]
                    if s2["instructions"]:
                        kept.append(s2)
        elif mode == "train_filtered":
            excl_t = set(spec.get("exclude_trajectory_ids", []))
            excl_i = spec.get("exclude_instruction_indices", {})
            kept = []
            for s in samples:
                tid = str(s.get("trajectory_id"))
                if tid in excl_t:
                    continue
                s2 = dict(s)
                if tid in excl_i:
                    drop = set(excl_i[tid])
                    instrs = s.get("instructions", [])
                    s2["instructions"] = [x for i, x in enumerate(instrs)
                                          if i not in drop]
                if s2.get("instructions"):
                    kept.append(s2)
        else:
            kept = samples

        if not kept:
            continue
        payload = {"scenes": [{**scenes[0], "samples": kept}]}
        out = out_dir / f"{file_prefix}_{scene_id}.json"
        with open(out, "w") as f:
            json.dump(payload, f, indent=2)
        outputs.append(out)
    return outputs


def materialize_all(split_dir, traj_root, output_root,
                    prefix: str = "gvln") -> Dict[str, List[Path]]:
    split_dir = Path(split_dir)
    out: Dict[str, List[Path]] = {}
    for split_name, filename in SPLIT_FILES.items():
        path = split_dir / filename
        if not path.exists():
            continue
        with open(path) as f:
            mapping = json.load(f)
        out[split_name] = materialize_split(split_name, mapping, traj_root,
                                            output_root, prefix=prefix)
    return out
