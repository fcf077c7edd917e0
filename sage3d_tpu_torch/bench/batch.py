"""Multi-scene batch benchmark: the reference's primary evaluation workflow.

PyTorch counterpart of ``sage3d_tpu/bench/batch.py``. The port's env fixes
its render budgets when it is built, so a hot swap between scenes of
different density takes a ``budgets`` map (scene name -> ``autotune_*``
dict) that is set on the env with each scene.

Mirrors run_benchmark.py batch mode: recursively scan a directory for
`test_*.json` files (:307-339), auto-match each file's scene asset
(:408-461) and 2D semantic map (:464-523) by the `scene_name` recorded in
the JSON (exact first, then fuzzy substring), HOT-SWAP the shared
environment per file (:2184-2189 — one env object, `load_scene` +
`update_map`), run every episode with resume + isolation, and write the
per-file results plus `batch_test_summary.json` (:526-569).

Scene assets here are the bundle formats (renderer/scene.py): a
`{scene_name}.ply`, a `{scene_name}/scene.ply` bundle dir, or a
`manifest.json` bundle.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from .runner import run_benchmark


def find_test_json_files(batch_dir, pattern_prefix: str = "test_",
                         verbose: bool = False) -> List[str]:
    """Recursive `test_*.json` scan, sorted (run_benchmark.py:307-339)."""
    batch_path = Path(batch_dir)
    if not batch_path.exists():
        print(f"[ERROR] Batch test directory does not exist: {batch_dir}")
        return []
    files = []
    for root, _dirs, names in os.walk(batch_path):
        for name in names:
            if name.startswith(pattern_prefix) and name.endswith(".json"):
                files.append(os.path.join(root, name))
    files.sort()
    if verbose:
        print(f"[INFO] Found {len(files)} test JSON files")
    return files


def get_scene_name_from_json(json_file_path) -> str:
    """scenes[0].scene_name of a GVLN test file (run_benchmark.py:342-366)."""
    try:
        with open(json_file_path) as f:
            data = json.load(f)
        if data.get("scenes"):
            return str(data["scenes"][0].get("scene_name", ""))
    except (OSError, json.JSONDecodeError, KeyError) as e:
        print(f"[ERROR] Failed to read JSON file: {json_file_path}: {e}")
    return ""


def find_matching_scene_file(json_file_path, scene_folder,
                             scene_name: Optional[str] = None) -> str:
    """Match a scene asset for a test file (run_benchmark.py:408-461):
    exact `{scene_name}.ply` / `{scene_name}/scene.ply` /
    `{scene_name}/manifest.json` first, then fuzzy substring over the folder.
    Returns "" when nothing matches."""
    if not scene_folder or not os.path.exists(str(scene_folder)):
        print(f"[WARN] Scene folder does not exist or not specified: {scene_folder}")
        return ""
    if not scene_name:
        scene_name = get_scene_name_from_json(json_file_path)
    if not scene_name:
        print(f"[WARN] scene_name not found: {json_file_path}")
        return ""
    folder = Path(scene_folder)
    for cand in (folder / f"{scene_name}.ply",
                 folder / scene_name / "scene.ply",
                 folder / scene_name / "manifest.json"):
        if cand.exists():
            return str(cand)
    # fuzzy: any entry containing the scene name
    for entry in sorted(folder.iterdir()):
        if scene_name in entry.name:
            if entry.is_file() and entry.suffix == ".ply":
                return str(entry)
            if entry.is_dir():
                for inner in (entry / "scene.ply", entry / "manifest.json"):
                    if inner.exists():
                        return str(inner)
    print(f"[SCENE_MATCH] no matching scene file found for '{scene_name}'")
    return ""


def find_matching_map_file(json_file_path, map_folder,
                           scene_name: Optional[str] = None) -> str:
    """Match the 2D semantic map for a test file (run_benchmark.py:464-523):
    the `2D_Semantic_Map_*_{scene}_Complete.json` pattern ladder, then fuzzy
    substring."""
    import glob as _glob
    if not map_folder or not os.path.exists(str(map_folder)):
        print(f"[WARN] Map folder does not exist or not specified: {map_folder}")
        return ""
    if not scene_name:
        scene_name = get_scene_name_from_json(json_file_path)
    if not scene_name:
        return ""
    patterns = [
        f"2D_Semantic_Map_*_{scene_name}_Complete.json",
        f"2D_Semantic_Map_{scene_name}_Complete.json",
        f"*_{scene_name}_Complete.json",
        f"*{scene_name}*.json",
    ]
    for pat in patterns:
        hits = sorted(_glob.glob(os.path.join(str(map_folder), pat)))
        if hits:
            return hits[0]
    for name in sorted(os.listdir(str(map_folder))):
        if name.endswith(".json") and scene_name in name:
            return os.path.join(str(map_folder), name)
    print(f"[MAP_MATCH] no matching map file found for '{scene_name}'")
    return ""


def run_batch_benchmark(
    env,
    test_dir,
    scene_folder,
    map_folder,
    policy: Callable[..., Dict[str, Any]],
    output_dir,
    goal_radius: float = 0.5,
    max_steps: int = 200,
    max_episodes_per_file: Optional[int] = None,
    skip_completed: bool = True,
    model_info: str = "scripted",
    instance_id: int = 0,
    total_instances: int = 1,
    quiet: bool = True,
    budgets: Optional[Dict[str, Dict[str, int]]] = None,
    **episode_kw,
) -> Dict[str, Any]:
    """Evaluate a directory of test files end-to-end on ONE shared env.

    Per file: match scene + map, hot-swap the env (`load_scene`/`update_map`,
    the reference's shared-env pattern run_benchmark.py:2184-2189, 649-668),
    adapt episodes, run with resume; failures are isolated per file
    (:2298-2318). File-level sharding across instances uses the same
    `hash % total` contract the reference applies to scenes
    (generate_images.py:136-139). Writes batch_test_summary.json (:526-569).

    ``budgets`` maps a scene name to the budgets its frames need
    (``env.set_budgets`` at each hot swap); a scene it does not name keeps
    the env's budgets. The env's ``total_overflow`` counts what any frame
    dropped.
    """
    from .episodes import adapt_gvln_to_episodes

    test_files = find_test_json_files(test_dir)
    if total_instances > 1:
        test_files = [tf for i, tf in enumerate(test_files)
                      if i % total_instances == instance_id]
    out_root = Path(output_dir)
    out_root.mkdir(parents=True, exist_ok=True)

    file_results: List[Dict[str, Any]] = []
    t_start = time.time()
    for tf in test_files:
        scene_name = get_scene_name_from_json(tf)
        rec: Dict[str, Any] = {"json_file": str(tf), "scene_name": scene_name}
        try:
            scene_file = find_matching_scene_file(tf, scene_folder, scene_name)
            if not scene_file:
                rec.update(status="no_scene", total_episodes=0,
                           successful_episodes=0, failed_episodes=0)
                file_results.append(rec)
                continue
            map_file = find_matching_map_file(tf, map_folder, scene_name)
            # shared-env hot-swap
            if budgets and scene_name in budgets:
                env.set_budgets(budgets[scene_name])
            if scene_file.endswith("manifest.json"):
                from ..data.scene_build import load_scene_bundle
                scene_obj, bundle_map = load_scene_bundle(scene_file,
                                                          device=env.device)
                env.load_scene(scene_obj)
                env.update_map(map_file or bundle_map)
            else:
                env.load_scene(scene_file)
                env.update_map(map_file or None)

            episodes = adapt_gvln_to_episodes(tf, scene_file,
                                              goal_radius=goal_radius)
            if max_episodes_per_file:
                episodes = episodes[:max_episodes_per_file]
            summary = run_benchmark(
                env, episodes, policy, output_dir=str(out_root),
                max_steps=max_steps, skip_completed=skip_completed,
                quiet=quiet, map_file=map_file or None,
                # per-file summaries must not clobber each other (or the
                # final batch summary) in the shared out_root; the name
                # encodes the path relative to test_dir because the scan is
                # recursive and stems repeat across scene subdirectories
                summary_filename="summary_" + str(
                    Path(tf).resolve().relative_to(
                        Path(test_dir).resolve())).replace(
                    os.sep, "__").replace(".json", "") + ".json",
                **episode_kw)
            # Denominator covers every ATTEMPTED episode (run-OK + resumed +
            # errored) so a crash cannot inflate the rate. Note the semantics
            # differ from run_benchmark.py:539-552 on purpose:
            # successful_episodes here means TASK success, not merely
            # completed-without-error.
            n = (summary["num_episodes"] + summary["num_skipped"]
                 + summary["num_failures"])
            rec.update(status="ok", total_episodes=n,
                       successful_episodes=summary["num_success"],
                       failed_episodes=summary["num_failures"],
                       metrics=summary.get("metrics", {}),
                       num_skipped=summary["num_skipped"])
        except Exception as e:  # file-level isolation (:2298-2318)
            rec.update(status="error", error=str(e), total_episodes=0,
                       successful_episodes=0, failed_episodes=0)
        file_results.append(rec)

    total_eps = sum(r["total_episodes"] for r in file_results)
    total_succ = sum(r["successful_episodes"] for r in file_results)
    total_fail = sum(r["failed_episodes"] for r in file_results)
    summary = {
        "model_info": model_info,
        "batch_summary": {
            "total_json_files": len(file_results),
            "total_episodes": total_eps,
            "successful_episodes": total_succ,
            "failed_episodes": total_fail,
            "overall_success_rate": total_succ / total_eps if total_eps else 0.0,
            "wall_time_s": round(time.time() - t_start, 2),
        },
        "file_results": file_results,
    }
    with open(out_root / "batch_test_summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    if not quiet:
        bs = summary["batch_summary"]
        print(f"[BATCH_SUMMARY] files={bs['total_json_files']} "
              f"episodes={bs['total_episodes']} "
              f"SR={bs['overall_success_rate']:.2%}")
    return summary
