"""VLN trajectory generation: endpoints, LLM judging, planning, instructions.

PyTorch counterpart of ``sage3d_tpu/data/trajectory_gen.py``: the same host
pipeline, with the batched planner's distance fields computed on ``device``
(``astar.plan_many``). Re-architecture of the reference's largest pipeline stage
(vln_trajectory_generator.py, 2382 lines) with the same outputs and resume
contract:

  * nav grid from the 2D semantic map (0.05 m/px, robot radius 0.2 m, EDT
    inflation — build_2d_map :487-556);
  * union-find connectivity precompute so unreachable pairs are rejected
    without planning (:639-689) — here a single scipy connected-component
    label, the vectorized equivalent of the reference's pixel union-find loop;
  * candidate endpoint pairs filtered by distance (2-20 m) and same/similar
    category groups (:586-636);
  * batched LLM meaningfulness judging (10 pairs per call — :393-427) through
    any data.llm client (MockLLMClient for offline runs);
  * path planning: reference-parity A* per pair, or the batched wavefront
    planner on the card (data/astar.py) that amortizes one distance field per
    start item over every candidate goal;
  * trajectory points with segment-direction yaw quaternions and the Isaac
    camera parameters (:703-741);
  * instruction generation per the 7-type taxonomy with retry (:1607-1643) and
    incremental part-file saving + endpoint/trajectory reconciliation resume
    (:887-894, :970-1060, :2016-2046).
"""

from __future__ import annotations

import json
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.ndimage import distance_transform_edt
from scipy.ndimage import label as nd_label

from ..renderer.scene import resolve_device
from .astar import (astar_pixel, instance_centroid_px,
                    nearest_free_pixel_on_side, plan_many)
from .llm import LLMClient, MockLLMClient, robust_json_parse
from .prompt_templates import (pairwise_judgement_messages,
                               traj_to_instruction_messages)

# Constants mirrored from vln_trajectory_generator.py:63-85
ROBOT_RADIUS_M = 0.2
SCALE_M_PER_PX = 0.05
FIXED_Z = 0.5
SAMPLE_STEP = 1
MIN_TRAJS_PER_SCENE = 100
MAX_PAIRS_PER_BATCH = 50
BATCH_PAIRS_PER_LLM_CALL = 10
MAX_TOTAL_PAIRS_CHECK = 5000
MIN_DISTANCE_THRESHOLD = 2.0
MAX_DISTANCE_THRESHOLD = 20.0
INCREMENTAL_SAVE_THRESHOLD = 5
JUDGE_WORKERS = 32

# Instruction taxonomy comes from the few-shot template module (the
# template-driven contract of prompt_traj_to_instruction.json).
from .prompt_templates import INSTRUCTION_TYPES  # noqa: E402  (re-export)

SIMILAR_GROUPS = [
    {"chair", "stool", "armchair"},
    {"table", "desk", "dining_table"},
    {"bed", "sofa", "couch"},
    {"cabinet", "shelf", "bookshelf", "wardrobe"},
    {"lamp", "light", "ceiling_light"},
]

CAMERA_PARAMS = {
    "focal_length": 7.0,
    "horizontal_aperture": 20.954999923706055,
    "vertical_aperture": 20.954999923706055,
    "focus_distance": 0.0,
    "clipping_range": [1.0, 1000000.0],
}


# ---------------------------------------------------------------------------
# Nav grid
# ---------------------------------------------------------------------------

def build_2d_map(sem_data: List[Dict], scale: float = SCALE_M_PER_PX,
                 robot_radius_m: float = ROBOT_RADIUS_M):
    """Obstacle grid (1 = blocked) from semantic-map records; also annotates
    each record with its pixel coords (``mask_coords``). Returns
    (grid, scale, min_x, min_y) or (None,)*4."""
    all_x, all_y = [], []
    for inst in sem_data:
        for y, x in inst.get("mask_coords_m", []):
            try:
                all_y.append(float(y))
                all_x.append(float(x))
            except (TypeError, ValueError):
                continue
    if not all_x:
        return None, None, None, None
    min_x, min_y = min(all_x), min(all_y)
    h = int(np.ceil((max(all_y) - min_y) / scale)) + 1
    w = int(np.ceil((max(all_x) - min_x) / scale)) + 1

    grid = np.zeros((h, w), np.uint8)
    for inst in sem_data:
        coords = []
        for y_m, x_m in inst.get("mask_coords_m", []):
            try:
                px = int(round((float(x_m) - min_x) / scale))
                py = int(round((float(y_m) - min_y) / scale))
            except (TypeError, ValueError):
                continue
            if 0 <= py < h and 0 <= px < w:
                coords.append((py, px))
        inst["mask_coords"] = coords
        if str(inst.get("category_label", "")).lower() in ("unable area", "wall"):
            for py, px in coords:
                grid[py, px] = 1

    if robot_radius_m > 0:
        dist_m = distance_transform_edt(grid == 0, sampling=scale)
        grid = (dist_m <= robot_radius_m).astype(np.uint8)
    return grid, scale, min_x, min_y


def build_connectivity(grid: np.ndarray) -> np.ndarray:
    """Connected-component id per pixel over free space (vectorized stand-in
    for the reference's union-find loop, :639-689). Blocked pixels get 0."""
    comp, _ = nd_label(grid == 0, structure=np.ones((3, 3)))
    return comp


def same_component(comp: np.ndarray, a_xy, b_xy) -> bool:
    ax, ay = a_xy
    bx, by = b_xy
    return comp[ay, ax] != 0 and comp[ay, ax] == comp[by, bx]


# ---------------------------------------------------------------------------
# Pair generation / filtering
# ---------------------------------------------------------------------------

def item_index(sem_data: List[Dict]) -> Dict[str, Dict]:
    return {inst["item_id"]: inst for inst in sem_data if "item_id" in inst}


def calculate_distance(inst1: Dict, inst2: Dict) -> float:
    def center(inst):
        bbox = [float(v) for v in inst.get("bbox_m", [0, 0, 0, 0])]
        return np.array([(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2])
    return float(np.linalg.norm(center(inst1) - center(inst2)))


def should_skip_same_category(item1: str, item2: str,
                              itemid2inst: Dict[str, Dict]) -> bool:
    """Same-category / similar-functional-group rejection (:586-614)."""
    i1, i2 = itemid2inst.get(item1), itemid2inst.get(item2)
    if i1 is None or i2 is None:
        return False
    l1 = i1.get("category_label", "").lower()
    l2 = i2.get("category_label", "").lower()
    if l1 == l2:
        return True
    return any(l1 in g and l2 in g for g in SIMILAR_GROUPS)


def filter_pairs(pairs: Sequence[Tuple[str, str]], itemid2inst: Dict[str, Dict],
                 min_dist: float = MIN_DISTANCE_THRESHOLD,
                 max_dist: float = MAX_DISTANCE_THRESHOLD):
    out = []
    for s, e in pairs:
        if should_skip_same_category(s, e, itemid2inst):
            continue
        if s in itemid2inst and e in itemid2inst:
            d = calculate_distance(itemid2inst[s], itemid2inst[e])
            if d < min_dist or d > max_dist:
                continue
        out.append((s, e))
    return out


def candidate_items(sem_data: List[Dict]) -> List[str]:
    """Items eligible as endpoints: labeled objects (not walls/unable/floor)."""
    skip = {"wall", "unable area", "floor", "ceiling"}
    return [inst["item_id"] for inst in sem_data
            if "item_id" in inst
            and inst.get("category_label", "").lower() not in skip
            and inst.get("mask_coords")]


def generate_pairs(items: Sequence[str], existing: set, rng: np.random.Generator,
                   limit: int = MAX_TOTAL_PAIRS_CHECK):
    pairs = [(a, b) for a in items for b in items if a != b
             and (a, b) not in existing]
    rng.shuffle(pairs)
    return pairs[:limit]


# ---------------------------------------------------------------------------
# LLM judging
# ---------------------------------------------------------------------------

def judge_pairs_batch(client: LLMClient, pairs: Sequence[Tuple[str, str]],
                      scene_text: str,
                      batch_size: int = BATCH_PAIRS_PER_LLM_CALL,
                      workers: int = JUDGE_WORKERS):
    """Batched meaningfulness judging (:393-427): groups of ``batch_size``
    pairs per LLM call, a thread pool across calls; failures mark the batch
    not-meaningful and continue."""
    batches = [pairs[i:i + batch_size] for i in range(0, len(pairs), batch_size)]

    def judge(batch):
        msg = pairwise_judgement_messages(scene_text, batch)
        text = client.chat_with_retry(msg)
        if text is None:
            return [False] * len(batch)
        parsed = robust_json_parse(text)
        # template contract: JSON array of {pair_id, start, end, meaningful}
        if isinstance(parsed, list):
            verdicts = [False] * len(batch)
            for entry in parsed:
                if isinstance(entry, dict) and "pair_id" in entry:
                    i = int(entry["pair_id"])
                    if 0 <= i < len(batch):
                        verdicts[i] = bool(entry.get("meaningful", False))
            return verdicts
        # legacy dict format {"1": "yes", ...} still tolerated
        if isinstance(parsed, dict):
            return [str(parsed.get(str(i + 1), "no")).lower().startswith("y")
                    for i in range(len(batch))]
        return [False] * len(batch)

    results: List[bool] = []
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for verdicts in pool.map(judge, batches):
            results.extend(verdicts)
    return [p for p, ok in zip(pairs, results) if ok]


def judge_pair(client: LLMClient, start_item: str, end_item: str,
               scene_text: str) -> bool:
    """Non-batched single-pair judging via prompt_pairwise_judgement (the
    reference ships both templates; the batch path above is the production
    one, this keeps CLI parity for one-off judgement calls)."""
    from .prompt_templates import pairwise_judgement_single_messages
    text = client.chat_with_retry(
        pairwise_judgement_single_messages(scene_text, start_item, end_item))
    if text is None:
        return False
    parsed = robust_json_parse(text)
    return bool(parsed.get("meaningful", False)) if isinstance(parsed, dict) \
        else False


# ---------------------------------------------------------------------------
# Path -> trajectory points
# ---------------------------------------------------------------------------

def generate_trajectory_points(path: List[Tuple[int, int]], scale: float,
                               min_x: float, min_y: float,
                               fixed_z: float = FIXED_Z,
                               sample_step: int = SAMPLE_STEP) -> List[Dict]:
    """(x, y) pixel path -> posed trajectory points (:703-741): segment-
    direction yaw as a z-quaternion, Isaac camera parameters attached."""
    xs, ys = zip(*path)
    world = [(min_x + (x + 0.5) * scale, min_y + (y + 0.5) * scale)
             for x, y in zip(xs, ys)]
    sampled = world[::sample_step]
    points = []
    for j, (wx, wy) in enumerate(sampled):
        nx, ny = sampled[j + 1] if j < len(sampled) - 1 else sampled[j]
        yaw = math.atan2(ny - wy, nx - wx)
        points.append({
            "point": str(j),
            "position": [wx, wy, fixed_z],
            "rotation": [0.0, 0.0, math.sin(yaw / 2.0), math.cos(yaw / 2.0)],
            "action": [],
            "camera_images": [],
            **CAMERA_PARAMS,
        })
    return points


def validate_and_generate_path(start_item: str, end_item: str,
                               itemid2inst: Dict[str, Dict],
                               grid: np.ndarray, scale: float, min_x: float,
                               min_y: float,
                               comp: Optional[np.ndarray] = None
                               ) -> Optional[Dict]:
    """Snap endpoints to free pixels facing each other, run A*, build points
    (:744-779); the connectivity precompute short-circuits unreachable pairs."""
    s_inst = itemid2inst.get(start_item)
    g_inst = itemid2inst.get(end_item)
    if not s_inst or not g_inst:
        return None
    s_cent = instance_centroid_px(s_inst.get("mask_coords", []))
    g_cent = instance_centroid_px(g_inst.get("mask_coords", []))
    if not s_cent or not g_cent:
        return None
    s_px = nearest_free_pixel_on_side(s_inst.get("mask_coords", []), grid,
                                      towards_px=g_cent)
    g_px = nearest_free_pixel_on_side(g_inst.get("mask_coords", []), grid,
                                      towards_px=s_cent)
    if not s_px or not g_px:
        return None
    if comp is not None and not same_component(comp, s_px, g_px):
        return None
    path = astar_pixel(grid, s_px, g_px)
    if not path:
        return None
    return {"start": start_item, "end": end_item,
            "points": generate_trajectory_points(path, scale, min_x, min_y)}


def _snap_pair(start_item: str, end_item: str, itemid2inst: Dict[str, Dict],
               grid: np.ndarray, comp: Optional[np.ndarray]):
    """Endpoint snapping half of validate_and_generate_path: (s_px, g_px)
    as (x, y) tuples, or None when the pair can't be planned."""
    s_inst = itemid2inst.get(start_item)
    g_inst = itemid2inst.get(end_item)
    if not s_inst or not g_inst:
        return None
    s_cent = instance_centroid_px(s_inst.get("mask_coords", []))
    g_cent = instance_centroid_px(g_inst.get("mask_coords", []))
    if not s_cent or not g_cent:
        return None
    s_px = nearest_free_pixel_on_side(s_inst.get("mask_coords", []), grid,
                                      towards_px=g_cent)
    g_px = nearest_free_pixel_on_side(g_inst.get("mask_coords", []), grid,
                                      towards_px=s_cent)
    if not s_px or not g_px:
        return None
    if comp is not None and not same_component(comp, s_px, g_px):
        return None
    return s_px, g_px


def validate_and_generate_paths_batch(
    pairs: Sequence[Tuple[str, str]],
    itemid2inst: Dict[str, Dict],
    grid: np.ndarray,
    scale: float,
    min_x: float,
    min_y: float,
    comp: Optional[np.ndarray] = None,
    wavefront_batch: int = 16,
    device=None,
) -> List[Optional[Dict]]:
    """Batched planning for many pairs at once: snap every endpoint on the
    host, then compute geodesic distance fields for ALL starts in parallel on
    ``device`` (`wavefront_distances` — the batched planner astar.py exists
    for; None means the card) and recover paths by greedy descent. Produces
    shortest 8-connected paths on the same grid as `astar_pixel` (identical
    reachability and length; tie-broken differently). One wavefront per
    ``wavefront_batch`` pairs replaces that many serial host A* runs."""
    snapped = [_snap_pair(s, e, itemid2inst, grid, comp) for s, e in pairs]
    idx = [i for i, sn in enumerate(snapped) if sn is not None]
    out: List[Optional[Dict]] = [None] * len(pairs)
    if not idx:
        return out
    starts = np.array([[snapped[i][0][1], snapped[i][0][0]] for i in idx])
    goals = np.array([[snapped[i][1][1], snapped[i][1][0]] for i in idx])
    paths = plan_many(grid == 0, starts, goals, batch=wavefront_batch,
                      device=device)
    for i, path_yx in zip(idx, paths):
        if path_yx is None:
            continue
        path_xy = [(x, y) for (y, x) in path_yx]
        out[i] = {"start": pairs[i][0], "end": pairs[i][1],
                  "points": generate_trajectory_points(path_xy, scale,
                                                       min_x, min_y)}
    return out


# ---------------------------------------------------------------------------
# Instructions
# ---------------------------------------------------------------------------

def generate_instructions(client: LLMClient, scene_text: str, start_item: str,
                          end_item: str,
                          types: Sequence[str] = INSTRUCTION_TYPES) -> List[Dict]:
    """Template-driven instruction generation: ONE few-shot LLM call returns
    2-4 instructions per type as a JSON array (prompt_traj_to_instruction,
    the reference's loaded template vln_trajectory_generator.py:2306-2309),
    with per-type default fallback on failure (:1607-1643 retry; :2078-2111
    timeout-default substitution)."""
    msg = traj_to_instruction_messages(scene_text, start_item, end_item)
    text = client.chat_with_retry(msg)
    parsed = robust_json_parse(text) if text else None
    out: List[Dict] = []
    if isinstance(parsed, list):
        for entry in parsed:
            if not isinstance(entry, dict):
                continue
            instr = str(entry.get("generated_instruction", "")).strip()
            itype = str(entry.get("instruction_type", "")).strip()
            if instr and itype in types:
                out.append({"instruction_type": itype,
                            "start": str(entry.get("start", start_item)),
                            "end": str(entry.get("end", end_item)),
                            "generated_instruction": instr})
    covered = {rec["instruction_type"] for rec in out}
    for itype in types:              # default-substitute any missing type
        if itype not in covered:
            out.append({"instruction_type": "Default",
                        "start": start_item, "end": end_item,
                        "generated_instruction":
                        f"Navigate from the {start_item} to the {end_item}."})
    return out


def visualize_trajectory_png(grid: np.ndarray, points: List[Dict],
                             out_path, scale: float, min_x: float,
                             min_y: float, title: str = "") -> Optional[Path]:
    """Per-trajectory planning visualization (vln_trajectory_generator.py:
    2156-2188): obstacle grid + planned waypoints + start/end markers."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    xs = [(p["position"][0] - min_x) / scale for p in points]
    ys = [(p["position"][1] - min_y) / scale for p in points]
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(grid, cmap="gray_r", origin="lower", alpha=0.6)
    ax.plot(xs, ys, "-", color="#1f77b4", linewidth=1.5)
    ax.plot(xs[0], ys[0], "go", markersize=8, label="start")
    ax.plot(xs[-1], ys[-1], "r*", markersize=12, label="end")
    ax.set_title(title)
    ax.legend(loc="upper right", fontsize=8)
    fig.savefig(out_path, dpi=80, bbox_inches="tight")
    plt.close(fig)
    return out_path


# ---------------------------------------------------------------------------
# Scene processing with resume
# ---------------------------------------------------------------------------

def count_existing_trajectories(scene_out: Path, scene_key: str) -> int:
    """Resume helper (:797-832): count trajectories across part files."""
    total = 0
    for f in sorted(scene_out.glob("trajectories_*_part*.json")):
        try:
            with open(f) as fh:
                data = json.load(fh)
            for scene in data.get("scenes", []):
                total += len(scene.get("samples", []))
        except (json.JSONDecodeError, OSError):
            continue
    return total


def _existing_traj_pairs(scene_out: Path) -> List[Tuple[str, str]]:
    """(start, end) item pairs of every saved trajectory sample."""
    pairs = []
    for f in sorted(scene_out.glob("trajectories_*_part*.json")):
        try:
            with open(f) as fh:
                data = json.load(fh)
        except (json.JSONDecodeError, OSError):
            continue
        for scene in data.get("scenes", []):
            for sample in scene.get("samples", []):
                instr = sample.get("instructions") or [{}]
                s, e = instr[0].get("start"), instr[0].get("end")
                if s and e:
                    pairs.append((str(s), str(e)))
    return pairs


def check_endpoint_trajectory_pairs(scene_out: Path, scene_key: str,
                                    prefix: str = "gvln") -> Dict:
    """Reconciliation audit (vln_trajectory_generator.py:970-1060): compare
    the endpoint file against the trajectory part files and report the
    missing halves on each side."""
    scene_out = Path(scene_out)
    ep_file = scene_out / f"endpoints_{prefix}_{scene_key}.json"
    endpoints: List[Dict] = []
    if ep_file.exists():
        try:
            with open(ep_file) as f:
                endpoints = json.load(f)
        except (json.JSONDecodeError, OSError):
            endpoints = []
    ep_pairs = [(str(e["start"]), str(e["end"])) for e in endpoints
                if "start" in e and "end" in e]
    traj_pairs = _existing_traj_pairs(scene_out)
    traj_set = set(traj_pairs)
    ep_set = set(ep_pairs)
    return {
        "endpoint_file": str(ep_file),
        "endpoints": ep_pairs,
        "trajectories": traj_pairs,
        "missing_trajectories": [p for p in ep_pairs if p not in traj_set],
        "missing_endpoints": [p for p in traj_pairs if p not in ep_set],
    }


def reconcile_endpoints_trajectories(
    scene_key: str,
    sem_data: List[Dict],
    output_dir,
    client: Optional[LLMClient] = None,
    scene_text: str = "",
    prefix: str = "gvln",
) -> Dict:
    """Regenerate the missing half of each endpoint<->trajectory pair
    (vln_trajectory_generator.py:970-1060, 1687-1737): endpoints recorded
    without a saved trajectory get their paths re-planned and instructions
    regenerated into a new part file; trajectory pairs absent from the
    endpoint file are appended to it. Returns a summary of what was healed."""
    client = client or MockLLMClient()
    scene_out = Path(output_dir) / scene_key
    scene_out.mkdir(parents=True, exist_ok=True)
    audit = check_endpoint_trajectory_pairs(scene_out, scene_key, prefix)

    regenerated = 0
    if audit["missing_trajectories"]:
        grid, scale, min_x, min_y = build_2d_map(sem_data)
        if grid is not None:
            comp = build_connectivity(grid)
            itemid2inst = item_index(sem_data)
            next_id = count_existing_trajectories(scene_out, scene_key)
            samples = []
            for s, e in audit["missing_trajectories"]:
                rec = validate_and_generate_path(s, e, itemid2inst, grid,
                                                 scale, min_x, min_y,
                                                 comp=comp)
                if rec is None:
                    continue
                samples.append({
                    "trajectory_id": str(next_id + len(samples)),
                    "instructions": generate_instructions(client, scene_text,
                                                          s, e),
                    "points": rec["points"],
                })
            if samples:
                part_idx = len(list(
                    scene_out.glob("trajectories_*_part*.json")))
                payload = {"scenes": [{"scene_id": scene_key,
                                       "scene_name": scene_key,
                                       "samples": samples}]}
                with open(scene_out / f"trajectories_{prefix}_{scene_key}"
                          f"_part{part_idx}.json", "w") as f:
                    json.dump(payload, f, indent=2)
                regenerated = len(samples)

    appended = 0
    if audit["missing_endpoints"]:
        endpoints = [{"start": s, "end": e} for s, e in audit["endpoints"]]
        for s, e in audit["missing_endpoints"]:
            endpoints.append({"start": s, "end": e})
            appended += 1
        with open(Path(audit["endpoint_file"]), "w") as f:
            json.dump(endpoints, f, indent=2)

    return {"scene": scene_key, "regenerated_trajectories": regenerated,
            "appended_endpoints": appended,
            "missing_trajectories": len(audit["missing_trajectories"]),
            "missing_endpoints": len(audit["missing_endpoints"])}


def process_scene(
    scene_key: str,
    sem_data: List[Dict],
    output_dir,
    client: Optional[LLMClient] = None,
    scene_text: str = "",
    min_trajs: int = MIN_TRAJS_PER_SCENE,
    max_batches: int = 10,
    seed: int = 0,
    prefix: str = "gvln",
    visualize: bool = True,
    device=None,
) -> Dict:
    """Generate >= min_trajs trajectories for one scene, with incremental
    part-file saving, per-trajectory visualization PNGs, and resume.
    Batches of 4 or more judged pairs are planned by the wavefront planner on
    ``device`` (None means the card; raises without one); smaller ones by
    host A*. Returns a summary dict."""
    device = resolve_device(device)
    client = client or MockLLMClient()
    output_dir = Path(output_dir)
    scene_out = output_dir / scene_key
    scene_out.mkdir(parents=True, exist_ok=True)

    # Heal interrupted runs first: regenerate missing endpoint/trajectory
    # halves before counting (vln_trajectory_generator.py:1687-1737).
    reconcile_endpoints_trajectories(scene_key, sem_data, output_dir,
                                     client=client, scene_text=scene_text,
                                     prefix=prefix)

    existing_count = count_existing_trajectories(scene_out, scene_key)
    if existing_count >= min_trajs:
        return {"scene": scene_key, "trajectories": existing_count,
                "resumed": True}

    grid, scale, min_x, min_y = build_2d_map(sem_data)
    if grid is None:
        return {"scene": scene_key, "trajectories": 0, "error": "empty map"}
    comp = build_connectivity(grid)
    itemid2inst = item_index(sem_data)
    items = candidate_items(sem_data)

    rng = np.random.default_rng(seed)
    tried: set = set()
    samples: List[Dict] = []
    part_idx = len(list(scene_out.glob("trajectories_*_part*.json")))
    traj_id = existing_count
    endpoints: List[Dict] = []

    def flush_part():
        nonlocal part_idx, samples
        if not samples:
            return
        payload = {"scenes": [{"scene_id": scene_key, "scene_name": scene_key,
                               "samples": samples}]}
        with open(scene_out /
                  f"trajectories_{prefix}_{scene_key}_part{part_idx}.json",
                  "w") as f:
            json.dump(payload, f, indent=2)
        part_idx += 1
        samples = []

    for _ in range(max_batches):
        if traj_id - existing_count + len(samples) >= min_trajs:
            break
        pairs = generate_pairs(items, tried, rng)
        if not pairs:
            break
        tried.update(pairs)
        pairs = filter_pairs(pairs, itemid2inst)[:MAX_PAIRS_PER_BATCH]
        if not pairs:
            continue
        meaningful = judge_pairs_batch(client, pairs, scene_text)
        # Batched wavefront planning for multi-pair batches (one wavefront
        # per 16 pairs); serial A* kept for tiny batches.
        if len(meaningful) >= 4:
            recs = validate_and_generate_paths_batch(
                meaningful, itemid2inst, grid, scale, min_x, min_y, comp=comp,
                device=device)
        else:
            recs = [validate_and_generate_path(s, e, itemid2inst, grid, scale,
                                               min_x, min_y, comp=comp)
                    for s, e in meaningful]
        for (s, e), rec in zip(meaningful, recs):
            if rec is None:
                continue
            instructions = generate_instructions(client, scene_text, s, e)
            tid = str(traj_id + len(samples))
            samples.append({
                "trajectory_id": tid,
                "instructions": instructions,
                "points": rec["points"],
            })
            if visualize:
                visualize_trajectory_png(
                    grid, rec["points"],
                    scene_out / "visualization" / f"trajectory_{tid}.png",
                    scale, min_x, min_y,
                    title=f"{scene_key} #{tid}: {s} -> {e}")
            endpoints.append({"start": s, "end": e})
            if len(endpoints) % INCREMENTAL_SAVE_THRESHOLD == 0:
                with open(scene_out / f"endpoints_{prefix}_{scene_key}.json",
                          "w") as f:
                    json.dump(endpoints, f, indent=2)
            if traj_id - existing_count + len(samples) >= min_trajs:
                break
        traj_id += len(samples)
        flush_part()

    flush_part()
    with open(scene_out / f"endpoints_{prefix}_{scene_key}.json", "w") as f:
        json.dump(endpoints, f, indent=2)
    total = count_existing_trajectories(scene_out, scene_key)
    return {"scene": scene_key, "trajectories": total, "resumed": False}
