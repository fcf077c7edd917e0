"""Object-based success evaluation: semantic "did we reach the right object".

Re-implementation of the reference ObjectBasedSuccessEvaluator
(object_based_success.py:62-543) with identical decision logic:

  1. the episode's first instruction names an `end` object -> agent must stand
     inside that object's bbox expanded by ``expansion_radius`` (in 2D map
     coords, world position mapped back via the negate+mirror chain), AND be
     collision-free;
  2. no/unknown end object, or the labeled object is > 5 m from the agent
     (mislabel guard, :315-325) -> "smart position": candidate objects within
     2 m of the GT endpoint ranked by (category priority, distance), same
     containment + collision test (:370-507);
  3. no candidates -> 2D distance-to-endpoint <= expansion_radius (:447-466);
     and if even the endpoint is unavailable -> plain goal-radius test (:341-368).

Category priorities: screen/projector 1, table/desk 2, chair 3,
furniture/cabinet/shelf/bookcase 4, unable 10, default 5 (:509-543).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..physics.occupancy import check_collision_world
from ..utils.transforms import world_to_map_xy

SEARCH_RADIUS_M = 2.0
MISLABEL_DISTANCE_M = 5.0

_PRIORITY_RULES = (
    (("screen", "projector"), 1),
    (("table", "desk"), 2),
    (("chair",), 3),
    (("furniture", "cabinet", "shelf", "bookcase"), 4),
    (("unable",), 10),
)


def object_priority(item_id: str, category: str) -> int:
    text = f"{item_id} {category}".lower()
    for keywords, prio in _PRIORITY_RULES:
        if any(k in text for k in keywords):
            return prio
    return 5


class ObjectBasedSuccessEvaluator:
    """Semantic success evaluator over a 2D semantic map."""

    def __init__(self, semantic_map, collision_detector=None, verbose: bool = False):
        self.collision_detector = collision_detector
        self.verbose = verbose
        if isinstance(semantic_map, (str, Path)):
            self.semantic_map_path = str(semantic_map)
            with open(semantic_map) as f:
                self.map_data: List[Dict] = json.load(f)
        else:
            self.semantic_map_path = None
            self.map_data = list(semantic_map)

        self.by_item_id: Dict[str, Dict] = {
            obj["item_id"]: obj for obj in self.map_data if "item_id" in obj}

        xs, ys = [], []
        for inst in self.map_data:
            for y, x in inst.get("mask_coords_m", []):
                ys.append(float(y))
                xs.append(float(x))
        self.bounds = ((min(xs), max(xs), min(ys), max(ys)) if xs else None)

    # -- helpers ------------------------------------------------------------
    def _world_to_map(self, wx: float, wy: float) -> Tuple[float, float]:
        if self.bounds is None:
            return wx, wy
        return world_to_map_xy(wx, wy, self.bounds)

    def _bbox(self, object_id: str) -> Optional[List[float]]:
        obj = self.by_item_id.get(object_id)
        if obj is None:
            return None
        bbox = obj.get("bbox_m", [])
        return bbox if len(bbox) == 4 else None

    def _bbox_center(self, bbox: List[float]) -> np.ndarray:
        return np.array([(float(bbox[0]) + float(bbox[2])) / 2.0,
                         (float(bbox[1]) + float(bbox[3])) / 2.0])

    def _in_expanded_bbox(self, pos_world, bbox, expansion: float) -> bool:
        mx, my = self._world_to_map(float(pos_world[0]), float(pos_world[1]))
        return (float(bbox[0]) - expansion <= mx <= float(bbox[2]) + expansion
                and float(bbox[1]) - expansion <= my <= float(bbox[3]) + expansion)

    def _collision_free(self, pos_world) -> bool:
        """``collision_detector`` is an ``OccupancyGrid`` (physics/occupancy.py);
        the query runs on the grid's device. Any failure raises: a position
        never counts as collision-free because the test could not run."""
        if self.collision_detector is None:
            return True
        return not bool(check_collision_world(
            self.collision_detector,
            [float(pos_world[0]), float(pos_world[1])]))

    @staticmethod
    def extract_end_object_id(episode: Dict[str, Any]) -> Optional[str]:
        instructions = episode.get("instructions", [])
        if instructions and isinstance(instructions[0], dict):
            end = instructions[0].get("end")
            if end:
                return end
        # episodes_adapter flattens one instruction per episode with end_item
        end = episode.get("end_item")
        return end or None

    # -- main entry ---------------------------------------------------------
    def evaluate_success(self, current_position, episode: Dict[str, Any],
                         expansion_radius: float = 1.0) -> Tuple[bool, Dict]:
        info: Dict[str, Any] = {"method": "object_based", "end_object_id": None,
                                "object_found": False, "in_object_area": False,
                                "collision_free": False}
        end_id = self.extract_end_object_id(episode)
        info["end_object_id"] = end_id

        bbox = self._bbox(end_id) if end_id else None
        if bbox is None:
            info["fallback_to_smart_position"] = True
            ok, sub = self._smart_position_success(
                current_position, episode, expansion_radius)
            info.update(sub)
            return ok, info

        info["object_found"] = True
        in_area = self._in_expanded_bbox(current_position, bbox, expansion_radius)
        info["in_object_area"] = in_area

        if not in_area:
            # Mislabel guard: labeled object very far from the agent.
            mx, my = self._world_to_map(float(current_position[0]),
                                        float(current_position[1]))
            dist = float(np.linalg.norm(np.array([mx, my]) - self._bbox_center(bbox)))
            if dist > MISLABEL_DISTANCE_M:
                info["labeled_object_too_far"] = True
                info["distance_to_labeled_object"] = dist
                info["fallback_to_smart_position"] = True
                ok, sub = self._smart_position_success(
                    current_position, episode, expansion_radius)
                info.update(sub)
                return ok, info
            return False, info

        cf = self._collision_free(current_position)
        info["collision_free"] = cf
        return in_area and cf, info

    # -- fallbacks ----------------------------------------------------------
    def _smart_position_success(self, current_position, episode,
                                expansion_radius: float) -> Tuple[bool, Dict]:
        info: Dict[str, Any] = {"method": "smart_position", "found_candidates": 0,
                                "best_target": None, "final_success": False}
        gt = episode.get("gt_locations", [])
        if not gt:
            info["error"] = "no trajectory endpoint"
            return self._point_success(current_position, episode), info

        target = np.asarray(gt[-1], float)
        tx, ty = self._world_to_map(target[0], target[1])
        target_2d = np.array([tx, ty])
        info["target_2d"] = [tx, ty]

        candidates = []
        for obj in self.map_data:
            bbox = obj.get("bbox_m", [])
            if len(bbox) != 4:
                continue
            try:
                center = self._bbox_center(bbox)
            except (TypeError, ValueError):
                continue
            d = float(np.linalg.norm(center - target_2d))
            if d <= SEARCH_RADIUS_M:
                candidates.append({
                    "item_id": obj.get("item_id", ""),
                    "category": obj.get("category_label", ""),
                    "distance": d,
                    "priority": object_priority(obj.get("item_id", ""),
                                                obj.get("category_label", "")),
                    "bbox_m": bbox,
                })
        info["found_candidates"] = len(candidates)

        if not candidates:
            mx, my = self._world_to_map(float(current_position[0]),
                                        float(current_position[1]))
            d2 = float(np.linalg.norm(np.array([mx, my]) - target_2d))
            info["fallback_distance"] = d2
            ok = d2 <= expansion_radius
            info["final_success"] = ok
            return ok, info

        candidates.sort(key=lambda c: (c["priority"], c["distance"]))
        best = candidates[0]
        info["best_target"] = {k: best[k] for k in
                               ("item_id", "category", "distance", "priority")}
        if not self._in_expanded_bbox(current_position, best["bbox_m"],
                                      expansion_radius):
            return False, info
        if not self._collision_free(current_position):
            info["collision_free"] = False
            return False, info
        info["in_object_area"] = True
        info["collision_free"] = True
        info["final_success"] = True
        return True, info

    def _point_success(self, current_position, episode) -> bool:
        goals = episode.get("goals", [])
        if not goals:
            return False
        goal = np.asarray(goals[0]["position"], float)
        radius = float(goals[0].get("radius", 0.5))
        return float(np.linalg.norm(np.asarray(current_position, float) - goal)) < radius
