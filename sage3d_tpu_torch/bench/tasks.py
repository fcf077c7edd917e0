"""Navigation task types: VLN, ObjectNav, PointNav, ImgNav, NoGoalNav.

Re-implementation of the reference task system (task_types.py:15-433): same
registry, same task-type inference from episode shape, same success predicates
and episode adaptation, so benchmark JSONs evaluate identically.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List

import numpy as np

DEFAULT_EXPLORE_INSTRUCTION = (
    "Explore this environment as much as possible, but avoid colliding with "
    "objects, walls, etc., and maintain safe navigation.")

_OBJECT_KEYWORDS = [
    ("folder", "folder"), ("window", "window"), ("chair", "chair"),
    ("screen", "projection_screen"), ("projection", "projection_screen"),
    ("notebook", "notebook"), ("cup", "cup"),
]


class NavigationTask(ABC):
    def __init__(self, task_config: Dict[str, Any] | None = None):
        self.task_config = task_config or {}
        self.task_type = self.__class__.__name__.lower().replace("task", "")

    @abstractmethod
    def get_instruction(self, episode: Dict[str, Any], step: int = 0) -> str: ...

    @abstractmethod
    def get_goal_position(self, episode: Dict[str, Any]) -> np.ndarray: ...

    @abstractmethod
    def get_goal_radius(self, episode: Dict[str, Any]) -> float: ...

    @abstractmethod
    def is_success(self, current_pos: np.ndarray, episode: Dict[str, Any],
                   **kwargs) -> bool: ...

    def get_task_specific_metrics(self) -> List[str]:
        return []

    def get_progress_info(self, current_pos, episode, step: int = 0) -> str:
        d = np.linalg.norm(np.asarray(current_pos)
                           - self.get_goal_position(episode))
        return f"Distance to goal: {d:.2f}m"


def _episode_instruction(episode: Dict[str, Any], step: int) -> str | None:
    instructions = episode.get("instructions", [])
    if not instructions:
        return None
    idx = step % len(instructions) if len(instructions) > 1 else 0
    sel = instructions[idx]
    if isinstance(sel, dict):
        return sel.get("generated_instruction")
    return sel


class VLNTask(NavigationTask):
    def get_instruction(self, episode, step=0):
        text = _episode_instruction(episode, step)
        if text is not None:
            return text
        return episode.get("instruction", {}).get(
            "instruction_text", "Navigate to the destination")

    def get_goal_position(self, episode):
        points = episode.get("points", [])
        if points:
            return np.asarray(points[-1]["position"], float)
        if episode.get("goals"):
            return np.asarray(episode["goals"][0]["position"], float)
        return np.zeros(3)

    def get_goal_radius(self, episode):
        return self.task_config.get("goal_radius", 0.5)

    def is_success(self, current_pos, episode, **kw):
        d = np.linalg.norm(np.asarray(current_pos) - self.get_goal_position(episode))
        return d < self.get_goal_radius(episode)

    def get_task_specific_metrics(self):
        return ["instruction_following_score", "semantic_alignment"]


class ObjectNavTask(NavigationTask):
    def get_instruction(self, episode, step=0):
        return f"Find the {episode.get('target_object', 'unknown object')}"

    def get_goal_position(self, episode):
        return np.asarray(episode.get("target_object_position",
                                      episode.get("goal_position", [0, 0, 0])), float)

    def get_goal_radius(self, episode):
        return self.task_config.get("goal_radius", 1.0)

    def is_success(self, current_pos, episode, **kw):
        d = np.linalg.norm(np.asarray(current_pos) - self.get_goal_position(episode))
        return d <= self.get_goal_radius(episode)

    def get_task_specific_metrics(self):
        return ["object_detection_accuracy", "view_success_rate"]


class PointNavTask(NavigationTask):
    def get_instruction(self, episode, step=0):
        g = self.get_goal_position(episode)
        return f"Navigate to coordinates ({g[0]:.2f}, {g[1]:.2f}, {g[2]:.2f})"

    def get_goal_position(self, episode):
        return np.asarray(episode.get("goal_position", [0, 0, 0]), float)

    def get_goal_radius(self, episode):
        return self.task_config.get("goal_radius", 0.2)

    def is_success(self, current_pos, episode, **kw):
        d = np.linalg.norm(np.asarray(current_pos) - self.get_goal_position(episode))
        return d < self.get_goal_radius(episode)

    def get_task_specific_metrics(self):
        return ["coordinate_accuracy", "path_efficiency"]


class ImgNavTask(NavigationTask):
    def get_instruction(self, episode, step=0):
        return "Navigate to the location that matches the target image"

    def get_goal_position(self, episode):
        return np.asarray(episode.get("target_image_position",
                                      episode.get("goal_position", [0, 0, 0])), float)

    def get_goal_radius(self, episode):
        return self.task_config.get("goal_radius", 1.0)

    def is_success(self, current_pos, episode, **kw):
        d = np.linalg.norm(np.asarray(current_pos) - self.get_goal_position(episode))
        if d > self.get_goal_radius(episode):
            return False
        current = kw.get("current_image")
        target = episode.get("target_image")
        if current is not None and target is not None:
            return self._image_similarity(current, target) > \
                self.task_config.get("similarity_threshold", 0.8)
        return True

    def _image_similarity(self, img1, img2) -> float:
        """Mean-normalized correlation of downsampled grayscale images.

        The reference stubs this at a constant 0.85 (task_types.py:201-204);
        here it is a real (if simple) similarity so ImgNav is exercisable.
        """
        a = np.asarray(img1, np.float32)
        b = np.asarray(img2, np.float32)
        if a.shape != b.shape:
            return 0.0
        a = a - a.mean()
        b = b - b.mean()
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        if denom == 0:
            return 1.0
        return float(np.clip((a * b).sum() / denom * 0.5 + 0.5, 0.0, 1.0))

    def get_task_specific_metrics(self):
        return ["image_similarity_score", "visual_alignment"]


class NoGoalNavTask(NavigationTask):
    def __init__(self, task_config=None):
        super().__init__(task_config)
        self.visited_positions: List[np.ndarray] = []
        self.max_episode_time = self.task_config.get("max_episode_time", 80.0)
        self.collision_penalty = self.task_config.get("collision_penalty", True)

    def get_instruction(self, episode, step=0):
        text = _episode_instruction(episode, step)
        if isinstance(text, str) and text:
            return text
        return DEFAULT_EXPLORE_INSTRUCTION

    def get_goal_position(self, episode):
        points = episode.get("points", [])
        if points:
            return np.asarray(points[0]["position"], float)
        return np.array([0.0, 0.0, 0.5])

    def get_goal_radius(self, episode):
        return self.task_config.get("goal_radius", 0.5)

    def is_success(self, current_pos, episode, **kw):
        if self.collision_penalty and kw.get("collision_detected", False):
            return False
        if kw.get("episode_time", 0.0) >= self.max_episode_time:
            return True
        return kw.get("exploration_coverage", 0.0) >= \
            self.task_config.get("min_exploration_coverage", 0.25)

    def should_terminate_episode(self, **kw) -> bool:
        if self.collision_penalty and kw.get("collision_detected", False):
            return True
        return kw.get("episode_time", 0.0) >= self.max_episode_time

    def update_exploration_state(self, current_pos, step: int):
        self.visited_positions.append(np.array(current_pos, float))

    def calculate_exploration_coverage(self, visited_positions,
                                       grid_size: float = 0.5) -> float:
        if not visited_positions:
            return 0.0
        cells = {(int(p[0] / grid_size), int(p[1] / grid_size))
                 for p in visited_positions}
        return min(len(cells) / 400.0, 1.0)

    def get_task_specific_metrics(self):
        return ["episode_time", "explored_areas", "exploration_coverage",
                "collision_count"]


class TaskTypeManager:
    TASK_TYPES = {
        "vln": VLNTask,
        "objectnav": ObjectNavTask,
        "pointnav": PointNavTask,
        "imgnav": ImgNavTask,
        "nogoalnav": NoGoalNavTask,
    }

    @classmethod
    def create_task(cls, task_type: str, task_config=None) -> NavigationTask:
        key = task_type.lower()
        if key not in cls.TASK_TYPES:
            raise ValueError(f"Unsupported task type: {task_type}. "
                             f"Supported: {list(cls.TASK_TYPES)}")
        return cls.TASK_TYPES[key](task_config or {})

    @classmethod
    def infer_task_type(cls, episode: Dict[str, Any]) -> str:
        """Infer the task from episode shape (task_types.py:333-365)."""
        if episode.get("task_type") == "no_goal_exploration":
            return "nogoalnav"
        # Adapted episodes (bench/episodes.py) carry the instruction type at
        # the top level — a Goal-less instruction is a no-goal episode there
        # too, not just in the raw GVLN {"instructions": [...]} shape.
        if episode.get("instruction_type") == "Goal-less":
            return "nogoalnav"
        instructions = episode.get("instructions")
        if instructions:
            if isinstance(instructions[0], dict) and \
                    instructions[0].get("instruction_type", "") == "Goal-less":
                return "nogoalnav"
            return "vln"
        if "target_object" in episode:
            return "objectnav"
        if "target_image" in episode:
            return "imgnav"
        if "goal_position" in episode:
            return "pointnav"
        return "vln"

    @classmethod
    def get_supported_tasks(cls) -> List[str]:
        return list(cls.TASK_TYPES)


def adapt_episode_for_task(episode: Dict[str, Any], task_type: str) -> Dict[str, Any]:
    """Fill task-specific fields from a VLN episode (task_types.py:373-433)."""
    ep = episode.copy()
    t = task_type.lower()
    if t == "objectnav":
        text = ""
        instructions = episode.get("instructions", [])
        if instructions and isinstance(instructions[0], str):
            text = instructions[0].lower()
        elif not instructions:
            text = episode.get("instruction", {}).get("instruction_text", "").lower()
        ep["target_object"] = next(
            (name for kw, name in _OBJECT_KEYWORDS if kw in text), "unknown")
        if episode.get("points"):
            ep["target_object_position"] = episode["points"][-1]["position"]
    elif t == "pointnav":
        ep["goal_position"] = (episode["points"][-1]["position"]
                               if episode.get("points") else [0, 0, 0])
    elif t == "imgnav":
        if episode.get("points"):
            ep["target_image_position"] = episode["points"][-1]["position"]
    elif t == "nogoalnav":
        ep["start_position"] = (episode["points"][0]["position"]
                                if episode.get("points") else [0, 0, 0])
    return ep
