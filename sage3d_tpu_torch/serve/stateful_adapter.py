"""Stateful VLN adapter: frame history + pending-action queue (NaVid-style).

The port's copy of ``sage3d_tpu/serve/stateful_adapter.py``.

Reproduces the reference NaVid server's session behavior (navid_server.py:
76-482): a growing frame history, model output like "move forward 75 cm" or
"turn left 30 degree" expanded into up to 3 queued unit actions drained one per
request, a {"action": "reset"} message clearing state, and the action->velocity
mapping (0.25 m/s forward, 30 deg/s turn over 1 s). Wraps any text-generating
model callable, so an in-process policy or HF model slots in where NaVid's
torch checkpoint did.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional

from .mllm_server import MLLMAdapter

FORWARD_SPEED = 0.25     # m/s (navid_server.py:342-376)
TURN_RATE_DEG = 30.0     # deg/s
UNIT_FORWARD_CM = 25.0
UNIT_TURN_DEG = 30.0
MAX_QUEUED = 3


def parse_motion_text(text: str) -> List[str]:
    """'forward N cm' / 'left|right N degree' -> unit action list (<=3)
    (navid_server.py:228-270 extract_result + :296-334 queue expansion)."""
    t = text.lower()
    if any(w in t for w in ("stop", "done", "finish")):
        return ["STOP"]
    m = re.search(r"forward\s+(\d+\.?\d*)\s*(?:cm|centimeter)", t)
    if m:
        n = min(max(int(round(float(m.group(1)) / UNIT_FORWARD_CM)), 1),
                MAX_QUEUED)
        return ["MOVE_FORWARD"] * n
    m = re.search(r"forward\s+(\d+\.?\d*)\s*(?:m|meter)", t)
    if m:
        n = min(max(int(round(float(m.group(1)) * 100 / UNIT_FORWARD_CM)), 1),
                MAX_QUEUED)
        return ["MOVE_FORWARD"] * n
    m = re.search(r"(left|right)\s+(\d+\.?\d*)\s*(?:degree|deg|°)", t)
    if m:
        side = "TURN_LEFT" if m.group(1) == "left" else "TURN_RIGHT"
        n = min(max(int(round(float(m.group(2)) / UNIT_TURN_DEG)), 1),
                MAX_QUEUED)
        return [side] * n
    if "left" in t:
        return ["TURN_LEFT"]
    if "right" in t:
        return ["TURN_RIGHT"]
    return ["MOVE_FORWARD"]  # parse-failure default (navid_server.py:326-327)


def action_to_velocity(action: str) -> Dict[str, float]:
    if action == "MOVE_FORWARD":
        return {"vx": FORWARD_SPEED, "vy": 0.0, "yaw_rate": 0.0,
                "duration_s": 1.0, "stop": False}
    if action == "TURN_LEFT":
        return {"vx": 0.0, "vy": 0.0, "yaw_rate": math.radians(TURN_RATE_DEG),
                "duration_s": 1.0, "stop": False}
    if action == "TURN_RIGHT":
        return {"vx": 0.0, "vy": 0.0, "yaw_rate": -math.radians(TURN_RATE_DEG),
                "duration_s": 1.0, "stop": False}
    return {"vx": 0.0, "vy": 0.0, "yaw_rate": 0.0, "duration_s": 1.0,
            "stop": True}


class StatefulVLNAdapter(MLLMAdapter):
    """Frame-accumulating adapter with a pending-action queue."""

    def __init__(self, model_fn: Callable[[List, str], str],
                 max_history: Optional[int] = None):
        self.model_fn = model_fn
        self.max_history = max_history
        self.frame_history: List = []
        self.pending: List[str] = []

    def reset(self) -> None:
        self.frame_history = []
        self.pending = []

    def generate_response(self, images: List, instruction: str) -> str:
        self.frame_history.extend(images)
        if self.max_history is not None:
            self.frame_history = self.frame_history[-self.max_history:]
        if self.pending:
            return self.pending.pop(0)
        text = self.model_fn(self.frame_history, instruction)
        actions = parse_motion_text(text)
        self.pending = actions[1:]
        return actions[0]

    def extract_action(self, text: str) -> str:
        # generate_response already emits canonical actions
        return text if text in ("MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT",
                                "STOP") else super().extract_action(text)
