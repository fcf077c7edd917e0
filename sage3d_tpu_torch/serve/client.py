"""Modular policy client: (input x output x protocol) plug-in composition.

Re-implementation of the reference ModularVLMClient (vlm_client_modular.py:
44-696) with identical wire behavior and parsing math, so the TPU benchmark
can drive the reference's unmodified NaVILA/NaVid/MLLM/NavDP servers:

  * RGBInputProcessor: 8-frame sliding history with front-padding (:54-82)
  * RGBDInputProcessor: real or default-5m depth (:84-110)
  * TrajectoryOutputParser: waypoint direction averaging -> yaw_rate (x2 gain,
    clip 60 deg/s), first >1cm waypoint -> velocity (x3 gain, robot->world by
    yaw, 0.5 m/s cap) (:125-218)
  * TextOutputParser: stop/forward/turn/backward keyword + quantity regex
    parsing (:244-299)
  * SocketProtocol / HTTPProtocol wire formats (serve/protocol.py)
  * error fallback: stop-action dict, never raises (:601-611)
"""

from __future__ import annotations

import math
import re
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

import numpy as np

from .protocol import (encode_depth_png, encode_image_b64, socket_request)

MAX_SPEED = 0.5
MAX_YAW_RATE = math.radians(60)
TRAJ_SCALE = 3.0


class InputProcessor(ABC):
    @abstractmethod
    def process_input(self, rgb_images, depth_images=None, **kw) -> Dict[str, Any]: ...


class RGBInputProcessor(InputProcessor):
    def __init__(self, history_frames: int = 8, **_):
        self.history_frames = history_frames
        self.image_history: List = []

    def process_input(self, rgb_images, depth_images=None, **kw):
        if not rgb_images:
            raise ValueError("RGB image list is empty")
        current = rgb_images[0]
        self.image_history.append(current)
        self.image_history = self.image_history[-self.history_frames:]
        seq = self.image_history.copy()
        while len(seq) < self.history_frames:
            seq.insert(0, seq[0] if seq else current)
        return {"input_type": "rgb", "images": seq, "current_image": current}


class RGBDInputProcessor(InputProcessor):
    def __init__(self, **_):
        pass

    def process_input(self, rgb_images, depth_images=None, **kw):
        if not rgb_images:
            raise ValueError("RGB image list is empty")
        rgb = rgb_images[0]
        if depth_images:
            depth = np.asarray(depth_images[0], np.float32)
        else:
            h, w = (rgb.size[1], rgb.size[0]) if hasattr(rgb, "size") else (480, 640)
            depth = np.full((h, w), 5.0, np.float32)
        return {"input_type": "rgbd", "rgb_image": rgb, "depth_image": depth}


class OutputParser(ABC):
    @abstractmethod
    def parse_output(self, raw, current_yaw: float = 0.0, **kw) -> Dict[str, Any]: ...


class TrajectoryOutputParser(OutputParser):
    def parse_output(self, raw, current_yaw: float = 0.0, **kw):
        if isinstance(raw, dict) and "trajectory" in raw:
            traj = np.asarray(raw["trajectory"])
        else:
            traj = np.asarray(raw)
        if traj.ndim == 3 and traj.shape[0] == 1:
            traj = traj[0]
        vx, vy, yaw_rate = self._to_velocity(traj, current_yaw)
        return {"vx": vx, "vy": vy, "yaw_rate": yaw_rate, "duration_s": 1.0,
                "stop": False,
                "raw_response": f"Trajectory: {traj[0] if len(traj) else 'empty'}",
                "parsed_from": "trajectory"}

    @staticmethod
    def _to_velocity(traj: np.ndarray, current_yaw: float):
        if traj.ndim != 2 or traj.shape[1] < 3:
            return 0.0, 0.0, 0.0
        # Average the heading change of the first waypoint segments.
        yaw_rate = 0.0
        if len(traj) >= 3:
            dirs = []
            for i in range(min(5, len(traj) - 1)):
                dx = traj[i + 1][0] - traj[i][0]
                dy = traj[i + 1][1] - traj[i][1]
                if math.hypot(dx, dy) > 0.005:
                    dirs.append(math.atan2(dy, dx))
            if len(dirs) >= 2:
                changes = []
                for a, b in zip(dirs[:-1], dirs[1:]):
                    d = b - a
                    while d > math.pi:
                        d -= 2 * math.pi
                    while d < -math.pi:
                        d += 2 * math.pi
                    changes.append(d)
                if changes:
                    yaw_rate = float(np.clip(np.mean(changes) * 2.0,
                                             -MAX_YAW_RATE, MAX_YAW_RATE))
        # First waypoint farther than 1 cm sets the translation command.
        for i in range(len(traj)):
            x, y = float(traj[i][0]), float(traj[i][1])
            if math.hypot(x, y) > 0.01:
                robot_vx = -x * TRAJ_SCALE
                robot_vy = y * TRAJ_SCALE
                cos_y, sin_y = math.cos(current_yaw), math.sin(current_yaw)
                wx = robot_vx * cos_y - robot_vy * sin_y
                wy = robot_vx * sin_y + robot_vy * cos_y
                speed = math.hypot(wx, wy)
                if speed > MAX_SPEED:
                    wx *= MAX_SPEED / speed
                    wy *= MAX_SPEED / speed
                return wx, wy, yaw_rate
        return 0.0, 0.0, yaw_rate


class TextOutputParser(OutputParser):
    STOP_WORDS = ("stop", "halt", "complete", "finish", "done")
    FWD_WORDS = ("forward", "ahead", "straight", "move")
    BACK_WORDS = ("back", "backward", "reverse")

    def parse_output(self, raw, current_yaw: float = 0.0, **kw):
        if isinstance(raw, dict):
            text = raw.get("text_response", raw.get("text", raw.get("result", str(raw))))
        else:
            text = str(raw)
        action = self._parse(text)
        action["raw_response"] = text
        action["parsed_from"] = "text"
        return action

    def _parse(self, text: str) -> Dict[str, Any]:
        t = text.lower()
        action = {"vx": 0.0, "vy": 0.0, "yaw_rate": 0.0, "duration_s": 1.0,
                  "stop": False}
        if any(w in t for w in self.STOP_WORDS):
            action["stop"] = True
            return action
        if any(w in t for w in self.FWD_WORDS):
            m = re.search(r"(\d+\.?\d*)\s*(?:meter|metre|m|step)", t)
            if m:
                action["vx"] = min(float(m.group(1)) / action["duration_s"], MAX_SPEED)
            else:
                action["vx"] = 0.3
        left = "left" in t
        right = "right" in t
        if left or right:
            m = re.search(r"(\d+\.?\d*)\s*(?:degree|deg|°)", t)
            angle = math.radians(float(m.group(1))) if m else math.radians(30)
            action["yaw_rate"] = (angle if left else -angle) / action["duration_s"]
        if any(w in t for w in self.BACK_WORDS):
            action["vx"] = -0.2
        return action


class SocketProtocolClient:
    def send_request(self, processed, instruction, host, port, **kw):
        if processed["input_type"] != "rgb":
            raise ValueError("Socket protocol supports rgb input only")
        images = [encode_image_b64(img) for img in processed["images"]]
        return socket_request(host, port, {"images": images, "query": instruction})


class HTTPProtocolClient:
    def send_request(self, processed, instruction, host, port, **kw):
        import requests
        if processed["input_type"] == "rgbd":
            from .protocol import DEPTH_CLIP_M  # noqa: F401 (doc parity)
            import io as _io
            from PIL import Image
            rgb = processed["rgb_image"]
            if not hasattr(rgb, "save"):
                rgb = Image.fromarray(np.asarray(rgb).astype(np.uint8))
            buf = _io.BytesIO()
            # reference sends BGR-encoded JPEG (cv2 path); channel order only
            # matters to the server's decoder, which reverses it again
            rgb.convert("RGB").save(buf, format="JPEG")
            files = {
                "image": ("image.jpg", buf.getvalue(), "image/jpeg"),
                "depth": ("depth.png", encode_depth_png(processed["depth_image"]),
                          "image/png"),
            }
            r = requests.post(f"http://{host}:{port}/nogoal_step", files=files,
                              timeout=30)
            r.raise_for_status()
            return {"trajectory": np.asarray(r.json()["trajectory"])}
        images = processed.get("images") or [processed.get("current_image")]
        payload = {"images": [encode_image_b64(images[0])],
                   "instruction": instruction, "current_yaw": 0.0}
        r = requests.post(f"http://{host}:{port}/vln_step", json=payload,
                          timeout=60)
        r.raise_for_status()
        return {"text": r.json().get("result", "MOVE_FORWARD")}


PREDEFINED_CONFIGS = {
    "navdp": {"input_type": "rgbd", "output_type": "trajectory",
              "protocol": "http", "port": 8888},
    "navila": {"input_type": "rgb", "output_type": "text",
               "protocol": "socket", "port": 54321, "history_frames": 8},
    "navid": {"input_type": "rgb", "output_type": "trajectory",
              "protocol": "socket", "port": 54321, "history_frames": 8},
    "scripted": {"input_type": "rgb", "output_type": "text",
                 "protocol": "socket", "port": 55221, "history_frames": 8},
}


class ModularVLMClient:
    def __init__(self, input_type: str, output_type: str, protocol: str,
                 host: str = "localhost", port: int = 8888, **kwargs):
        self.input_type = input_type
        self.output_type = output_type
        self.protocol_type = protocol
        self.host = host
        self.port = port
        self.kwargs = kwargs
        self.input_processor = (RGBInputProcessor(**kwargs) if input_type == "rgb"
                                else RGBDInputProcessor(**kwargs))
        self.output_parser = (TrajectoryOutputParser() if output_type == "trajectory"
                              else TextOutputParser())
        self.protocol = (HTTPProtocolClient() if protocol == "http"
                         else SocketProtocolClient())
        if protocol == "http" and output_type == "trajectory" and (
                port == 8888 or kwargs.get("model_type") == "navdp"):
            self._init_navigator()

    def _init_navigator(self):
        """NavDP /navigator_reset handshake with pinhole intrinsics
        (vlm_client_modular.py:558-584)."""
        try:
            import requests
            intrinsic = [[525.0, 0.0, 320.0], [0.0, 525.0, 240.0], [0.0, 0.0, 1.0]]
            requests.post(f"http://{self.host}:{self.port}/navigator_reset",
                          json={"intrinsic": intrinsic, "stop_threshold": -0.5,
                                "batch_size": 1}, timeout=30)
        except Exception:
            pass

    def query(self, rgb_images, instruction: str, current_yaw: float = 0.0,
              depth_images=None, **kw) -> Dict[str, Any]:
        try:
            processed = self.input_processor.process_input(
                rgb_images, depth_images, **kw)
            raw = self.protocol.send_request(processed, instruction, self.host,
                                             self.port, **kw)
            return self.output_parser.parse_output(raw, current_yaw, **kw)
        except Exception as e:
            return {"vx": 0.0, "vy": 0.0, "yaw_rate": 0.0, "duration_s": 1.0,
                    "stop": True, "raw_response": f"Error: {e}",
                    "parsed_from": "error"}


def create_vlm_client(model_name: Optional[str] = None, input_type=None,
                      output_type=None, protocol=None, **kwargs) -> ModularVLMClient:
    if model_name and model_name in PREDEFINED_CONFIGS:
        config = PREDEFINED_CONFIGS[model_name].copy()
        config.update(kwargs)
        return ModularVLMClient(**config)
    if input_type and output_type and protocol:
        return ModularVLMClient(input_type, output_type, protocol, **kwargs)
    raise ValueError("Must provide model_name or (input_type, output_type, protocol)")


def query_vlm(images, instruction: str, host: str = "localhost", port: int = 8888,
              current_yaw: float = 0.0, depth_images=None, model_type=None,
              input_type=None, output_type=None, protocol=None, **kwargs):
    """One-shot query helper (vlm_client_modular.py:671-696)."""
    if input_type and output_type and protocol:
        client = create_vlm_client(input_type=input_type, output_type=output_type,
                                   protocol=protocol, host=host, port=port, **kwargs)
    elif model_type and model_type in PREDEFINED_CONFIGS:
        client = create_vlm_client(model_name=model_type, host=host, port=port,
                                   **kwargs)
    else:
        client = create_vlm_client(model_name="navdp", host=host, port=port,
                                   **kwargs)
    return client.query(images, instruction, current_yaw=current_yaw,
                        depth_images=depth_images, **kwargs)
