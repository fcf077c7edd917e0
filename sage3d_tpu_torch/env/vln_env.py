"""GaussianVLNEnv: the VLN environment on the card.

PyTorch counterpart of ``sage3d_tpu/env/vln_env.py``, which replaces the
reference's Isaac-Sim-backed SimpleVLNEnv (simple_env.py, 3060 lines around
an external C++/CUDA engine) with a thin stateful wrapper over three cores:

  * rendering    -> renderer/render.py (RGB + depth + semantic in ONE pass; no
                    collision-mesh visibility toggling, no 5-strategy depth
                    fallback chain: simple_env.py:1356-1842 collapses to one
                    render call)
  * collision    -> physics/occupancy.py (EDT grid, the reference's primary
                    collision path) + ops/collision.py capsule queries
  * motion       -> physics/agent.py (vectorized micro-step semantics)

The environment keeps the reference's public surface (get_rgb/get_depth/
get_rgbd/apply_cmd_for/set_start_pose/get_agent_pos/get_yaw/
update_time_and_reset_collision/get_collision_count/load_scene/update_map) so
the benchmark runner, measures and policy clients port over unchanged. Sim time
advances by commanded duration (deterministic), not wall clock. The agent's
state stays on the env's device; the accessors that return host values
(``get_agent_pos``, ``get_yaw``, the collision counters, the frames) each read
it back once.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ..physics.agent import AgentState, apply_cmd, init_agent
from ..physics.occupancy import OccupancyGrid, grid_from_semantic_map
from ..renderer.camera import agent_camera_t
from ..renderer.render import budget_kwargs, render, rgb_to_uint8
from ..renderer.scene import GaussianScene, load_ply, resolve_device
from ..utils.transforms import yaw_from_world_quat


class GaussianVLNEnv:
    """Stateful env facade over the render, occupancy and agent cores.

    Args:
      scene: a GaussianScene (moved to ``device`` if it lies elsewhere), the
        path of a 3DGS PLY, or the ``manifest.json`` of a scene bundle
        (``data/scene_build.py``).
      map_json: 2D semantic map (path, instance list or OccupancyGrid) for
        collision; None disables collision (reference --disable-collision
        debug mode).
      width/height: agent camera resolution (reference default 640x480).
      backend: renderer backend; None means ``"cuda"`` on a CUDA device and
        ``"torch"`` on the CPU.
      device: where the scene, grid and agent live; None means the card
        (raises without one: pass ``device="cpu"`` for the CPU).
      budgets: an ``autotune_*`` budgets dict for the frames (through
        ``budget_kwargs``); None takes ``render``'s defaults, as the JAX env
        does; ``set_budgets`` replaces them (a hot swap to a denser scene
        needs budgets that cover it). ``total_overflow`` sums every frame's
        dropped pairs.
    """

    def __init__(
        self,
        scene,
        map_json=None,
        width: int = 640,
        height: int = 480,
        focal_mm: float = 8.0,
        hz: float = 30.0,
        backend: Optional[str] = None,
        robot_radius_m: float = 0.08,
        camera_height: float = 1.2,
        device=None,
        budgets: Optional[dict] = None,
    ):
        self.device = resolve_device(device)
        if backend is None:
            backend = "cuda" if self.device.type == "cuda" else "torch"
        self.backend = backend
        self.width = width
        self.height = height
        self.focal_mm = focal_mm
        self.hz = hz
        self.camera_height = camera_height
        self.robot_radius_m = robot_radius_m
        self.set_budgets(budgets)
        self.semantic_map_path: Optional[str] = None
        self.scene: GaussianScene = None
        self.grid: Optional[OccupancyGrid] = None
        self._video_frames = []
        self._record_video = False
        self.total_overflow = torch.zeros((), dtype=torch.int32,
                                          device=self.device)

        self.load_scene(scene)
        self.update_map(map_json)
        self.state: AgentState = init_agent([0.0, 0.0, 0.5], 0.0,
                                            device=self.device)

    # -- scene / map management (reference load_scene simple_env.py:1085,
    #    update_map :1116) ---------------------------------------------------
    def load_scene(self, scene) -> None:
        if isinstance(scene, GaussianScene):
            self.scene = GaussianScene(*(t.to(self.device) for t in scene))
        elif str(scene).endswith("manifest.json"):
            # scene-bundle directory (data/scene_build.py): PLY + labels
            from ..data.scene_build import load_scene_bundle
            self.scene, _ = load_scene_bundle(scene, device=self.device)
        else:
            self.scene = load_ply(scene, device=self.device)

    def set_budgets(self, budgets: Optional[dict]) -> None:
        """The frames' binning budgets from now on: an ``autotune_*`` dict,
        or None for ``render``'s defaults."""
        self.render_kw = budget_kwargs(budgets) if budgets else {}

    def update_map(self, map_json) -> None:
        self.semantic_map_path = map_json if isinstance(map_json, str) else None
        if map_json is None:
            self.grid = None
        elif isinstance(map_json, OccupancyGrid):
            self.grid = OccupancyGrid(*(t.to(self.device) for t in map_json))
        else:
            self.grid = grid_from_semantic_map(
                map_json, robot_radius_m=self.robot_radius_m,
                device=self.device)

    # -- pose ---------------------------------------------------------------
    def set_start_pose(self, position, rotation_xyzw) -> None:
        """Set agent pose from a trajectory point (position + remapped quat).

        Mirrors simple_env.py:1149-1195: the stored quaternion is decoded with
        the z->-x remap and the -pi generation offset (see utils/transforms).
        """
        qx, qy, qz, qw = [float(v) for v in rotation_xyzw]
        yaw = yaw_from_world_quat(qx, qy, qz, qw)
        pos = [float(position[0]), float(position[1]),
               float(position[2]) if len(position) > 2 else 0.5]
        self.state = init_agent(pos, yaw, device=self.device)
        self._video_frames = []

    def get_agent_pos(self) -> np.ndarray:
        return self.state.pos.cpu().numpy()

    def get_yaw(self) -> float:
        return float(self.state.yaw)

    # -- capture ------------------------------------------------------------
    @torch.no_grad()
    def render_frame(self) -> Dict[str, torch.Tensor]:
        """One render pass from the agent's pose: rgb + depth + semantic +
        alpha (geometry identical to agent_camera; tested)."""
        cam = agent_camera_t(
            self.state.pos[:2], self.state.yaw, width=self.width,
            height=self.height, focal_mm=self.focal_mm,
            camera_height=self.camera_height)
        out = render(self.scene, cam, backend=self.backend, **self.render_kw)
        self.total_overflow += out["overflow"]
        return out

    def get_rgb(self) -> np.ndarray:
        out = self.render_frame()
        frame = rgb_to_uint8(out["rgb"]).cpu().numpy()
        if self._record_video:
            self._video_frames.append(frame)
        return frame

    def get_depth(self) -> np.ndarray:
        return self.render_frame()["depth"].cpu().numpy()

    def get_rgbd(self):
        out = self.render_frame()
        rgb = rgb_to_uint8(out["rgb"]).cpu().numpy()
        if self._record_video:
            self._video_frames.append(rgb)
        return rgb, out["depth"].cpu().numpy()

    def get_semantic(self) -> np.ndarray:
        return self.render_frame()["semantic"].cpu().numpy()

    # -- stepping -----------------------------------------------------------
    def apply_cmd_for(self, vx: float, vy: float, yaw_rate: float,
                      duration_s: float) -> None:
        if self.grid is None:
            # collision disabled: integrate freely (reference
            # --disable-collision, simple_env.py:2682-2686)
            yaw = float(self.state.yaw)
            wvx = vx * math.cos(yaw) - vy * math.sin(yaw)
            wvy = vx * math.sin(yaw) + vy * math.cos(yaw)
            dist = math.hypot(wvx, wvy) * duration_s
            dist = min(dist, 0.20)
            norm = math.hypot(wvx, wvy) or 1.0
            new_pos = self.state.pos + torch.tensor(
                [wvx / norm * dist, wvy / norm * dist, 0.0],
                device=self.device)
            new_yaw = (yaw + yaw_rate * duration_s + math.pi) % (2 * math.pi) - math.pi
            self.state = self.state._replace(
                pos=new_pos,
                yaw=torch.tensor(new_yaw, dtype=torch.float32,
                                 device=self.device),
                time_s=self.state.time_s + duration_s,
                collision_detected=torch.zeros_like(
                    self.state.collision_detected))
            return
        self.state = apply_cmd(self.state, self.grid, vx, vy, yaw_rate,
                               duration_s)

    # -- bookkeeping surface used by measures/runner ------------------------
    def update_time_and_reset_collision(self) -> None:
        self.state = self.state._replace(collision_detected=torch.zeros_like(
            self.state.collision_detected))

    def reset_episode_time(self) -> None:
        self.state = self.state._replace(
            time_s=torch.zeros_like(self.state.time_s))

    def get_collision_count(self) -> int:
        return int(self.state.total_collisions)

    @property
    def consecutive_collisions(self) -> int:
        return int(self.state.consecutive_collisions)

    @property
    def collision_detected(self) -> bool:
        """Collision flag of the current step window (VLNEnvProtocol)."""
        return bool(self.state.collision_detected)

    @property
    def episode_time_s(self) -> float:
        """Sim-time seconds since episode start (VLNEnvProtocol)."""
        return float(self.state.time_s)

    # legacy aliases (reference SimpleVLNEnv private names); the measures and
    # runner read only the public VLNEnvProtocol members above
    @property
    def _collision_detected(self) -> bool:
        return self.collision_detected

    @property
    def _episode_start_time(self) -> float:
        return 0.0

    @property
    def _current_time(self) -> float:
        return self.episode_time_s

    # -- video --------------------------------------------------------------
    def start_video_recording(self) -> None:
        self._record_video = True
        self._video_frames = []

    def write_video(self, path: str, fps: int = 10) -> bool:
        """Write recorded frames (reference simple_env.py:2715-2759)."""
        if not self._video_frames:
            return False
        try:
            import imageio
            imageio.mimwrite(path, self._video_frames, fps=fps)
            return True
        except Exception:
            from PIL import Image
            base = path.rsplit(".", 1)[0]
            for i, f in enumerate(self._video_frames):
                Image.fromarray(f).save(f"{base}_{i:04d}.png")
            return True
