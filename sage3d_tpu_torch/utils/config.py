"""Typed configuration tree with CLI overrides.

The port's copy of ``sage3d_tpu/utils/config.py``; ``renderer.backend``
takes the port's backend names.

The reference has no unified config system — 45+ argparse flags in
run_benchmark.py:1964-2026, module-level constant blocks, preset dicts and env
vars (SURVEY.md 5.6). Here every subsystem reads one dataclass tree that can be
built from defaults, a JSON file, and dotted CLI overrides
(``--set renderer.tile_capacity=2048``), including the reference's
fast-mode bundles (run_benchmark.py:2052-2080).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class RendererConfig:
    backend: str = "auto"            # auto|oracle|torch|cuda (the JAX
                                     # package's auto|oracle|xla|pallas)
    width: int = 640                 # agent camera (simple_env.py:52)
    height: int = 480
    focal_mm: float = 8.0
    tile_capacity: int = 1024
    pair_capacity: int = 0           # 0 => heuristic
    sh_degree: int = -1              # -1 => scene's degree
    bg_color: tuple = (0.0, 0.0, 0.0)


@dataclass
class PhysicsConfig:
    robot_radius_m: float = 0.08     # runtime radius (simple_env.py:136-141)
    planning_radius_m: float = 0.2   # planner radius
    scale_m_per_px: float = 0.05
    disable_collision: bool = False  # --disable-collision debug mode


@dataclass
class BenchmarkConfig:
    max_steps: int = 200             # run_benchmark.py:1997
    hz: float = 30.0
    goal_radius: float = 0.5
    skip_completed: bool = True
    max_episodes: Optional[int] = None
    use_depth: bool = False
    record_video: bool = False
    output_dir: str = "outputs/benchmark"
    task_type: Optional[str] = None  # None => infer per episode
    instance_id: int = 0             # episode sharding across hosts —
    total_instances: int = 1         # implemented (reference documented only)


@dataclass
class PolicyConfig:
    model_type: str = "scripted"     # navdp|navila|navid|scripted
    host: str = "localhost"
    port: int = 55221
    history_frames: int = 8


@dataclass
class DataConfig:
    min_trajs_per_scene: int = 100
    seed: int = 42
    action_preset: str = "vlnce"
    samples_per_part: int = 10000
    image_width: int = 1024
    image_height: int = 768


@dataclass
class TrainConfig:
    lr: float = 1e-3
    mesh_shape: tuple = (1, 1)       # (data, tile)
    checkpoint_dir: str = "outputs/ckpt"
    checkpoint_every: int = 100


@dataclass
class Config:
    renderer: RendererConfig = field(default_factory=RendererConfig)
    physics: PhysicsConfig = field(default_factory=PhysicsConfig)
    benchmark: BenchmarkConfig = field(default_factory=BenchmarkConfig)
    policy: PolicyConfig = field(default_factory=PolicyConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    silent: bool = False             # SILENT_LOGGING_MODE equivalent

    def apply_fast_mode(self, level: str = "fast") -> "Config":
        """Reference performance tiers --fast-mode/--ultra-fast
        (run_benchmark.py:2052-2080): trade fidelity for speed."""
        if level == "fast":
            self.renderer.width, self.renderer.height = 320, 240
            self.benchmark.record_video = False
        elif level == "ultra":
            self.renderer.width, self.renderer.height = 160, 120
            self.benchmark.record_video = False
            self.benchmark.max_steps = 100
        return self


def _set_dotted(obj: Any, dotted: str, value: str) -> None:
    parts = dotted.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    name = parts[-1]
    current = getattr(obj, name)
    if isinstance(current, bool):
        value = value.lower() in ("1", "true", "yes", "on")
    elif isinstance(current, int) and not isinstance(current, bool):
        value = int(value)
    elif isinstance(current, float):
        value = float(value)
    elif isinstance(current, tuple):
        value = tuple(json.loads(value))
    elif current is None:
        if value.lower() == "none":
            value = None
        else:
            for cast in (int, float):
                try:
                    value = cast(value)
                    break
                except ValueError:
                    continue
    elif isinstance(current, str):
        value = None if value.lower() == "none" else value
    setattr(obj, name, value)


def load_config(json_path: Optional[str] = None,
                overrides: Optional[List[str]] = None) -> Config:
    """Defaults <- optional JSON file <- dotted key=value overrides."""
    cfg = Config()
    if json_path:
        with open(json_path) as f:
            data = json.load(f)

        def apply(obj, d):
            for k, v in d.items():
                if dataclasses.is_dataclass(getattr(obj, k, None)) and \
                        isinstance(v, dict):
                    apply(getattr(obj, k), v)
                else:
                    setattr(obj, k, tuple(v) if isinstance(
                        getattr(obj, k, None), tuple) else v)
        apply(cfg, data)
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        _set_dotted(cfg, key.strip(), val.strip())
    return cfg


def to_dict(cfg: Config) -> Dict:
    return dataclasses.asdict(cfg)
