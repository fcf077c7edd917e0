"""Scene-optimization training loop: fit Gaussian scenes to target renders.

PyTorch counterpart of ``fit_scene``, ``psnr`` and ``make_orbit_targets`` in
``sage3d_tpu/parallel/trainer.py``: Adam over ``parallel/train.py``'s step,
with periodic checkpoints and resume, reporting PSNR. One device; adaptive
density control (``fit_scene_adaptive``) is not ported yet.

``TrainerConfig`` carries only ``pair_capacity`` and ``tile_capacity`` of the
render budgets, as in the JAX package: a dense scene at full width, whose
budgets come from ``autotune_all``, trains through ``make_train_step(...,
**budget_kwargs(budgets))`` directly.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..renderer.camera import Camera, make_camera, stack_cameras
from ..renderer.render import render
from ..renderer.scene import GaussianScene
from .checkpoint import restore_train_state, save_train_state
from .train import (make_group_optimizer, make_optimizer, make_train_step,
                    init_train_state, pad_scene_to, with_params)


@dataclass
class TrainerConfig:
    lr: float = 1e-3
    steps: int = 200
    mesh_shape: tuple = (1, 1)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    log_every: int = 20
    backend: str = "torch"
    pair_capacity: int = 1 << 20
    tile_capacity: int = 1024
    group_lrs: bool = False     # classic 3DGS per-group rates (see
    scene_extent: float = 1.0   # parallel.train.make_group_optimizer)

    def make_opt(self):
        if self.group_lrs:
            return make_group_optimizer(extent=self.scene_extent)
        return make_optimizer(self.lr)


def psnr(mse: float) -> float:
    return 10.0 * math.log10(1.0 / max(mse, 1e-12))


def fit_scene(scene: GaussianScene, cameras: Camera, targets: torch.Tensor,
              config: TrainerConfig = TrainerConfig(), verbose: bool = True):
    """Optimize ``scene`` so its renders match ``targets`` (B, H, W, 3).

    Returns (fitted_scene, history). Resumes from ``config.checkpoint_dir``
    if it holds a checkpoint."""
    template = pad_scene_to(scene, max(config.mesh_shape[1], 1))
    opt = config.make_opt()
    train_step, _ = make_train_step(
        template, cameras, mesh=config.mesh_shape, optimizer=opt,
        backend=config.backend, pair_capacity=config.pair_capacity,
        tile_capacity=config.tile_capacity)
    state = init_train_state(template, opt)
    if config.checkpoint_dir:
        restored = restore_train_state(config.checkpoint_dir, state)
        if restored is not None:
            state = restored
            if verbose:
                print(f"[trainer] resumed at step {state.step}")

    history = []
    t0 = time.time()
    for step in range(state.step, config.steps):
        state, loss = train_step(state, cameras, targets)
        if (step + 1) % config.log_every == 0 or step + 1 == config.steps:
            mse = float(loss)
            history.append({"step": step + 1, "mse": mse, "psnr": psnr(mse),
                            "elapsed_s": time.time() - t0})
            if verbose:
                h = history[-1]
                print(f"[trainer] step {h['step']} mse={h['mse']:.6f} "
                      f"psnr={h['psnr']:.2f}dB t={h['elapsed_s']:.1f}s")
        if config.checkpoint_dir and (step + 1) % config.checkpoint_every == 0:
            save_train_state(config.checkpoint_dir, state)
    if config.checkpoint_dir:
        save_train_state(config.checkpoint_dir, state)

    fitted = with_params(template, {k: v.detach()
                                    for k, v in state.params.items()})
    return fitted, history


@torch.no_grad()
def make_orbit_targets(scene: GaussianScene, n_views: int = 4,
                       radius: float = 5.0, width: int = 128,
                       height: int = 128, backend: str = "torch"):
    """Ground-truth targets rendered from an orbit of cameras, one camera
    after another (test and demo data). Returns (cameras, targets)."""
    cams = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        pos = [radius * np.cos(ang), radius * np.sin(ang), 1.5]
        cams.append(make_camera(pos, [-np.cos(ang), -np.sin(ang), -0.1],
                                width=width, height=height,
                                device=scene.device))
    targets = torch.stack([render(scene, c, backend=backend)["rgb"]
                           for c in cams])
    return stack_cameras(cams), targets
