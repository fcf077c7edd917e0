"""Scene-optimization training loop: fit Gaussian scenes to target renders.

PyTorch counterpart of ``fit_scene``, ``fit_scene_adaptive``, ``with_capacity``,
``psnr`` and ``make_orbit_targets`` in ``sage3d_tpu/parallel/trainer.py``:
Adam over ``parallel/train.py``'s step, with periodic checkpoints and resume,
reporting PSNR, and the same loop with classic 3DGS adaptive density control
(``parallel/densify.py``) inside a fixed slot capacity. One device: a mesh of
more than one device raises the train step's ``NotImplementedError``.

``TrainerConfig`` carries ``pair_capacity`` and ``tile_capacity`` of the
render budgets, as in the JAX package, and optionally a whole ``budgets``
dict (``autotune_*``'s, passed through ``budget_kwargs``, with its emission
tiers); ``budgets=None`` keeps the JAX package's behaviour, where the
emission tiers are ``render``'s defaults.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..renderer.camera import Camera, make_camera, stack_cameras
from ..renderer.render import budget_kwargs, render
from ..renderer.scene import GaussianScene
from .checkpoint import restore_train_state, save_train_state
from .densify import (DEAD_LOGIT, PARK_POS, DensifyConfig, accumulate,
                      densify_prune, init_densify_state, reset_opacity,
                      zero_opacity_moments)
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
    budgets: Optional[dict] = None  # autotune_* budgets; overrides the two
                                    # capacities above when given

    def make_opt(self):
        if self.group_lrs:
            return make_group_optimizer(extent=self.scene_extent)
        return make_optimizer(self.lr)

    def render_kw(self) -> dict:
        """The render budgets the train step is built with."""
        if self.budgets is not None:
            return budget_kwargs(self.budgets)
        return {"pair_capacity": self.pair_capacity,
                "tile_capacity": self.tile_capacity}


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
        backend=config.backend, **config.render_kw())
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


@dataclass
class AdaptiveConfig:
    densify_every: int = 50       # 0 = never
    densify_until: int = 10_000   # no density control after this step
    opacity_reset_every: int = 0  # 0 = never
    grad_threshold: float = 2e-4
    split_scale: float = 0.05
    prune_opacity: float = 0.005
    max_new_fraction: float = 0.1


def with_capacity(scene: GaussianScene, capacity: int) -> GaussianScene:
    """Pad ``scene`` to a fixed slot capacity; extra slots are PARKED (dead)
    so adaptive density control can grow into them without reallocation."""
    n = scene.num_gaussians
    assert capacity >= n
    pad = capacity - n
    if pad == 0:
        return scene

    def ext(x, value):
        fill = torch.full((pad,) + tuple(x.shape[1:]), value, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, fill])

    quats = ext(scene.quats, 0.0)
    quats[n:, 0] = 1.0
    return GaussianScene(
        means=ext(scene.means, PARK_POS),
        log_scales=ext(scene.log_scales, 0.0),
        quats=quats,
        opacity_logits=ext(scene.opacity_logits, DEAD_LOGIT),
        sh=ext(scene.sh, 0.0),
        semantic_ids=ext(scene.semantic_ids, -1),
    )


def fit_scene_adaptive(scene: GaussianScene, cameras: Camera,
                       targets: torch.Tensor,
                       config: TrainerConfig = TrainerConfig(),
                       adaptive: AdaptiveConfig = AdaptiveConfig(),
                       capacity: Optional[int] = None, seed: int = 0,
                       verbose: bool = True):
    """fit_scene + classic 3DGS adaptive density control (densify/prune).

    ``capacity`` fixes the slot count (default 2x the initial scene); live
    Gaussians grow and shrink inside it (parallel/densify.py), written in
    place into the tensors the optimizer holds. ``seed`` seeds the CPU
    generator of the split noise. Returns (fitted_scene, history); a
    density-control round's entry also carries n_alive, n_new, n_pruned,
    n_split and n_clone."""
    cap = capacity or 2 * scene.num_gaussians
    template = pad_scene_to(with_capacity(scene, cap),
                            max(config.mesh_shape[1], 1))
    opt = config.make_opt()
    train_step, _ = make_train_step(
        template, cameras, mesh=config.mesh_shape, optimizer=opt,
        backend=config.backend, **config.render_kw())
    state = init_train_state(template, opt)
    dstate = init_densify_state(template.num_gaussians,
                                device=template.means.device)
    dcfg = DensifyConfig(grad_threshold=adaptive.grad_threshold,
                         split_scale=adaptive.split_scale,
                         prune_opacity=adaptive.prune_opacity,
                         max_new_fraction=adaptive.max_new_fraction)
    gen = torch.Generator().manual_seed(seed)
    semantic_ids = template.semantic_ids

    history = []
    t0 = time.time()
    for step in range(config.steps):
        state, loss, gnorm = train_step.adc(state, cameras, targets)
        dstate = accumulate(dstate, gnorm[:, None])
        info = None
        if adaptive.densify_every \
                and (step + 1) % adaptive.densify_every == 0 \
                and step + 1 <= adaptive.densify_until:
            _, dstate, _, semantic_ids, info = densify_prune(
                state.params, dstate, gen, dcfg, opt_state=state.opt_state,
                semantic_ids=semantic_ids)
        if adaptive.opacity_reset_every and \
                (step + 1) % adaptive.opacity_reset_every == 0:
            reset_opacity(state.params)
            zero_opacity_moments(state.opt_state)
        if (step + 1) % config.log_every == 0 or info is not None \
                or step + 1 == config.steps:
            mse = float(loss)
            h = {"step": step + 1, "mse": mse, "psnr": psnr(mse),
                 "elapsed_s": time.time() - t0}
            if info is not None:
                h.update({k: int(v) for k, v in info.items()})
            history.append(h)
            if verbose:
                extra = (f" alive={h['n_alive']} new={h['n_new']} "
                         f"pruned={h['n_pruned']}" if info is not None
                         else "")
                print(f"[trainer/adc] step {h['step']} "
                      f"mse={h['mse']:.6f} psnr={h['psnr']:.2f}dB{extra}")

    fitted = with_params(template, {k: v.detach()
                                    for k, v in state.params.items()})
    return fitted._replace(semantic_ids=semantic_ids), history


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
