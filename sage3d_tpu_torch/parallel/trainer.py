"""Scene-optimization training loop: fit Gaussian scenes to target renders.

PyTorch counterpart of ``fit_scene``, ``fit_scene_adaptive``, ``with_capacity``,
``psnr`` and ``make_orbit_targets`` in ``sage3d_tpu/parallel/trainer.py``:
Adam over ``parallel/train.py``'s step, with periodic checkpoints and resume,
reporting PSNR, and the same loop with classic 3DGS adaptive density control
(``parallel/densify.py``) inside a fixed slot capacity.

``TrainerConfig.mesh_shape`` of more than one rank trains over a (data x
tile) mesh (``parallel/mesh.py``): inside a process group the loop runs as
the calling rank, on its rows of the global batch (``shard_rows``) with the
sharded train step; outside one it runs under ``spawn_mesh`` and returns
rank 0's fitted scene and history. A density-control round gathers the
parameters, their Adam moments and the gradient score, runs
``densify_prune`` on the full rows identically on every rank (the same CPU
generator), checks that every rank's scene is bitwise rank 0's, and writes
each rank's rows back in place into the shards and moments its Adam holds.

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
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..renderer.camera import Camera, make_camera, stack_cameras
from ..renderer.render import budget_kwargs, render_batch
from ..renderer.scene import GaussianScene
from .checkpoint import restore_train_state, save_train_state
from .densify import (DEAD_LOGIT, PARK_POS, DensifyConfig, DensifyState,
                      accumulate, densify_prune, init_densify_state,
                      reset_opacity, zero_opacity_moments)
from .mesh import Mesh, all_gather, broadcast, make_mesh, shard_rows, spawn_mesh
from .train import (TRAINABLE, make_group_optimizer, make_optimizer,
                    make_train_step, init_train_state, pad_scene_to,
                    with_params)


@dataclass
class TrainerConfig:
    lr: float = 1e-3
    steps: int = 200
    mesh_shape: tuple = (1, 1)
    gather: str = "params"      # the sharded layout (parallel.train.GATHERS)
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


def _spawned(mesh_shape) -> bool:
    """A mesh of more than one rank, outside a process group: the fit runs
    under ``spawn_mesh``."""
    return math.prod(mesh_shape) > 1 and not dist.is_initialized()


def _mesh_of(mesh_shape, device) -> Optional[Mesh]:
    """The mesh of a fit inside a process group; None for one rank."""
    return make_mesh(mesh_shape, device=device) \
        if math.prod(mesh_shape) > 1 else None


def _full_params(params, mesh: Optional[Mesh]) -> dict:
    """The trainable tensors, detached; gathered over "tile" on a mesh."""
    if mesh is None:
        return {k: v.detach() for k, v in params.items()}
    return {k: all_gather(v.detach(), mesh, "tile", tag="fitted")
            for k, v in params.items()}


def fit_scene(scene: GaussianScene, cameras: Camera, targets: torch.Tensor,
              config: TrainerConfig = TrainerConfig(), verbose: bool = True):
    """Optimize ``scene`` so its renders match ``targets`` (B, H, W, 3).

    Returns (fitted_scene, history). Resumes from ``config.checkpoint_dir``
    if it holds a checkpoint (of any mesh shape). ``cameras`` and
    ``targets`` are the global batch; B must divide over the mesh's data
    axis. Outside a process group, a ``mesh_shape`` of more than one rank
    runs under ``spawn_mesh`` on ``scene``'s kind of device (on cards, each
    rank takes a card of its own where there are enough)."""
    if _spawned(config.mesh_shape):
        return spawn_mesh(_fit_scene, config.mesh_shape, scene, cameras,
                          targets, config, verbose, device=scene.device.type)
    return _fit_scene(scene, cameras, targets, config, verbose,
                      mesh=_mesh_of(config.mesh_shape, scene.device))


def _fit_scene(scene, cameras, targets, config, verbose, mesh=None):
    template = pad_scene_to(scene, max(config.mesh_shape[1], 1))
    opt = config.make_opt()
    cams = shard_rows(cameras, mesh, "data")
    targets = shard_rows(targets, mesh, "data")
    train_step, _ = make_train_step(
        template, cams, mesh=mesh, optimizer=opt, backend=config.backend,
        gather=config.gather, **config.render_kw())
    state = init_train_state(template, opt, mesh)
    verbose = verbose and (mesh is None or mesh.rank == 0)
    if config.checkpoint_dir:
        restored = restore_train_state(config.checkpoint_dir, state,
                                       mesh=mesh)
        if restored is not None:
            state = restored
            if verbose:
                print(f"[trainer] resumed at step {state.step}")

    history = []
    t0 = time.time()
    for step in range(state.step, config.steps):
        state, loss = train_step(state, cams, targets)
        if (step + 1) % config.log_every == 0 or step + 1 == config.steps:
            mse = float(loss)
            history.append({"step": step + 1, "mse": mse, "psnr": psnr(mse),
                            "elapsed_s": time.time() - t0})
            if verbose:
                h = history[-1]
                print(f"[trainer] step {h['step']} mse={h['mse']:.6f} "
                      f"psnr={h['psnr']:.2f}dB t={h['elapsed_s']:.1f}s")
        if config.checkpoint_dir and (step + 1) % config.checkpoint_every == 0:
            save_train_state(config.checkpoint_dir, state, mesh=mesh)
    if config.checkpoint_dir:
        save_train_state(config.checkpoint_dir, state, mesh=mesh)

    fitted = with_params(template, _full_params(state.params, mesh))
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
    n_split and n_clone. Meshes as in ``fit_scene``."""
    if _spawned(config.mesh_shape):
        return spawn_mesh(_fit_scene_adaptive, config.mesh_shape, scene,
                          cameras, targets, config, adaptive, capacity, seed,
                          verbose, device=scene.device.type)
    return _fit_scene_adaptive(scene, cameras, targets, config, adaptive,
                               capacity, seed, verbose,
                               mesh=_mesh_of(config.mesh_shape, scene.device))


def _fit_scene_adaptive(scene, cameras, targets, config, adaptive, capacity,
                        seed, verbose, mesh=None):
    cap = capacity or 2 * scene.num_gaussians
    template = pad_scene_to(with_capacity(scene, cap),
                            max(config.mesh_shape[1], 1))
    opt = config.make_opt()
    cams = shard_rows(cameras, mesh, "data")
    targets = shard_rows(targets, mesh, "data")
    train_step, _ = make_train_step(
        template, cams, mesh=mesh, optimizer=opt, backend=config.backend,
        gather=config.gather, **config.render_kw())
    state = init_train_state(template, opt, mesh)
    dstate = init_densify_state(state.params["means"].shape[0],
                                device=template.means.device)
    dcfg = DensifyConfig(grad_threshold=adaptive.grad_threshold,
                         split_scale=adaptive.split_scale,
                         prune_opacity=adaptive.prune_opacity,
                         max_new_fraction=adaptive.max_new_fraction)
    gen = torch.Generator().manual_seed(seed)
    semantic_ids = template.semantic_ids
    verbose = verbose and (mesh is None or mesh.rank == 0)

    history = []
    t0 = time.time()
    for step in range(config.steps):
        state, loss, gnorm = train_step.adc(state, cams, targets)
        dstate = accumulate(dstate, gnorm[:, None])
        info = None
        if adaptive.densify_every \
                and (step + 1) % adaptive.densify_every == 0 \
                and step + 1 <= adaptive.densify_until:
            if mesh is None:
                _, dstate, _, semantic_ids, info = densify_prune(
                    state.params, dstate, gen, dcfg,
                    opt_state=state.opt_state, semantic_ids=semantic_ids)
            else:
                dstate, semantic_ids, info = _sharded_round(
                    state, dstate, gen, dcfg, semantic_ids, mesh)
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

    fitted = with_params(template, _full_params(state.params, mesh))
    return fitted._replace(semantic_ids=semantic_ids), history


class _FullRows(NamedTuple):
    """What ``densify_prune`` reads of an optimizer (``param_groups`` and
    ``state``), over full-row copies of the parameters and their moments."""
    param_groups: list
    state: dict


@torch.no_grad()
def _sharded_round(state, dstate: DensifyState, gen, dcfg: DensifyConfig,
                   semantic_ids, mesh: Mesh):
    """One density-control round on a mesh: gather the parameters, their
    Adam moments and the gradient score over "tile", run ``densify_prune``
    on the full rows (the same on every rank), check that every rank's scene
    is bitwise rank 0's, and write this rank's rows back in place into its
    shards and the moments its Adam holds. Returns (state of the score,
    semantic_ids, info)."""
    opt = state.opt_state
    full = {k: all_gather(state.params[k].detach(), mesh, "tile",
                          tag="round") for k in TRAINABLE}
    moments = {k: {name: all_gather(v, mesh, "tile", tag="round")
                   for name, v in opt.state.get(state.params[k], {}).items()
                   if torch.is_tensor(v) and v.dim() >= 1}
               for k in TRAINABLE}
    accum = all_gather(dstate.grad_accum, mesh, "tile", tag="round")
    view = _FullRows([{"params": [full[k]]} for k in TRAINABLE],
                     {full[k]: moments[k] for k in TRAINABLE})
    _, _, _, semantic_ids, info = densify_prune(
        full, DensifyState(accum, dstate.n_steps), gen, dcfg, opt_state=view,
        semantic_ids=semantic_ids)
    bits = torch.cat([full[k].reshape(-1).view(torch.int32)
                      for k in TRAINABLE] + [semantic_ids.reshape(-1)])
    if not torch.equal(broadcast(bits.clone(), mesh, 0, tag="replicas"),
                       bits):
        raise RuntimeError(f"rank {mesh.rank}: the scene after density "
                           "control differs from rank 0's")
    for k in TRAINABLE:
        p = state.params[k]
        p.copy_(shard_rows(full[k], mesh, "tile"))
        for name, v in moments[k].items():
            opt.state[p][name].copy_(shard_rows(v, mesh, "tile"))
    return (init_densify_state(dstate.grad_accum.shape[0],
                               device=dstate.grad_accum.device),
            semantic_ids, info)


@torch.no_grad()
def make_orbit_targets(scene: GaussianScene, n_views: int = 4,
                       radius: float = 5.0, width: int = 128,
                       height: int = 128, backend: str = "torch"):
    """Ground-truth targets rendered from an orbit of cameras by
    ``render_batch`` (on the ``cuda`` backend one batched render; test and
    demo data). Returns (cameras, targets)."""
    cams = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        pos = [radius * np.cos(ang), radius * np.sin(ang), 1.5]
        cams.append(make_camera(pos, [-np.cos(ang), -np.sin(ang), -0.1],
                                width=width, height=height,
                                device=scene.device))
    cams = stack_cameras(cams)
    return cams, render_batch(scene, cams, backend=backend)["rgb"]
