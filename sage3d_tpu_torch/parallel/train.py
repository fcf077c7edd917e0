"""Scene optimization: the single-device training step.

PyTorch counterpart of the single-chip path of ``sage3d_tpu/parallel/train.py``.
A step renders every camera of the batch, one after another, takes the
masked squared error against its target, and runs Adam on the five trainable
groups. The loss of a batch is the squared error summed over cameras, rows,
columns and channels, divided by ``B * H * W * 3``.

The state is mutable, as PyTorch's is: ``TrainState.params`` are leaf tensors
that ``opt_state`` (a ``torch.optim.Adam`` over them) updates in place, and a
step returns the same state with ``step`` advanced. The sharded step over a
(data x tile) mesh is not ported: a mesh of more than one device raises.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from ..ops.binning import TILE_H
from ..renderer.camera import Camera, unstack_cameras
from ..renderer.render import render
from ..renderer.scene import GaussianScene

TRAINABLE = ("means", "log_scales", "quats", "opacity_logits", "sh")

# Classic 3DGS per-group learning rates (positions far slower than opacity);
# ``means`` scales with the scene extent.
GROUP_LRS = {"means": 1.6e-4, "log_scales": 5e-3, "quats": 1e-3,
             "opacity_logits": 5e-2, "sh": 2.5e-3}


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt_state: torch.optim.Optimizer
    step: int


class Optimizer(NamedTuple):
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8), as a recipe:
    ``init(params)`` builds one ``torch.optim.Adam`` over the parameter
    tensors with one param group per key, at ``lr`` or, where ``group_lrs``
    names the key, at that rate."""

    lr: float = 1e-3
    group_lrs: Optional[Dict[str, float]] = None

    def lr_of(self, key: str) -> float:
        return self.group_lrs[key] if self.group_lrs is not None else self.lr

    def init(self, params: Dict[str, torch.Tensor]) -> torch.optim.Adam:
        groups = [{"params": [p], "lr": self.lr_of(k), "name": k}
                  for k, p in params.items()]
        return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


def make_optimizer(lr: float = 1e-3) -> Optimizer:
    return Optimizer(lr=lr)


def make_group_optimizer(extent: float = 1.0,
                         lrs: Dict[str, float] = GROUP_LRS) -> Optimizer:
    """Per-parameter-group Adam, the classic 3DGS schedule: one global rate
    either freezes opacity or throws positions around; scene fitting needs
    both ends of a ~300x spread at once."""
    return Optimizer(group_lrs={k: lr * (extent if k == "means" else 1.0)
                                for k, lr in lrs.items()})


def scene_params(scene: GaussianScene) -> Dict[str, torch.Tensor]:
    return {k: getattr(scene, k) for k in TRAINABLE}


def with_params(scene: GaussianScene,
                params: Dict[str, torch.Tensor]) -> GaussianScene:
    return scene._replace(**params)


def init_train_state(scene: GaussianScene,
                     optimizer: Optional[Optimizer] = None) -> TrainState:
    """Step 0: the scene's trainable tensors copied into leaves that require
    grad, and the optimizer over them."""
    optimizer = optimizer if optimizer is not None else make_optimizer()
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in scene_params(scene).items()}
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def pad_scene_to(scene: GaussianScene, multiple: int) -> GaussianScene:
    """Pad the Gaussian axis to a multiple of ``multiple`` with parked
    Gaussians (far away, transparent, unlabeled)."""
    n = scene.num_gaussians
    pad = (-n) % multiple
    if pad == 0:
        return scene

    def ext(x, value):
        fill = torch.full((pad,) + tuple(x.shape[1:]), value, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, fill])

    quats = ext(scene.quats, 0.0)
    quats[n:, 0] = 1.0
    return GaussianScene(
        means=ext(scene.means, 1e6),
        log_scales=ext(scene.log_scales, 0.0),
        quats=quats,
        opacity_logits=ext(scene.opacity_logits, -20.0),
        sh=ext(scene.sh, 0.0),
        semantic_ids=ext(scene.semantic_ids, -1),
    )


def _mesh_devices(mesh: Optional[Sequence[int]]) -> int:
    """The number of devices of a mesh given as None (one) or as a shape such
    as ``(n_data, n_tile)``."""
    return 1 if mesh is None else math.prod(int(s) for s in mesh)


def make_train_step(template: GaussianScene, camera: Camera, mesh=None,
                    optimizer: Optional[Optimizer] = None,
                    backend: str = "torch", **render_kw):
    """Build the train step.

    ``template`` supplies the non-trainable fields (semantic ids); ``camera``
    the intrinsics and resolution every camera of a batch shares. ``mesh``:
    None or a shape such as ``(1, 1)``; more than one device raises
    ``NotImplementedError`` (the sharded step, ROADMAP.md Queue 1 item 13).

    Returns (train_step, optimizer):
    ``train_step(state, cam_batch, targets (B, H, W, 3)) -> (state, loss)``;
    ``train_step.adc(...) -> (state, loss, gnorm)`` also returns the
    per-Gaussian norms of the ``means`` gradient (N,), the densification
    score. The loss is a detached scalar tensor; nothing waits for the device.
    """
    n_dev = _mesh_devices(mesh)
    if n_dev != 1:
        raise NotImplementedError(
            f"make_train_step: a mesh of {n_dev} devices needs the sharded "
            "train step, which is not ported yet (ROADMAP.md Queue 1, item "
            "13); pass mesh=None to train on one device")
    if optimizer is None:
        optimizer = make_optimizer()
    height, width = camera.height, camera.width
    band_h = -(-height // TILE_H) * TILE_H   # one band: the tile-padded frame

    def loss_and_grads(state: TrainState, cam_batch: Camera,
                       targets: torch.Tensor) -> torch.Tensor:
        """Backpropagate the batch loss camera by camera, so one camera's
        graph is freed before the next is rendered. Returns the loss."""
        params = state.params
        scene = with_params(template, params)
        n_px = targets.shape[0] * height * width * 3
        if targets.shape[1] < band_h:     # pad rows to the band grid
            targets = torch.nn.functional.pad(
                targets, (0, 0, 0, 0, 0, band_h - targets.shape[1]))
        mask = (torch.arange(band_h, device=targets.device) < height).to(
            torch.float32)[:, None, None]
        total = torch.zeros((), dtype=torch.float32, device=targets.device)
        for cam, target in zip(unstack_cameras(cam_batch), targets):
            out = render(scene, cam._replace(height=band_h), backend=backend,
                         clamp_dims=(width, height), **render_kw)
            err = torch.sum(((out["rgb"] - target[:band_h]) ** 2) * mask)
            (err / n_px).backward()
            total = total + err.detach()
        return total / n_px

    def _step(state, cam_batch, targets, adc: bool):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = loss_and_grads(state, cam_batch, targets)
        gnorm = None
        if adc:
            gnorm = torch.linalg.vector_norm(state.params["means"].grad, dim=-1)
        opt.step()
        return TrainState(state.params, opt, state.step + 1), loss, gnorm

    def train_step(state: TrainState, cam_batch: Camera,
                   targets: torch.Tensor):
        state, loss, _ = _step(state, cam_batch, targets, adc=False)
        return state, loss

    def train_step_adc(state: TrainState, cam_batch: Camera,
                       targets: torch.Tensor):
        """Like train_step, also returning the per-Gaussian norms of the
        positional gradient (N,)."""
        return _step(state, cam_batch, targets, adc=True)

    train_step.adc = train_step_adc
    return train_step, optimizer


def make_chained_steps(train_step, n_inner: int):
    """``n_inner`` train steps in a row. Returns run(state, cams, targets) ->
    (state, last_loss)."""
    def run(state: TrainState, cam_batch: Camera, targets: torch.Tensor):
        loss = None
        for _ in range(n_inner):
            state, loss = train_step(state, cam_batch, targets)
        return state, loss
    return run


def make_chained_adc_steps(train_step, n_inner: int):
    """``n_inner`` steps of ``train_step.adc`` in a row, summing the
    per-Gaussian positional-gradient norms for adaptive density control.
    Returns run(state, cams, targets) -> (state, gnorm_sum, last_loss)."""
    def run(state: TrainState, cam_batch: Camera, targets: torch.Tensor):
        acc = torch.zeros((state.params["means"].shape[0],),
                          dtype=torch.float32,
                          device=state.params["means"].device)
        loss = None
        for _ in range(n_inner):
            state, loss, gnorm = train_step.adc(state, cam_batch, targets)
            acc = acc + gnorm
        return state, acc, loss
    return run
