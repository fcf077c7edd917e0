"""Scene optimization: the train step, on one device or over a mesh.

PyTorch counterpart of ``sage3d_tpu/parallel/train.py``. A step renders
every camera of the batch, takes the masked squared error against its
target, and runs Adam on the five trainable groups. On the ``cuda`` backend
the batch is one batched render (``render_batch``: one launch each of K1,
K2, K3 and K4 for the cameras, as the JAX package's ``jax.vmap`` over them)
and one ``backward``; the ``torch`` and ``oracle`` backends render and
backpropagate camera by camera, so one camera's graph is freed before the
next is built. The loss of a batch is the squared error summed over cameras,
rows, columns and channels, divided by ``B * H * W * 3``.

The state is mutable, as PyTorch's is: ``TrainState.params`` are leaf tensors
that ``opt_state`` (a ``torch.optim.Adam`` over them) updates in place, and a
step returns the same state with ``step`` advanced.

Over a (data x tile) ``Mesh`` (``parallel/mesh.py``) the step is the JAX
package's FSDP-style layout: the parameters and the Adam moments are split
into row shards over "tile" (each rank's Adam holds only its shard, as ZeRO
does); a step all-gathers them once, in ``grad_buckets`` row chunks, renders
this rank's band of rows for each of its cameras (its rows of the batch over
"data"), reduce-scatters the gradients once in the same chunks over "tile"
and all-reduces them over "data". Without a mesh (or on a one-rank mesh) the
step renders the whole frame on one device with no collective.

``gather="splats"`` selects the second sharded layout, for scenes whose
parameters no rank can gather whole: each rank projects only its own row
shard (under autograd), the ranks all-gather the projected splats (ten
differentiable values and four of metadata a Gaussian, against 59 raw
parameters), each renders its band from them, and the splats' gradients
are reduce-scattered back to the shard owners, whose projection backward
gives the parameter gradients. Both layouts give the same loss, gradients
and parameters up to the band's rounding of the 2D means (a band projects
with its shifted camera in the parameter layout and shifts the full frame's
means here) and the order of the sums.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from ..ops.binning import TILE_H
from ..ops.projection import ProjectedGaussians, project_gaussians
from ..renderer.camera import (Camera, slice_cameras, stack_cameras,
                               unstack_cameras)
from ..renderer.render import (camera_groups, render, render_batch,
                               render_projected)
from ..renderer.scene import GaussianScene
from ..utils.profiling import count as add_count, span
from .mesh import (Mesh, all_reduce, gather_into, make_mesh,
                   reduce_scatter_into, shard_rows)

TRAINABLE = ("means", "log_scales", "quats", "opacity_logits", "sh")

# The sharded step's layouts: gather the raw parameters (the JAX package's)
# or the projected splats.
GATHERS = ("params", "splats")
# A projected splat as the splat layout gathers it: the differentiable
# fields (means2d 2, conics 3, depth, colour 3, opacity) and the metadata
# (extents 2, radius, visible), float32 each.
SPLAT_DIFF = 10
SPLAT_META = 4

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
    names the key, at that rate; ``eps`` is Adam's (optax's ``eps``)."""

    lr: float = 1e-3
    group_lrs: Optional[Dict[str, float]] = None
    eps: float = 1e-8

    def lr_of(self, key: str) -> float:
        return self.group_lrs[key] if self.group_lrs is not None else self.lr

    def init(self, params: Dict[str, torch.Tensor]) -> torch.optim.Adam:
        groups = [{"params": [p], "lr": self.lr_of(k), "name": k}
                  for k, p in params.items()]
        return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=self.eps)


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
                     optimizer: Optional[Optimizer] = None,
                     mesh: Optional[Mesh] = None,
                     tile_axis: str = "tile") -> TrainState:
    """Step 0: the scene's trainable tensors copied into leaves that require
    grad, and the optimizer over them. On a mesh, each leaf is this rank's
    row shard over ``tile_axis`` (N / n_tile rows of the padded scene), and
    the optimizer holds only the shards."""
    optimizer = optimizer if optimizer is not None else make_optimizer()
    params = {k: shard_rows(v, mesh, tile_axis).detach().clone()
              .requires_grad_(True) for k, v in scene_params(scene).items()}
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


def _buckets(rows: int, n_buckets: int) -> list:
    """Row ranges of the gather buckets: ``n_buckets`` equal chunks, or one
    where the rows do not divide (as in the JAX package)."""
    if n_buckets <= 1 or rows % n_buckets:
        return [(0, rows)]
    c = rows // n_buckets
    return [(i * c, (i + 1) * c) for i in range(n_buckets)]


class _AllGatherBucketed(torch.autograd.Function):
    """Forward: one gather per bucket of rows; the full tensor is rank-major
    (rank r's shard at rows r*s .. (r+1)*s), bitwise one monolithic gather.
    Backward: one reduce-scatter per bucket, in the same chunks."""

    @staticmethod
    def forward(ctx, x, mesh, axis, n_buckets, tag):
        n, s = mesh.axis_size(axis), x.shape[0]
        ctx.mesh, ctx.axis, ctx.tag = mesh, axis, tag
        ctx.buckets = _buckets(s, n_buckets)
        out = x.new_empty((n, s) + tuple(x.shape[1:]))
        for a, b in ctx.buckets:
            gather_into([out[r, a:b] for r in range(n)], x[a:b].contiguous(),
                        mesh, axis, tag)
        return out.view((n * s,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        n = ctx.mesh.axis_size(ctx.axis)
        grad = grad.contiguous().view((n, -1) + tuple(grad.shape[1:]))
        gx = grad.new_empty(grad.shape[1:])
        for a, b in ctx.buckets:
            reduce_scatter_into(gx[a:b], [grad[r, a:b] for r in range(n)],
                                ctx.mesh, ctx.axis, ctx.tag)
        return gx, None, None, None, None


def all_gather_bucketed(x: torch.Tensor, mesh: Mesh, axis: str,
                        n_buckets: int, tag: str = "params") -> torch.Tensor:
    """All-gather the row shards ``x`` over ``axis`` in ``n_buckets`` row
    chunks: ``n_buckets`` collectives whose gradient is ``n_buckets``
    independent reduce-scatters, the bucketed gradient reduction of the JAX
    package. One gather where the shard's rows do not divide by
    ``n_buckets``. Differentiable in ``x``."""
    return _AllGatherBucketed.apply(x, mesh, axis, n_buckets, tag)


def pack_splats(proj: ProjectedGaussians):
    """A projection of B cameras ((B, s, ...) fields) as the rows the splat
    layout gathers: (s, B * SPLAT_DIFF) differentiable values and
    (s, B * SPLAT_META) metadata (extents, radius, visible as floats; the
    radii and flags are small integers, exact in float32)."""
    diff = torch.cat([proj.means2d, proj.conics, proj.depths[..., None],
                      proj.colors, proj.opacities[..., None]], -1)
    meta = torch.cat([proj.extents, proj.radii[..., None].to(torch.float32),
                      proj.visible[..., None].to(torch.float32)], -1)
    s = diff.shape[1]
    return (diff.transpose(0, 1).reshape(s, -1),
            meta.detach().transpose(0, 1).reshape(s, -1))


def band_splats(diff: torch.Tensor, meta: torch.Tensor, n_cams: int,
                y0: int, band_h: int) -> ProjectedGaussians:
    """The gathered rows (N, B * SPLAT_DIFF) and (N, B * SPLAT_META) as the
    (B, N, ...) projection of a band of ``band_h`` image rows from row
    ``y0``: the means shifted up by ``y0``, and a splat visible where it was
    in the frame and its extent box reaches into the band (radius and
    extents zero elsewhere, as ``project_gaussians`` gives a band
    camera)."""
    n = diff.shape[0]
    d = diff.view(n, n_cams, SPLAT_DIFF).transpose(0, 1)
    m = meta.view(n, n_cams, SPLAT_META).transpose(0, 1)
    v = d[..., 1] - float(y0)
    ext = m[..., 0:2]
    visible = ((m[..., 3] > 0) & (v + ext[..., 1] > 0)
               & (v - ext[..., 1] < band_h))
    return ProjectedGaussians(
        means2d=torch.stack([d[..., 0], v], -1),
        conics=d[..., 2:5],
        depths=d[..., 5],
        radii=torch.where(visible, m[..., 2], 0.0).to(torch.int32),
        colors=d[..., 6:9],
        opacities=d[..., 9],
        visible=visible,
        extents=torch.where(visible[..., None], ext, 0.0))


def _proj_rows(proj: ProjectedGaussians, sl) -> ProjectedGaussians:
    """Cameras ``sl`` (an index or a slice) of a batched projection."""
    return ProjectedGaussians(*(f[sl] for f in proj))


def _as_mesh(mesh, force_shard_map: bool, device) -> Optional[Mesh]:
    """The mesh the step runs on, or None for the direct path: no mesh, a
    one-rank shape such as ``(1, 1)``, or a one-rank ``Mesh`` unless
    ``force_shard_map``. A shape of more than one rank raises: its ranks
    are processes, each passing its ``Mesh``."""
    if mesh is not None and not isinstance(mesh, Mesh):
        shape = tuple(int(s) for s in mesh)
        if math.prod(shape) > 1:
            raise ValueError(
                f"make_train_step: a mesh of shape {shape} runs one process "
                "per rank: run it under spawn_mesh (parallel/mesh.py) and "
                "pass each rank's Mesh, or pass mesh=None for one device")
        mesh = make_mesh(shape, device=device) if force_shard_map else None
    if mesh is not None and mesh.size == 1 and not force_shard_map:
        return None
    return mesh


def make_train_step(template: GaussianScene, camera: Camera, mesh=None,
                    optimizer: Optional[Optimizer] = None,
                    data_axis: str = "data", tile_axis: str = "tile",
                    backend: str = "torch", grad_buckets: int = 4,
                    force_shard_map: bool = False, gather: str = "params",
                    **render_kw):
    """Build the train step.

    ``template`` supplies the non-trainable fields (semantic ids) and the
    shapes, padded so that N divides the mesh's tile axis (``pad_scene_to``);
    ``camera`` the intrinsics and resolution every camera of a batch shares.
    ``mesh``: None or a one-rank shape such as ``(1, 1)`` for the direct
    path; this rank's ``Mesh`` for the sharded step. A shape of more than
    one rank raises ``ValueError``: run the ranks under ``spawn_mesh``.
    ``force_shard_map`` takes the collective path on a one-rank mesh (its
    cost without communication).

    On a mesh, the state is ``init_train_state(template, optimizer, mesh)``;
    the cameras and targets a rank passes are its own rows of the batch over
    ``data_axis`` (``global_batch_from_local``, or ``shard_rows`` of a global
    batch). A step issues ``grad_buckets`` all-gathers and reduce-scatters
    per trainable group over ``tile_axis``, one all-reduce of each group's
    gradient over ``data_axis``, and one all-reduce of the loss over every
    rank, whatever the batch; every rank returns the same loss.

    ``gather`` picks the sharded layout: ``"params"`` (the JAX package's,
    above) or ``"splats"``: each rank projects its own row shard, a step
    issues ``grad_buckets`` all-gathers of the splats' values and as many of
    their metadata, and ``grad_buckets`` reduce-scatters of their gradients,
    over ``tile_axis``; the all-reduces over ``data_axis`` and of the loss
    are the same. Without a mesh both are the direct path.

    Returns (train_step, optimizer):
    ``train_step(state, cam_batch, targets (B, H, W, 3)) -> (state, loss)``;
    ``train_step.adc(...) -> (state, loss, gnorm)`` also returns the norms of
    the ``means`` gradient rows this rank holds (N,) or (N / n_tile,), the
    densification score. The loss is a detached scalar tensor.
    """
    if gather not in GATHERS:
        raise ValueError(f"make_train_step: gather must be one of {GATHERS},"
                         f" got {gather!r}")
    mesh = _as_mesh(mesh, force_shard_map, template.device)
    if optimizer is None:
        optimizer = make_optimizer()
    height, width = camera.height, camera.width
    n_data = n_tile = 1
    band = 0
    if mesh is not None:
        n_data, n_tile = mesh.shape[data_axis], mesh.shape[tile_axis]
        band = mesh.axis_index(tile_axis)
    tiles_h = -(-height // TILE_H)              # tile rows of the frame
    band_h = -(-tiles_h // n_tile) * TILE_H     # image rows per band
    y0 = band * band_h
    # rows past the true image height are band-grid padding: masked
    mask = (torch.arange(y0, y0 + band_h, device=template.device)
            < height).to(torch.float32)[:, None, None]

    def band_error(scene, cam_batch, targets, n_px) -> torch.Tensor:
        """Backpropagate the masked error of this band / n_px: on the
        ``cuda`` backend one batched render of the band cameras and one
        backward, else camera by camera, so one camera's graph is freed
        before the next is rendered. Returns the summed error, detached."""
        if targets.shape[1] < n_tile * band_h:    # pad rows to the band grid
            targets = torch.nn.functional.pad(
                targets, (0, 0, 0, 0, 0, n_tile * band_h - targets.shape[1]))
        if backend == "cuda":
            cams = cam_batch._replace(cy=cam_batch.cy - y0, height=band_h)
            with span("train.forward"):
                out = render_batch(scene, cams, backend=backend,
                                   clamp_dims=(width, height), **render_kw)
            with span("train.loss"):
                err = torch.sum(((out["rgb"] - targets[:, y0:y0 + band_h])
                                 ** 2) * mask)
            if err.requires_grad:   # else no Gaussian reaches this band
                with span("train.backward"):
                    (err / n_px).backward()
            return err.detach()
        total = torch.zeros((), dtype=torch.float32, device=targets.device)
        for cam, target in zip(unstack_cameras(cam_batch), targets):
            if y0:
                cam = cam._replace(cy=cam.cy - y0)
            with span("train.forward"):
                out = render(scene, cam._replace(height=band_h),
                             backend=backend, clamp_dims=(width, height),
                             **render_kw)
            with span("train.loss"):
                err = torch.sum(((out["rgb"] - target[y0:y0 + band_h]) ** 2)
                                * mask)
            if err.requires_grad:   # else no Gaussian reaches this band
                with span("train.backward"):
                    (err / n_px).backward()
            total = total + err.detach()
        return total

    def direct_loss(state: TrainState, cam_batch, targets) -> torch.Tensor:
        n_px = targets.shape[0] * height * width * 3
        scene = with_params(template, state.params)
        return band_error(scene, cam_batch, targets, n_px) / n_px

    def sharded_loss(state: TrainState, cam_batch, targets) -> torch.Tensor:
        """Gather the shards once, backpropagate every camera into the
        gathered leaves, then reduce-scatter their gradients once over the
        tile axis (into the shards' ``.grad``) and all-reduce them over the
        data axis."""
        n_px = targets.shape[0] * n_data * height * width * 3
        full = {k: all_gather_bucketed(state.params[k], mesh, tile_axis,
                                       grad_buckets) for k in TRAINABLE}
        leaves = {k: v.detach().requires_grad_(True) for k, v in full.items()}
        total = band_error(with_params(template, leaves), cam_batch, targets,
                           n_px)
        for k in TRAINABLE:
            g = leaves[k].grad
            full[k].backward(g if g is not None
                             else torch.zeros_like(leaves[k]))
            all_reduce(state.params[k].grad, mesh, data_axis, tag="grads")
        return all_reduce(total, mesh, None, tag="loss") / n_px

    # the splat layout projects with the frame's clamp and renders the rest
    proj_kw = {k: v for k, v in render_kw.items() if k == "sh_degree"}
    band_kw = {k: v for k, v in render_kw.items()
               if k not in ("sh_degree", "clamp_dims")}

    def splat_error(proj: ProjectedGaussians, cams, targets, n_px):
        """Backpropagate the masked error of this band / n_px from the
        band's splats: on the ``cuda`` backend one render a group of
        cameras, else camera by camera. Returns the summed error,
        detached."""
        if targets.shape[1] < n_tile * band_h:    # pad rows to the band grid
            targets = torch.nn.functional.pad(
                targets, (0, 0, 0, 0, 0, n_tile * band_h - targets.shape[1]))
        if backend == "cuda":
            parts = [(sl, slice_cameras(cams, sl)) for sl in camera_groups(
                cams.position.shape[0], proj.depths.shape[1])]
        else:
            parts = list(enumerate(unstack_cameras(cams)))
        total = torch.zeros((), dtype=torch.float32, device=targets.device)
        for sl, cam in parts:
            with span("train.forward"):
                out = render_projected(_proj_rows(proj, sl),
                                       template.semantic_ids, cam,
                                       backend=backend, **band_kw)
            with span("train.loss"):
                err = torch.sum(((out["rgb"] - targets[sl, y0:y0 + band_h])
                                 ** 2) * mask)
            if err.requires_grad:   # else no Gaussian reaches this band
                with span("train.backward"):
                    (err / n_px).backward()
            total = total + err.detach()
        return total

    def splat_loss(state: TrainState, cam_batch, targets) -> torch.Tensor:
        """Project this rank's shard, gather the splats, render this band
        from them and backpropagate into the gathered splats; then
        reduce-scatter the splats' gradients to their owners over the tile
        axis, run the shard's projection backward into its ``.grad`` and
        all-reduce that over the data axis."""
        n_px = targets.shape[0] * n_data * height * width * 3
        n_cams = cam_batch.position.shape[0]
        shard = GaussianScene(**state.params,
                              semantic_ids=shard_rows(template.semantic_ids,
                                                      mesh, tile_axis))
        cams = cam_batch if cam_batch.position.dim() == 2 else \
            stack_cameras([cam_batch])
        with span("train.project_shard"):
            proj = project_gaussians(shard, cams, clamp_dims=(width, height),
                                     **proj_kw)
            diff, meta = pack_splats(proj)
        rows = diff.detach().requires_grad_(True)
        with span("train.gather_splats"):
            full = all_gather_bucketed(rows, mesh, tile_axis, grad_buckets,
                                       tag="splats")
            full_meta = all_gather_bucketed(meta, mesh, tile_axis,
                                            grad_buckets, tag="splat_meta")
        leaves = full.detach().requires_grad_(True)
        band_cams = cams._replace(cy=cams.cy - y0, height=band_h)
        total = splat_error(band_splats(leaves, full_meta, n_cams, y0, band_h),
                            band_cams, targets, n_px)
        with span("train.scatter_splat_grads"):
            full.backward(leaves.grad if leaves.grad is not None
                          else torch.zeros_like(leaves))
        with span("train.project_shard"):
            diff.backward(rows.grad)
        for k in TRAINABLE:
            if state.params[k].grad is None:
                state.params[k].grad = torch.zeros_like(state.params[k])
            all_reduce(state.params[k].grad, mesh, data_axis, tag="grads")
        return all_reduce(total, mesh, None, tag="loss") / n_px

    if mesh is None:
        loss_and_grads = direct_loss
    else:
        loss_and_grads = splat_loss if gather == "splats" else sharded_loss

    def _step(state, cam_batch, targets, adc: bool):
        with span("train.step", unit=True):
            add_count("train.scene_rows", template.num_gaussians * (
                cam_batch.position.shape[0]
                if cam_batch.position.dim() == 2 else 1))
            opt = state.opt_state
            opt.zero_grad(set_to_none=True)
            loss = loss_and_grads(state, cam_batch, targets)
            gnorm = None
            if adc:
                gnorm = torch.linalg.vector_norm(state.params["means"].grad,
                                                 dim=-1)
            with span("train.optimizer"):
                opt.step()
        return TrainState(state.params, opt, state.step + 1), loss, gnorm

    def train_step(state: TrainState, cam_batch: Camera,
                   targets: torch.Tensor):
        state, loss, _ = _step(state, cam_batch, targets, adc=False)
        return state, loss

    def train_step_adc(state: TrainState, cam_batch: Camera,
                       targets: torch.Tensor):
        """Like train_step, also returning the per-Gaussian norms of the
        positional gradient rows this rank holds."""
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
