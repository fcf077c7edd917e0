"""Audit of the sharded path: the collectives a step issues, the shards each
rank holds, and the bucketed gather.

PyTorch counterpart of ``audit_sharded_step`` in
``sage3d_tpu/parallel/audit.py``. The JAX audit reads the collectives from
the program XLA compiles (StableHLO before partitioning, HLO after); here
the collectives are calls, and ``parallel/mesh.py`` counts every one, so the
audit runs one step and reads the count. Nothing merges collectives, so the
issued count is also the executed one. The JAX module's
``_count_stablehlo``, ``_collect_hlo_ops``, ``audit_tpu_schedule`` and
``audit_tpu_schedule_render`` read XLA's program text or need libtpu's TPU
topology, and have no counterpart.

The functions here run on the ranks of a mesh and take it as the keyword
``mesh``, so ``spawn_mesh`` can run them as they are.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..renderer.camera import agent_camera, stack_cameras
from ..renderer.scene import synthetic_room
from ..utils import profiling
from .mesh import Mesh, all_gather, shard_rows
from .train import (SPLAT_DIFF, SPLAT_META, TRAINABLE, init_train_state,
                    make_optimizer, make_train_step, pad_scene_to,
                    all_gather_bucketed)


def audit_sharded_step(mesh: Mesh, n_gauss: int = 256, width: int = 64,
                       height: int = 64, grad_buckets: int = 4,
                       backend=None, pair_capacity: int = 1 << 14,
                       tile_capacity: int = 256,
                       gather: str = "params") -> Dict:
    """Run one sharded train step (``force_shard_map``, so a one-rank mesh
    takes the collective path too) on ``synthetic_room(n_gauss, seed=3)``
    and 2 cameras per data rank, and return the audit: the collectives the
    step issued by kind (``written_collectives``, with the loss's all-reduce
    apart as ``loss_all_reduce``), the count expected per kind
    (``grad_buckets`` x 5 groups), each group's shard rows, and the
    communication model: the parameter bytes, the bytes on the wire per
    step and rank by the JAX package's formula, the step's collective
    milliseconds (the device synchronized around each) and the transport.
    ``backend`` None: ``cuda`` on the card, ``torch`` on the CPU. Raises
    AssertionError when a kind falls short or a group is not sharded.

    ``gather="splats"`` audits the splat layout instead: ``grad_buckets``
    gathers of the splats' values and as many of their metadata, and
    ``grad_buckets`` reduce-scatters of their gradients; its wire bytes are
    the splats' (14 floats a Gaussian a camera gathered, 10 scattered back)
    where the parameter layout's are the parameters' both ways.
    ``audit_layouts`` runs both."""
    dev = mesh.device
    backend = backend or ("cuda" if dev.type == "cuda" else "torch")
    n_data, n_tile = mesh.shape["data"], mesh.shape["tile"]
    scene = pad_scene_to(synthetic_room(num_gaussians=n_gauss, seed=3,
                                        device=dev), n_tile * grad_buckets)
    cams = stack_cameras([
        agent_camera((0.1 * i, -4.0), yaw=1.5 + 0.1 * i, width=width,
                     height=height, device=dev) for i in range(2 * n_data)])
    padded_h = -(-height // 32) * 32
    targets = torch.zeros((2 * n_data, max(padded_h, 32 * n_tile), width, 3),
                          device=dev)
    opt = make_optimizer(1e-3)
    step, _ = make_train_step(scene, shard_rows(cams, mesh, "data"), mesh,
                              optimizer=opt, backend=backend,
                              pair_capacity=pair_capacity,
                              tile_capacity=tile_capacity,
                              grad_buckets=grad_buckets, force_shard_map=True,
                              gather=gather)
    state = init_train_state(scene, opt, mesh)
    n_rows = scene.num_gaussians
    shards = {}
    for k in TRAINABLE:
        rows = state.params[k].shape[0]
        shards[k] = {"total_rows": n_rows, "shard_rows": rows,
                     "n_tile": n_tile}
        if rows * n_tile != n_rows:
            raise AssertionError(f"param {k} not sharded: {rows} rows a "
                                 f"rank, expected {n_rows // n_tile}")

    mesh.counter.reset()
    mesh.counter.timed = True
    try:
        step(state, shard_rows(cams, mesh, "data"),
             shard_rows(targets, mesh, "data"))
    finally:
        mesh.counter.timed = False
    written = mesh.counter.counts(apart=("loss",))
    summary = mesh.counter.summary()
    if gather == "splats":
        expect = {"all_gather": 2 * grad_buckets,
                  "reduce_scatter": grad_buckets}
    else:
        expect = dict.fromkeys(("all_gather", "reduce_scatter"),
                               grad_buckets * len(TRAINABLE))
    for kind, want in expect.items():
        if written.get(kind, 0) < want:
            raise AssertionError(
                f"the step issued {written.get(kind, 0)} {kind}s, expected "
                f">= {want} ({grad_buckets} buckets, {gather} layout)")

    param_bytes = sum(int(np.prod(getattr(scene, k).shape)) * 4
                      for k in TRAINABLE)
    share = (n_tile - 1) / max(n_tile, 1)
    if gather == "splats":
        splat_rows = n_rows * cams.position.shape[0] // n_data
        wire = splat_rows * (2 * SPLAT_DIFF + SPLAT_META) * 4 * share
    else:
        wire = 2 * param_bytes * share
    return {
        "mesh": dict(mesh.shape),
        "gather": gather,
        "grad_buckets": grad_buckets,
        "written_collectives": written,
        "expected_written_per_kind": (expect["all_gather"]
                                      if gather == "params" else expect),
        **{f"optimized_{kind}": {"count": s["count"], "bytes": s["bytes"]}
           for kind, s in summary.items()},
        "param_shards": shards,
        "comm_model": {
            "param_bytes": int(param_bytes),
            "wire_bytes_per_step_per_device": int(wire),
            "collective_ms": sum(s["ms"] or 0.0 for s in summary.values()),
            "collective_ms_by_kind": {k: s["ms"] for k, s in summary.items()},
            "transport": mesh.transport,
        },
    }


def audit_layouts(mesh: Mesh, **kw) -> Dict:
    """``audit_sharded_step`` of each layout on the same scene and
    cameras: {"params": ..., "splats": ...}, their collectives and wire
    bytes side by side."""
    return {g: audit_sharded_step(mesh, gather=g, **kw)
            for g in ("params", "splats")}


def audit_bucketed_gather(x: torch.Tensor, n_buckets: int, mesh: Mesh,
                          axis: str = "tile") -> Dict:
    """``all_gather_bucketed`` of this rank's block of ``x`` in
    ``n_buckets`` chunks and in one, each followed by the gradient of
    ``sum(full ** 2) * (axis index + 1)`` summed over the ranks (the JAX
    package's test). Returns rank 0's view: both gathers, both gradients
    (gathered over ``axis``), and the gathers each issued."""
    out = {}
    for n in (n_buckets, 1):
        xs = shard_rows(x, mesh, axis).detach().clone().requires_grad_(True)
        mesh.counter.reset()
        full = all_gather_bucketed(xs, mesh, axis, n)
        issued = mesh.counter.counts().get("all_gather", 0)
        (torch.sum(full ** 2) * (mesh.axis_index(axis) + 1.0)).backward()
        out[n] = {"full": full.detach(), "gathers": issued,
                  "grad": all_gather(xs.grad, mesh, axis)}
    return {"bucketed": out[n_buckets], "monolithic": out[1]}


def trace_sharded_steps(template, cameras, targets, optimizer,
                        n_steps: int, mesh: Mesh, **step_kw) -> Dict:
    """``n_steps`` sharded train steps from ``init_train_state(template)``
    on the global batch (each rank takes its rows with ``shard_rows``).
    Returns rank 0's view: every rank's losses (rank-major), the first
    step's gradients and the last parameters gathered over "tile", and the
    collectives of each step by kind (the loss's all-reduce under
    ``loss_all_reduce``)."""
    step, _ = make_train_step(template, shard_rows(cameras, mesh, "data"),
                              mesh, optimizer=optimizer, **step_kw)
    state = init_train_state(template, optimizer, mesh)
    cams = shard_rows(cameras, mesh, "data")
    tgts = shard_rows(targets, mesh, "data")
    losses, counts, grads = [], [], None
    for i in range(n_steps):
        mesh.counter.reset()
        state, loss = step(state, cams, tgts)
        counts.append(mesh.counter.counts(apart=("loss",)))
        losses.append(loss)
        if i == 0:
            grads = {k: all_gather(state.params[k].grad, mesh, "tile")
                     for k in TRAINABLE}
    return {
        "losses": all_gather(torch.stack(losses)[None], mesh, None),
        "grads": grads,
        "params": {k: all_gather(state.params[k].detach(), mesh, "tile")
                   for k in TRAINABLE},
        "counts": counts,
    }


def compare_layouts(template, cameras, targets, optimizer, n_steps: int,
                    mesh: Mesh, **step_kw) -> Dict:
    """``trace_sharded_steps`` of the parameter layout and of the splat
    layout from the same start, and the Gaussian rows each rank projected
    a step under each (the recorder's ``projection.rows``), gathered
    rank-major: {"params": ..., "splats": ..., "rows": {layout: (ranks,)}}.
    """
    out, rows = {}, {}
    for gather in ("params", "splats"):
        profiling.reset()
        profiling.enable()
        try:
            out[gather] = trace_sharded_steps(template, cameras, targets,
                                              optimizer, n_steps, mesh,
                                              gather=gather, **step_kw)
        finally:
            profiling.disable()
        n = profiling.counters().get("projection.rows", 0) / n_steps
        profiling.reset()
        rows[gather] = all_gather(torch.tensor([n], dtype=torch.float64,
                                               device=mesh.device),
                                  mesh, None)
    out["rows"] = rows
    return out
