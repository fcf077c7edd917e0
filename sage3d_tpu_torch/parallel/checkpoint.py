"""Checkpoint and restore for scene-optimization training, on ``torch.save``.

PyTorch counterpart of ``sage3d_tpu/parallel/checkpoint.py`` (orbax there).
A checkpoint is one file ``step_<step>.pt`` in the checkpoint directory
holding the parameters, the optimizer's ``state_dict`` and the step; the
newest ``max_to_keep`` files are kept. A file is written under a temporary
name and renamed, so a reader never sees half of one.

Under a mesh (``mesh=``, the state's leaves and Adam moments row shards over
"tile"), rank 0 writes the same single-device format: the full parameters
and moments, gathered. Every rank restores its own rows, so a run can resume
on another mesh shape: rows past the end of the saved tensors (a larger
padding) keep the state's values and get zero moments.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional

import torch

from .mesh import Mesh, all_gather
from .train import TrainState

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(ckpt_dir) -> List[int]:
    path = Path(ckpt_dir)
    if not path.is_dir():
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(path))
                  if m)


def _file(ckpt_dir, step: int) -> Path:
    return Path(ckpt_dir) / f"step_{step:09d}.pt"


def _rows(v) -> bool:
    """An optimizer-state entry held per row (the Adam moments)."""
    return torch.is_tensor(v) and v.dim() >= 1


def save_train_state(ckpt_dir, state: TrainState, step: Optional[int] = None,
                     max_to_keep: int = 3, mesh: Optional[Mesh] = None,
                     tile_axis: str = "tile") -> int:
    """Save a TrainState; returns the step written. Under ``mesh`` every
    rank gathers and rank 0 writes; every rank returns once it is written."""
    if step is None:
        step = int(state.step)
    params = {k: v.detach() for k, v in state.params.items()}
    opt_state = state.opt_state.state_dict()
    if mesh is not None:
        def full(v):
            return all_gather(v, mesh, tile_axis, tag="checkpoint")
        params = {k: full(v) for k, v in params.items()}
        opt_state = {**opt_state, "state": {
            i: {name: full(v) if _rows(v) else v for name, v in st.items()}
            for i, st in opt_state["state"].items()}}
    if mesh is None or mesh.rank == 0:
        path = Path(ckpt_dir)
        path.mkdir(parents=True, exist_ok=True)
        payload = {"step": step,
                   "params": {k: v.cpu() for k, v in params.items()},
                   "opt_state": opt_state}
        tmp = path / f".step_{step:09d}.pt.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, _file(path, step))
        for old in _steps(path)[:-max_to_keep] if max_to_keep > 0 else []:
            _file(path, old).unlink(missing_ok=True)
    if mesh is not None:
        mesh.barrier()
    return step


def _my_rows(saved: torch.Tensor, current: torch.Tensor, mesh: Mesh,
             tile_axis: str, fill=None) -> torch.Tensor:
    """This rank's rows of a saved full tensor, shaped as its shard
    ``current``; rows past the saved ones keep ``current``'s values (or
    ``fill``)."""
    s = current.shape[0]
    a = mesh.axis_index(tile_axis) * s
    out = current.detach().cpu().clone() if fill is None else \
        torch.full(current.shape, fill, dtype=current.dtype)
    rows = saved[a:a + s]
    out[:rows.shape[0]] = rows
    return out


def restore_train_state(ckpt_dir, template: TrainState,
                        step: Optional[int] = None,
                        mesh: Optional[Mesh] = None,
                        tile_axis: str = "tile") -> Optional[TrainState]:
    """Load a checkpoint into ``template``'s tensors and optimizer (in place)
    and return the state at its step; None if there is no checkpoint. Under
    ``mesh`` each rank takes its own rows of the saved full tensors."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return None
    payload = torch.load(_file(ckpt_dir, step), map_location="cpu",
                         weights_only=True)
    opt_state = payload["opt_state"]
    if mesh is not None:
        params = template.params
        payload["params"] = {k: _my_rows(payload["params"][k], params[k],
                                         mesh, tile_axis) for k in params}
        # the optimizer's state is keyed by the index of its parameter
        shards = [p for g in template.opt_state.param_groups
                  for p in g["params"]]
        opt_state = {**opt_state, "state": {
            i: {name: _my_rows(v, shards[i], mesh, tile_axis, fill=0.0)
                if _rows(v) else v for name, v in st.items()}
            for i, st in opt_state["state"].items()}}
    with torch.no_grad():
        for k, v in template.params.items():
            v.copy_(payload["params"][k])
    template.opt_state.load_state_dict(opt_state)
    return TrainState(template.params, template.opt_state,
                      int(payload["step"]))


def latest_step(ckpt_dir) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None
