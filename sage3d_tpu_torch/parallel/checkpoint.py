"""Checkpoint and restore for scene-optimization training, on ``torch.save``.

PyTorch counterpart of ``sage3d_tpu/parallel/checkpoint.py`` (orbax there).
A checkpoint is one file ``step_<step>.pt`` in the checkpoint directory
holding the parameters, the optimizer's ``state_dict`` and the step; the
newest ``max_to_keep`` files are kept. A file is written under a temporary
name and renamed, so a reader never sees half of one.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional

import torch

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


def save_train_state(ckpt_dir, state: TrainState, step: Optional[int] = None,
                     max_to_keep: int = 3) -> int:
    """Save a TrainState; returns the step written."""
    if step is None:
        step = int(state.step)
    path = Path(ckpt_dir)
    path.mkdir(parents=True, exist_ok=True)
    payload = {
        "step": step,
        "params": {k: v.detach().cpu() for k, v in state.params.items()},
        "opt_state": state.opt_state.state_dict(),
    }
    tmp = path / f".step_{step:09d}.pt.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, _file(path, step))
    for old in _steps(path)[:-max_to_keep] if max_to_keep > 0 else []:
        _file(path, old).unlink(missing_ok=True)
    return step


def restore_train_state(ckpt_dir, template: TrainState,
                        step: Optional[int] = None) -> Optional[TrainState]:
    """Load a checkpoint into ``template``'s tensors and optimizer (in place)
    and return the state at its step; None if there is no checkpoint."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return None
    payload = torch.load(_file(ckpt_dir, step), map_location="cpu",
                         weights_only=True)
    with torch.no_grad():
        for k, v in template.params.items():
            v.copy_(payload["params"][k])
    template.opt_state.load_state_dict(payload["opt_state"])
    return TrainState(template.params, template.opt_state,
                      int(payload["step"]))


def latest_step(ckpt_dir) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None
