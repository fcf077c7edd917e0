"""What the drivers hand to the program: its scene and camera types built
from the benchmark's own numbers, the build of its kernels, and the freeing
of its state before the reference runs. The program is imported here, when a
driver sets up, and nowhere in the reference."""

from __future__ import annotations

import gc

import numpy as np
import torch

from ..reference import render as rr
from . import scene as hs


def gaussian_scene(fields: dict):
    from sage3d_tpu_torch.renderer.scene import GaussianScene
    return GaussianScene(**{k: fields[k] for k in hs.FIELDS})


def intrinsics(width: int, height: int, focal_mm: float):
    fx = float(np.float32(width * focal_mm / rr.APERTURE_MM))
    return fx, fx, width / 2.0, height / 2.0


def cameras(views, width, height, focal_mm, device, program=True):
    """The program's stacked Camera of ``views`` ((position, forward)
    pairs), and the reference's cameras of the same numbers (None for the
    program's where ``program`` is false)."""
    fx, fy, cx, cy = intrinsics(width, height, focal_mm)
    pos = torch.tensor(np.stack([v[0] for v in views]), device=device)
    rot = torch.tensor(np.stack([hs.look_rotation(v[1]) for v in views]),
                       device=device)
    n = len(views)
    ref = [rr.Cam(pos[i], rot[i], fx, fy, cx, cy, width, height)
           for i in range(n)]
    if not program:
        return None, ref
    from sage3d_tpu_torch.renderer.camera import Camera

    def fill(x):
        return torch.full((n,), x, dtype=torch.float32, device=device)

    prog = Camera(pos, rot, fill(fx), fill(fy), fill(cx), fill(cy),
                  width, height)
    return prog, ref


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build() -> None:
    """Build the program's kernels that are not built yet, all at once
    (its compile cache is ``build/`` in the checkout)."""
    from sage3d_tpu_torch.ops import _build
    _build.build_all()
