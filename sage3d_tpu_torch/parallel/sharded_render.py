"""Tile-sharded rendering: one image composited cooperatively by the ranks
of a mesh.

PyTorch counterpart of ``sage3d_tpu/parallel/sharded_render.py``. Image rows
(bands of tile rows) split over the mesh's "tile" axis; the Gaussian set is
split into row shards over the same axis and all-gathered before the render;
each rank bins and composites only its own band, and the bands are gathered
back into the full image on every rank.

The band trick: a horizontal band of the image is the same camera with the
principal point shifted by the band's first row and a shorter image, so each
rank runs the one render on a "sub-camera" and the bands stack along rows.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.binning import TILE_H
from ..renderer.camera import Camera
from ..renderer.render import render
from ..renderer.scene import SCENE_FIELDS, GaussianScene
from .mesh import Mesh, all_gather, all_reduce, shard_rows
from .train import all_gather_bucketed, pad_scene_to

COUNTS = ("overflow", "grad_chunks")    # summed over the bands


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def band_height(height: int, n_dev: int) -> int:
    """Image rows of one band: the tile-padded frame over ``n_dev`` ranks,
    padded to whole tiles (the JAX package's formula)."""
    return _pad_to(_pad_to(height, TILE_H) // n_dev, TILE_H)


def render_tile_sharded(scene: GaussianScene, camera: Camera, mesh: Mesh,
                        tile_axis: str = "tile", backend: Optional[str] = None,
                        shard_gaussians: bool = True,
                        **render_kw) -> Dict[str, torch.Tensor]:
    """Render one camera with bands of rows sharded over ``tile_axis``.

    ``scene`` is the whole scene on every rank; with ``shard_gaussians`` each
    rank keeps its N / n_tile rows (the scene padded with parked Gaussians
    to a multiple of n_tile, as ``pad_scene_to``) and all-gathers them, else
    every rank renders from its own replica. Each rank renders its band, the
    sub-camera ``camera._replace(cy=camera.cy - y0, height=band_h)`` with
    ``clamp_dims=(width, height)``. Returns ``render``'s outputs for the full
    image on every rank: the bands gathered and cropped to
    ``camera.height``, ``overflow`` and ``grad_chunks`` summed over the
    bands. ``backend`` None: ``cuda`` on the card, ``torch`` on the CPU.
    The outputs are not differentiable (the band gather is not).
    """
    if backend is None:
        backend = "cuda" if scene.device.type == "cuda" else "torch"
    n_dev = mesh.shape[tile_axis]
    band_h = band_height(camera.height, n_dev)
    if shard_gaussians:
        shard = shard_rows(pad_scene_to(scene, n_dev), mesh, tile_axis)
        scene = GaussianScene(*[
            all_gather_bucketed(getattr(shard, f), mesh, tile_axis, 1,
                                tag="scene") for f in SCENE_FIELDS])
    y0 = mesh.axis_index(tile_axis) * band_h
    band_cam = camera._replace(cy=camera.cy - y0, height=band_h)
    out = render(scene, band_cam, backend=backend,
                 clamp_dims=(camera.width, camera.height), **render_kw)
    with torch.no_grad():
        full = {k: all_gather(v, mesh, tile_axis, tag="band")[:camera.height]
                for k, v in out.items() if k not in COUNTS}
        counts = all_reduce(torch.stack([out[k] for k in COUNTS]), mesh,
                            tile_axis, tag="band")
    full.update(zip(COUNTS, counts.unbind(0)))
    return full
