"""High-level render API: RGB + depth + semantic-ID images.

PyTorch counterpart of ``sage3d_tpu/renderer/render.py``. One call renders
all channels in one pass; depth is the expected splat depth from the same
compositing weights as RGB, with the background at ``camera.far``.

Backends:
  * ``"oracle"``: exact per-pixel reference (tests / small scenes).
  * ``"torch"``:  tiled compositor in plain PyTorch (ops/composite_torch.py;
                  the JAX package's ``"xla"``), differentiable.
  * ``"cuda"``:   hand-written kernels (ops/composite_cuda.py; the JAX
                  package's ``"pallas"``): K2 forward, K3 and K4 backward.
All three are differentiable w.r.t. the scene parameters.

``render`` runs where the scene's tensors are. On a CPU scene the ``cuda``
backend runs the kernels' plain versions.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.binning import (EMIT_BUDGET_KEYS, _pick_budgets, _pow2_at_least,
                           bin_gaussians, pair_count_stats)
from ..ops.composite_cuda import composite_tiles_cuda
from ..ops.composite_ref import composite_reference
from ..ops.composite_torch import composite_tiles
from ..ops.projection import project_gaussians
from .camera import Camera, unstack_cameras
from .scene import GaussianScene


def _host_stats(stats: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in stats.items()}


def _bin_with(proj, camera: Camera, budgets: Dict[str, int]):
    return bin_gaussians(proj, camera.width, camera.height,
                         **{k: budgets[k] for k in EMIT_BUDGET_KEYS})


@torch.no_grad()
def autotune_budgets(scene: GaussianScene, camera: Camera,
                     sh_degree: Optional[int] = None) -> Dict[str, int]:
    """Overflow-free binning budgets for (scene, camera) from one probe of
    projection + elementwise pair stats; the host picks static budgets."""
    proj = project_gaussians(scene, camera, sh_degree=sh_degree)
    stats = pair_count_stats(proj, camera.width, camera.height)
    return _pick_budgets(_host_stats(stats), scene.num_gaussians)


@torch.no_grad()
def autotune_all(scene: GaussianScene, camera: Camera,
                 sh_degree: Optional[int] = None,
                 pair_margin: Optional[float] = None,
                 grad_margin: Optional[float] = None) -> Dict[str, int]:
    """``autotune_budgets`` plus a probe that runs the binning with the chosen
    budgets and pow2-rounds the densest tile into ``tile_capacity``, so the
    measured pipeline drops zero pairs.

    ``pair_margin``: tighten ``pair_capacity`` to the measured post-cull pair
    count x margin (128-rounded) — only for a fixed (scene, camera).
    ``grad_margin``: run the ``cuda`` forward once and size
    ``grad_capacity`` to its total early-termination chunk count x margin.
    """
    budgets = autotune_budgets(scene, camera, sh_degree=sh_degree)
    proj = project_gaussians(scene, camera, sh_degree=sh_degree)
    bins = _bin_with(proj, camera, budgets)
    budgets["tile_capacity"] = _pow2_at_least(int(torch.max(bins.tile_count)))
    n_pairs = int(bins.n_pairs)
    budgets["n_pairs_measured"] = n_pairs
    if pair_margin is not None:
        tight = -(-int(n_pairs * pair_margin + 256) // 128) * 128
        budgets["pair_capacity"] = min(budgets["pair_capacity"], tight)
    if grad_margin is not None:
        out = render(scene, camera, backend="cuda", sh_degree=sh_degree,
                     **budget_kwargs(budgets))
        chunks = int(out["grad_chunks"])
        budgets["grad_capacity"] = -(-int(chunks * grad_margin + 64) // 64) * 64
        budgets["grad_chunks_measured"] = chunks
    return budgets


@torch.no_grad()
def autotune_poses(scene: GaussianScene, cameras: Camera,
                   pair_margin: float = 1.5,
                   sh_degree: Optional[int] = None,
                   grad_margin: Optional[float] = None) -> Dict[str, int]:
    """Budgets safe across many camera poses (a stacked Camera of probe
    poses): the budgets cover the worst pose, and ``pair_capacity`` /
    ``tile_capacity`` are the worst measured pose x ``pair_margin``.
    ``grad_margin`` also sizes ``grad_capacity`` from the worst pose's
    ``cuda`` forward."""
    cams = unstack_cameras(cameras)
    stats = []
    for c in cams:
        proj = project_gaussians(scene, c, sh_degree=sh_degree)
        stats.append(_host_stats(pair_count_stats(proj, c.width, c.height)))
    worst = {
        "n_visible": max(int(s["n_visible"]) for s in stats),
        "max_count": max(int(s["max_count"]) for s in stats),
        "exceed": [max(int(s["exceed"][i]) for s in stats)
                   for i in range(len(stats[0]["exceed"]))],
        "sum_count_parts": [max(int(s["sum_count_parts"].sum()) for s in stats)],
    }
    budgets = _pick_budgets(worst, scene.num_gaussians)

    max_tile, n_pairs = 0, 0
    for c in cams:
        bins = _bin_with(project_gaussians(scene, c, sh_degree=sh_degree), c,
                         budgets)
        max_tile = max(max_tile, int(torch.max(bins.tile_count)))
        n_pairs = max(n_pairs, int(bins.n_pairs))
    budgets["tile_capacity"] = _pow2_at_least(int(max_tile * pair_margin))
    budgets["n_pairs_measured"] = n_pairs
    tight = -(-int(n_pairs * pair_margin + 256) // 128) * 128
    budgets["pair_capacity"] = min(budgets["pair_capacity"], tight)

    if grad_margin is not None:
        chunks = max(int(render(scene, c, backend="cuda", sh_degree=sh_degree,
                                **budget_kwargs(budgets))["grad_chunks"])
                     for c in cams)
        budgets["grad_capacity"] = -(-int(chunks * grad_margin + 64) // 64) * 64
        budgets["grad_chunks_measured"] = chunks
    return budgets


def budget_kwargs(budgets: Dict[str, int]) -> Dict[str, int]:
    """Map an autotune_* budgets dict onto render()'s keyword arguments
    (including the optional 3-tier emission budgets)."""
    out = {k: int(budgets[k]) for k in ("pair_capacity", "tile_capacity",
                                        "k_small", "m_big", "k_big")
           if k in budgets}
    out["m_mid"] = int(budgets.get("m_mid", 0))
    out["k_mid"] = int(budgets.get("k_mid", 0))
    out["grad_capacity"] = int(budgets.get("grad_capacity", 0))
    return out


def default_pair_capacity(n_gaussians: int, width: int, height: int) -> int:
    """Static pair-buffer size heuristic: ~16 tiles per Gaussian, pow2-rounded.
    Overflow is always reported in the output, never silent."""
    est = max(16 * n_gaussians, 1 << 16)
    cap = 1 << (est - 1).bit_length()
    return min(cap, 1 << 25)


def render(
    scene: GaussianScene,
    camera: Camera,
    backend: str = "cuda",
    bg_color=(0.0, 0.0, 0.0),
    sh_degree: Optional[int] = None,
    pair_capacity: Optional[int] = None,
    tile_capacity: int = 1024,
    chunk: int = 128,
    clamp_dims: Optional[tuple] = None,
    k_small: int = 16,
    m_big: int = 8192,
    k_big: int = 256,
    m_mid: int = 0,
    k_mid: int = 0,
    grad_sort_bf16: bool = False,
    grad_sort: Optional[str] = None,
    grad_capacity: int = 0,
) -> Dict[str, torch.Tensor]:
    """Render one camera. Returns a dict:

      rgb:       (H, W, 3) composited over ``bg_color``
      depth:     (H, W) expected depth, background at camera.far
      alpha:     (H, W) accumulated opacity
      semantic:  (H, W) int32 argmax-weight object ID (-1 = background)
      trans:     (H, W) final transmittance
      depth_acc: (H, W) raw sum(w_i * z_i)
      rgb_acc:   (H, W, 3) premultiplied color before the background
      overflow:  () int32 dropped pairs (capacity accounting; 0 in correct runs)
      grad_chunks: () chunks the cuda compositor processed (0 elsewhere)

    ``grad_sort`` (``"f32"`` default, ``"f16"``, ``"bf16"``; alias
    ``grad_sort_bf16``) and ``grad_capacity`` set the ``cuda`` backend's
    backward; other backends ignore them.
    """
    width, height = camera.width, camera.height
    dev = scene.device
    proj = project_gaussians(scene, camera, sh_degree=sh_degree,
                             clamp_dims=clamp_dims)

    if backend == "oracle":
        out = composite_reference(proj, scene.semantic_ids, width, height)
        overflow = torch.zeros((), dtype=torch.int32, device=dev)
    elif backend in ("torch", "cuda"):
        bins = bin_gaussians(proj, width, height, k_small=k_small,
                             m_big=m_big, k_big=k_big, m_mid=m_mid,
                             k_mid=k_mid)
        if backend == "torch":
            out = composite_tiles(proj, scene.semantic_ids, bins, width,
                                  height, tile_capacity=tile_capacity,
                                  chunk=chunk)
        else:
            if pair_capacity is None:
                pair_capacity = default_pair_capacity(scene.num_gaussians,
                                                      width, height)
            out = composite_tiles_cuda(proj, scene.semantic_ids, bins, width,
                                       height, tile_capacity=tile_capacity,
                                       pair_capacity=pair_capacity,
                                       grad_sort_bf16=grad_sort_bf16,
                                       grad_sort=grad_sort,
                                       grad_capacity=grad_capacity)
        overflow = (bins.overflow + out.pop("tile_overflow")).to(torch.int32)
    else:
        raise ValueError(f"unknown backend: {backend}")

    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    rgb = out["rgb"] + out["trans"][..., None] * bg
    depth = out["depth_acc"] + out["trans"] * camera.far
    grad_chunks = out.pop("grad_chunks", None)
    return {
        "rgb": rgb,
        "depth": depth,
        "alpha": out["alpha"],
        "semantic": out["semantic"],
        "trans": out["trans"],
        "depth_acc": out["depth_acc"],
        "rgb_acc": out["rgb"],
        "overflow": overflow,
        "grad_chunks": (grad_chunks if grad_chunks is not None
                        else torch.zeros((), dtype=torch.int32, device=dev)),
    }


def render_batch(scene: GaussianScene, cameras: Camera,
                 sequential: bool = False, **kw) -> Dict[str, torch.Tensor]:
    """Render a stacked Camera batch; outputs carry a leading camera axis.

    Both modes render the cameras one after the other: ``sequential`` is kept
    for the JAX package's signature, where it chose ``lax.map`` over
    ``vmap``.
    """
    del sequential
    outs = [render(scene, c, **kw) for c in unstack_cameras(cameras)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def rgb_to_uint8(rgb: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(rgb, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)

