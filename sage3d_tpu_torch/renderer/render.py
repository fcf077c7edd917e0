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

``render_batch`` renders a stacked camera batch. On the ``cuda`` backend
(``sequential=False``, the default) that is the JAX package's ``vmap``:
``render`` of the stacked camera, which projects, bins and composites all
cameras at once (one K1, one K2 and, under autograd, one K3 and one K4
launch a group of cameras, two host reads), each camera bitwise what it
gives alone. ``sequential=True`` renders camera by camera (the JAX
package's ``lax.map``); the ``torch`` and ``oracle`` backends always do.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.binning import (EMIT_BUDGET_KEYS, _pick_budgets, _pow2_at_least,
                           bin_gaussians, pair_count_stats)
from ..ops.composite_cuda import composite_tiles_cuda
from ..ops.composite_ref import composite_reference
from ..ops.composite_torch import composite_tiles
from ..ops.projection import ProjectedGaussians, project_gaussians
from ..utils.profiling import span
from .camera import Camera, slice_cameras, unstack_cameras
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


# Gaussian rows (cameras x Gaussians) a group of ``autotune_poses`` probes
# at most: its passes hold every probed camera's projection, emission table
# and kept pairs at once (4 cameras at 1M Gaussians).
PROBE_ROWS = 1 << 22
# Gaussian rows (cameras x Gaussians) of one batched ``cuda`` render. The
# backward's row id routes up to 2^31 - 1 rows, but a group's kept pairs must
# stay under binning's PAIR_LIMIT (int32 pair indices), and its tables and
# pairs on the card grow with its rows: 2^24 rows (16 cameras at 1M
# Gaussians) keeps every batch the benchmark renders in the groups it had.
BATCH_ROWS = 1 << 24


def camera_groups(n_cams: int, n_gauss: int,
                  max_rows: Optional[int] = None) -> list:
    """Slices of whole cameras that one batched ``cuda`` render takes: at
    most (BATCH_ROWS - 1) // N cameras (16 at 1M Gaussians), and at most
    ``max_rows`` // N where given; one camera a group where N alone reaches
    the cap."""
    rows = BATCH_ROWS - 1 if max_rows is None else min(BATCH_ROWS - 1,
                                                        max_rows)
    size = max(1, rows // max(n_gauss, 1))
    return [slice(i, min(i + size, n_cams)) for i in range(0, n_cams, size)]


@torch.no_grad()
def autotune_poses(scene: GaussianScene, cameras: Camera,
                   pair_margin: float = 1.5,
                   sh_degree: Optional[int] = None,
                   grad_margin: Optional[float] = None,
                   clamp_dims: Optional[tuple] = None) -> Dict[str, int]:
    """Budgets safe across many camera poses (a stacked Camera of probe
    poses): the budgets cover the worst pose, and ``pair_capacity`` /
    ``tile_capacity`` are the worst measured pose x ``pair_margin``.
    ``grad_margin`` also sizes ``grad_capacity`` from the worst pose's
    ``cuda`` forward.

    The poses are probed in ``camera_groups`` of at most ``PROBE_ROWS``
    Gaussian rows: each group is one batched projection with its pair
    counts, one batched binning and (with ``grad_margin``) one batched
    ``cuda`` forward, and the host reads a few values a group, not two a
    pose. ``clamp_dims`` as in ``render``: the band cameras of a sharded
    step project with the whole frame's clamp."""
    groups = camera_groups(cameras.position.shape[0], scene.num_gaussians,
                           PROBE_ROWS)
    rows = [pair_count_stats(
        project_gaussians(scene, slice_cameras(cameras, sl),
                          sh_degree=sh_degree, clamp_dims=clamp_dims),
        cameras.width, cameras.height) for sl in groups]
    # each statistic's worst pose
    stats = {k: torch.cat([r[k] for r in rows]).amax(0) for k in rows[0]}
    budgets = _pick_budgets(_host_stats(stats), scene.num_gaussians)

    worst = []
    for sl in groups:
        cams = slice_cameras(cameras, sl)
        bins = _bin_with(project_gaussians(scene, cams, sh_degree=sh_degree,
                                           clamp_dims=clamp_dims),
                         cams, budgets)
        worst.append(torch.stack([bins.tile_count.max().to(torch.int64),
                                  bins.n_pairs.max().to(torch.int64)]))
    max_tile, n_pairs = (int(v) for v in torch.stack(worst).amax(0).cpu())
    budgets["tile_capacity"] = _pow2_at_least(int(max_tile * pair_margin))
    budgets["n_pairs_measured"] = n_pairs
    tight = -(-int(n_pairs * pair_margin + 256) // 128) * 128
    budgets["pair_capacity"] = min(budgets["pair_capacity"], tight)

    if grad_margin is not None:
        chunks = int(torch.cat([
            render(scene, slice_cameras(cameras, sl), backend="cuda",
                   sh_degree=sh_degree, clamp_dims=clamp_dims,
                   **budget_kwargs(budgets))
            ["grad_chunks"] for sl in groups]).max())
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

    On the ``cuda`` backend ``camera`` may be a stacked batch of B cameras
    (``render_batch``'s batched path): every output then has a leading
    camera axis, ``overflow`` and ``grad_chunks`` are (B,), the budgets
    apply per camera, and each camera's outputs are bitwise its own render.

    ``render`` is the projection (``project_gaussians``) followed by
    ``render_projected``, which bins and composites splats already
    projected.
    """
    single = camera.position.dim() == 1
    if not single and backend != "cuda":
        raise ValueError(f"render: the {backend} backend takes one camera; "
                         "render_batch renders a stacked batch")
    with span("render", unit=True):
        with span("render.project"):
            proj = project_gaussians(scene, camera, sh_degree=sh_degree,
                                     clamp_dims=clamp_dims)
        return _composite_projected(
            proj, scene.semantic_ids, camera, backend=backend,
            bg_color=bg_color, pair_capacity=pair_capacity,
            tile_capacity=tile_capacity, chunk=chunk, k_small=k_small,
            m_big=m_big, k_big=k_big, m_mid=m_mid, k_mid=k_mid,
            grad_sort_bf16=grad_sort_bf16, grad_sort=grad_sort,
            grad_capacity=grad_capacity)


def render_projected(proj: ProjectedGaussians, semantic_ids: torch.Tensor,
                     camera: Camera, backend: str = "cuda",
                     bg_color=(0.0, 0.0, 0.0), **budgets
                     ) -> Dict[str, torch.Tensor]:
    """``render``'s outputs from splats already projected for ``camera``
    (its size, ``far`` and whether it is one camera or a batch): binning
    and compositing, differentiable in ``proj``'s float fields.
    ``budgets``: ``render``'s keyword arguments after ``clamp_dims``. The
    sharded train step's splat layout projects each rank's shard, gathers
    the splats and renders its band with this."""
    if camera.position.dim() != 1 and backend != "cuda":
        raise ValueError(f"render: the {backend} backend takes one camera; "
                         "render_batch renders a stacked batch")
    with span("render", unit=True):
        return _composite_projected(proj, semantic_ids, camera, backend,
                                    bg_color, **budgets)


def _composite_projected(
    proj: ProjectedGaussians,
    semantic_ids: torch.Tensor,
    camera: Camera,
    backend: str,
    bg_color,
    pair_capacity: Optional[int] = None,
    tile_capacity: int = 1024,
    chunk: int = 128,
    k_small: int = 16,
    m_big: int = 8192,
    k_big: int = 256,
    m_mid: int = 0,
    k_mid: int = 0,
    grad_sort_bf16: bool = False,
    grad_sort: Optional[str] = None,
    grad_capacity: int = 0,
) -> Dict[str, torch.Tensor]:
    """Binning and compositing of ``render`` and ``render_projected``,
    inside the caller's ``render`` span."""
    width, height = camera.width, camera.height
    single = camera.position.dim() == 1
    dev = proj.depths.device
    if backend == "oracle":
        with span("render.composite"):
            out = composite_reference(proj, semantic_ids, width, height)
        overflow = torch.zeros((), dtype=torch.int32, device=dev)
    elif backend in ("torch", "cuda"):
        # bins and the cuda compositor's outputs carry a leading camera
        # axis (B = 1 for one camera), taken off once below
        with span("render.bin"):
            bins = bin_gaussians(proj, width, height, k_small=k_small,
                                 m_big=m_big, k_big=k_big, m_mid=m_mid,
                                 k_mid=k_mid)
        with span("render.composite"):
            if backend == "torch":
                out = {k: v[None] for k, v in composite_tiles(
                    proj, semantic_ids, bins, width, height,
                    tile_capacity=tile_capacity, chunk=chunk).items()}
            else:
                if pair_capacity is None:
                    pair_capacity = default_pair_capacity(
                        proj.depths.shape[-1], width, height)
                out = composite_tiles_cuda(
                    proj, semantic_ids, bins, width, height,
                    tile_capacity=tile_capacity,
                    pair_capacity=pair_capacity,
                    grad_sort_bf16=grad_sort_bf16, grad_sort=grad_sort,
                    grad_capacity=grad_capacity)
        overflow = (bins.overflow + out.pop("tile_overflow")).to(
            torch.int32)
        if single:
            out = {k: v[0] for k, v in out.items()}
            overflow = overflow[0]
    else:
        raise ValueError(f"unknown backend: {backend}")

    # the background per channel from Python numbers: a tensor of them
    # would be a host-to-device copy, which waits for the card
    rgb = torch.stack([out["rgb"][..., i] + out["trans"] * float(c)
                       for i, c in enumerate(bg_color)], -1)
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
                        else torch.zeros((), dtype=torch.int32,
                                         device=dev)),
    }


def render_batch(scene: GaussianScene, cameras: Camera,
                 sequential: bool = False, **kw) -> Dict[str, torch.Tensor]:
    """Render a stacked Camera batch; outputs carry a leading camera axis.

    On the ``cuda`` backend (the default) the batch renders together, the
    counterpart of the JAX package's ``vmap``: each group of
    ``camera_groups`` (all cameras while B·N < 2^24) is one ``render`` of the
    stacked cameras, which launches K1 and K2 once and, under autograd, K3
    and K4 once, and reads the host twice. Every camera's outputs, overflow
    and ``grad_chunks`` are bitwise its own ``render``; the budgets apply per
    camera. ``sequential=True`` renders the cameras one after the other (the
    JAX package's ``lax.map``), as the ``torch`` and ``oracle`` backends
    always do.
    """
    if kw.get("backend", "cuda") == "cuda" and not sequential:
        groups = camera_groups(cameras.position.shape[0], scene.num_gaussians)
        outs = [render(scene, slice_cameras(cameras, sl), **kw)
                for sl in groups]
        if len(outs) == 1:
            return outs[0]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    outs = [render(scene, c, **kw) for c in unstack_cameras(cameras)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def rgb_to_uint8(rgb: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(rgb, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)

