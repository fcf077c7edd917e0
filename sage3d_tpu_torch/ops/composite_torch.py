"""Tiled compositor in plain PyTorch, differentiable through autograd.

Replaces the JAX module ``sage3d_tpu/ops/composite_xla.py`` (the ``"xla"``
backend); this is the ``"torch"`` backend of ``render``. Same algorithm:

  * A tile is 32x32 = 1024 pixels; Gaussians are processed in depth-ordered
    chunks of ``chunk`` (default 128).
  * The EWA exponent is a quadratic in tile-local pixel coordinates
    (``quad_coeffs`` x ``pixel_basis``), evaluated elementwise in f32.
  * Front-to-back transmittance within a chunk is exp(cumsum(log1p(-alpha))).
  * Color/depth/alpha accumulation is a batched matmul of the weights with
    the per-pair features.

The JAX version maps over all tiles at once; here tiles go in batches of
``tile_batch`` so memory stays bounded at 1080p, and each batch stops at its
longest tile's last chunk (later chunks hold no pairs and add exactly zero).

Under autograd each chunk step is rematerialised, as the JAX version's
``jax.checkpoint``: the backward recomputes the chunk's (tile_batch, 1024,
chunk) alpha and weight matrices from the chunk's inputs instead of keeping
them, so what the backward holds per chunk is its carry and gathered pair
features, not ~33 MB of matrices at tile_batch 64.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from .binning import TILE_H, TILE_W, TileBins
from .projection import ALPHA_MAX, ALPHA_MIN, ProjectedGaussians


def quad_coeffs(means2d_local: torch.Tensor, conics: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian coefficients of the EWA exponent as a pixel-space quadratic:
    power(px, py) = w0 + wx*px + wy*py + wxx*px^2 + wyy*py^2 + wxy*px*py.
    Returns (..., 6) stacked [w0, wx, wy, wxx, wyy, wxy]."""
    cx = means2d_local[..., 0]
    cy = means2d_local[..., 1]
    a = conics[..., 0]
    b = conics[..., 1]
    c = conics[..., 2]
    w0 = -0.5 * (a * cx * cx + c * cy * cy) - b * cx * cy
    wx = a * cx + b * cy
    wy = c * cy + b * cx
    return torch.stack([w0, wx, wy, -0.5 * a, -0.5 * c, -b], dim=-1)


def pixel_basis(tile_h: int, tile_w: int, device=None) -> torch.Tensor:
    """(tile_h*tile_w, 6) basis [1, px, py, px^2, py^2, px*py], tile-local."""
    py, px = torch.meshgrid(
        torch.arange(tile_h, dtype=torch.float32, device=device) + 0.5,
        torch.arange(tile_w, dtype=torch.float32, device=device) + 0.5,
        indexing="ij")
    py, px = py.reshape(-1), px.reshape(-1)
    return torch.stack([torch.ones_like(px), px, py, px * px, py * py, px * py],
                       dim=-1)


@contextlib.contextmanager
def _full_f32_matmul(device: torch.device):
    """The blend matmul must run in full f32 (the JAX version asks for
    Precision.HIGHEST): TF32 keeps ~3 decimal digits. On the card, TF32 is
    switched off for the duration and the caller's setting restored after."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _untile(x: torch.Tensor, tiles_x: int, tiles_y: int, width: int,
            height: int) -> torch.Tensor:
    """(T, TILE_H*TILE_W, C) -> (height, width, C)."""
    c = x.shape[-1]
    x = x.reshape(tiles_y, tiles_x, TILE_H, TILE_W, c).permute(0, 2, 1, 3, 4)
    return x.reshape(tiles_y * TILE_H, tiles_x * TILE_W, c)[:height, :width]


def _chunk_step(log_T, acc, best_w, best_id, co, op, ft, sm, Xb):
    """One chunk of a batch of tiles: the carry (log_T, acc, best_w, best_id)
    after blending the chunk's pairs, whose quadratic coefficients ``co``
    (b, chunk, 6), opacities ``op``, blended features ``ft`` (rgb, depth, 1)
    and semantic ids ``sm`` are given; ``Xb`` the pixel basis columns."""
    cos = [co[:, None, :, i] for i in range(6)]         # (b, 1, chunk)
    power = (cos[0] + Xb[1] * cos[1] + Xb[2] * cos[2]
             + Xb[3] * cos[3] + Xb[4] * cos[4] + Xb[5] * cos[5])
    alpha = op[:, None, :] * torch.exp(torch.clamp(power, max=0.0))
    alpha = torch.where(power > 0.0, 0.0, alpha)
    alpha = torch.clamp(alpha, max=ALPHA_MAX)
    alpha = torch.where(alpha < ALPHA_MIN, 0.0, alpha)
    l = torch.log1p(-alpha)
    s_incl = torch.cumsum(l, dim=-1)
    s_excl = s_incl - l
    w = alpha * torch.exp(log_T[:, :, None] + s_excl)  # (b, pix, chunk)
    acc = acc + torch.bmm(w, ft)
    cw, arg = torch.max(w, dim=-1)
    cid = torch.gather(sm, 1, arg)
    better = cw > best_w
    best_w = torch.where(better, cw, best_w)
    best_id = torch.where(better, cid, best_id)
    log_T = log_T + s_incl[..., -1]
    return log_T, acc, best_w, best_id


def _run_chunk(step, *args):
    """``step(*args)``; under grad through a non-reentrant checkpoint, so
    the backward recomputes the step instead of saving its matrices."""
    if torch.is_grad_enabled():
        return checkpoint(step, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return step(*args)


def composite_tiles(
    proj: ProjectedGaussians,
    semantic_ids: torch.Tensor,
    bins: TileBins,
    width: int,
    height: int,
    tile_capacity: int = 1024,
    chunk: int = 128,
    tile_batch: int = 64,
) -> Dict[str, torch.Tensor]:
    """Composite all tiles. Returns the same dict schema as
    ``composite_reference`` plus ``tile_overflow`` (pairs past
    ``tile_capacity``, reported, never silently mis-rendered)."""
    dev = proj.depths.device
    tiles_x, tiles_y = bins.tiles_x, bins.tiles_y
    n_tiles = tiles_x * tiles_y
    n_pix = TILE_W * TILE_H
    cap = -(-tile_capacity // chunk) * chunk
    n_pairs_buf = bins.pair_gauss.shape[0]

    tid = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    origin = torch.stack([(tid % tiles_x) * TILE_W, (tid // tiles_x) * TILE_H],
                         -1).to(torch.float32)
    count_all = torch.clamp(bins.tile_count, max=cap)
    X = pixel_basis(TILE_H, TILE_W, device=dev)
    Xb = [X[None, :, i, None] for i in range(6)]                 # (1, pix, 1)
    k_local = torch.arange(chunk, dtype=torch.int32, device=dev)

    accs, transs, sems = [], [], []
    with _full_f32_matmul(dev):
        for t0 in range(0, n_tiles, tile_batch):
            sl = slice(t0, min(t0 + tile_batch, n_tiles))
            count = count_all[sl]
            start = bins.tile_start[sl]
            b = count.shape[0]
            log_T = torch.zeros((b, n_pix), dtype=torch.float32, device=dev)
            acc = torch.zeros((b, n_pix, 5), dtype=torch.float32, device=dev)
            best_w = torch.zeros((b, n_pix), dtype=torch.float32, device=dev)
            best_id = torch.full((b, n_pix), -1, dtype=torch.int32, device=dev)
            n_chunks = -(-int(count.max()) // chunk) if b else 0
            for c in range(n_chunks):
                k = k_local + c * chunk
                valid = k[None, :] < count[:, None]                  # (b, chunk)
                pair_idx = torch.clamp(start[:, None] + k, 0, n_pairs_buf - 1)
                g = torch.where(valid, bins.pair_gauss[pair_idx.long()], 0).long()
                means_l = proj.means2d[g] - origin[sl][:, None, :]
                co = quad_coeffs(means_l, proj.conics[g])          # (b, chunk, 6)
                op = torch.where(valid, proj.opacities[g], 0.0)
                ft = torch.cat([proj.colors[g], proj.depths[g][..., None],
                                torch.ones_like(op)[..., None]], dim=-1)
                sm = torch.where(valid, semantic_ids[g], -1)
                log_T, acc, best_w, best_id = _run_chunk(
                    _chunk_step, log_T, acc, best_w, best_id, co, op, ft, sm,
                    Xb)
            accs.append(acc)
            transs.append(torch.exp(log_T))
            sems.append(best_id)

    def untile(x):
        return _untile(x, tiles_x, tiles_y, width, height)

    acc_img = untile(torch.cat(accs))
    return {
        "rgb": acc_img[..., 0:3],
        "depth_acc": acc_img[..., 3],
        "alpha": acc_img[..., 4],
        "trans": untile(torch.cat(transs)[..., None])[..., 0],
        "semantic": untile(torch.cat(sems)[..., None])[..., 0].to(torch.int32),
        "tile_overflow": torch.sum(torch.clamp(bins.tile_count - cap, min=0)),
    }
