"""Tile compositor on the hand-written CUDA kernel K2 (forward only).

Replaces the JAX module ``sage3d_tpu/ops/composite_pallas.py`` (the
``"pallas"`` backend); this is the ``"cuda"`` backend of ``render``.
``composite_tiles_cuda`` takes the arguments of ``composite_tiles_pallas`` and
returns the same dict. The per-Gaussian (N, 16) attribute table keeps the
JAX layout, Gaussian id in ``GID_COL``, so the backward kernels can reuse it.

The kernel is ``csrc/composite_fwd.cu``; ``composite_fwd_plain`` is its plain
PyTorch version. ``composite_fwd`` takes the plain version only for CPU
tensors. The analytic backward (K3, and the segment reduction K4) is not
ported yet: the ``cuda`` backend raises if an input requires grad.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import _build
from .binning import TILE_H, TILE_W, TileBins
from .composite_torch import _untile
from .projection import ALPHA_MAX, ALPHA_MIN, ProjectedGaussians

CHUNK = 128             # pairs per chunk
NPIX = TILE_W * TILE_H  # 1024 pixels per tile
NFEAT = 16              # attribute-table columns
NCH = 8                 # out channels: r,g,b,depth,alpha,trans,best_w,best_id
GID_COL = 11            # attr column carrying the Gaussian id (f32-exact < 2^24)
TRANS_EPS = 1e-4        # early-termination threshold, per tile


def composite_fwd_plain(attrs: torch.Tensor, pair_gauss: torch.Tensor,
                        tile_start: torch.Tensor, tile_count: torch.Tensor,
                        tiles_x: int, tile_batch: int = 128):
    """Plain PyTorch version of K2: the same chunk walk, alpha form, blend and
    per-tile early termination, vectorized over tiles in batches. Returns
    (out (T, NCH, NPIX) float32, k_end (T,) int32)."""
    dev = attrs.device
    n_tiles = tile_start.shape[0]
    n_pairs = pair_gauss.shape[0]
    pix = torch.arange(NPIX, device=dev)
    px = ((pix % TILE_W).to(torch.float32) + 0.5)[None, None, :]
    py = ((pix // TILE_W).to(torch.float32) + 0.5)[None, None, :]
    lanes = torch.arange(CHUNK, device=dev)
    outs, kends = [], []
    for t0 in range(0, n_tiles, tile_batch):
        tid = torch.arange(t0, min(t0 + tile_batch, n_tiles), device=dev)
        b = tid.shape[0]
        start = tile_start[tid].long()
        count = tile_count[tid].long()
        n_chunks = (count + CHUNK - 1) // CHUNK
        ox = ((tid % tiles_x) * TILE_W).to(torch.float32)[:, None, None]
        oy = ((tid // tiles_x) * TILE_H).to(torch.float32)[:, None, None]
        trans = torch.ones((b, NPIX), device=dev)
        acc = torch.zeros((b, 5, NPIX), device=dev)
        best_w = torch.zeros((b, NPIX), device=dev)
        best_id = torch.full((b, NPIX), -1.0, device=dev)
        k_end = torch.zeros((b,), dtype=torch.int32, device=dev)
        active = torch.ones((b,), dtype=torch.bool, device=dev)
        for k in range(int(n_chunks.max()) if b else 0):
            active = active & (k < n_chunks) & (trans.amax(-1) > TRANS_EPS)
            if not bool(active.any()):
                break
            valid = lanes[None, :] < (count - k * CHUNK)[:, None]   # (b, CHUNK)
            idx = torch.clamp(start[:, None] + k * CHUNK + lanes, 0, n_pairs - 1)
            co = attrs[pair_gauss[idx].long()]                        # (b, CHUNK, 16)
            a, bb, c = co[..., 0:1], co[..., 1:2], co[..., 2:3]
            cx = co[..., 3:4] - ox
            cy = co[..., 4:5] - oy
            w0 = -0.5 * (a * cx * cx + c * cy * cy) - bb * cx * cy
            wx = a * cx + bb * cy
            wy = c * cy + bb * cx
            power = (w0 + wx * px + wy * py - 0.5 * a * (px * px)
                     - 0.5 * c * (py * py) - bb * (px * py))         # (b, CHUNK, NPIX)
            raw = co[..., 5:6] * torch.exp(torch.clamp(power, max=0.0))
            raw = torch.where(power > 0.0, 0.0, raw)
            raw = torch.where(valid[..., None], raw, 0.0)
            alpha = torch.clamp(raw, max=ALPHA_MAX)
            alpha = torch.where(alpha < ALPHA_MIN, 0.0, alpha)
            # T before each pair: a running product seeded with the tile's
            # transmittance, in the kernel's left-to-right order.
            t_run = torch.cumprod(torch.cat([trans[:, None, :], 1.0 - alpha], 1), 1)
            w = alpha * t_run[:, :-1]
            acc_new = acc + torch.stack(
                [(w * co[..., ch:ch + 1]).sum(1) for ch in (6, 7, 8, 9)]
                + [w.sum(1)], dim=1)
            cmax, first = torch.max(w, dim=1)             # first max in depth order
            sel = torch.gather(co[..., 10], 1, first)
            better = cmax > best_w
            act = active[:, None]
            acc = torch.where(act[..., None], acc_new, acc)
            best_id = torch.where(act & better, sel, best_id)
            best_w = torch.where(act & better, cmax, best_w)
            trans = torch.where(act, t_run[:, -1], trans)
            k_end = k_end + active.to(torch.int32)
        outs.append(torch.cat([acc, trans[:, None], best_w[:, None],
                               best_id[:, None]], 1))
        kends.append(k_end)
    if not outs:
        return (torch.zeros((0, NCH, NPIX), device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev))
    return torch.cat(outs), torch.cat(kends)


def composite_fwd(attrs: torch.Tensor, pair_gauss: torch.Tensor,
                  tile_start: torch.Tensor, tile_count: torch.Tensor,
                  tiles_x: int):
    """K2 wrapper: (out (T, NCH, NPIX) float32, k_end (T,) int32).

    ``attrs`` (N, NFEAT) float32; ``pair_gauss`` (P,) int32 with entries in
    [0, N); ``tile_start``/``tile_count`` (T,) int32 with every tile's range
    inside [0, P). A CPU tensor takes the plain version; a CUDA tensor
    launches ``csrc/composite_fwd.cu``."""
    tensors = (attrs, pair_gauss, tile_start, tile_count)
    if attrs.dim() != 2 or attrs.shape[1] != NFEAT or attrs.dtype != torch.float32:
        raise ValueError(f"attrs must be (N, {NFEAT}) float32")
    if any(x.dtype != torch.int32 or x.dim() != 1 for x in tensors[1:]):
        raise ValueError("pair_gauss, tile_start and tile_count must be 1-D int32")
    if tile_start.shape != tile_count.shape:
        raise ValueError("tile_start and tile_count differ in shape")
    if any(x.device != attrs.device for x in tensors):
        raise ValueError("composite_fwd: inputs on different devices")
    n_tiles = tile_start.shape[0]
    if attrs.device.type == "cpu":
        return composite_fwd_plain(attrs, pair_gauss, tile_start, tile_count,
                                   tiles_x)
    if attrs.device.type != "cuda":
        raise ValueError(f"composite_fwd: unsupported device {attrs.device}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("composite_fwd: inputs must be contiguous")
    if max(attrs.shape[0], pair_gauss.shape[0], n_tiles) >= 2**31:
        raise ValueError("composite_fwd: sizes must fit int32")
    out = torch.empty((n_tiles, NCH, NPIX), dtype=torch.float32,
                      device=attrs.device)
    kend = torch.empty((n_tiles,), dtype=torch.int32, device=attrs.device)
    lib = _build.load("composite_fwd")
    with torch.cuda.device(attrs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sage3d_composite_fwd(
            attrs.data_ptr(), pair_gauss.data_ptr(), tile_start.data_ptr(),
            tile_count.data_ptr(), out.data_ptr(), kend.data_ptr(), n_tiles,
            tiles_x, attrs.shape[0], pair_gauss.shape[0], stream)
    _build.check(err, "composite_fwd")
    composite_fwd.launches += 1
    return out, kend


composite_fwd.launches = 0


def attribute_table(proj: ProjectedGaussians,
                    semantic_ids: torch.Tensor) -> torch.Tensor:
    """The per-Gaussian (N, NFEAT) table: conic a/b/c, mean x/y, opacity,
    rgb, depth, semantic id, Gaussian id (GID_COL), 4 zero pads."""
    n = proj.depths.shape[0]
    dev = proj.depths.device
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    return torch.stack([
        proj.conics[:, 0], proj.conics[:, 1], proj.conics[:, 2],
        proj.means2d[:, 0], proj.means2d[:, 1],
        proj.opacities,
        proj.colors[:, 0], proj.colors[:, 1], proj.colors[:, 2],
        proj.depths,
        semantic_ids.to(torch.float32),
        torch.arange(n, dtype=torch.float32, device=dev),   # GID_COL
        zeros, zeros, zeros, zeros,
    ], dim=1)


def trim_to_capacity(bins: TileBins, pair_capacity: int = 0):
    """Cut the sorted pair list to ``pair_capacity`` (0 = keep it whole) and
    clip every tile's range to it. Returns (pair_gauss, tile_start,
    tile_count, pair_capacity), int32 and contiguous."""
    full_p = bins.pair_gauss.shape[0]
    if not pair_capacity or pair_capacity >= full_p:
        pair_capacity = full_p
    start = torch.clamp(bins.tile_start, max=pair_capacity)
    count = torch.clamp(torch.clamp(bins.tile_start + bins.tile_count,
                                    max=pair_capacity) - start, min=0)
    return (bins.pair_gauss[:pair_capacity].contiguous(),
            start.to(torch.int32).contiguous(),
            count.to(torch.int32).contiguous(), pair_capacity)


def composite_tiles_cuda(
    proj: ProjectedGaussians,
    semantic_ids: torch.Tensor,
    bins: TileBins,
    width: int,
    height: int,
    tile_capacity: int = 4096,
    pair_capacity: int = 0,
    grad_capacity: int = 0,
) -> Dict[str, torch.Tensor]:
    """Composite via kernel K2. Same output schema as ``composite_tiles``.

    ``pair_capacity`` (0 = the binning entry budget) trims the sorted pair
    array; trimmed pairs are counted as overflow. ``grad_capacity`` (in
    CHUNK-sized slots; 0 = the safe bound pair_capacity//CHUNK + n_tiles) is
    the backward's gradient buffer: the forward's total k_end
    (``grad_chunks``) beyond it is counted in ``tile_overflow``, so an
    undersized capacity never passes silently.
    """
    if any(isinstance(x, torch.Tensor) and x.requires_grad for x in proj):
        raise NotImplementedError(
            "the cuda backend is forward-only: its analytic backward (kernels "
            "K3 and K4) comes with the next slice of the port; render under "
            "torch.no_grad() or use backend='torch'")
    tiles_x, tiles_y = bins.tiles_x, bins.tiles_y
    n_tiles = tiles_x * tiles_y
    pair_gauss_t, tile_start_t, tile_count_t, pair_capacity = trim_to_capacity(
        bins, pair_capacity)
    count_c = torch.clamp(tile_count_t, max=tile_capacity)
    trim_overflow = torch.clamp(bins.n_pairs - pair_capacity, min=0)
    c_cap = int(grad_capacity) if grad_capacity and grad_capacity > 0 else (
        pair_capacity // CHUNK + n_tiles)

    n = proj.depths.shape[0]
    # The backward routes gradients by a float32 Gaussian id (GID_COL),
    # exact only below 2^24: refuse larger scenes here, as the JAX package does.
    if n >= (1 << 24):
        raise ValueError(
            f"composite_tiles_cuda: {n} Gaussians >= 2^24; the f32 id channel "
            "of the backward would mis-route gradients. Use the torch "
            "compositor or shard the scene.")
    attrs = attribute_table(proj, semantic_ids)
    out, kend = composite_fwd(attrs, pair_gauss_t, tile_start_t, count_c,
                              tiles_x)
    grad_chunks = torch.sum(kend)
    grad_overflow = torch.clamp(grad_chunks - c_cap, min=0) * CHUNK

    imgs = _untile(out.transpose(1, 2), tiles_x, tiles_y, width, height)
    return {
        "rgb": imgs[..., 0:3],
        "depth_acc": imgs[..., 3],
        "alpha": imgs[..., 4],
        "trans": imgs[..., 5],
        "semantic": imgs[..., 7].to(torch.int32),
        "grad_chunks": grad_chunks,
        "tile_overflow": torch.sum(torch.clamp(tile_count_t - tile_capacity,
                                               min=0))
        + trim_overflow + grad_overflow,
    }
