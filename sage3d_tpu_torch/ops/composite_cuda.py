"""Tile compositor on the hand-written CUDA kernels K2 (forward), K3
(backward) and K4 (the segment sum of the backward's gradient rows).

Replaces the JAX module ``sage3d_tpu/ops/composite_pallas.py`` (the
``"pallas"`` backend); this is the ``"cuda"`` backend of ``render``.
``composite_tiles_cuda`` takes the arguments of ``composite_tiles_pallas`` and
returns the same dict. The per-Gaussian (N, 16) attribute table keeps the
JAX layout, Gaussian id in ``GID_COL``.

The autograd boundary is the JAX ``custom_vjp``'s, ``attrs -> (out, k_end)``
(``_AttrComposite``). Its backward runs K3 (``csrc/composite_bwd.cu``) into a
buffer of per-pair gradient rows, one 128-row slot per chunk the forward
processed (packed by the forward's per-tile ``k_end``, at most
``grad_capacity`` slots), each row carrying its Gaussian id; a stable sort
groups the rows by id and K4 (``ops/segreduce.py``) sums them per Gaussian.
Rows no pair fills carry the out-of-range id N: they sort last and add
nothing.
The sort's payload is exact f32 by default (``GRAD_SORT_DEFAULT``); ``"f16"``
(per-channel absmax-scaled) and ``"bf16"`` are options.

``composite_fwd_plain`` and ``composite_bwd_plain`` are the kernels' plain
PyTorch versions; the wrappers take them only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build
from .binning import TILE_H, TILE_W, TileBins
from .composite_torch import _untile
from .projection import ALPHA_MAX, ALPHA_MIN, ProjectedGaussians
from .segreduce import segment_reduce_sorted

CHUNK = 128             # pairs per chunk
NPIX = TILE_W * TILE_H  # 1024 pixels per tile
NFEAT = 16              # attribute-table columns
NCH = 8                 # out channels: r,g,b,depth,alpha,trans,best_w,best_id
NGRAD = 10              # gradient channels: d_a..d_cy, dop, df_r..df_d
GID_COL = 11            # attr column carrying the Gaussian id (f32-exact < 2^24)
TRANS_EPS = 1e-4        # early-termination threshold, per tile
GRAD_SORT_DEFAULT = "f32"   # the backward's sort payload: exact f32
GRAD_SORT_MODES = ("f32", "f16", "bf16")
F16_SCALE = 30000.0     # "f16": each channel scaled to this absmax before the cast


def _pixel_centers(dev):
    """Tile-local pixel centers as (1, 1, NPIX) rows, x and y."""
    pix = torch.arange(NPIX, device=dev)
    px = ((pix % TILE_W).to(torch.float32) + 0.5)[None, None, :]
    py = ((pix // TILE_W).to(torch.float32) + 0.5)[None, None, :]
    return px, py


def _plain_chunk(attrs, pair_gauss, start, count, k, ox, oy, px, py):
    """Chunk ``k`` of a batch of tiles, as the kernels see it: the attribute
    rows (b, CHUNK, NFEAT), the lanes holding a pair (b, CHUNK), and alpha
    and its unclamped value (b, CHUNK, NPIX) in the kernels' tile-local form
    and operation order; lanes without a pair have alpha 0."""
    lanes = torch.arange(CHUNK, device=attrs.device)
    valid = lanes[None, :] < (count - k * CHUNK)[:, None]
    idx = torch.clamp(start[:, None] + k * CHUNK + lanes, 0,
                      pair_gauss.shape[0] - 1)
    co = attrs[pair_gauss[idx].long()]
    a, bb, c = co[..., 0:1], co[..., 1:2], co[..., 2:3]
    cx = co[..., 3:4] - ox
    cy = co[..., 4:5] - oy
    w0 = -0.5 * (a * cx * cx + c * cy * cy) - bb * cx * cy
    wx = a * cx + bb * cy
    wy = c * cy + bb * cx
    power = (w0 + wx * px + wy * py - 0.5 * a * (px * px)
             - 0.5 * c * (py * py) - bb * (px * py))
    raw = co[..., 5:6] * torch.exp(torch.clamp(power, max=0.0))
    raw = torch.where(power > 0.0, 0.0, raw)
    raw = torch.where(valid[..., None], raw, 0.0)
    alpha = torch.clamp(raw, max=ALPHA_MAX)
    alpha = torch.where(alpha < ALPHA_MIN, 0.0, alpha)
    return co, valid, alpha, raw


def composite_fwd_plain(attrs: torch.Tensor, pair_gauss: torch.Tensor,
                        tile_start: torch.Tensor, tile_count: torch.Tensor,
                        tiles_x: int, tile_batch: int = 128):
    """Plain PyTorch version of K2: the same chunk walk, alpha form, blend and
    per-tile early termination, vectorized over tiles in batches. Returns
    (out (T, NCH, NPIX) float32, k_end (T,) int32)."""
    dev = attrs.device
    n_tiles = tile_start.shape[0]
    px, py = _pixel_centers(dev)
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
            co, valid, alpha, _ = _plain_chunk(attrs, pair_gauss, start,
                                               count, k, ox, oy, px, py)
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

    ``attrs`` (N, NFEAT) float32, 16-byte aligned (the kernel reads its rows
    as float4; checked on every device); ``pair_gauss`` (P,) int32 with
    entries in [0, N); ``tile_start``/``tile_count`` (T,) int32 with every
    tile's range inside [0, P). A CPU tensor takes the plain version; a CUDA
    tensor launches ``csrc/composite_fwd.cu``."""
    tensors = (attrs, pair_gauss, tile_start, tile_count)
    if attrs.dim() != 2 or attrs.shape[1] != NFEAT or attrs.dtype != torch.float32:
        raise ValueError(f"attrs must be (N, {NFEAT}) float32")
    if attrs.data_ptr() % 16:
        raise ValueError("composite_fwd: attrs must be 16-byte aligned (the "
                         "kernel reads its rows as float4)")
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
    err = _build.launch(
        _build.load("composite_fwd").sage3d_composite_fwd, attrs.device,
        attrs.data_ptr(), pair_gauss.data_ptr(), tile_start.data_ptr(),
        tile_count.data_ptr(), out.data_ptr(), kend.data_ptr(), n_tiles,
        tiles_x, attrs.shape[0], pair_gauss.shape[0])
    _build.check(err, "composite_fwd")
    composite_fwd.launches += 1
    return out, kend


composite_fwd.launches = 0


def _slot_buffer(c_cap: int, n_gauss: int, dev) -> torch.Tensor:
    """The (c_cap * CHUNK, NFEAT) slot buffer before K3: zero payload and the
    out-of-range id ``n_gauss`` in GID_COL, which the rows no pair fills
    keep."""
    slots = torch.zeros((c_cap * CHUNK, NFEAT), dtype=torch.float32, device=dev)
    slots[:, GID_COL] = float(n_gauss)
    return slots


def composite_bwd_plain(attrs: torch.Tensor, pair_gauss: torch.Tensor,
                        tile_start: torch.Tensor, tile_count: torch.Tensor,
                        chunk0: torch.Tensor, allowed: torch.Tensor,
                        fwd_out: torch.Tensor, gout: torch.Tensor, c_cap: int,
                        tiles_x: int, tile_batch: int = 32) -> torch.Tensor:
    """Plain PyTorch version of K3, vectorized over tiles in batches: the
    forward replayed as ``composite_fwd_plain`` computes it, the ten gradient
    channels per pair summed over the tile's pixels, and row
    ``(chunk0[t] + k) * CHUNK + i`` of ``_slot_buffer`` written for every
    pair of the first ``allowed[t]`` chunks (Gaussian id in GID_COL)."""
    dev = attrs.device
    n_tiles = tile_start.shape[0]
    px, py = _pixel_centers(dev)
    lanes = torch.arange(CHUNK, device=dev)
    slots = _slot_buffer(c_cap, attrs.shape[0], dev)
    for t0 in range(0, n_tiles, tile_batch):
        tid = torch.arange(t0, min(t0 + tile_batch, n_tiles), device=dev)
        start = tile_start[tid].long()
        count = tile_count[tid].long()
        ch0 = chunk0[tid].long()
        allow = allowed[tid].long()
        ox = ((tid % tiles_x) * TILE_W).to(torch.float32)[:, None, None]
        oy = ((tid // tiles_x) * TILE_H).to(torch.float32)[:, None, None]
        g = gout[tid][:, :, None, :]                     # (b, NCH, 1, NPIX)
        f = fwd_out[tid][:, :, None, :]
        g0, g1, g2, g3, g4 = (g[:, ch] for ch in range(5))
        s_pix = g0 * f[:, 0] + g1 * f[:, 1] + g2 * f[:, 2] + g3 * f[:, 3] \
            + g4 * f[:, 4]
        gtt = g[:, 5] * f[:, 5]
        trans = torch.ones((tid.shape[0], NPIX), device=dev)
        prefix = torch.zeros((tid.shape[0], 1, NPIX), device=dev)
        for k in range(int(allow.max()) if tid.shape[0] else 0):
            act = k < allow
            co, valid, alpha, raw = _plain_chunk(attrs, pair_gauss, start,
                                                 count, k, ox, oy, px, py)
            t_run = torch.cumprod(torch.cat([trans[:, None, :], 1.0 - alpha],
                                            1), 1)
            t_at = t_run[:, :-1]
            w = alpha * t_at
            c = (co[..., 6:7] * g0 + co[..., 7:8] * g1 + co[..., 8:9] * g2
                 + co[..., 9:10] * g3 + g4)
            incl_cw = prefix + torch.cumsum(c * w, 1)
            om = 1.0 - alpha
            dalpha = c * t_at - (s_pix - incl_cw) / om - gtt / om
            dalpha = torch.where((alpha > 0.0) & (raw <= ALPHA_MAX), dalpha, 0.0)
            dpower = dalpha * alpha
            op = co[..., 5]
            dx = px - (co[..., 3:4] - ox)
            dy = py - (co[..., 4:5] - oy)
            zeros = torch.zeros_like(op)
            rows = torch.stack([
                (dpower * (-0.5 * dx * dx)).sum(-1),
                (dpower * (-dx * dy)).sum(-1),
                (dpower * (-0.5 * dy * dy)).sum(-1),
                (dpower * (co[..., 0:1] * dx + co[..., 1:2] * dy)).sum(-1),
                (dpower * (co[..., 2:3] * dy + co[..., 1:2] * dx)).sum(-1),
                dpower.sum(-1) / torch.where(op > 0, op, 1.0),
                (g0 * w).sum(-1), (g1 * w).sum(-1), (g2 * w).sum(-1),
                (g3 * w).sum(-1),
                zeros, co[..., GID_COL], zeros, zeros, zeros, zeros,
            ], dim=-1)                                   # (b, CHUNK, NFEAT)
            dest = (ch0 + k)[:, None] * CHUNK + lanes
            keep = act[:, None] & valid
            slots[dest[keep]] = rows[keep]
            trans = torch.where(act[:, None], t_run[:, -1], trans)
            prefix = torch.where(act[:, None, None], incl_cw[:, -1:], prefix)
    return slots


def composite_bwd(attrs: torch.Tensor, pair_gauss: torch.Tensor,
                  tile_start: torch.Tensor, tile_count: torch.Tensor,
                  chunk0: torch.Tensor, allowed: torch.Tensor,
                  fwd_out: torch.Tensor, gout: torch.Tensor, c_cap: int,
                  tiles_x: int) -> torch.Tensor:
    """K3 wrapper: the (c_cap * CHUNK, NFEAT) float32 slot buffer of per-pair
    gradient rows (channels 0..NGRAD-1, Gaussian id in GID_COL). Rows no pair
    fills (lanes past a chunk's last pair, slots past a tile's allowed
    chunks) keep zero payload and the out-of-range id N = ``attrs.shape[0]``.

    Tile ``t`` fills slots ``chunk0[t] .. chunk0[t] + allowed[t] - 1``; the
    caller keeps those inside ``[0, c_cap)`` and ``allowed[t]`` within the
    forward's ``k_end[t]``. ``fwd_out``/``gout`` are (T, NCH, NPIX) float32:
    K2's output and its cotangent. A CPU tensor takes the plain version; a
    CUDA tensor launches ``csrc/composite_bwd.cu``."""
    ints = (pair_gauss, tile_start, tile_count, chunk0, allowed)
    if attrs.dim() != 2 or attrs.shape[1] != NFEAT or attrs.dtype != torch.float32:
        raise ValueError(f"attrs must be (N, {NFEAT}) float32")
    if any(x.dtype != torch.int32 or x.dim() != 1 for x in ints):
        raise ValueError("pair_gauss, tile_start, tile_count, chunk0 and "
                         "allowed must be 1-D int32")
    n_tiles = tile_start.shape[0]
    if any(x.shape != (n_tiles,) for x in ints[2:]):
        raise ValueError("tile ranges, chunk0 and allowed differ in shape")
    for x in (fwd_out, gout):
        if x.shape != (n_tiles, NCH, NPIX) or x.dtype != torch.float32:
            raise ValueError(f"fwd_out and gout must be (T, {NCH}, {NPIX}) "
                             "float32")
    tensors = (attrs, *ints, fwd_out, gout)
    if any(x.device != attrs.device for x in tensors):
        raise ValueError("composite_bwd: inputs on different devices")
    if attrs.device.type == "cpu":
        return composite_bwd_plain(attrs, pair_gauss, tile_start, tile_count,
                                   chunk0, allowed, fwd_out, gout, c_cap,
                                   tiles_x)
    if attrs.device.type != "cuda":
        raise ValueError(f"composite_bwd: unsupported device {attrs.device}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("composite_bwd: inputs must be contiguous")
    if attrs.data_ptr() % 16:
        raise ValueError("composite_bwd: attrs must be 16-byte aligned (the "
                         "kernel reads its rows as float4)")
    if max(attrs.shape[0], pair_gauss.shape[0], n_tiles, c_cap) >= 2**31:
        raise ValueError("composite_bwd: sizes must fit int32")
    slots = _slot_buffer(c_cap, attrs.shape[0], attrs.device)
    err = _build.launch(
        _build.load("composite_bwd").sage3d_composite_bwd, attrs.device,
        attrs.data_ptr(), pair_gauss.data_ptr(), tile_start.data_ptr(),
        tile_count.data_ptr(), chunk0.data_ptr(), allowed.data_ptr(),
        fwd_out.data_ptr(), gout.data_ptr(), slots.data_ptr(), n_tiles,
        tiles_x, attrs.shape[0], pair_gauss.shape[0], c_cap)
    _build.check(err, "composite_bwd")
    composite_bwd.launches += 1
    return slots


composite_bwd.launches = 0


def composite_bwd_registers() -> int:
    """Registers per thread of K3's kernel (cudaFuncGetAttributes); card
    only."""
    regs = ctypes.c_int(0)
    _build.check(_build.load("composite_bwd").sage3d_composite_bwd_regs(
        ctypes.byref(regs)), "composite_bwd_regs")
    return regs.value


def slot_ranges(kend: torch.Tensor, c_cap: int):
    """Each tile's first gradient slot and its number of slots: the slots
    are packed by the forward's k_end, and chunks past ``c_cap`` are cut
    (counted as overflow by ``composite_tiles_cuda``). Returns (chunk0,
    allowed), (T,) int32."""
    kend = kend.long()
    chunk0 = torch.cumsum(kend, 0) - kend
    allowed = torch.clamp(torch.minimum(kend, c_cap - chunk0), min=0)
    return chunk0.to(torch.int32), allowed.to(torch.int32)


def composite_vjp(attrs: torch.Tensor, pair_gauss: torch.Tensor,
                  tile_start: torch.Tensor, tile_count: torch.Tensor,
                  kend: torch.Tensor, fwd_out: torch.Tensor,
                  gout: torch.Tensor, tiles_x: int, c_cap: int,
                  grad_sort: str = GRAD_SORT_DEFAULT) -> torch.Tensor:
    """The backward of ``attrs -> out``: d_attrs (N, NFEAT), columns NGRAD..
    zero. K3 fills the slot buffer; a stable sort groups its rows by the
    Gaussian id they carry; K4 sums each Gaussian's rows. The rows no pair
    filled carry the id N: they sort last and K4 skips them, and the rows
    of every Gaussian keep their order, so a larger ``c_cap`` changes no
    bit of the result. Nothing waits for the device.

    ``grad_sort`` picks the sort's payload: ``"f32"`` (exact, the default)
    as K3 wrote it; ``"f16"`` scales each channel to an absmax of 30000,
    rounds to f16 and divides the (N, NGRAD) sums by the scales; ``"bf16"``
    rounds to bf16 as is. The rounded values overwrite the slot rows'
    payload, so K4 reads the rows through the sort's permutation in every
    mode. The sums are f32 in every mode."""
    if grad_sort not in GRAD_SORT_MODES:
        raise ValueError(f"unknown grad_sort mode: {grad_sort}")
    chunk0, allowed = slot_ranges(kend, c_cap)
    slots = composite_bwd(attrs, pair_gauss, tile_start, tile_count, chunk0,
                          allowed, fwd_out, gout, c_cap, tiles_x)
    ids_sorted, perm = torch.sort(slots[:, GID_COL].to(torch.int32),
                                  stable=True)
    n = attrs.shape[0]
    grads = slots[:, :NGRAD]
    scales = None
    if grad_sort == "f16":
        absmax = grads.abs().amax(0)
        scales = F16_SCALE / torch.clamp(absmax, min=1e-30)
        grads.copy_((grads * scales).to(torch.float16))
    elif grad_sort == "bf16":
        grads.copy_(grads.to(torch.bfloat16))
    dg = segment_reduce_sorted(ids_sorted, grads, n, perm=perm)
    if scales is not None:
        dg = dg / scales
    return torch.cat([dg, torch.zeros((n, NFEAT - NGRAD), dtype=dg.dtype,
                                      device=dg.device)], 1)


class _AttrComposite(torch.autograd.Function):
    """``attrs -> (out, k_end)`` through K2, with the analytic backward of
    ``composite_vjp``: the JAX package's ``custom_vjp`` boundary."""

    @staticmethod
    def forward(ctx, attrs, pair_gauss, tile_start, tile_count, tiles_x,
                c_cap, grad_sort):
        out, kend = composite_fwd(attrs, pair_gauss, tile_start, tile_count,
                                  tiles_x)
        ctx.mark_non_differentiable(kend)
        ctx.save_for_backward(attrs, pair_gauss, tile_start, tile_count, kend,
                              out)
        ctx.tiles_x, ctx.c_cap, ctx.grad_sort = tiles_x, c_cap, grad_sort
        return out, kend

    @staticmethod
    def backward(ctx, gout, _gkend):
        attrs, pair_gauss, tile_start, tile_count, kend, out = ctx.saved_tensors
        d_attrs = composite_vjp(attrs, pair_gauss, tile_start, tile_count,
                                kend, out, gout.contiguous(), ctx.tiles_x,
                                ctx.c_cap, ctx.grad_sort)
        return d_attrs, None, None, None, None, None, None


def attr_composite(attrs: torch.Tensor, pair_gauss: torch.Tensor,
                   tile_start: torch.Tensor, tile_count: torch.Tensor,
                   tiles_x: int, c_cap: int,
                   grad_sort: str = GRAD_SORT_DEFAULT):
    """Differentiable ``attrs -> (out (T, NCH, NPIX), k_end (T,))``: K2
    forward; backward through K3, the sort and K4 into a gradient buffer of
    ``c_cap`` chunk slots. ``k_end`` carries no gradient."""
    if grad_sort not in GRAD_SORT_MODES:
        raise ValueError(f"unknown grad_sort mode: {grad_sort}")
    return _AttrComposite.apply(attrs, pair_gauss, tile_start, tile_count,
                                tiles_x, int(c_cap), grad_sort)


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
    grad_sort_bf16: bool = False,
    grad_sort: str = None,
    grad_capacity: int = 0,
) -> Dict[str, torch.Tensor]:
    """Composite via kernel K2, differentiable through K3 and K4. Same output
    schema as ``composite_tiles``.

    ``pair_capacity`` (0 = the binning entry budget) trims the sorted pair
    array; trimmed pairs are counted as overflow. ``grad_capacity`` (in
    CHUNK-sized slots; 0 = the safe bound pair_capacity//CHUNK + n_tiles) is
    the backward's gradient buffer: the forward's total k_end
    (``grad_chunks``) beyond it is counted in ``tile_overflow``, so an
    undersized capacity never passes silently. ``grad_sort``: the backward's
    sort payload, ``"f32"`` (default, exact), ``"f16"`` or ``"bf16"``;
    ``grad_sort_bf16=True`` is the JAX package's alias for ``"bf16"``.
    """
    mode = grad_sort if grad_sort is not None else (
        "bf16" if grad_sort_bf16 else GRAD_SORT_DEFAULT)
    if mode not in GRAD_SORT_MODES:
        raise ValueError(f"unknown grad_sort mode: {mode}")
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
    out, kend = attr_composite(attrs, pair_gauss_t, tile_start_t, count_c,
                               tiles_x, c_cap, mode)
    grad_chunks = torch.sum(kend, dtype=torch.int32)
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
