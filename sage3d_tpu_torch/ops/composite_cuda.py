"""Tile compositor on the hand-written CUDA kernels K2 (forward), K3
(backward) and K4 (the segment sum of the backward's gradient rows).

Replaces the JAX module ``sage3d_tpu/ops/composite_pallas.py`` (the
``"pallas"`` backend); this is the ``"cuda"`` backend of ``render``.
``composite_tiles_cuda`` takes the arguments of ``composite_tiles_pallas`` and
returns the same dict. The per-Gaussian (N, 16) attribute table keeps the
JAX layout, Gaussian id in ``GID_COL``; past 2^24 rows, where a float32 no
longer holds every id, the id's low 24 bits stay in ``GID_COL`` and its high
bits go to ``GID_HI_COL``, one of the JAX layout's zero pads, so tables
below 2^24 rows are bitwise the JAX package's (``gid_split``).

The autograd boundary is the JAX ``custom_vjp``'s, ``attrs -> (out, k_end)``
(``_AttrComposite``). Its backward runs K3 (``csrc/composite_bwd.cu``) into a
buffer of per-pair gradient rows, one 128-row slot per chunk the forward
processed (packed by the forward's per-tile ``k_end``, at most
``grad_capacity`` slots), each row carrying its Gaussian id (low bits in
``GID_COL``, high bits in ``SLOT_HI_COL``); a stable sort of the int32 id
(``slot_ids``) groups the rows by id and K4 (``ops/segreduce.py``) sums
them per Gaussian.
Rows no pair fills carry the out-of-range id N: they sort last and add
nothing.
The sort's payload is exact f32 by default (``GRAD_SORT_DEFAULT``); ``"f16"``
(per-channel absmax-scaled) and ``"bf16"`` are options.

A stacked camera batch (``project_gaussians`` over B cameras and the batch's
``bin_gaussians``) composites in one launch of K2, and its backward in one of
K3 and one of K4, as the JAX package's vmapped ``pallas_call``s do: the
attribute table has B·N rows (camera b's Gaussian g at row b·N + g, its id
in ``GID_COL``), the kernels walk B·T camera-major tiles and take each
tile's pixel origin from its index within its camera (``cam_tiles``), and
K4 sums the B·N ids' rows; autograd through the batched projection then adds
the cameras' gradients. Each camera's images, ``k_end`` and gradient rows
are bitwise what it gives alone; budgets (``pair_capacity``,
``tile_capacity``, ``grad_capacity``) apply per camera.

Under autograd a dense tile's backward walk is split into segments of
``seg`` chunks, one K3 block each, so that a frame of few dense tiles (a
mesh rank's band) still fills the card: K2 writes each pixel's
transmittance and accumulators at every ``seg``-th chunk boundary
(``composite_fwd(..., seg=)``), and K3 starts each segment from them.
``segment_chunks`` picks ``seg`` from the pair count and the card's
resident K3 blocks. Past a tile's first segment the rows differ from the
single sweep's by float32 rounding of the running prefix of c * w, which
restarts from K2's accumulators (``csrc/composite_bwd.cu``).

``composite_fwd_plain`` and ``composite_bwd_plain`` are the kernels' plain
PyTorch versions; the wrappers take them only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ..utils.profiling import count as add_count, span
from . import _build
from .binning import TILE_H, TILE_W, TileBins
from .projection import ALPHA_MAX, ALPHA_MIN, ProjectedGaussians
from .segreduce import segment_reduce_sorted

CHUNK = 128             # pairs per chunk
NPIX = TILE_W * TILE_H  # 1024 pixels per tile
NFEAT = 16              # attribute-table columns
NCH = 8                 # out channels: r,g,b,depth,alpha,trans,best_w,best_id
NGRAD = 10              # gradient channels: d_a..d_cy, dop, df_r..df_d
GID_COL = 11            # the Gaussian id's low 24 bits, as a float (exact)
GID_HI_COL = 12         # attribute table: the id's high bits (id >> 24)
SLOT_HI_COL = 10        # gradient slot rows: the id's high bits
GID_LO_BITS = 24        # a float32 holds every integer below 2^24 exactly
GID_LIMIT = 2**31 - 1   # rows of a table (B·N for a camera batch) the id
                        # routes exactly: the sort key hi·2^24 + lo, and the
                        # out-of-range id N of unfilled rows, are int32
TRANS_EPS = 1e-4        # early-termination threshold, per tile
GRAD_SORT_DEFAULT = "f32"   # the backward's sort payload: exact f32
GRAD_SORT_MODES = ("f32", "f16", "bf16")
F16_SCALE = 30000.0     # "f16": each channel scaled to this absmax before the cast
CKPT_CH = 6             # a segment checkpoint: T, r, g, b, depth, alpha a pixel
SPLIT_WAVES = 8         # K3 segments: about this many waves of the card's
                        # resident blocks over a frame's chunks


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


def _origin(tid: torch.Tensor, tiles_x: int, cam_tiles: int):
    """Pixel origins (b, 1, 1) of tiles ``tid``: the tile's index within its
    camera (``cam_tiles`` tiles a camera) in rows of ``tiles_x``."""
    tc = tid % cam_tiles
    return (((tc % tiles_x) * TILE_W).to(torch.float32)[:, None, None],
            ((tc // tiles_x) * TILE_H).to(torch.float32)[:, None, None])


def checkpoint_rows(n_pairs: int, seg: int) -> int:
    """Rows of the segment checkpoint buffer of a pair list of ``n_pairs``
    pairs with segments of ``seg`` chunks: tile t's checkpoint of chunk k
    (a multiple of ``seg``) is row ``tile_start[t] // (seg * CHUNK) + k //
    seg``, distinct for every tile and k since a tile's pairs are one range
    of the list."""
    return max(1, -(-n_pairs // (seg * CHUNK)))


def composite_fwd_plain(attrs: torch.Tensor, pair_gauss: torch.Tensor,
                        tile_start: torch.Tensor, tile_count: torch.Tensor,
                        tiles_x: int, tile_batch: int = 128,
                        cam_tiles: int = 0, seg: int = 0):
    """Plain PyTorch version of K2: the same chunk walk, alpha form, blend and
    per-tile early termination, vectorized over tiles in batches. Returns
    (out (T, NCH, NPIX) float32, k_end (T,) int32). ``cam_tiles``: tiles of
    one camera of a batch (0: all T). ``seg`` > 0: also the segment
    checkpoints (``checkpoint_rows`` x CKPT_CH x NPIX float32), each tile's
    T and accumulators before every chunk k it walks with k a positive
    multiple of ``seg``; other rows zero."""
    dev = attrs.device
    n_tiles = tile_start.shape[0]
    cam_tiles = cam_tiles or max(n_tiles, 1)
    px, py = _pixel_centers(dev)
    ckpt = (torch.zeros((checkpoint_rows(pair_gauss.shape[0], seg), CKPT_CH,
                         NPIX), device=dev) if seg else None)
    outs, kends = [], []
    for t0 in range(0, n_tiles, tile_batch):
        tid = torch.arange(t0, min(t0 + tile_batch, n_tiles), device=dev)
        b = tid.shape[0]
        start = tile_start[tid].long()
        count = tile_count[tid].long()
        n_chunks = (count + CHUNK - 1) // CHUNK
        ox, oy = _origin(tid, tiles_x, cam_tiles)
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
            if seg and k and k % seg == 0:
                rows = start // (seg * CHUNK) + k // seg
                ckpt[rows[active]] = torch.cat([trans[:, None], acc],
                                               1)[active]
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
        out = (torch.zeros((0, NCH, NPIX), device=dev),
               torch.zeros((0,), dtype=torch.int32, device=dev))
    else:
        out = torch.cat(outs), torch.cat(kends)
    return out + (ckpt,) if seg else out


def _cam_tiles(cam_tiles: int, n_tiles: int) -> int:
    """``cam_tiles`` checked against the tile count (0: one camera)."""
    cam_tiles = int(cam_tiles) or max(n_tiles, 1)
    if cam_tiles < 1 or n_tiles % cam_tiles:
        raise ValueError(f"{n_tiles} tiles are not whole cameras of "
                         f"{cam_tiles} tiles")
    return cam_tiles


def composite_fwd(attrs: torch.Tensor, pair_gauss: torch.Tensor,
                  tile_start: torch.Tensor, tile_count: torch.Tensor,
                  tiles_x: int, cam_tiles: int = 0, seg: int = 0):
    """K2 wrapper: (out (T, NCH, NPIX) float32, k_end (T,) int32), and
    with ``seg`` > 0 chunks the segment checkpoints K3 splits its walk with
    (``composite_fwd_plain``; rows the walk never reaches are not written):
    (out, k_end, ckpt). ``out`` and ``k_end`` are the same either way.

    ``attrs`` (N, NFEAT) float32, 16-byte aligned (the kernel reads its rows
    as float4; checked on every device); ``pair_gauss`` (P,) int32 with
    entries in [0, N); ``tile_start``/``tile_count`` (T,) int32 with every
    tile's range inside [0, P). ``cam_tiles``: the tiles of one camera when
    the T tiles are a camera batch's, camera-major (0: one camera). A CPU
    tensor takes the plain version; a CUDA tensor launches
    ``csrc/composite_fwd.cu``, once for the whole batch."""
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
    cam_tiles = _cam_tiles(cam_tiles, n_tiles)
    seg = _check_seg(seg)
    if attrs.device.type == "cpu":
        return composite_fwd_plain(attrs, pair_gauss, tile_start, tile_count,
                                   tiles_x, cam_tiles=cam_tiles, seg=seg)
    if attrs.device.type != "cuda":
        raise ValueError(f"composite_fwd: unsupported device {attrs.device}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("composite_fwd: inputs must be contiguous")
    if max(attrs.shape[0], pair_gauss.shape[0], n_tiles) >= 2**31:
        raise ValueError("composite_fwd: sizes must fit int32")
    out = torch.empty((n_tiles, NCH, NPIX), dtype=torch.float32,
                      device=attrs.device)
    kend = torch.empty((n_tiles,), dtype=torch.int32, device=attrs.device)
    ckpt = (torch.empty((checkpoint_rows(pair_gauss.shape[0], seg), CKPT_CH,
                         NPIX), dtype=torch.float32, device=attrs.device)
            if seg else None)
    err = _build.launch(
        _build.load("composite_fwd").sage3d_composite_fwd, attrs.device,
        attrs.data_ptr(), pair_gauss.data_ptr(), tile_start.data_ptr(),
        tile_count.data_ptr(), out.data_ptr(), kend.data_ptr(),
        ckpt.data_ptr() if seg else None, seg, n_tiles, tiles_x, cam_tiles,
        attrs.shape[0], pair_gauss.shape[0])
    _build.check(err, "composite_fwd")
    composite_fwd.launches += 1
    return (out, kend, ckpt) if seg else (out, kend)


composite_fwd.launches = 0


def _check_seg(seg) -> int:
    seg = int(seg)
    if seg < 0 or seg >= 2**31 // CHUNK:
        raise ValueError(f"segment length {seg} chunks: must be 0 (no "
                         f"segments) or in [1, {2**31 // CHUNK})")
    return seg


_RESIDENT: Dict[int, int] = {}   # device index -> K3 blocks the card holds


def resident_blocks(device: torch.device) -> int:
    """K3 blocks the card holds at once: its SMs times the blocks an SM
    holds (the occupancy calculator, for K3's registers and shared
    memory); card only, asked once per device."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _RESIDENT:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(index):
            _build.check(_build.load("composite_bwd")
                         .sage3d_composite_bwd_occupancy(ctypes.byref(per_sm)),
                         "composite_bwd_occupancy")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _RESIDENT[index] = sms * max(per_sm.value, 1)
    return _RESIDENT[index]


def segment_chunks(n_pairs: int, device: torch.device) -> int:
    """The chunks of one K3 segment for a frame of ``n_pairs`` listed pairs
    on ``device``: the list's chunks over ``SPLIT_WAVES`` waves of the card's
    resident K3 blocks, so that a frame of few dense tiles gives enough
    blocks to fill the card and long walks end in short pieces; 0 (one
    segment a tile) on the CPU, or where one segment would hold the whole
    list. From shapes alone: it does not read the device, and a tight
    ``grad_capacity`` gets the segments of the safe bound."""
    if device.type != "cuda":
        return 0
    chunks = -(-n_pairs // CHUNK)
    seg = max(1, -(-chunks // (SPLIT_WAVES * resident_blocks(device))))
    return seg if seg < chunks else 0


def gid_split(ids: torch.Tensor):
    """Integer Gaussian ids as the two float32 columns that carry them:
    (id mod 2^24, id >> 24), each exact. Below 2^24 the high part is 0 and
    the low part is the id, as the JAX package's single float column."""
    ids = ids.to(torch.int64)
    return ((ids & ((1 << GID_LO_BITS) - 1)).to(torch.float32),
            (ids >> GID_LO_BITS).to(torch.float32))


def slot_ids(slots: torch.Tensor, n_gauss: int) -> torch.Tensor:
    """The int32 Gaussian id of every slot row, the gradient sort's key:
    hi·2^24 + lo from ``SLOT_HI_COL`` and ``GID_COL``. Tables below 2^24
    rows carry no high part, and their key is ``GID_COL`` alone."""
    lo = slots[:, GID_COL].to(torch.int32)
    if n_gauss < 1 << GID_LO_BITS:
        return lo
    return (slots[:, SLOT_HI_COL].to(torch.int32) << GID_LO_BITS) + lo


def _slot_buffer(c_cap: int, n_gauss: int, dev) -> torch.Tensor:
    """The (c_cap * CHUNK, NFEAT) slot buffer before K3: zero payload and the
    out-of-range id ``n_gauss`` (GID_COL and SLOT_HI_COL), which the rows no
    pair fills keep."""
    slots = torch.zeros((c_cap * CHUNK, NFEAT), dtype=torch.float32, device=dev)
    slots[:, GID_COL] = float(n_gauss & ((1 << GID_LO_BITS) - 1))
    if n_gauss >> GID_LO_BITS:
        slots[:, SLOT_HI_COL] = float(n_gauss >> GID_LO_BITS)
    return slots


def composite_bwd_plain(attrs: torch.Tensor, pair_gauss: torch.Tensor,
                        tile_start: torch.Tensor, tile_count: torch.Tensor,
                        chunk0: torch.Tensor, allowed: torch.Tensor,
                        fwd_out: torch.Tensor, gout: torch.Tensor, c_cap: int,
                        tiles_x: int, tile_batch: int = 32,
                        cam_tiles: int = 0, ckpt: torch.Tensor = None,
                        seg: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K3, vectorized over tiles in batches: the
    forward replayed as ``composite_fwd_plain`` computes it, the ten gradient
    channels per pair summed over the tile's pixels, and row
    ``(chunk0[t] + k) * CHUNK + i`` of ``_slot_buffer`` written for every
    pair of the first ``allowed[t]`` chunks (the pair's Gaussian id in
    GID_COL and SLOT_HI_COL, from ``pair_gauss``). With ``seg`` > 0 the walk
    is K3's segments: at every chunk k, a positive multiple of ``seg``, the
    tile's T and running prefix of c * w start again from checkpoint
    ``ckpt`` (``composite_fwd_plain``) as K3's block of that segment starts
    them."""
    dev = attrs.device
    n_tiles = tile_start.shape[0]
    cam_tiles = cam_tiles or max(n_tiles, 1)
    px, py = _pixel_centers(dev)
    lanes = torch.arange(CHUNK, device=dev)
    slots = _slot_buffer(c_cap, attrs.shape[0], dev)
    for t0 in range(0, n_tiles, tile_batch):
        tid = torch.arange(t0, min(t0 + tile_batch, n_tiles), device=dev)
        start = tile_start[tid].long()
        count = tile_count[tid].long()
        ch0 = chunk0[tid].long()
        allow = allowed[tid].long()
        ox, oy = _origin(tid, tiles_x, cam_tiles)
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
            if seg and k and k % seg == 0:
                row = torch.clamp(start // (seg * CHUNK) + k // seg,
                                  max=ckpt.shape[0] - 1)  # valid where act
                c = ckpt[row][:, :, None, :]
                trans = torch.where(act[:, None], c[:, 0, 0], trans)
                prefix = torch.where(
                    act[:, None, None],
                    g0 * c[:, 1] + g1 * c[:, 2] + g2 * c[:, 3] + g3 * c[:, 4]
                    + g4 * c[:, 5], prefix)
            co, valid, alpha, raw = _plain_chunk(attrs, pair_gauss, start,
                                                 count, k, ox, oy, px, py)
            idx = torch.clamp(start[:, None] + k * CHUNK + lanes, 0,
                              pair_gauss.shape[0] - 1)
            lo, hi = gid_split(pair_gauss[idx])
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
                hi, lo, zeros, zeros, zeros, zeros,
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
                  tiles_x: int, cam_tiles: int = 0,
                  ckpt: torch.Tensor = None, seg: int = 0) -> torch.Tensor:
    """K3 wrapper: the (c_cap * CHUNK, NFEAT) float32 slot buffer of per-pair
    gradient rows (channels 0..NGRAD-1; the Gaussian id's low 24 bits in
    GID_COL and its high bits in SLOT_HI_COL, ``slot_ids``). Rows no pair
    fills (lanes past a chunk's last pair, slots past a tile's allowed
    chunks) keep zero payload and the out-of-range id N = ``attrs.shape[0]``.

    Tile ``t`` fills slots ``chunk0[t] .. chunk0[t] + allowed[t] - 1``; the
    caller keeps those inside ``[0, c_cap)`` and ``allowed[t]`` within the
    forward's ``k_end[t]``. ``fwd_out``/``gout`` are (T, NCH, NPIX) float32:
    K2's output and its cotangent. ``cam_tiles`` as for ``composite_fwd``:
    a camera batch is one launch. ``seg`` > 0: each tile's walk in segments
    of ``seg`` chunks, a block each, started from ``ckpt``, the checkpoints
    of ``composite_fwd(..., seg=seg)``; 0: a block a tile. A CPU tensor
    takes the plain version; a CUDA tensor launches
    ``csrc/composite_bwd.cu``. Counts ``composite.bwd_tiles`` and
    ``composite.bwd_blocks``, the blocks launched: an upper bound of the
    (tile, segment) work items, taken from host-known sizes; the blocks
    past the work list's total exit at once."""
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
    seg = _check_seg(seg)
    if seg and (ckpt is None or ckpt.dtype != torch.float32 or ckpt.shape != (
            checkpoint_rows(pair_gauss.shape[0], seg), CKPT_CH, NPIX)):
        raise ValueError("composite_bwd: segments need the checkpoints of "
                         "composite_fwd(..., seg=seg)")
    tensors = (attrs, *ints, fwd_out, gout) + ((ckpt,) if seg else ())
    if any(x.device != attrs.device for x in tensors):
        raise ValueError("composite_bwd: inputs on different devices")
    cam_tiles = _cam_tiles(cam_tiles, n_tiles)
    # work items: at most a segment a tile plus one every seg chunks of the
    # walks, which the buffer's c_cap slots and the list's chunks bound
    n_items = n_tiles + (-(-min(c_cap, -(-pair_gauss.shape[0] // CHUNK)
                                + n_tiles) // seg) if seg else 0)
    add_count("composite.bwd_tiles", n_tiles)
    add_count("composite.bwd_blocks", n_items)
    if attrs.device.type == "cpu":
        return composite_bwd_plain(attrs, pair_gauss, tile_start, tile_count,
                                   chunk0, allowed, fwd_out, gout, c_cap,
                                   tiles_x, cam_tiles=cam_tiles, ckpt=ckpt,
                                   seg=seg)
    if attrs.device.type != "cuda":
        raise ValueError(f"composite_bwd: unsupported device {attrs.device}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("composite_bwd: inputs must be contiguous")
    if attrs.data_ptr() % 16:
        raise ValueError("composite_bwd: attrs must be 16-byte aligned (the "
                         "kernel reads its rows as float4)")
    if max(attrs.shape[0], pair_gauss.shape[0], n_tiles + n_items,
           c_cap) >= 2**31:
        raise ValueError("composite_bwd: sizes must fit int32")
    slots = _slot_buffer(c_cap, attrs.shape[0], attrs.device)
    work = torch.empty((n_tiles + n_items,), dtype=torch.int32,
                       device=attrs.device)
    err = _build.launch(
        _build.load("composite_bwd").sage3d_composite_bwd, attrs.device,
        attrs.data_ptr(), pair_gauss.data_ptr(), tile_start.data_ptr(),
        tile_count.data_ptr(), chunk0.data_ptr(), allowed.data_ptr(),
        fwd_out.data_ptr(), gout.data_ptr(), ckpt.data_ptr() if seg else None,
        work.data_ptr(), slots.data_ptr(), n_tiles, tiles_x, cam_tiles,
        attrs.shape[0], pair_gauss.shape[0], c_cap, seg, n_items)
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


def slot_ranges(kend: torch.Tensor, c_cap: int, groups: int = 1):
    """Each tile's first gradient slot and its number of slots: the tiles
    fall into ``groups`` equal runs (the cameras of a batch, each with its
    own buffer, or one run for one pool), run g's slots start at g·c_cap
    and are packed by the forward's k_end, and chunks past the run's
    ``c_cap`` are cut (counted as overflow by ``composite_tiles_cuda``).
    Returns (chunk0, allowed), (T,) int32; the buffer holds groups·c_cap
    slots."""
    kend = kend.long().view(groups, -1)
    local = torch.cumsum(kend, 1) - kend
    allowed = torch.clamp(torch.minimum(kend, c_cap - local), min=0)
    chunk0 = local + torch.arange(groups, device=kend.device)[:, None] * c_cap
    return (chunk0.reshape(-1).to(torch.int32),
            allowed.reshape(-1).to(torch.int32))


def composite_vjp(attrs: torch.Tensor, pair_gauss: torch.Tensor,
                  tile_start: torch.Tensor, tile_count: torch.Tensor,
                  kend: torch.Tensor, fwd_out: torch.Tensor,
                  gout: torch.Tensor, tiles_x: int, c_cap: int,
                  grad_sort: str = GRAD_SORT_DEFAULT, cam_tiles: int = 0,
                  groups: int = 1, ckpt: torch.Tensor = None,
                  seg: int = 0) -> torch.Tensor:
    """The backward of ``attrs -> out``: d_attrs (N, NFEAT), columns NGRAD..
    zero. K3 fills the slot buffer; a stable sort groups its rows by the
    Gaussian id they carry; K4 sums each Gaussian's rows. The rows no pair
    filled carry the id N: they sort last and K4 skips them, and the rows
    of every Gaussian keep their order, so a larger ``c_cap`` changes no
    bit of the result. Nothing waits for the device. A camera batch
    (``cam_tiles``, N = B·N rows) is one K3 and one K4 launch; its buffer is
    ``groups`` runs of ``c_cap`` slots (``slot_ranges``). ``ckpt`` and
    ``seg``: K3's segments (``composite_bwd``); they do not depend on
    ``c_cap``, so neither does the result.

    ``grad_sort`` picks the sort's payload: ``"f32"`` (exact, the default)
    as K3 wrote it; ``"f16"`` scales each channel to an absmax of 30000,
    rounds to f16 and divides the (N, NGRAD) sums by the scales; ``"bf16"``
    rounds to bf16 as is. The rounded values overwrite the slot rows'
    payload, so K4 reads the rows through the sort's permutation in every
    mode. The sums are f32 in every mode."""
    if grad_sort not in GRAD_SORT_MODES:
        raise ValueError(f"unknown grad_sort mode: {grad_sort}")
    chunk0, allowed = slot_ranges(kend, c_cap, groups)
    slots = composite_bwd(attrs, pair_gauss, tile_start, tile_count, chunk0,
                          allowed, fwd_out, gout, groups * c_cap, tiles_x,
                          cam_tiles, ckpt, seg)
    n = attrs.shape[0]
    ids_sorted, perm = torch.sort(slot_ids(slots, n), stable=True)
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
    ``composite_vjp``: the JAX package's ``custom_vjp`` boundary. ``seg`` >
    0: K2 also writes the checkpoints of K3's segments."""

    @staticmethod
    def forward(ctx, attrs, pair_gauss, tile_start, tile_count, tiles_x,
                c_cap, grad_sort, cam_tiles, groups, seg):
        out, kend, *ckpt = composite_fwd(attrs, pair_gauss, tile_start,
                                         tile_count, tiles_x, cam_tiles,
                                         seg=seg)
        ctx.mark_non_differentiable(kend)
        ctx.save_for_backward(attrs, pair_gauss, tile_start, tile_count, kend,
                              out, *ckpt)
        ctx.tiles_x, ctx.c_cap, ctx.grad_sort = tiles_x, c_cap, grad_sort
        ctx.cam_tiles, ctx.groups, ctx.seg = cam_tiles, groups, seg
        return out, kend

    @staticmethod
    def backward(ctx, gout, _gkend):
        with span("composite.backward"):
            attrs, pair_gauss, tile_start, tile_count, kend, out, *ckpt = \
                ctx.saved_tensors
            d_attrs = composite_vjp(attrs, pair_gauss, tile_start,
                                    tile_count, kend, out, gout.contiguous(),
                                    ctx.tiles_x, ctx.c_cap, ctx.grad_sort,
                                    ctx.cam_tiles, ctx.groups,
                                    ckpt=ckpt[0] if ckpt else None,
                                    seg=ctx.seg)
        return (d_attrs,) + (None,) * 9


def attr_composite(attrs: torch.Tensor, pair_gauss: torch.Tensor,
                   tile_start: torch.Tensor, tile_count: torch.Tensor,
                   tiles_x: int, c_cap: int,
                   grad_sort: str = GRAD_SORT_DEFAULT, cam_tiles: int = 0,
                   groups: int = 1, _seg: Optional[int] = None):
    """Differentiable ``attrs -> (out (T, NCH, NPIX), k_end (T,))``: K2
    forward; backward through K3, the sort and K4 into a gradient buffer of
    ``groups`` runs of ``c_cap`` chunk slots (``slot_ranges``).
    ``cam_tiles``: the tiles of one camera of a batch (0: one camera).
    ``k_end`` carries no gradient. Where a gradient is wanted, K3 walks
    segments of ``segment_chunks`` chunks (``_seg``, for tests: that many,
    0 for a block a tile); without one K2 writes no checkpoint."""
    if grad_sort not in GRAD_SORT_MODES:
        raise ValueError(f"unknown grad_sort mode: {grad_sort}")
    seg = 0
    if torch.is_grad_enabled() and attrs.requires_grad:
        seg = (segment_chunks(pair_gauss.shape[0], attrs.device)
               if _seg is None else _seg)
    return _AttrComposite.apply(attrs, pair_gauss, tile_start, tile_count,
                                tiles_x, int(c_cap), grad_sort,
                                _cam_tiles(cam_tiles, tile_start.shape[0]),
                                int(groups), int(seg))


def attribute_table(proj: ProjectedGaussians,
                    semantic_ids: torch.Tensor) -> torch.Tensor:
    """The per-Gaussian (N, NFEAT) table: conic a/b/c, mean x/y, opacity,
    rgb, depth, semantic id, the Gaussian id's low 24 bits (GID_COL), its
    high bits (GID_HI_COL, 0 below 2^24 rows), 3 zero pads. For a camera
    batch ((B, N, ...) fields) the (B·N, NFEAT) table of every camera's
    rows, row b·N + g, whose id is the row."""
    shape = proj.depths.shape
    dev = proj.depths.device
    zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
    n_rows = proj.depths.numel()
    if n_rows <= 1 << GID_LO_BITS:
        rows = torch.arange(n_rows, dtype=torch.float32, device=dev)
        hi = zeros
    else:
        rows, hi = gid_split(torch.arange(n_rows, device=dev))
        hi = hi.view(shape)
    rows = rows.view(shape)
    return torch.stack([
        proj.conics[..., 0], proj.conics[..., 1], proj.conics[..., 2],
        proj.means2d[..., 0], proj.means2d[..., 1],
        proj.opacities,
        proj.colors[..., 0], proj.colors[..., 1], proj.colors[..., 2],
        proj.depths,
        semantic_ids.to(torch.float32).expand(shape),
        rows,                                               # GID_COL
        hi,                                                 # GID_HI_COL
        zeros, zeros, zeros,
    ], dim=-1).reshape(-1, NFEAT)


def trim_to_capacity(bins: TileBins, pair_capacity: int = 0):
    """Cut each camera's sorted pair list to ``pair_capacity`` (0 = keep it
    whole): every tile's range is clipped to its camera's first
    ``pair_capacity`` pairs; ``pair_gauss`` stays whole. Returns
    (pair_gauss, tile_start, tile_count, pair_capacity), int32 and
    contiguous."""
    full_p = bins.pair_gauss.shape[0]
    if not pair_capacity or pair_capacity >= full_p:
        pair_capacity = full_p
    n_cams = bins.n_cams
    # each camera's first pair: 0 for one camera
    first = bins.tile_start.view(n_cams, -1)[:, :1]
    local = bins.tile_start.view(n_cams, -1) - first
    start = torch.clamp(local, max=pair_capacity)
    count = torch.clamp(torch.clamp(local + bins.tile_count.view(n_cams, -1),
                                    max=pair_capacity) - start, min=0)
    return (bins.pair_gauss.contiguous(),
            (start + first).reshape(-1).to(torch.int32).contiguous(),
            count.reshape(-1).to(torch.int32).contiguous(), pair_capacity)


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
    """Composite via kernel K2, differentiable through K3 and K4. The outputs
    of ``composite_tiles``, with a leading camera axis.

    ``pair_capacity`` (0 = the binning entry budget) trims the sorted pair
    array; trimmed pairs are counted as overflow. ``grad_capacity`` (in
    CHUNK-sized slots; 0 = the safe bound pair_capacity//CHUNK + n_tiles) is
    the backward's gradient buffer: the forward's total k_end
    (``grad_chunks``) beyond it is counted in ``tile_overflow``, so an
    undersized capacity never passes silently. ``grad_sort``: the backward's
    sort payload, ``"f32"`` (default, exact), ``"f16"`` or ``"bf16"``;
    ``grad_sort_bf16=True`` is the JAX package's alias for ``"bf16"``.

    ``bins`` holds B cameras (B = 1 for one camera; ``proj`` of one
    camera or of the batch): they composite in one K2 launch, differentiate
    in one K3 and one K4 launch, and give (B, H, W, ...) images with
    per-camera ``grad_chunks`` and ``tile_overflow``; ``pair_capacity``,
    ``tile_capacity`` and ``grad_capacity`` apply to each camera. B·N must
    stay below ``GID_LIMIT`` (2^31 - 1).
    """
    mode = grad_sort if grad_sort is not None else (
        "bf16" if grad_sort_bf16 else GRAD_SORT_DEFAULT)
    if mode not in GRAD_SORT_MODES:
        raise ValueError(f"unknown grad_sort mode: {mode}")
    tiles_x, tiles_y = bins.tiles_x, bins.tiles_y
    n_tiles = tiles_x * tiles_y
    n_cams = bins.n_cams
    full_p = bins.pair_gauss.shape[0]
    pair_gauss_t, tile_start_t, tile_count_t, pair_capacity = trim_to_capacity(
        bins, pair_capacity)
    count_c = torch.clamp(tile_count_t, max=tile_capacity)
    trim_overflow = torch.clamp(bins.n_pairs - pair_capacity, min=0)
    if grad_capacity and grad_capacity > 0:
        # each camera its own run of grad_capacity slots
        c_cap, groups = int(grad_capacity), n_cams
    else:
        # one pool: the safe bound of every camera's chunks together, so no
        # chunk is ever cut (per camera it is pair_capacity // CHUNK + T)
        c_cap = min(n_cams * pair_capacity, full_p) // CHUNK + n_cams * n_tiles
        groups = 1

    n = proj.depths.numel()
    # The backward routes gradients by an int32 row id carried in two f32
    # columns (``gid_split``): refuse tables the id cannot name.
    if n >= GID_LIMIT:
        raise ValueError(
            f"composite_tiles_cuda: {n} Gaussian rows (cameras x Gaussians) "
            ">= 2^31 - 1; the backward's int32 row id would mis-route "
            "gradients. Render fewer cameras a batch.")
    attrs = attribute_table(proj, semantic_ids)
    out, kend = attr_composite(attrs, pair_gauss_t, tile_start_t, count_c,
                               tiles_x, c_cap, mode, cam_tiles=n_tiles,
                               groups=groups)
    grad_chunks = torch.sum(kend.view(n_cams, n_tiles), 1, dtype=torch.int32)
    if groups == n_cams:
        cap_b = c_cap
    else:   # each camera's own safe bound: nothing is cut
        cap_b = (torch.clamp(bins.n_pairs, max=pair_capacity) // CHUNK
                 + n_tiles)
    grad_overflow = torch.clamp(grad_chunks - cap_b, min=0) * CHUNK

    tile_overflow = torch.sum(torch.clamp(tile_count_t - tile_capacity, min=0)
                              .view(n_cams, n_tiles), 1)
    c = out.shape[1]
    imgs = (out.view(n_cams, tiles_y, tiles_x, c, TILE_H, TILE_W)
            .permute(0, 1, 4, 2, 5, 3)
            .reshape(n_cams, tiles_y * TILE_H, tiles_x * TILE_W, c)
            [:, :height, :width])
    return {
        "rgb": imgs[..., 0:3],
        "depth_acc": imgs[..., 3],
        "alpha": imgs[..., 4],
        "trans": imgs[..., 5],
        "semantic": imgs[..., 7].to(torch.int32),
        "grad_chunks": grad_chunks,
        "tile_overflow": tile_overflow + trim_overflow.view(-1)
        + grad_overflow,
    }
