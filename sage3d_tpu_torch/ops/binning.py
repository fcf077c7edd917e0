"""Tile binning: turn projected Gaussians into per-tile depth-ordered work lists.

PyTorch counterpart of ``sage3d_tpu/ops/binning.py``, same algorithm and
contracts:

  1. Each visible Gaussian gets a depth RANK (front-to-back, ties broken by
     index — the oracle's stable order) from a stable argsort.
  2. Every Gaussian may emit up to ``k_small`` candidate (tile, Gaussian)
     pairs from its tight AABB tile rect; the ``m_big`` largest spanners up
     to ``k_big``, and an optional mid tier up to ``k_mid``. The tiers split
     the Gaussians by tile count, so each Gaussian has its live slots
     (``count_eff``) in at most one of them, and one table describes all.
     Each live slot's candidate is culled by the exact ellipse-tile test.
     Emission is kernel K1 (``csrc/emit.cu``): one launch walks the live
     slots of every tier and writes the kept pairs compacted;
     ``emit_tile_pairs_plain`` is its plain version.
  3. Keys are ``tile * 2^rank_bits + rank`` in int32; one sort orders the
     kept pairs per tile front to back. When the fused key cannot fit int32
     (more than 2047 tiles, e.g. 4K frames) the key is the int64
     ``(tile << 31) | rank`` instead.
  4. Per-tile [start, count) ranges come from a searchsorted over T queries.

A stacked camera batch (``project_gaussians`` over B cameras, (B, N) fields)
bins in one pass, the counterpart of the JAX package's vmapped binning:
depth ranks and tier picks per camera from one argsort along the Gaussian
axis, one K1 table of B·N rows (row b·N + g; column 11 carries camera b's
tile base b·T), one K1 launch, one sort and two host reads for the whole
batch. Tile ids are camera-major (b·T + tile), so the result covers B·T
tiles; ``n_pairs`` and ``overflow`` are per camera, and each camera's tiles
are bitwise what the camera gives alone.

The JAX package gives every budgeted slot a key and sorts the whole padded
emission array (static shapes); here only the kept pairs exist, so
``pair_gauss`` holds exactly ``n_pairs`` entries and the per-tile lists are
the same. ``emit_tile_keys_plain`` is the padded counterpart of the JAX
kernel, for the parity tests. Pairs dropped by the emission budgets are
counted in ``overflow`` — never silently lost. Indices carry no gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiling import count as add_count, span
from . import _build
from .projection import ALPHA_MIN, ProjectedGaussians

TILE_W = 32
TILE_H = 32

RANK_BITS = 20            # least depth-rank field width of the fused key
K1_DEFAULT = 16           # candidate entries per ordinary Gaussian
M_BIG_DEFAULT = 8192      # large-spanning Gaussians given extended budgets
K2_DEFAULT = 256          # entries per large Gaussian
INVALID_KEY = 2**31 - 1
PAIR_LIMIT = 1 << 31      # kept pairs of a batch: the tile bounds and the
                          # compositor's pair indices are int32
SUGGEST_THRESHOLDS = (4, 8, 16, 32, 64, 128)
# the budgets dict keys that are bin_gaussians' keyword arguments
EMIT_BUDGET_KEYS = ("k_small", "m_big", "k_big", "m_mid", "k_mid")

EMIT_GB = 1024  # the padded tier tables' columns are a multiple of this (as
                # in the JAX package)
ATTR_ROWS = 16  # padded tier table rows (the JAX kernel's layout):
                # [x0, y0, nx, count_eff, mx, my, cut2, rank(bitcast),
                #  conic_a, conic_b, conic_c, 5 x pad]
LIVE_COLS = 12  # K1's per-Gaussian table: columns 0-10 of those rows and
                # the camera's tile base (int32 bits; 0 for one camera),
                # three float4 a row


class TileBins(NamedTuple):
    """Per-tile pair lists of B cameras (B = 1 for one camera): the tiles
    are camera-major (B·T entries), ``pair_gauss`` holds rows b·N + g, and
    ``n_pairs`` and ``overflow`` are per camera."""
    pair_gauss: torch.Tensor   # (P,) int32 gaussian index per pair, depth-ordered per tile
    tile_start: torch.Tensor   # (B·T,) int32 first pair index of each tile
    tile_count: torch.Tensor   # (B·T,) int32 number of pairs of each tile
    n_pairs: torch.Tensor      # (B,) int32 valid pairs of each camera
    overflow: torch.Tensor     # (B,) int32 pairs dropped by the K1/K2/M budgets
    tiles_x: int
    tiles_y: int

    @property
    def n_cams(self) -> int:
        return self.tile_start.shape[0] // (self.tiles_x * self.tiles_y)


def num_tiles(width: int, height: int, tile_w: int = TILE_W,
              tile_h: int = TILE_H):
    return -(-width // tile_w), -(-height // tile_h)


def _tile_rect(proj: ProjectedGaussians, tiles_x: int, tiles_y: int):
    """Tight per-Gaussian tile rect from the per-axis AABB extents. Returns
    (vis, x0, y0, nx, count, mx, my)."""
    means2d = proj.means2d.detach()
    mx = means2d[..., 0]
    my = means2d[..., 1]
    ex = proj.extents[..., 0].detach()
    ey = proj.extents[..., 1].detach()
    vis = proj.visible & (proj.radii > 0)

    def cell(v, size, hi):
        return torch.clamp(torch.floor(v / size), 0, hi - 1).to(torch.int32)

    x0 = cell(mx - ex, TILE_W, tiles_x)
    x1 = cell(mx + ex, TILE_W, tiles_x)
    y0 = cell(my - ey, TILE_H, tiles_y)
    y1 = cell(my + ey, TILE_H, tiles_y)
    nx = x1 - x0 + 1
    count = torch.where(vis, nx * (y1 - y0 + 1), 0)
    return vis, x0, y0, nx, count, mx, my


# ---------------------------------------------------------------------------
# K1: tile-key emission
# ---------------------------------------------------------------------------

def _slot_tiles(kf, x0, y0, nx, mx, my, cut2, ca, cb, cc, tiles_x: int):
    """The tile of candidate slot ``kf`` (float) of a Gaussian's rect, and
    whether it survives the exact ellipse-tile cull, in K1's f32 operations
    and order (the arguments broadcast). Returns (keep, tile id int32)."""
    nxs = torch.clamp(nx, min=1.0)   # padded columns carry nx=0 (and count=0)
    inv = 1.0 / nxs
    q = torch.floor(kf * inv)
    r = kf - q * nxs
    q = torch.where(r < 0, q - 1.0, torch.where(r >= nxs, q + 1.0, q))
    r = kf - q * nxs
    tx = x0 + r
    ty = y0 + q
    x_lo = tx * float(TILE_W) - mx
    x_hi = x_lo + float(TILE_W)
    y_lo = ty * float(TILE_H) - my
    y_hi = y_lo + float(TILE_H)
    inside = (x_lo <= 0.0) & (x_hi >= 0.0) & (y_lo <= 0.0) & (y_hi >= 0.0)
    inv_a = 1.0 / torch.clamp(ca, min=1e-20)
    inv_c = 1.0 / torch.clamp(cc, min=1e-20)

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    def vedge(xe):   # min over y' in [y_lo, y_hi] at fixed x' = xe
        t = clip(-cb * xe * inv_c, y_lo, y_hi)
        return (ca * xe) * xe + (2.0 * cb * xe + cc * t) * t

    def hedge(ye):   # min over x' in [x_lo, x_hi] at fixed y' = ye
        t = clip(-cb * ye * inv_a, x_lo, x_hi)
        return (cc * ye) * ye + (2.0 * cb * ye + ca * t) * t

    m2 = torch.minimum(torch.minimum(vedge(x_lo), vedge(x_hi)),
                       torch.minimum(hedge(y_lo), hedge(y_hi)))
    m2 = torch.where(inside, 0.0, m2)
    # 1e-3 relative+absolute margin >> f32 rounding of this ~10-op chain:
    # over-keeps a hair's width of tiles, never drops a contributing pair.
    keep = m2 <= cut2 * 1.001 + 1e-3
    return keep, (ty * float(tiles_x) + tx).to(torch.int32)


def emit_tile_keys_plain(attrs: torch.Tensor, rank: torch.Tensor,
                         k_budget: int, tiles_x: int, n_tiles: int,
                         mult: int) -> torch.Tensor:
    """One tier's padded emission, as the JAX kernel ``_emit_kernel``
    computes it (the parity tests hold the two equal): (k_budget, n) int32
    keys (``mult`` > 0; INVALID_KEY for a slot past the count or culled) or
    tile ids (``mult`` == 0; ``n_tiles`` there), k-major. ``attrs``: the
    (ATTR_ROWS, n) table of ``padded_tier``. K1 computes the same keys for
    the live slots only."""
    x0, y0, nx, count, mx, my, cut2 = (attrs[i:i + 1] for i in range(7))
    ca, cb, cc = attrs[8:9], attrs[9:10], attrs[10:11]
    kf = torch.arange(k_budget, dtype=torch.float32,
                      device=attrs.device)[:, None]
    keep, tid = _slot_tiles(kf, x0, y0, nx, mx, my, cut2, ca, cb, cc, tiles_x)
    valid = (kf < count) & keep
    if mult:
        return torch.where(valid, tid * mult + rank[None, :], INVALID_KEY)
    return torch.where(valid, tid, n_tiles)


def emit_tile_pairs_plain(table: torch.Tensor, offsets: torch.Tensor,
                          n_live: int, tiles_x: int, mult: int):
    """Plain PyTorch version of K1: live slot s is candidate
    ``s - offsets[g]`` of the Gaussian g with ``offsets[g] <= s <
    offsets[g + 1]``; its tile and cull as ``emit_tile_keys_plain``, the
    tile offset by the row's camera tile base (column 11). Returns
    (keys, gauss int32, n_kept () int64) as ``emit_tile_pairs``, with exactly
    the kept pairs, in slot order."""
    dev = table.device
    n = table.shape[0]
    g = torch.repeat_interleave(torch.arange(n, device=dev),
                                offsets[1:] - offsets[:-1],
                                output_size=n_live)
    kf = (torch.arange(n_live, device=dev) - offsets[g]).to(torch.float32)
    row = table[g]
    keep, tid = _slot_tiles(kf, *(row[:, i] for i in (0, 1, 2, 4, 5, 6, 8, 9,
                                                      10)), tiles_x)
    rank = table[:, 7].contiguous().view(torch.int32)[g]
    tid = tid + table[:, 11].contiguous().view(torch.int32)[g]
    if mult:
        keys = tid * mult + rank
    else:
        keys = (tid.to(torch.int64) << 31) | rank.to(torch.int64)
    keys = keys[keep]
    return (keys, g[keep].to(torch.int32),
            torch.tensor(keys.shape[0], dtype=torch.int64, device=dev))


def emit_tile_pairs(table: torch.Tensor, offsets: torch.Tensor, n_live: int,
                    tiles_x: int, mult: int):
    """K1 wrapper: the kept (key, Gaussian) pairs of every live slot.

    ``table``: (n, LIVE_COLS) float32, contiguous and 16-byte aligned (the
    kernel reads a row as three float4): x0, y0, nx, count_eff, mx, my, cut2,
    the int32 rank's bits, conic a, b, c, the int32 tile base's bits (the
    row's camera's first tile, b·T in a batch; 0 for one camera), added to
    the tile id of every key. ``offsets``: (n + 1,) int64,
    the exclusive scan of count_eff; ``n_live`` its last entry, as a host int
    (the caller's copy; checking it would wait for the device). Keys: int32
    ``tile * mult + rank`` (``mult`` > 0) or int64 ``(tile << 31) | rank``.
    Returns (keys (n_live,) int32 if ``mult`` else int64,
    gauss (n_live,) int32, n_kept () int64 on the device): the first n_kept
    entries are the kept pairs, in no particular order, the rest undefined.
    Nothing waits for the device. A CPU tensor takes the plain version
    (exactly the kept pairs, in slot order); a CUDA tensor launches
    ``csrc/emit.cu``."""
    if table.dim() != 2 or table.shape[1] != LIVE_COLS:
        raise ValueError(f"table must be (n, {LIVE_COLS}), got "
                         f"{tuple(table.shape)}")
    n = table.shape[0]
    if table.dtype != torch.float32 or offsets.dtype != torch.int64:
        raise TypeError("emit_tile_pairs takes a float32 table and int64 "
                        "offsets")
    if offsets.shape != (n + 1,) or offsets.device != table.device:
        raise ValueError("offsets must be (n + 1,) on the device of table")
    if table.data_ptr() % 16:
        raise ValueError("emit_tile_pairs: table must be 16-byte aligned (the "
                         "kernel reads its rows as float4)")
    if not 0 <= n_live < 2**38 or n >= 2**31:
        raise ValueError(f"emit_tile_pairs: {n_live} live slots or {n} "
                         "Gaussians past what the kernel indexes")
    if table.device.type == "cpu":
        return emit_tile_pairs_plain(table, offsets, n_live, tiles_x, mult)
    if table.device.type != "cuda":
        raise ValueError(f"emit_tile_pairs: unsupported device {table.device}")
    if not (table.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("emit_tile_pairs: inputs must be contiguous")
    dev = table.device
    keys = torch.empty((n_live,), dtype=torch.int32 if mult else torch.int64,
                       device=dev)
    gauss = torch.empty((n_live,), dtype=torch.int32, device=dev)
    n_kept = torch.empty((), dtype=torch.int64, device=dev)
    err = _build.launch(
        _build.load("emit").sage3d_emit_tile_pairs, dev, table.data_ptr(),
        offsets.data_ptr(), n, n_live, tiles_x, mult, keys.data_ptr(),
        gauss.data_ptr(), n_kept.data_ptr())
    _build.check(err, "emit_tile_pairs")
    emit_tile_pairs.launches += 1
    return keys, gauss, n_kept


emit_tile_pairs.launches = 0


class EmitTier(NamedTuple):
    """One emission tier: ``gauss`` (m,) int64 Gaussian ids, ``count`` (m,)
    int64 live slots of each (0 where the id is not in the tier), at most
    ``k_budget``."""
    gauss: torch.Tensor
    count: torch.Tensor
    k_budget: int


class EmissionPlan(NamedTuple):
    table: torch.Tensor      # (B·n, LIVE_COLS) float32, K1's per-Gaussian table
    offsets: torch.Tensor    # (B·n + 1,) int64 exclusive scan of count_eff
    n_live: int              # live slots of all tiers (offsets[-1])
    tiers: list              # [EmitTier]: small, (mid,) big; rows b·n + g
    tiles_x: int
    tiles_y: int
    mult: int                # 2^rank_bits for the fused key, 0 for two keys
    overflow: torch.Tensor   # (B,) int64 pairs dropped by the budgets


def padded_tier(plan: EmissionPlan, tier: EmitTier):
    """The tier as the JAX kernel takes it: (ATTR_ROWS, n_pad) float32
    table with the tier's count in row 3, and the (n_pad,) int32 rank and
    Gaussian id per column; columns padded to a multiple of EMIT_GB with
    count 0, as in the JAX package. For the parity tests of
    ``emit_tile_keys_plain``; the binning does not build it."""
    rows = plan.table[tier.gauss]
    m = rows.shape[0]
    gb = min(EMIT_GB, max(128, m))
    n_pad = -(-m // gb) * gb
    attrs = torch.zeros((ATTR_ROWS, n_pad), dtype=torch.float32,
                        device=rows.device)
    attrs[:LIVE_COLS - 1, :m] = rows[:, :LIVE_COLS - 1].T
    attrs[3, :m] = tier.count.to(torch.float32)

    def col(v):
        out = torch.zeros((n_pad,), dtype=torch.int32, device=rows.device)
        out[:m] = v
        return out

    return attrs, col(rows[:, 7].contiguous().view(torch.int32)), col(tier.gauss)


def emission_plan(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    k_small: int = K1_DEFAULT,
    m_big: int = M_BIG_DEFAULT,
    k_big: int = K2_DEFAULT,
    m_mid: int = 0,
    k_mid: int = 0,
) -> EmissionPlan:
    """Everything ``bin_gaussians`` hands to K1: depth ranks, the tight tile
    rects, the tier selection, the per-Gaussian table and live-slot offsets,
    and the overflow count. Reads the number of live slots to the host.

    ``proj`` of a batch of B cameras ((B, N, ...) fields; one camera's
    (N, ...) fields are a batch of 1): ranks and tier picks are per camera,
    the budgets apply to each camera, and the table holds B·N rows (row
    b·N + g) with camera b's tile base b·T in column 11. One host read for
    the whole batch."""
    if proj.depths.dim() == 1:
        proj = ProjectedGaussians(*(x[None] for x in proj))
    dev = proj.depths.device
    tiles_x, tiles_y = num_tiles(width, height)
    n_tiles = tiles_x * tiles_y
    n_cams, n = proj.depths.shape
    # The fused key holds (base + tile) * 2^rank_bits + rank in int32.
    all_tiles = max(n_cams * n_tiles, 1)
    rank_bits = min(((2**31 - 1) // all_tiles).bit_length() - 1, 31)
    fused_ok = rank_bits >= RANK_BITS and n <= (1 << rank_bits)
    m_big = max(min(m_big, n), 1)

    depths = proj.depths.detach()

    # 1. Depth ranks per camera (front-to-back, ties by index): the inverse
    # of a stable argsort along the Gaussians.
    order = torch.argsort(torch.where(proj.visible, depths, float("inf")),
                          dim=1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(n, device=dev).expand(n_cams, n))
    rank = rank.to(torch.int32)

    # 2. Tile rect per Gaussian.
    vis, x0, y0, nx, count, mx, my = _tile_rect(proj, tiles_x, tiles_y)

    small = count <= k_small
    use_mid = m_mid > 0 and k_mid > k_small
    m_mid = max(min(m_mid, n), 1) if use_mid else 1

    # Large spanners: top m_big by count per camera (stable, ties by index).
    big_floor = k_mid if use_mid else k_small
    big_score = torch.where(vis & (count > big_floor), count, -1)
    big_idx = torch.argsort(-big_score, dim=1, stable=True)[:, :m_big]
    big_sel = torch.gather(big_score, 1, big_idx) > 0
    if use_mid:
        mid_score = torch.where(vis & ~small & (count <= k_mid), count, -1)
        mid_idx = torch.argsort(-mid_score, dim=1, stable=True)[:, :m_mid]
        mid_sel = torch.gather(mid_score, 1, mid_idx) > 0

    # The tiers' live slots. They split the Gaussians by count (small:
    # count <= k_small; mid: k_small < count <= k_mid; big: above), so a
    # Gaussian is live in one tier at most and count_eff adds them up. The
    # tiers name table rows: camera b's Gaussian g is row b·n + g.
    count64 = count.to(torch.int64)
    row0 = torch.arange(n_cams, device=dev)[:, None] * n

    def tier(idx, sel, cnt, k_budget):
        return EmitTier((idx + row0).reshape(-1),
                        torch.where(sel, cnt, 0).reshape(-1), k_budget)

    tiers = [tier(torch.arange(n, device=dev).expand(n_cams, n), vis & small,
                  count64, k_small)]
    if use_mid:
        tiers.append(tier(mid_idx, mid_sel, torch.gather(count64, 1, mid_idx),
                          k_mid))
    count_b = torch.gather(count64, 1, big_idx)
    tiers.append(tier(big_idx, big_sel, torch.clamp(count_b, max=k_big),
                      k_big))
    count_eff = tiers[0].count.clone()
    for t in tiers[1:]:
        count_eff.index_add_(0, t.gauss, t.count)
    offsets = torch.zeros((n_cams * n + 1,), dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(count_eff, 0)

    # K1's (B·n, LIVE_COLS) table; the int32 rank and tile base ride it as
    # their bit patterns. cut2 is the opacity-aware alpha cutoff the exact
    # ellipse cull tests against.
    cut2 = 2.0 * torch.log(
        torch.clamp(proj.opacities.detach(), min=ALPHA_MIN) / ALPHA_MIN)
    conics = proj.conics.detach()
    base = (torch.arange(n_cams, dtype=torch.int32, device=dev)[:, None]
            * n_tiles).expand(n_cams, n)
    table = torch.stack([
        x0.to(torch.float32), y0.to(torch.float32), nx.to(torch.float32),
        count_eff.view(n_cams, n).to(torch.float32), mx, my, cut2,
        rank.view(torch.float32), conics[..., 0], conics[..., 1],
        conics[..., 2], base.contiguous().view(torch.float32),
    ], dim=-1).reshape(n_cams * n, LIVE_COLS)

    # Overflow accounting per camera (conservative: AABB counts, pre-cull):
    # big Gaussians clipped at k_big, plus spanners not covered by the big
    # or mid tier.
    clipped_big = torch.sum(torch.where(
        big_sel, torch.clamp(count_b - k_big, min=0), 0), dim=1)
    covered = torch.sum(torch.where(big_sel, count_b, 0), dim=1)
    if use_mid:
        covered = covered + torch.sum(torch.where(
            mid_sel, torch.gather(count64, 1, mid_idx), 0), dim=1)
    dropped_whole = torch.sum(torch.where(vis & ~small, count64, 0),
                              dim=1) - covered
    overflow = clipped_big + dropped_whole
    with span("binning.read_live"):
        n_live = int(offsets[-1])
        add_count("binning.live_slots", n_live)
        add_count("binning.cameras", n_cams)
    return EmissionPlan(table, offsets, n_live, tiers, tiles_x, tiles_y,
                        (1 << rank_bits) if fused_ok else 0, overflow)


def bin_gaussians(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    k_small: int = K1_DEFAULT,
    m_big: int = M_BIG_DEFAULT,
    k_big: int = K2_DEFAULT,
    m_mid: int = 0,
    k_mid: int = 0,
) -> TileBins:
    """Build per-tile depth-ordered Gaussian lists.

    Emission tiers: every Gaussian gets ``k_small`` slots; the top ``m_big``
    spanners (by AABB tile count) get ``k_big``. When ``m_mid``/``k_mid`` are
    set, a third tier slots the mid-size spanners (k_small < count <= k_mid)
    at ``k_mid`` each, and the big tier only takes count > k_mid. The
    budgets apply to each camera of a batch; ``n_pairs`` and ``overflow``
    are per camera, (1,) for one camera. Tiles are TILE_W x TILE_H; the JAX
    signature's unused ``pair_capacity``, ``max_tiles_per_gaussian`` and
    tile-size arguments are not carried over. Raises where the batch keeps
    ``PAIR_LIMIT`` pairs or more.
    """
    plan = emission_plan(proj, width, height, k_small=k_small, m_big=m_big,
                         k_big=k_big, m_mid=m_mid, k_mid=k_mid)
    n_tiles = plan.tiles_x * plan.tiles_y
    n_cams = plan.overflow.shape[0]
    mult = plan.mult
    keys, gauss, n_kept = emit_tile_pairs(plan.table, plan.offsets,
                                          plan.n_live, plan.tiles_x, mult)
    with span("binning.read_kept"):
        kept = int(n_kept)
        add_count("binning.kept_pairs", kept)
    if kept >= PAIR_LIMIT:
        raise ValueError(
            f"bin_gaussians: {n_cams} camera(s) keep {kept} pairs, past the "
            "int32 pair index; render fewer cameras at a time")
    keys, gauss = keys[:kept], gauss[:kept]

    # 3. One sort orders the kept pairs per tile front to back. Kept keys are
    # unique, so an unstable sort gives the same pairs as a stable one, in
    # whatever order K1 wrote them. The tiles are camera-major.
    tile_ids = torch.arange(n_cams * n_tiles + 1, dtype=torch.int64,
                            device=keys.device)
    keys_sorted, perm = torch.sort(keys)
    if mult:
        queries = (tile_ids * mult).to(torch.int32)
    else:
        # Two-key path: the int64 key (tile << 31) | rank.
        queries = tile_ids << 31
    bounds = torch.searchsorted(keys_sorted, queries).to(torch.int32)
    cam_bounds = bounds[::n_tiles]             # each camera's first pair
    return TileBins(
        pair_gauss=gauss[perm],
        tile_start=bounds[:-1],
        tile_count=bounds[1:] - bounds[:-1],
        n_pairs=cam_bounds[1:] - cam_bounds[:-1],
        overflow=plan.overflow.to(torch.int32),
        tiles_x=plan.tiles_x,
        tiles_y=plan.tiles_y,
    )


def pair_count_stats(proj: ProjectedGaussians, width: int,
                     height: int) -> dict:
    """Cheap elementwise probe of the binning workload (no sort): per-Gaussian
    AABB tile counts reduced to the scalars ``suggest_budgets`` needs. The
    reductions run over the Gaussian axis, so a camera batch's projection
    gives each statistic per camera, with a leading (B,) axis."""
    tiles_x, tiles_y = num_tiles(width, height)
    vis, _, _, _, count, _, _ = _tile_rect(proj, tiles_x, tiles_y)
    exceed = torch.stack([torch.sum(count > k, -1)
                          for k in SUGGEST_THRESHOLDS], -1)
    return {
        "n_visible": torch.sum(vis, -1),
        "sum_count_parts": torch.sum(count.to(torch.int64), -1)[..., None],
        "max_count": torch.amax(count, -1),
        "exceed": exceed,   # aligned with SUGGEST_THRESHOLDS
    }


def _pow2_at_least(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def suggest_budgets(proj: ProjectedGaussians, width: int, height: int) -> dict:
    """Overflow-free static budgets for ``bin_gaussians`` + the pair capacity
    from one probe. Returns {"k_small", "m_big", "k_big", "m_mid", "k_mid",
    "pair_capacity", "n_pairs_upper"}."""
    stats = pair_count_stats(proj, width, height)
    return _pick_budgets({k: v.cpu().numpy() for k, v in stats.items()},
                         proj.depths.shape[0])


def _pick_budgets(stats: dict, n: int) -> dict:
    """Host-side budget choice from fetched ``pair_count_stats`` scalars.

    Considers both the 2-tier (small/big) and the 3-tier (small/mid/big)
    emission layouts and picks the smaller total emission array; the 3-tier
    form costs one extra argsort + emit call, so it must win by >=20%."""
    max_count = int(stats["max_count"])
    sum_count = sum(int(p) for p in stats["sum_count_parts"])
    exceed = [int(e) for e in stats["exceed"]]
    k_big = max(_pow2_at_least(max_count), 8)

    def msize(n_exceed):
        return max(_pow2_at_least(n_exceed + max(n_exceed // 8, 16)), 32)

    best = None
    for k1, e1 in zip(SUGGEST_THRESHOLDS, exceed):
        emission = n * k1 + msize(e1) * k_big
        if best is None or emission < best[0]:
            best = (emission, k1, msize(e1), 0, 0)
    for i, (k1, e1) in enumerate(zip(SUGGEST_THRESHOLDS, exceed)):
        for k2, e2 in zip(SUGGEST_THRESHOLDS[i + 1:], exceed[i + 1:]):
            m_mid = msize(e1 - e2)
            m_big3 = msize(e2)
            emission = n * k1 + m_mid * k2 + m_big3 * k_big
            if emission < best[0] * 0.8:
                best = (emission, k1, m_big3, m_mid, k2)
    _, k_small, m_big, m_mid, k_mid = best
    # 128-multiple (the compositor's chunk size), not pow2: every downstream
    # stage is proportional to the static capacity.
    pair_capacity = -(-(sum_count + 1024) // 128) * 128
    return {
        "k_small": int(k_small),
        "m_big": int(m_big),
        "k_big": int(k_big),
        "m_mid": int(m_mid),
        "k_mid": int(k_mid),
        "pair_capacity": int(pair_capacity),
        "n_pairs_upper": sum_count,
    }
