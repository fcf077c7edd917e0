"""Grid path planning: reference-parity A* plus a batched wavefront planner
on the card.

PyTorch counterpart of ``sage3d_tpu/data/astar.py``. The reference plans one
endpoint pair at a time with heapq A* over the occupancy grid
(vln_trajectory_generator.py:253-286 ``astar_pixel``, 8-connected, octile
heuristic) and finds snap-on targets via a boundary BFS (:309-344). Both are
host numpy, copied from the JAX package. ``wavefront_distances`` computes the
geodesic distance field from MANY sources at once by iterated 8-neighbour
min-relaxation on ``device``; paths are then recovered by greedy descent on
the host. For the trajectory-generation workload (thousands of candidate
pairs per scene), one wavefront per endpoint replaces thousands of serial A*
runs.

The relaxation keeps the JAX version's arithmetic step for step (f32,
``INF = 1e9``, the neighbour order of ``_NEIGHBORS``, ``best + free_f`` then
``min(., INF)``, convergence when no cell drops by more than 1e-6 over a
check of 8 relaxations), so the fields are bitwise the JAX package's: every
candidate is one f32 add and ``min`` is exact. One trip of the JAX
``while_loop`` body (8 relaxations and the changed test) is one launch of
kernel K5 (``csrc/wavefront.cu``) on the card, or of its plain twin
``relax_tiles_plain`` on the CPU; the relaxation count is JAX's.
"""

from __future__ import annotations

import heapq
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import _build
from ..renderer.scene import resolve_device

SQRT2 = math.sqrt(2.0)


# ---------------------------------------------------------------------------
# Reference-parity host A*
# ---------------------------------------------------------------------------

_NEIGHBORS = [(-1, -1, SQRT2), (-1, 0, 1.0), (-1, 1, SQRT2),
              (0, -1, 1.0), (0, 1, 1.0),
              (1, -1, SQRT2), (1, 0, 1.0), (1, 1, SQRT2)]

# reference neighbor order, (dx, dy) in its (x, y) coordinate tuples
_REF_DIRS = [(-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1)]


def astar_pixel(grid: np.ndarray, start: Tuple[int, int],
                goal: Tuple[int, int]) -> Optional[List[Tuple[int, int]]]:
    """8-connected A* on an obstacle grid (1 = blocked), (x, y) tuples.

    Exact-parity port of the reference planner semantics
    (vln_trajectory_generator.py:253-286): euclidean heuristic, same neighbor
    expansion order, grid indexed grid[y, x]. Returns the (x, y) pixel path
    including both endpoints, or None if unreachable.
    """
    h, w = grid.shape
    open_set = [(0.0, start)]
    came_from = {}
    g_score = {start: 0.0}
    gx, gy = goal
    while open_set:
        _, cur = heapq.heappop(open_set)
        if cur == goal:
            path = [cur]
            while cur in came_from:
                cur = came_from[cur]
                path.append(cur)
            return path[::-1]
        for dx, dy in _REF_DIRS:
            nx, ny = cur[0] + dx, cur[1] + dy
            if not (0 <= nx < w and 0 <= ny < h):
                continue
            if grid[ny, nx] == 1:
                continue
            nb = (nx, ny)
            tg = g_score[cur] + math.hypot(nx - cur[0], ny - cur[1])
            if nb not in g_score or tg < g_score[nb]:
                came_from[nb] = cur
                g_score[nb] = tg
                f = tg + math.hypot(nx - gx, ny - gy)
                heapq.heappush(open_set, (f, nb))
    return None


def boundary_pixels(mask_coords) -> List[Tuple[int, int]]:
    """4-neighborhood boundary of a (y, x) pixel set
    (vln_trajectory_generator.py:290-299)."""
    s = set((int(y), int(x)) for (y, x) in mask_coords)
    out = []
    for (y, x) in s:
        if any(n not in s for n in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1))):
            out.append((y, x))
    return out


def nearest_free_pixel_on_side(instance_mask, base_map: np.ndarray,
                               towards_px: Optional[Tuple[int, int]] = None,
                               max_search_dist: int = 50
                               ) -> Optional[Tuple[int, int]]:
    """BFS from the instance boundary to the nearest free pixel, optionally on
    the side facing ``towards_px`` (vln_trajectory_generator.py:309-344).

    instance_mask: (y, x) pixels; base_map: obstacle grid (1 = blocked);
    returns (x, y) like the reference.
    """
    from collections import deque
    h, w = base_map.shape
    b_pixels = boundary_pixels(instance_mask)
    if not b_pixels:
        return None
    visited = set()
    q = deque()
    for (by, bx) in b_pixels:
        if 0 <= bx < w and 0 <= by < h:
            visited.add((bx, by))
            q.append((bx, by, 0))
    while q:
        x, y, d = q.popleft()
        if d > max_search_dist:
            break
        if 0 <= x < w and 0 <= y < h and base_map[y, x] == 0:
            if towards_px is None:
                return (x, y)
            bx, by = np.mean([(px, py) for (py, px) in instance_mask], axis=0)
            v_point = np.array([x - bx, y - by])
            v_towards = np.array([towards_px[0] - bx, towards_px[1] - by])
            if np.dot(v_point, v_towards) >= 0:
                return (x, y)
        for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            nx, ny = x + dx, y + dy
            if 0 <= nx < w and 0 <= ny < h and (nx, ny) not in visited:
                visited.add((nx, ny))
                q.append((nx, ny, d + 1))
    return None


def instance_centroid_px(mask_coords) -> Optional[Tuple[int, int]]:
    """Centroid of (y, x) mask pixels, returned as (x, y)
    (vln_trajectory_generator.py:289-295)."""
    if not mask_coords:
        return None
    m = np.asarray(mask_coords, float)
    c = m.mean(axis=0)
    return (int(round(c[1])), int(round(c[0])))


# ---------------------------------------------------------------------------
# Wavefront planner on the card (batched geodesic distance fields)
# ---------------------------------------------------------------------------

INF = 1e9
CHECK_EVERY = 8     # relaxations a launch of K5, between convergence tests
TILE = 32           # K5's output tile side; its halo is CHECK_EVERY cells
CHAIN = 8           # K5 launches queued between host reads of their flags


def relax_tiles_plain(src: torch.Tensor, dst: torch.Tensor,
                      free_t: torch.Tensor, prev_flag, flag) -> None:
    """Plain version of K5 (``csrc/wavefront.cu``), in its decomposition:
    CHECK_EVERY Jacobi relaxations of ``src`` (B, H, W) into ``dst``, tile by
    tile. Each TILE x TILE output tile is computed from its region with a
    CHECK_EVERY-cell halo (cells outside the grid INF), relaxation s on the
    cells at least s inside the region, so the tile is exact after the last.
    ``flag`` (an int32 element) is set to 1 where a cell ends below its value
    in ``src`` minus 1e-6; with ``prev_flag`` given and 0, nothing runs."""
    if prev_flag is not None and int(prev_flag) == 0:
        return
    b, h, w = src.shape
    dev, f32 = src.device, torch.float32
    ty, tx = -(-h // TILE), -(-w // TILE)
    halo, side = CHECK_EVERY, TILE + 2 * CHECK_EVERY
    padded = (b, ty * TILE + 2 * halo, tx * TILE + 2 * halo)
    field = torch.full(padded, INF, dtype=f32, device=dev)
    field[:, halo:halo + h, halo:halo + w] = src
    wall = torch.full(padded[1:], INF, dtype=f32, device=dev)
    wall[halo:halo + h, halo:halo + w] = torch.where(
        free_t, torch.zeros((), dtype=f32, device=dev),
        torch.tensor(INF, dtype=f32, device=dev))
    # (b, ty, tx, side, side) regions, overlapping by 2 * halo
    cur = field.unfold(1, side, TILE).unfold(2, side, TILE).contiguous()
    wall = wall.unfold(0, side, TILE).unfold(1, side, TILE)
    nxt = cur.clone()
    inf = torch.tensor(INF, dtype=f32, device=dev)
    costs = [torch.tensor(c, dtype=f32, device=dev) for _, _, c in _NEIGHBORS]
    for s in range(1, CHECK_EVERY + 1):
        n = side - 2 * s
        best = cur[..., s:s + n, s:s + n].clone()
        for (dy, dx, _), cost in zip(_NEIGHBORS, costs):
            # shifted[y, x] = d[y - dy, x - dx]
            torch.minimum(best, cur[..., s - dy:s - dy + n, s - dx:s - dx + n]
                          + cost, out=best)
        nxt[..., s:s + n, s:s + n] = torch.minimum(
            best + wall[..., s:s + n, s:s + n], inf)
        cur, nxt = nxt, cur
    tiles = cur[..., halo:halo + TILE, halo:halo + TILE]  # (b, ty, tx, T, T)
    out = tiles.permute(0, 1, 3, 2, 4).reshape(b, ty * TILE, tx * TILE)
    dst.copy_(out[:, :h, :w])
    if bool(torch.any(dst < src - torch.tensor(1e-6, dtype=f32, device=dev))):
        flag.fill_(1)


def relax_tiles(src: torch.Tensor, dst: torch.Tensor, free_t: torch.Tensor,
                prev_flag, flag) -> None:
    """CHECK_EVERY relaxations of the fields ``src`` (B, H, W) float32 into
    ``dst``, setting the int32 element ``flag`` where any cell dropped by
    more than 1e-6; ``prev_flag`` None, or the previous launch's flag: where
    it is 0 the launch does nothing. ``free_t`` is the (H, W) bool grid.

    A CPU tensor takes the plain version; a CUDA tensor launches K5
    (``csrc/wavefront.cu``), which never waits for the card."""
    if src.dim() != 3 or src.dtype != torch.float32:
        raise ValueError("relax_tiles: src must be (B, H, W) float32")
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError("relax_tiles: dst must match src")
    if free_t.dtype != torch.bool or free_t.shape != src.shape[1:]:
        raise ValueError("relax_tiles: free must be an (H, W) bool grid")
    flags = [flag] if prev_flag is None else [prev_flag, flag]
    if any(f.dtype != torch.int32 or f.numel() != 1 for f in flags):
        raise ValueError("relax_tiles: flags must be int32 elements")
    dev = src.device
    if any(t.device != dev for t in [dst, free_t] + flags):
        raise ValueError("relax_tiles: inputs on different devices")
    if dev.type == "cpu":
        return relax_tiles_plain(src, dst, free_t, prev_flag, flag)
    if dev.type != "cuda":
        raise ValueError(f"relax_tiles: unsupported device {dev}")
    if not (src.is_contiguous() and dst.is_contiguous()
            and free_t.is_contiguous()):
        raise ValueError("relax_tiles: src, dst and free must be contiguous")
    if src.shape[0] > 65535:
        raise ValueError("relax_tiles: at most 65535 sources a launch")
    err = _build.launch(
        _build.load("wavefront").sage3d_wavefront_relax, dev,
        src.data_ptr(), dst.data_ptr(), free_t.data_ptr(), *src.shape,
        None if prev_flag is None else prev_flag.data_ptr(), flag.data_ptr())
    _build.check(err, "relax_tiles")
    relax_tiles.launches += 1


relax_tiles.launches = 0


def _relax_until_converged(free_t: torch.Tensor, src: torch.Tensor, relax):
    """The JAX ``while_loop``: launches of ``relax`` (each CHECK_EVERY
    relaxations) until one finds no change, or the cap of H*W + 64
    relaxations. Launches are queued CHAIN at a time, each after the one
    before on the device, and their flags read once; a launch after the one
    that converged does nothing. Returns the field and the relaxations run,
    JAX's count."""
    dev = free_t.device
    h, w = free_t.shape
    b = src.shape[0]
    f32 = torch.float32
    cap = h * w + 64
    n_max = -(-cap // CHECK_EVERY)          # launches the cap allows
    bufs = [torch.full((b, h, w), INF, dtype=f32, device=dev),
            torch.empty((b, h, w), dtype=f32, device=dev)]
    bufs[0][torch.arange(b, device=dev), src[:, 0], src[:, 1]] = 0.0
    bufs[0] += torch.where(free_t, torch.zeros((), dtype=f32, device=dev),
                           torch.tensor(INF, dtype=f32, device=dev))
    flags = torch.zeros((n_max,), dtype=torch.int32, device=dev)
    ran = 0
    while ran < n_max:
        k0, n = ran, min(CHAIN, n_max - ran)
        for k in range(k0, k0 + n):
            relax(bufs[k % 2], bufs[(k + 1) % 2], free_t,
                  flags[k - 1] if k > k0 else None, flags[k])
        got = flags[k0:k0 + n].tolist()                 # one host read
        ran = k0 + (got.index(0) + 1 if 0 in got else n)
        if 0 in got:
            break
    return bufs[ran % 2], ran * CHECK_EVERY


@torch.no_grad()
def wavefront_distances(free, sources, device=None,
                        return_relaxations: bool = False):
    """Geodesic distance field(s) by iterated 8-neighbor min-relaxation.

    Args:
      free: (H, W) bool free-space grid (numpy or tensor).
      sources: (B, 2) int (row, col) source pixels.
      device: where the fields are computed; None means the card (raises
        without one: pass ``device="cpu"`` for the CPU).
      return_relaxations: also return the number of relaxations run.

    Returns a (B, H, W) float32 tensor on ``device``: distances in pixels
    (diagonals cost sqrt(2)); unreachable cells hold +INF. The loop runs
    until no distance changes (O(longest shortest path) relaxations); its
    cap of H*W + 64 is a safety bound only, since a shortest 8-connected
    path can wind through O(H*W) cells.

    The relaxations run CHECK_EVERY a launch of ``relax_tiles`` (K5 on the
    card), which also tests convergence on the device; the host reads the
    flags of CHAIN launches at a time.
    """
    dev = resolve_device(device)
    free_t = torch.as_tensor(free, device=dev).bool().contiguous()
    src = torch.as_tensor(np.asarray(sources), device=dev).long().reshape(-1, 2)
    out, it = _relax_until_converged(free_t, src, relax_tiles)
    return (out, it) if return_relaxations else out


def descend_path(dist: np.ndarray, goal: Tuple[int, int],
                 max_len: int = 10000) -> Optional[List[Tuple[int, int]]]:
    """Greedy steepest-descent from ``goal`` back to the wavefront source."""
    h, w = dist.shape
    cur = tuple(int(v) for v in goal)
    if not np.isfinite(dist[cur]) or dist[cur] >= INF:
        return None
    path = [cur]
    for _ in range(max_len):
        cy, cx = cur
        if dist[cy, cx] == 0.0:
            return path[::-1]
        best, best_d = None, dist[cy, cx]
        for dy, dx, cost in _NEIGHBORS:
            ny, nx = cy + dy, cx + dx
            if 0 <= ny < h and 0 <= nx < w and dist[ny, nx] < best_d:
                best, best_d = (ny, nx), dist[ny, nx]
        if best is None:
            return None
        cur = best
        path.append(cur)
    return None


def plan_many(free: np.ndarray, starts: np.ndarray, goals: np.ndarray,
              batch: int = 16, device=None):
    """Batched planning: one wavefront per unique start, greedy path recovery.

    Returns list of (path or None) matching the reference A* reachability
    semantics (path exists iff A* would find one — both compute shortest
    8-connected geodesics on the same grid). The fields are computed on
    ``device`` (None means the card), ``batch`` sources at a time, with one
    device-to-host copy of the (batch, H, W) fields per batch.
    """
    dev = resolve_device(device)
    free_t = torch.as_tensor(free, device=dev).bool()
    out = []
    for i in range(0, len(starts), batch):
        src = np.asarray(starts[i:i + batch], np.int64)
        dists = wavefront_distances(free_t, src, device=dev).cpu().numpy()
        for d, goal in zip(dists, goals[i:i + batch]):
            out.append(descend_path(d, tuple(int(v) for v in goal)))
    return out
