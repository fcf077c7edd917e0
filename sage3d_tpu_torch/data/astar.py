"""Grid path planning: reference-parity A* plus a batched wavefront planner
on the card.

PyTorch counterpart of ``sage3d_tpu/data/astar.py``. The reference plans one
endpoint pair at a time with heapq A* over the occupancy grid
(vln_trajectory_generator.py:253-286 ``astar_pixel``, 8-connected, octile
heuristic) and finds snap-on targets via a boundary BFS (:309-344). Both are
host numpy, copied from the JAX package. ``wavefront_distances`` computes the
geodesic distance field from MANY sources at once by iterated 8-neighbour
min-relaxation, as tensor ops on ``device``; paths are then recovered by
greedy descent on the host. For the trajectory-generation workload (thousands
of candidate pairs per scene), one wavefront per endpoint replaces thousands
of serial A* runs.

The relaxation keeps the JAX version's arithmetic step for step (f32,
``INF = 1e9``, the neighbour order of ``_NEIGHBORS``, ``best + free_f`` then
``min(., INF)``, convergence when no cell drops by more than 1e-6 over a
check of 8 relaxations), so the fields are bitwise the JAX package's: every
candidate is one f32 add and ``min`` is exact. The JAX ``while_loop``
becomes a Python loop with one host read of "changed" every 8 relaxations.
"""

from __future__ import annotations

import heapq
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

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
CHECK_EVERY = 8     # relaxations per host read of "changed"


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

    The distances live in the interior of a (B, H+2, W+2) buffer whose
    border holds INF, so each neighbour's shifted field is a view of it. A
    relaxation is 19 elementwise launches: a copy, an add and a minimum per
    neighbour, the obstacle add and the clamp; every 8 relaxations one
    comparison and one host read decide whether to go on.
    """
    dev = resolve_device(device)
    free_t = torch.as_tensor(free, device=dev).bool()
    src = torch.as_tensor(np.asarray(sources), device=dev).long().reshape(-1, 2)
    h, w = free_t.shape
    b = src.shape[0]
    f32 = torch.float32
    inf = torch.tensor(INF, dtype=f32, device=dev)
    free_f = torch.where(free_t, torch.zeros((), dtype=f32, device=dev),
                         inf)[None]                       # (1, H, W)
    costs = [torch.tensor(c, dtype=f32, device=dev) for _, _, c in _NEIGHBORS]

    pad = torch.full((b, h + 2, w + 2), INF, dtype=f32, device=dev)
    dist = pad[:, 1:h + 1, 1:w + 1]                       # a view
    dist[torch.arange(b, device=dev), src[:, 0], src[:, 1]] = 0.0
    dist += free_f                                        # sources in walls => INF
    best = torch.empty((b, h, w), dtype=f32, device=dev)
    cand = torch.empty_like(best)
    before = torch.empty_like(best)
    eps = torch.tensor(1e-6, dtype=f32, device=dev)

    def relax():
        # shifted[y, x] = dist[y - dy, x - dx], edges INF: a view of ``pad``
        best.copy_(dist)
        for (dy, dx, _), cost in zip(_NEIGHBORS, costs):
            torch.add(pad[:, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w], cost,
                      out=cand)
            torch.minimum(best, cand, out=best)
        best.add_(free_f)
        torch.clamp_max(best, inf, out=dist)

    it = 0
    changed = True
    while changed and it < h * w + 64:
        before.copy_(dist)
        for _ in range(CHECK_EVERY):
            relax()
        it += CHECK_EVERY
        changed = bool(torch.any(dist < before - eps))
    out = dist.contiguous()
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
