"""Planner benchmark: the batched wavefront planner on the card vs serial host A*.

    python -m sage3d_tpu_torch.benchmarks.planner_bench [--size 240]
        [--pairs 64] [--astar-pairs N] [--device cpu]

PyTorch counterpart of ``benchmarks/planner_bench.py``, with its own copy of
the indoor grid (``make_grid``) and the endpoint draw (``sample_free``): the
same numpy draws, so the same grid and pairs. The stated purpose of
``wavefront_distances`` (data/astar.py) is replacing thousands of serial A*
runs in trajectory generation; this measures that claim on a realistic nav
grid. Prints one JSON line: pairs/s of both planners (host clock; the
wavefront's ends in its fields' copy to the host), ms per batch of 16, the
relaxations each batch ran to convergence, and whether every pair's
reachability and path length agree with A* (lengths within max(2, 2%)).
``--astar-pairs`` runs A* on the first N pairs only (all by default): at
400x400 one A* takes most of a second on the host.

Without a card it exits 2; ``--device cpu`` runs the same code on the CPU
(a check of the script, not a measurement of the card).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..data.astar import astar_pixel, plan_many, wavefront_distances
from ..renderer.scene import resolve_device

BATCH = 16      # plan_many's sources per wavefront


def make_grid(size=240, seed=0):
    """Indoor-like occupancy grid: boundary walls + rooms + door gaps."""
    rng = np.random.default_rng(seed)
    g = np.zeros((size, size), np.int8)
    g[:2], g[-2:], g[:, :2], g[:, -2:] = 1, 1, 1, 1
    for _ in range(6):  # inner walls with doors
        if rng.random() < 0.5:
            r = rng.integers(20, size - 20)
            g[r:r + 2, :] = 1
            for _ in range(3):
                c = rng.integers(5, size - 15)
                g[r:r + 2, c:c + 10] = 0
        else:
            c = rng.integers(20, size - 20)
            g[:, c:c + 2] = 1
            for _ in range(3):
                r = rng.integers(5, size - 15)
                g[r:r + 10, c:c + 2] = 0
    return g


def sample_free(g, n, seed=1):
    free = np.argwhere(g == 0)
    rng = np.random.default_rng(seed)
    return free[rng.choice(len(free), n * 2, replace=False)].reshape(n, 2, 2)


def lengths_agree(astar_paths, wave_paths) -> int:
    """Pairs whose reachability agrees and, when reachable, whose path
    lengths agree within max(2, 2%) of A*'s."""
    agree = 0
    for pa, pw in zip(astar_paths, wave_paths):
        if (pa is None) == (pw is None):
            if pa is None or abs(len(pa) - len(pw)) <= max(
                    2, int(0.02 * len(pa))):
                agree += 1
    return agree


def run(size: int = 240, n_pairs: int = 64, device=None,
        n_astar: int | None = None) -> dict:
    """Both planners on ``make_grid(size)`` and ``n_pairs`` pairs of
    ``sample_free``, A* on the first ``n_astar`` of them (all when None);
    the wavefront on ``device`` (None means the card)."""
    dev = resolve_device(device)
    g = make_grid(size)
    pairs = sample_free(g, n_pairs)
    starts, goals = pairs[:, 0], pairs[:, 1]
    n_astar = n_pairs if n_astar is None else min(n_astar, n_pairs)

    t0 = time.perf_counter()
    astar_paths = [astar_pixel(g, (int(s[1]), int(s[0])),
                               (int(e[1]), int(e[0])))
                   for s, e in zip(starts[:n_astar], goals[:n_astar])]
    t_astar = time.perf_counter() - t0

    plan_many(g == 0, starts[:2], goals[:2], device=dev)    # warm-up
    t0 = time.perf_counter()
    wf_paths = plan_many(g == 0, starts, goals, batch=BATCH, device=dev)
    t_wf = time.perf_counter() - t0
    n_batches = -(-n_pairs // BATCH)
    relaxations = [wavefront_distances(g == 0, starts[i:i + BATCH],
                                       device=dev, return_relaxations=True)[1]
                   for i in range(0, n_pairs, BATCH)]
    return {
        "metric": "planner_pairs_per_s",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "grid": [size, size],
        "n_pairs": n_pairs,
        "astar_pairs": n_astar,
        "batches": n_batches,
        "astar_s": t_astar,
        "wavefront_s": t_wf,
        "speedup": (n_pairs / t_wf) / (n_astar / t_astar),
        "astar_pairs_per_s": n_astar / t_astar,
        "wavefront_pairs_per_s": n_pairs / t_wf,
        "wavefront_ms_per_batch": t_wf * 1e3 / n_batches,
        "relaxations_per_batch": relaxations,
        "reachability_agree": lengths_agree(astar_paths, wf_paths[:n_astar]),
        "reach_astar": sum(p is not None for p in astar_paths),
        "reach_wavefront": sum(p is not None for p in wf_paths[:n_astar]),
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv

    def arg(name, default):
        return argv[argv.index(name) + 1] if name in argv else default

    device = arg("--device", None)
    if device is None and not torch.cuda.is_available():
        print("planner_bench: no CUDA device; pass --device cpu to run the "
              "script on the CPU", file=sys.stderr)
        return 2
    n_astar = arg("--astar-pairs", None)
    print(json.dumps(run(int(arg("--size", 240)), int(arg("--pairs", 64)),
                         device=device,
                         n_astar=None if n_astar is None else int(n_astar))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
