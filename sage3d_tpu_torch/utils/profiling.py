"""Profiling and roofline accounting for the render pipeline.

PyTorch counterpart of ``sage3d_tpu/utils/profiling.py``:
  * ``trace()`` wraps ``torch.profiler`` (CPU, and CUDA where there is a
    card) and writes a TensorBoard trace;
  * ``timed()`` measures a call's first run and its steady state: CUDA events
    around the runs when the call's output lies on the card, the host clock
    when it lies on the CPU;
  * ``render_cost_model()`` gives per-stage FLOP/byte estimates so measured
    throughput can be compared against the memory/compute roofline.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch
from torch.utils._pytree import tree_leaves

DEFAULT_TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "trace"


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler trace context; the trace lands in ``log_dir``
    (default ``build/trace`` of the checkout), readable by TensorBoard."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    log_dir = str(log_dir or DEFAULT_TRACE_DIR)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


def _on_cuda(out) -> bool:
    return any(torch.is_tensor(x) and x.is_cuda for x in tree_leaves(out))


def timed(fn: Callable, *args, iters: int = 4) -> Dict[str, float]:
    """Seconds of ``fn(*args)``'s first call (``first_s``, the device
    finished) and per call over ``iters`` more (``steady_s``): CUDA events
    around the calls when the output lies on the card, else the host's
    clock."""
    t0 = time.perf_counter()
    cuda = _on_cuda(fn(*args))
    if cuda:
        torch.cuda.synchronize()
    first = time.perf_counter() - t0
    if cuda:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn(*args)
        b.record()
        b.synchronize()
        steady = a.elapsed_time(b) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        steady = (time.perf_counter() - t0) / iters
    return {"first_s": first, "steady_s": steady}


def render_cost_model(n_gaussians: int, width: int, height: int,
                      n_pairs: int, mean_live_depth: float = 64.0) -> Dict:
    """FLOP/byte estimates per render stage for roofline comparison.

    mean_live_depth: average pairs actually composited per pixel before
    early termination (scene-dependent; ~2x the opacity-weighted saturation
    depth).
    """
    proj_flops = n_gaussians * 250           # quat->rot, EWA, SH0
    proj_bytes = n_gaussians * (60 * 4 + 10 * 4)
    bin_bytes = n_pairs * 3 * 4 * 4          # emit + sort passes (approx)
    live_pairs = width * height / 1024 * mean_live_depth
    comp_flops = live_pairs * 1024 * 40      # alpha + scan + blend per pair-chunk px
    comp_bytes = n_pairs * 16 * 4            # one feats stream
    return {
        "projection": {"flops": proj_flops, "bytes": proj_bytes},
        "binning": {"bytes": bin_bytes},
        "compositing": {"flops": comp_flops, "bytes": comp_bytes},
        "total_flops": proj_flops + comp_flops,
        "total_bytes": proj_bytes + bin_bytes + comp_bytes,
    }
