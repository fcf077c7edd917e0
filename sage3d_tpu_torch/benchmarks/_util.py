"""Plumbing shared by the port's benchmark scripts: flushed stage logging,
timing of chained calls, and the card's name and power limit."""

from __future__ import annotations

import statistics
import subprocess
import time

import torch


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def timed(fn, iters: int, device=None) -> float:
    """Milliseconds per call of ``fn`` over ``iters`` chained calls
    ``c = c + fn(c)``, where ``fn`` returns a 0-d tensor that depends on the
    work of its call. On a CUDA device the time is taken with CUDA events
    around the chain, after which the last event is waited for; on the CPU
    (the plain versions only) it is the host clock."""
    dev = torch.device("cuda" if device is None else device)
    c = torch.zeros((), dtype=torch.float32, device=dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            c = c + fn(c)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        c = c + fn(c)
    float(c)
    return (time.perf_counter() - t0) * 1e3 / iters


def timed_best(fn, iters: int, device=None) -> tuple:
    """(least, median) milliseconds per call over 3 ``timed`` loops of
    ``iters`` chained calls, after one warm-up loop."""
    timed(fn, iters, device)
    per = [timed(fn, iters, device) for _ in range(3)]
    return min(per), statistics.median(per)


def nvidia_smi_line() -> str:
    """The first card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]
