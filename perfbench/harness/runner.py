"""One run of one cell: set up, measure a window (or trace a stretch),
check the outputs against the plain reference, print the result line.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's file names its configuration and its traffic driver; the driver
sets up the program from the seed, runs one unit of work a call, and
checks the window's outputs. Here are the parts every cell shares: the
device checks, the window, the rates and tails, the trace and its
readers, memory, the check for JAX, and the result line, whose last key
``compared`` holds each number compared beside its limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from . import registry, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "sage3d_tpu")


class Ctx:
    """What a traffic driver is given: the run's arguments, the cell's
    and its configuration's files, the device, the host spans, and a log
    to standard error."""

    def __init__(self, cell, seed, device, base=None):
        base = base or registry.HERE
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        self.workload = registry.workload(cell, base)
        self.config = registry.config(self.workload["config"], base)
        self.params = self.workload["params"]
        self.limits = self.workload.get("limits", {})
        self.spans = trace.Spans()

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def jax_modules() -> list:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs(root) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(root / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def window(session, seconds: float):
    """Units back to back until ``seconds`` have passed; the unit running
    then completes. Returns (the units' records, the window's seconds)."""
    records = []
    t0 = time.perf_counter()
    while True:
        records.append(session.unit())
        if time.perf_counter() - t0 >= seconds:
            break
    session.sync()
    return records, time.perf_counter() - t0


def traced(ctx, session, bench):
    """The per-layer metrics of the cell from a traced stretch of its
    units (``trace_units`` of them), a sync-counted stretch, and the
    driver's extras. Returns (metrics, device fields, breakdown, units
    traced)."""
    n = int(ctx.workload["trace_units"])
    records = []

    def stretch():
        for _ in range(n):
            records.append(session.unit())
        session.sync()

    events, t0, t1 = trace.profile(stretch, ctx.spans)
    n_sync = int(ctx.workload.get("sync_units", 1))
    syncs = trace.count_syncs(lambda: [session.unit() for _ in range(n_sync)]
                              and session.sync())
    work = session.work(records)
    extra = session.trace_extra(records)
    data = trace.TraceData(events, t0, t1, work, ctx.spans.items,
                           syncs / n_sync, extra)
    metrics = {}
    for m in registry.cell_metrics(bench, ctx.cell, "per_layer"):
        spec = registry.metric(m["name"])
        value = spec["read"](data, **spec.get("args", {}))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics, {"busy_s": data.busy_s, "window_s": data.window_s}, \
        data.breakdown(), len(records)


def run(cell: str, seed: int, seconds: float, trace_on: bool, t_start: float,
        device=None, base=None, bench=None) -> dict:
    """One run of ``cell``; returns the result line as a dict. ``device``
    None means the card (the benchmark's only device); tests pass "cpu"."""
    import torch
    bench = bench or registry.benchmark()
    dev = torch.device("cuda" if device is None else device)
    ctx = Ctx(cell, seed, dev, base)
    driver = registry.traffic(ctx.workload["traffic"], base or registry.HERE)
    if dev.type == "cuda":
        from . import port
        port.build()
        torch.cuda.reset_peak_memory_stats()
    session = driver.setup(ctx)
    session.sync()
    setup_s = time.perf_counter() - t_start
    out = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if trace_on:
        metrics, fields, breakdown, units = traced(ctx, session, bench)
        out["breakdown"] = breakdown
    else:
        records, window_s = window(session, seconds)
        units = len(records)
        values = session.end_to_end(records, window_s)
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in registry.cell_metrics(bench, cell, "end_to_end")}
        fields = {}
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    t_check = time.perf_counter()
    compared = session.check()       # frees the program's state first
    del session
    gc.collect()
    ctx.log(f"perfbench: {cell} seed {seed}: set-up {setup_s:.3f} s, "
            f"{'trace' if trace_on else 'window'} and readers "
            f"{t_check - t_start - setup_s:.3f} s, check "
            f"{time.perf_counter() - t_check:.3f} s")
    # the units of work run, and the compared numbers past their limits
    out["attempted"] = units
    out["failed"] = sum(1 for c in compared if not c["ok"])
    out["correct"] = out["failed"] == 0 and bool(compared)
    out["metrics"] = metrics
    out["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": int(ctx.workload["chips"]),
        "memory_peak_bytes": int(peak), **fields}
    out["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                       for c in compared}
    return out


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs(registry.ROOT)
    import torch
    torch.set_num_threads(1)
    bench = registry.benchmark()
    chips = int(registry.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              t_start, bench=bench)
    found = jax_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0
