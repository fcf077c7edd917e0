"""The program's own spans and counters in a traced run.

After the traced run's own stretches, two more stretches of the cell's
units run with the program's recorder (``sage3d_tpu_torch.utils.profiling``)
on:

- **a span stretch** of ``trace_units`` units under the same CUDA-only
  profiler. Each device operation is put on the host clock by its launch
  (the profiler's ``cuda_runtime`` event with the same ``correlation``), and
  attributed to the innermost program span open on the launching thread at
  that moment, else the innermost one open on the main thread, else the
  innermost of the benchmark's own spans. Two spin markers, launched right
  after ``perf_counter`` reads before and after the stretch, give the clock
  offset and check it; they are found by their launches between runs of
  padding launches, since the profiler can lose the device records of a
  trace's first and last operations (the launches that lost theirs are
  counted). Idle gaps are named by the innermost span of either kind open
  at their midpoint;
- **a sync stretch** of ``sync_units`` units in which every host sync that
  ``torch.cuda.set_sync_debug_mode`` reports is credited to the program's
  innermost span open on its thread when it is raised.

Readers reach the result through ``attach(data)``, which runs both
stretches the first time a reader asks and keeps it as ``data.program``;
the traced run's ``breakdown`` then comes from the span stretch. The runner
hands a reader only the ``TraceData``: the cell's session and context are
taken from the runner's frame that holds that ``TraceData``. Where the
program has no recorder, nothing runs and every reader gets None.
"""

from __future__ import annotations

import json
import statistics
import sys
import threading
import time
import warnings
from collections import Counter, defaultdict

from . import registry, stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARKER_CYCLES = 1000
# spin kernels launched before and after the markers: the profiler can lose
# the device records of the first and the last operations of a trace
PAD = 512
UNATTRIBUTED = "unattributed"


def recorder():
    """The program's recorder module, or None where the program has none."""
    try:
        from sage3d_tpu_torch.utils import profiling
    except ImportError:
        return None
    need = ("enable", "disable", "reset", "spans", "counters")
    return profiling if all(hasattr(profiling, k) for k in need) else None


def tid32(ident: int) -> int:
    """The profiler's id of a thread: the low 32 bits of
    ``threading.get_ident()`` as a signed int."""
    v = ident & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def innermost(spans, queries, home):
    """For each (time, thread) query, the innermost span open at that time
    on that thread, else on ``home``, else None. ``spans``: objects with
    ``start``, ``end`` and ``thread``, nested per thread."""
    events = [(s.start, 0, s) for s in spans]
    events += [(s.end, 2, s) for s in spans]
    events += [(t, 1, i) for i, (t, _) in enumerate(queries)]
    events.sort(key=lambda e: (e[0], e[1]))
    stacks = defaultdict(list)
    out = [None] * len(queries)
    for _, kind, x in events:
        if kind == 0:
            stacks[x.thread].append(x)
        elif kind == 2:
            st = stacks[x.thread]
            if st and st[-1] is x:
                st.pop()
            elif x in st:
                st.remove(x)
        else:
            st = stacks.get(queries[x][1]) or stacks.get(home)
            out[x] = st[-1] if st else None
    return out


class _Bench:
    """A benchmark span as ``innermost`` takes it."""
    __slots__ = ("name", "start", "end", "thread")

    def __init__(self, name, start, end, thread):
        self.name, self.start, self.end, self.thread = name, start, end, thread


def chrome_ops(events, t_mark, t_end, pad: int = 0):
    """Device operations of an exported Chrome trace on the host clock:
    (name, start, end, launch time, launching thread id) each, the end
    marker's distance from its ``perf_counter`` read (s), and the launches
    between the markers that the trace holds no device operation of. The
    markers are the kernel launches right after ``t_mark`` and ``t_end``
    were read, each ``pad`` launches in from its end of the trace; they are
    found by their launches, which the trace keeps even where it loses an
    operation's device record."""
    launch, kernels = {}, []
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e["ts"], e["tid"])
            if e["name"].startswith(("cudaLaunchKernel", "cuLaunchKernel")):
                kernels.append(e["ts"])
    kernels.sort()
    if len(kernels) < 2 * pad + 2:
        raise RuntimeError("the span stretch's trace lacks its markers")
    first, last = kernels[pad], kernels[-pad - 1]
    offset = t_mark - first * 1e-6
    check = last * 1e-6 + offset - t_end
    dev = {e["args"]["correlation"]: e for e in events
           if e.get("cat") in DEVICE_CATS
           and e.get("args", {}).get("correlation") in launch}
    ops = []
    for corr, e in dev.items():
        ts, tid = launch[corr]
        if not first < ts < last:
            continue
        s = e["ts"] * 1e-6 + offset
        ops.append((e["name"], s, s + e["dur"] * 1e-6, ts * 1e-6 + offset,
                    tid))
    ops.sort(key=lambda o: o[3])
    lost = sum(1 for e in events if e.get("cat") in LAUNCH_CATS
               and e["name"].startswith(("cudaLaunchKernel", "cuLaunchKernel",
                                         "cudaMemcpy", "cudaMemset"))
               and first < e["ts"] < last
               and e.get("args", {}).get("correlation") not in dev)
    return ops, check, lost


class ProgramTrace:
    """The span stretch's device operations attributed to spans, its spans
    and counters, and the sync stretch's syncs credited to spans."""

    def __init__(self, spans, counters, bench, ops, t0, t1, work, syncs,
                 sync_work, home, clock_check_s, lost=0):
        self.spans, self.counters, self.work = spans, counters, work
        self.t0, self.t1 = t0, t1
        self.clock_check_s, self.lost = clock_check_s, lost
        self.sync_work = sync_work
        self.by_id = {s.id: s for s in spans}
        threads = {tid32(s.thread): s.thread for s in spans}
        threads.setdefault(tid32(home), home)
        owner = innermost(spans, [(o[3], threads.get(o[4], home))
                                  for o in ops], home)
        bench_items = [_Bench(n, a, b, home) for n, a, b in bench]
        fallback = innermost(bench_items, [(o[3], home) for o in ops], home)
        # each operation: (name, start, end, program span or None, label)
        self.ops = [(o[0], o[1], o[2], p,
                     p.name if p is not None
                     else (b.name if b is not None else UNATTRIBUTED))
                    for o, p, b in zip(ops, owner, fallback)]
        self.bench = bench_items
        self.syncs = syncs              # [(program span name or None, bench)]
        self._chains = {}

    def chain(self, span) -> frozenset:
        """The names of ``span`` and its ancestors."""
        if span is None:
            return frozenset()
        if span.id not in self._chains:
            parent = self.by_id.get(span.parent)
            self._chains[span.id] = self.chain(parent) | {span.name}
        return self._chains[span.id]

    # -- what the readers read ---------------------------------------------
    def device_s(self, names) -> float:
        """Device seconds of the operations launched under any of
        ``names``."""
        names = set(names)
        return sum(e - s for _, s, e, p, _ in self.ops
                   if p is not None and self.chain(p) & names)

    def host_s(self, names) -> float:
        names = set(names)
        return sum(s.end - s.start for s in self.spans if s.name in names)

    def durations(self, name) -> list:
        return [s.end - s.start for s in self.spans if s.name == name]

    def unnamed_syncs(self) -> int:
        """Syncs whose innermost program span is not a ``*.read_*`` span;
        those the benchmark's own code makes outside every program span are
        the benchmark's, not the program's."""
        return sum(1 for name, bench in self.syncs
                   if not (name is None and bench)
                   and (name is None or ".read_" not in name))

    def stat(self, stat: str, names, per=None):
        names = [names] if isinstance(names, str) else list(names)
        if not any(s.name in names for s in self.spans):
            return None
        if stat == "median_ms":
            return 1e3 * statistics.median(self.durations(names[0]))
        if stat == "unnamed_syncs":
            n = self.sync_work.get(per, 0)
            return self.unnamed_syncs() / n if n else None
        n = self.work.get(per, 0)
        if not n:
            return None
        if stat == "device_ms":
            s = self.device_s(names)
            return 1e3 * s / n if s > 0 else None
        if stat == "host_ms":
            return 1e3 * self.host_s(names) / n
        raise ValueError(f"unknown stat {stat}")

    def counter_ratio(self, num: str, den: str):
        a, b = self.counters.get(num), self.counters.get(den)
        return a / b if a is not None and b else None

    # -- the breakdown and the run's log ------------------------------------
    def breakdown(self, n: int = 10) -> dict:
        """The (span, operation) pairs that took the most device time, and
        the longest idle gaps named by the innermost span, of either kind,
        open at their midpoint."""
        by_name = Counter()
        for name, s, e, _, label in self.ops:
            by_name[f"{label}: {name}"] += e - s
        gaps = stats.idle_gaps([(s, e) for _, s, e, _, _ in self.ops],
                               self.t0, self.t1)
        named = []
        every = list(self.spans) + self.bench
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = 0.5 * (s + e)
            inner = [sp for sp in every if sp.start <= mid <= sp.end]
            label = (min(inner, key=lambda sp: sp.end - sp.start).name
                     if inner else "between calls")
            named.append([label, e - s])
        return {"device_ops": [[k[:96], v] for k, v in by_name.most_common(n)],
                "idle_gaps": named}

    def summary(self) -> str:
        busy = stats.busy([(s, e) for _, s, e, _, _ in self.ops],
                          self.t0, self.t1)
        owned = stats.busy([(s, e) for _, s, e, _, label in self.ops
                            if label != UNATTRIBUTED], self.t0, self.t1)
        gaps = stats.idle_gaps([(s, e) for _, s, e, _, _ in self.ops],
                               self.t0, self.t1)
        g0, g1 = max(gaps, key=lambda g: g[1] - g[0], default=(0.0, 0.0))
        units = max(self.work.get("units", 0), 1)
        su = max(self.sync_work.get("units", 0), 1)
        syncs = Counter(name or ("benchmark" if bench else "no span")
                        for name, bench in self.syncs)
        table = ", ".join(f"{k} {v / su:g}" for k, v in syncs.most_common())
        return (f"program trace: {len(self.spans) / units:g} spans a unit; "
                f"unit {1e3 * (self.t1 - self.t0) / units:.3f} ms traced "
                f"with the recorder on; "
                f"{100 * owned / busy if busy else 0:.2f}% of "
                f"{1e3 * busy:.3f} ms busy attributed; "
                f"{len(self.ops)} operations, {self.lost} launches without "
                f"a device record; longest gap {1e3 * (g1 - g0):.3f} ms at "
                f"{1e3 * (g0 - self.t0):.3f} ms; end marker "
                f"{1e6 * self.clock_check_s:+.1f} us; syncs a unit: {table}")


def _runner_frame(data):
    """The runner's frame holding ``data``, its session and its context."""
    f = sys._getframe(1)
    while f is not None:
        loc = f.f_locals
        if loc.get("data") is data and "session" in loc and "ctx" in loc:
            return loc
        f = f.f_back
    return None


def span_stretch(ctx, session, prof, n: int):
    """``n`` units under the CUDA-only profiler with the recorder on.
    Returns (spans, counters, benchmark spans, operations, t0, t1, work,
    end marker check, launches without a device record)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    saved = ctx.spans.items
    ctx.spans.items = []
    records = []

    def pad():
        for _ in range(PAD):
            torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()

    pad()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        torch.cuda.synchronize()
        pad()
        prof.reset()
        prof.enable()
        t_mark = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        ctx.spans.on = True
        t0 = time.perf_counter()
        try:
            for _ in range(n):
                records.append(session.unit())
            session.sync()
        finally:
            t1 = time.perf_counter()
            ctx.spans.on = False
            prof.disable()
        t_end = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        pad()
        time.sleep(0.1)
    bench, ctx.spans.items = ctx.spans.items, saved
    spans, counters = prof.spans(), prof.counters()
    prof.reset()
    path = registry.ROOT / "build" / "program_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        p.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    ops, check, lost = chrome_ops(events, t_mark, t_end, PAD)
    return (spans, counters, bench, ops, t0, t1, session.work(records),
            check, lost)


def sync_stretch(session, prof, n: int):
    """``n`` units with the recorder on and every host sync reported.
    Returns ([(program span name or None, raised by the benchmark's own
    code)], work)."""
    import torch
    hits, records = [], []
    home = threading.get_ident()

    def hook(message, category, filename, lineno, file=None, line=None):
        m = str(message)
        if "synchroniz" in m and "prototype" not in m:
            hits.append((time.perf_counter(), threading.get_ident(),
                         "perfbench" in str(filename)))

    prof.reset()
    prof.enable()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n):
                records.append(session.unit())
            session.sync()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            prof.disable()
    spans = prof.spans()
    prof.reset()
    owner = innermost(spans, [(t, ident) for t, ident, _ in hits], home)
    return ([(s.name if s is not None else None, bench)
             for s, (_, _, bench) in zip(owner, hits)],
            session.work(records))


def attach(data):
    """The program's trace of this traced run (``data.program``), made the
    first time a reader asks; None where the program has no recorder or no
    runner's frame holds ``data``."""
    if hasattr(data, "program"):
        return data.program
    data.program = None
    prof = recorder()
    loc = _runner_frame(data)
    if prof is None or loc is None:
        return None
    ctx, session = loc["ctx"], loc["session"]
    home = threading.get_ident()
    spans, counters, bench, ops, t0, t1, work, check, lost = span_stretch(
        ctx, session, prof, int(ctx.workload["trace_units"]))
    syncs, sync_work = sync_stretch(
        session, prof, int(ctx.workload.get("sync_units", 1)))
    program = ProgramTrace(spans, counters, bench, ops, t0, t1, work, syncs,
                           sync_work, home, check, lost)
    data.program = program
    data.breakdown = program.breakdown
    ctx.log(program.summary())
    return program
