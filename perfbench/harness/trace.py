"""The traced run: a CUDA-only ``torch.profiler`` trace of a steady stretch
of the cell's own units, the benchmark's host spans around the calls into
the program's layers, and the host syncs of a second stretch.

Device time is read from the trace's kernels, copies and memsets: ``busy``
is the union of their intervals within the stretch, ``window`` the
stretch's wall time, so the idle share is 1 - busy / window. The host's
spans and the device's events are put on one clock by a marker kernel
launched right after a synchronize. Nothing here imports the program."""

from __future__ import annotations

import time
import warnings
from contextlib import contextmanager

import torch

from . import stats


class Spans:
    """Host spans of the benchmark's own calls into the program, as
    (name, start, end) on the host's ``perf_counter`` clock. Off unless
    ``on``; the timed window keeps them off."""

    def __init__(self):
        self.on = False
        self.items = []

    @contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))


class TraceData:
    """What a per-layer metric's reader is given: the stretch's device
    events (name, start s, end s) on the host clock, its window and busy
    seconds, the units, steps, frames and pixels it ran, its host spans, the
    syncs of the sync stretch per unit, and the driver's own extras
    (roofline counts, layer probes)."""

    def __init__(self, events, t0, t1, work, spans, syncs_per_unit, extra):
        self.events = events
        self.t0, self.t1 = t0, t1
        self.window_s = t1 - t0
        self.busy_s = stats.busy([(s, e) for _, s, e in events], t0, t1)
        self.work = work
        self.spans = spans
        self.syncs_per_unit = syncs_per_unit
        self.extra = extra

    def kernels(self, *patterns):
        """The events whose name holds one of ``patterns``, in order."""
        return [ev for ev in self.events
                if any(p in ev[0] for p in patterns)]

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took the most time, and the longest
        idle gaps named by the host span they fell in."""
        by_name = {}
        for name, s, e in self.events:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = stats.idle_gaps([(s, e) for _, s, e in self.events],
                               self.t0, self.t1)
        named = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = 0.5 * (s + e)
            inner = [sp for sp in self.spans if sp[1] <= mid <= sp[2]]
            label = (min(inner, key=lambda sp: sp[2] - sp[1])[0]
                     if inner else "between calls")
            named.append([label, e - s])
        return {"device_ops": [[k[:96], v] for k, v in ops],
                "idle_gaps": named}


def _device_events(prof):
    out = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        tr = e.time_range
        out.append((e.name, tr.start * 1e-6, tr.end * 1e-6))
    return sorted(out, key=lambda ev: ev[1])


def profile(run, spans: Spans):
    """Run ``run()`` (the stretch: units of the cell, then a synchronize)
    under a CUDA-only profiler. Returns (device events on the host clock,
    t0, t1): the stretch's host start and end."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t_mark = time.perf_counter()
        torch.cuda._sleep(1000)          # the marker: ~1 us of spin
        torch.cuda.synchronize()
        spans.on = True
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        spans.on = False
    events = _device_events(prof)
    if not events:
        raise RuntimeError("the profiler's trace holds no device event")
    offset = t_mark - events[0][1]      # the marker is the first event
    return ([(n, s + offset, e + offset) for n, s, e in events[1:]
             if s + offset >= t0 - 1e-4], t0, t1)


def count_syncs(run) -> int:
    """``run()`` and the host syncs it made (``set_sync_debug_mode``'s
    warnings; its notice that the mode is a prototype is not a sync)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message)
               and "prototype" not in str(w.message) for w in caught)
