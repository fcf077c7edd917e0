"""Spans and counters at the port's layer boundaries, and the one exporter.

Each layer wraps its boundary in ``span(name)`` and counts values it already
holds on the host with ``count(name, value)``. The recorder is off by
default: ``span`` then returns one shared no-op context manager after one
flag test (no allocation, no clock read) and ``count`` returns at once.

Turned on (``enable()``), a span records its name, its start and end on
``time.perf_counter()``, its thread's ``threading.get_ident()`` (whose low
32 bits are the profiler's id of the thread), its parent and the unit it
belongs to. Stacks are per thread: the autograd engine runs the
CUDA backward on its own thread, so a span opened there with none open on
its own thread takes as parent the innermost span open on the thread that
turned the recorder on. A span opened with ``unit=True`` where no span is
open starts a new unit (a train step, a lockstep step, an env step, a
render); every other span takes the unit of its parent, or the last unit
started. ``count`` adds to a counter of the innermost open span. Spans and
counters are kept in memory until read (``spans()``, ``counters()``) and
cleared by ``reset()``. Neither a span nor a counter launches, copies or
waits for the device.

``*.read_*`` spans mark the places where the host waits for the card: a
read of a device value, or a copy of host values to the card, which
PyTorch makes from pageable memory and waits for.

``trace()`` is the exporter: it turns the recorder on for its block, runs
``torch.profiler`` over it and writes one Chrome trace holding the
profiler's events and the spans, on the profiler's clock.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import torch

DEFAULT_TRACE = Path(__file__).resolve().parents[2] / "build" / "trace.json"
CLOCK_MARK = "sage3d.clock"


class Span(NamedTuple):
    """A closed span. ``thread`` is ``threading.get_ident()``; ``parent``
    the id of the enclosing span (None at the top); ``unit`` the unit id
    (None before the first unit); ``counters`` what was counted under it."""
    id: int
    name: str
    start: float
    end: float
    thread: int
    parent: Optional[int]
    unit: Optional[int]
    counters: Dict[str, float]


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()
_on = False


class _Recorder:
    """The recorder's state: the closed spans, each thread's stack of open
    ones and the units."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.closed: List[_Open] = []
        self.stacks: Dict[int, list] = {}
        self.ids = itertools.count()
        self.units = itertools.count()
        self.unit: Optional[int] = None
        self.home = threading.get_ident()

    def innermost(self):
        """The innermost open span of this thread, else of the home thread."""
        for ident in (threading.get_ident(), self.home):
            stack = self.stacks.get(ident)
            try:
                if stack:
                    return stack[-1]
            except IndexError:      # the other thread closed it meanwhile
                pass
        return None


_rec = _Recorder()


class _Open:
    """One span while the recorder is on: one object from its opening to
    ``spans()``, so that a span allocates once."""
    __slots__ = ("name", "unit", "id", "start", "end", "thread", "parent",
                 "counters")

    def __init__(self, name: str, unit: bool):
        self.name = name
        self.unit = unit            # a request until the span opens
        self.counters = None

    def __enter__(self):
        ident = threading.get_ident()
        stack = _rec.stacks.get(ident)
        if stack is None:
            stack = _rec.stacks[ident] = []
        parent = stack[-1] if stack else _rec.innermost()
        if parent is not None:
            self.parent, self.unit = parent.id, parent.unit
        else:
            self.parent = None
            if self.unit:
                _rec.unit = next(_rec.units)
            self.unit = _rec.unit
        self.id = next(_rec.ids)
        self.thread = ident
        stack.append(self)
        self.start = time.perf_counter()
        return None

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        _rec.stacks[self.thread].pop()
        _rec.closed.append(self)
        return False


def span(name: str, unit: bool = False):
    """A context manager around one layer's work: the shared no-op while
    the recorder is off. ``unit=True`` starts a unit where no span is
    open."""
    if not _on:
        return _NOOP
    return _Open(name, unit)


def count(name: str, value) -> None:
    """Add ``value`` (a host number the caller already holds) to the
    counter ``name`` of the innermost open span."""
    if not _on:
        return
    top = _rec.innermost()
    if top is not None:
        c = top.counters
        if c is None:
            c = top.counters = {}
        c[name] = c.get(name, 0) + value


def enable() -> None:
    """Turn the recorder on; spans opened with no span open on any thread
    take the calling thread's as parent from now on."""
    global _on
    _rec.home = threading.get_ident()
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Forget every span, counter and unit (call it with no span open)."""
    _rec.reset()


def spans() -> List[Span]:
    """The closed spans, in the order they closed."""
    return [Span(s.id, s.name, s.start, s.end, s.thread, s.parent, s.unit,
                 dict(s.counters or {})) for s in _rec.closed]


def counters() -> Dict[str, float]:
    """Each counter's total over the closed spans."""
    out: Dict[str, float] = {}
    for s in _rec.closed:
        for k, v in (s.counters or {}).items():
            out[k] = out.get(k, 0) + v
    return out


def _chrome_events(items: List[Span], offset_us: float) -> list:
    """The spans as Chrome trace events: a process of their own, a track a
    thread; ``offset_us`` takes ``perf_counter`` microseconds to the
    trace's clock."""
    out = [{"ph": "M", "name": "process_name", "pid": "spans",
            "args": {"name": "sage3d_tpu_torch spans"}}]
    for s in items:
        out.append({"ph": "X", "cat": "span", "name": s.name, "pid": "spans",
                    "tid": s.thread, "ts": s.start * 1e6 + offset_us,
                    "dur": (s.end - s.start) * 1e6,
                    "args": {"id": s.id, "parent": s.parent, "unit": s.unit,
                             **s.counters}})
    return out


@contextlib.contextmanager
def trace(path: Optional[str] = None):
    """Run the block under ``torch.profiler`` (CPU, and CUDA where there is
    a card) with the recorder on, then write one Chrome trace to ``path``
    (default ``build/trace.json`` of the checkout): the profiler's events
    and the block's spans, put on the profiler's clock by a marker
    annotation opened right after a ``perf_counter`` read. Yields the
    path."""
    from torch.profiler import ProfilerActivity, profile, record_function
    path = Path(path or DEFAULT_TRACE)
    path.parent.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was_on = _on
    reset()
    with profile(activities=activities) as prof:
        t_mark = time.perf_counter()
        with record_function(CLOCK_MARK):
            pass
        enable()
        try:
            yield str(path)
        finally:
            if not was_on:
                disable()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    mark = next(e for e in events if e.get("name") == CLOCK_MARK
                and e.get("ph") == "X")
    events.extend(_chrome_events(spans(), float(mark["ts"]) - t_mark * 1e6))
    with open(path, "w") as f:
        json.dump(data, f)
