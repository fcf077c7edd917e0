"""The arithmetic of the end-to-end and per-layer numbers.

A rate is all the work of the window over all its seconds; a tail is the
nearest-rank percentile of every sample of the window, never of medians of
chunks, so a stall shows in it; a spread is the distance between the first
and third quartiles as ``statistics.quantiles(values, n=4)`` gives them, as
a share of the median."""

from __future__ import annotations

import math
import statistics


def rate(work: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return work / seconds


def percentile(samples, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of all samples:
    the smallest sample with at least q% of the samples at or below it."""
    xs = sorted(samples)
    if not xs:
        raise ValueError("no samples")
    return xs[max(math.ceil(q / 100.0 * len(xs)) - 1, 0)]


def spread(values) -> float:
    """(Q3 - Q1) / median of a set of runs' readings."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def merge_intervals(intervals):
    """The union of (start, end) intervals, sorted and merged."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy(intervals, lo: float, hi: float) -> float:
    """The time within [lo, hi] that some interval covers."""
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in merge_intervals(intervals))


def idle_gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in merge_intervals(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]
