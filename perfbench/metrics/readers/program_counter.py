"""The ratio of two of the program's counters over the program trace's
span stretch (``harness/program_trace.py``), times ``scale``: ``num`` /
``den``. None where the program counted neither."""

from perfbench.harness import program_trace


def read(data, num: str, den: str, scale: float = 100.0):
    trace = program_trace.attach(data)
    if trace is None:
        return None
    ratio = trace.counter_ratio(num, den)
    return None if ratio is None else scale * ratio
