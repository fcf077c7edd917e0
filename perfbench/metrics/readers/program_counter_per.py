"""One of the program's counters over the program trace's span stretch
(``harness/program_trace.py``), per unit of ``per`` (a key of the
stretch's work), times ``scale``. None where the program counted nothing
of it."""

from perfbench.harness import program_trace


def read(data, counter: str, per: str, scale: float = 1.0):
    trace = program_trace.attach(data)
    if trace is None:
        return None
    value, n = trace.counters.get(counter), trace.work.get(per, 0)
    if value is None or not n:
        return None
    return scale * value / n
