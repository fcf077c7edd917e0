"""A number of the program's own spans, from the program trace's stretches
(``harness/program_trace.py``): ``device_ms``, the device milliseconds of
the operations launched under the spans named ``span`` (a name or a list),
per unit of ``per``; ``host_ms``, the spans' own host milliseconds per unit
of ``per``; ``median_ms``, the median host milliseconds of one such span;
``unnamed_syncs``, the host syncs per unit of ``per`` whose innermost
program span is not a ``*.read_*`` span. None where the program recorded no
such span."""

from perfbench.harness import program_trace


def read(data, stat: str, span, per: str = None):
    trace = program_trace.attach(data)
    if trace is None:
        return None
    return trace.stat(stat, span, per)
