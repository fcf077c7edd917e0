"""The collectives' share of the link's roofline, in percent: the least
time the bytes that had to enter this rank (the program's counter
``counter``, ``mesh.link_bytes``) take at the link's peak
(``roofline/links.py``), over the device time of the operations launched
under the program's collective spans ``span``, both over the program
trace's span stretch. None where the program recorded neither."""

from perfbench.harness import program_trace
from perfbench.roofline import links


def read(data, counter: str, span):
    trace = program_trace.attach(data)
    if trace is None:
        return None
    n_bytes = trace.counters.get(counter)
    spent = trace.device_s([span] if isinstance(span, str) else span)
    if not n_bytes or spent <= 0:
        return None
    return 100.0 * links.least_seconds(n_bytes) / spent
