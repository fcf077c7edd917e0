"""A kernel's share of its roofline, in percent: the least time the card
could take for the work the traced launches needed (``extra[least]``,
from the benchmark's own counts) over the device time of those launches
(the kernels whose name holds one of ``kernels``; where ``extra[launches]``
lists indices, only those launches)."""


def read(data, kernels: list, least: str, launches: str = None):
    t = data.extra.get(least)
    evs = data.kernels(*kernels)
    if not t or not evs:
        return None
    pick = data.extra.get(launches) if launches else None
    if pick is not None:
        if max(pick) >= len(evs):
            return None
        evs = [evs[i] for i in pick]
    spent = sum(e - s for _, s, e in evs)
    return 100.0 * t / spent if spent > 0 else None
