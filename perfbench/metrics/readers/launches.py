"""Device operations (kernels, copies, memsets) the host launched in the
traced stretch, per unit of ``per`` (a key of the stretch's work)."""


def read(data, per: str):
    n = data.work.get(per, 0)
    if not n or not data.events:
        return None
    return len(data.events) / n
