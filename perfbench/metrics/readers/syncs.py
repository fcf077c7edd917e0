"""Host syncs per env step, counted by ``torch.cuda.set_sync_debug_mode``
over a separate stretch of the cell's units."""


def read(data, per: str):
    units, n = data.work.get("units", 0), data.work.get(per, 0)
    if not units or not n:
        return None
    return data.syncs_per_unit * units / n
