"""The device's idle share of the traced stretch, in percent: the time no
kernel, copy or memset ran, over the stretch's wall time."""


def read(data):
    if data.window_s <= 0 or not data.events:
        return None
    return 100.0 * (1.0 - data.busy_s / data.window_s)
