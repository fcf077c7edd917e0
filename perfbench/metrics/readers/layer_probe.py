"""Device milliseconds of one layer alone, per unit of work: the layer's
device time summed over the driver's probe of the traced units' inputs
(``extra[<seconds>]`` over ``extra[<units>]``)."""


def read(data, seconds: str, units: str):
    s, n = data.extra.get(seconds), data.extra.get(units)
    if not s or not n:
        return None
    return 1e3 * s / n
