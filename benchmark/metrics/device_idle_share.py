"""Share of the traced slice in which the device ran nothing, in %:
100 (1 - union of device activity / the slice's span)."""


def read(t):
    if not t.device or t.span_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.span_s)
