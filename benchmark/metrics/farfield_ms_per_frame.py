"""Device milliseconds a frame spends in kernels launched inside the
program's "cr.core.farfield" span: the frame core's far-field work, the
test of each hit against the far-field sphere and the cache lookups.
None where the slice holds no such span (a program without it, or a frame
that uses no cache)."""

from benchmark.spans import eager_ms_in, spans

FARFIELD = "cr.core.farfield"


def read(t):
    if not any(s.name == FARFIELD for s in spans(t)):
        return None
    return eager_ms_in(t, FARFIELD)
