"""Device milliseconds a frame spends in kernels launched inside the
program's "cr.plan.cache.cull" span: the far-field cache build's
tile cones, its (tiles x clusters) cull and the shortlist sort, eager
torch all of them.  None where the slice holds no such span (a program
without it, or a window that builds no cache)."""

from benchmark.spans import eager_ms_in, spans

CULL = "cr.plan.cache.cull"


def read(t):
    if not any(s.name == CULL for s in spans(t)):
        return None
    return eager_ms_in(t, CULL)
