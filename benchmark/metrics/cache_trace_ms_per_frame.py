"""Device milliseconds a frame spends in kernels launched inside the
program's "cr.plan.cache.trace" span: the far-field cache build's
K2 launch, the shading of its hits, the un-blocking mean and the quad
table.  K2 is counted with the eager kernels (eager_ms_in leaves the
program's own kernels out, and K2 is most of this span's work).  None
where the slice holds no such span (a program without it, or a window
that builds no cache) or does not pair."""

from benchmark.spans import has_plan, pair, spans

TRACE = "cr.plan.cache.trace"


def read(t):
    if not any(s.name == TRACE for s in spans(t)):
        return None
    if not t.frames or not has_plan(t):
        return None
    p = pair(t)
    if p is None:
        return None
    us = sum(d.dur for d, chain in p.device
             if TRACE in chain and d.cat == "kernel")
    return us * 1e-3 / t.frames
