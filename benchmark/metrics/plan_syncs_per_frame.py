"""Host waits for the device inside the program's "cr.plan" span, per
frame: stream, device and event synchronisations and blocking copies."""

from benchmark.spans import PLAN, has_plan, syncs


def read(t):
    if not t.frames or not has_plan(t):
        return None
    return sum(PLAN in chain for _, chain in syncs(t)) / t.frames
