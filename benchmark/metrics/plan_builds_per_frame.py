"""Planning memos that missed and rebuilt, per frame: the program's
"cr.plan.build.*" spans (widths, pack, cache, sky, shadow), which it
records only on a miss."""

from benchmark.spans import BUILD, has_plan, spans


def read(t):
    if not t.frames or not has_plan(t):
        return None
    return sum(e.name.startswith(BUILD) for e in spans(t)) / t.frames
