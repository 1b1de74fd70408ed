"""Named host ranges of the port's layers, on torch.profiler's clock.

span(name) records a range of category cpu_op, the category of torch's own
operations, while a torch.profiler session records (EyeRenderer.start_profile
or any profiler around the calls); otherwise it returns one shared context
that does nothing, at the cost of one attribute read.  A span never launches
device work or syncs.  Spans nest by containment on the thread that renders:
the ranges a frame's device work was launched in say which layer did it.
PERF.md lists every span and what reads it.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` while a profiler records."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def spanned(name: str):
    """Decorator: every call of the function is span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
