"""Device milliseconds a frame spends in kernels launched inside the
program's "cr.plan" span, the program's own CUDA kernels excepted: the
planning layer's eager torch operations (spans.py pairs each kernel with
its launch)."""

from benchmark.spans import PLAN, eager_ms_in


def read(t):
    return eager_ms_in(t, PLAN)
