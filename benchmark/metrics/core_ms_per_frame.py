"""Device milliseconds a frame spends in kernels launched inside the
program's "cr.core" span, K1 and K3 excepted as eager_ms_per_frame excepts
them: the frame core's eager torch operations (spans.py pairs each kernel
with its launch)."""

from benchmark.spans import CORE, eager_ms_in


def read(t):
    return eager_ms_in(t, CORE)
