"""K1's divide-free reject test (mm_tracer.k1_reject, which
csrc/packed_tracer.cu mirrors) against the exact candidate test of the
twin, as a property over float32 values: it never rejects a pair that the
exact test accepts.  Torch only; the non-vacuity check on a pose pack is in
tests/test_torch_k1.py.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")

from hypothesis import example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from compound_ray_tpu_torch.trace import mm_tracer as TM  # noqa: E402


def _exact_accepts(w1, w2, den, tnum):
    """The twin's exact candidate test on float32 tensors."""
    inv = 1.0 / den
    u, v, t = w1 * inv, w2 * inv, tnum * inv
    return (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)


_TINY = float(np.float32(2.0 ** -149))  # the least subnormal


@settings(max_examples=3000, deadline=None)
@given(st.tuples(*[st.floats(width=32) for _ in range(4)])
       | st.tuples(st.floats(0.0, 1.0, width=32),
                   st.floats(-(2.0 ** 127), 2.0 ** 127, width=32),
                   st.floats(0.0, 4.0, width=32),
                   st.sampled_from([0.0, 1.0, -1.0, 2.0 ** -20])).map(
           lambda x: _near_boundary(*x)))
@example((0.0, 0.0, 0.0, 0.0))  # an all-zero padding column
@example((0.0, 0.0, -0.0, 0.0))
@example((1.0, 1.0, 0.0, 1.0))  # den = 0, u = v = +inf
@example((-_TINY, 0.5, 1e30, 1.0))  # u rounds to -0: accepted
@example((_TINY, _TINY, _TINY, 0.0))  # subnormal products, t = 0
@example((-_TINY, -_TINY, -_TINY, -_TINY))
@example((0.25, 0.75, 1.0, 0.0))  # u + v = 1 exactly, t = 0
@example((-0.25, -0.75, -1.0, -0.0))
@example((0.5, 0.5, 3.0, 2.0 ** -140))
@example((1.0, 0.0, float("inf"), 1.0))  # inv = 0: u = v = t = 0 accepted
@example((float("nan"), 0.0, 1.0, 0.0))
def test_reject_rule_never_rejects_an_accepted_pair(vals):
    """K1's divide-free reject test (mm_tracer.k1_reject, which the kernel
    mirrors) is sound: no pair that the exact test accepts is rejected.
    Drawn over all float32 values (signed zeros, subnormals, infinities,
    NaN) and over pairs built at the boundary of the triangle (u + v = 1,
    t = 0 and its neighbours, at every scale of den)."""
    w1, w2, den, tnum = (torch.tensor([x], dtype=torch.float32)
                         for x in vals)
    if _exact_accepts(w1, w2, den, tnum).item():
        assert not TM.k1_reject(w1, w2, den, tnum).item(), vals


def _near_boundary(u, den, t, nudge):
    """(w1, w2, den, tnum) for barycentrics u, 1 - u and t scaled by den,
    nudged by a few ulps' worth of `nudge`: pairs on the edges of what the
    exact test accepts."""
    f = np.float32
    v = f(1.0) - f(u) + f(nudge) * f(2.0 ** -24)
    with np.errstate(over="ignore"):  # |den| near the float32 limit
        return (float(f(u) * f(den)), float(v * f(den)), float(f(den)),
                float(f(t) * f(den) + f(nudge) * f(_TINY)))
