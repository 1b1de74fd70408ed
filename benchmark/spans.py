"""The program's own spans in a traced slice, and which span launched each
device operation.

The program records named host ranges ("cr.plan", "cr.core", ...; PERF.md
lists them) of the profiler's category cpu_op, so they reach
TraceSlice.host beside torch's operations and the CUDA API calls.  This
module is the one place that pairs the launch calls of the host with the
device's kernels, copies and sets, and puts each device operation down to
the spans around its launch.

The pairing does not compare a launch call's time with its operation's:
on the card the device's records drift against the host's by up to ~1.5 %
within a slice (tens of milliseconds over 2 s; PERF.md, section 7), so
neither a device time nor a cut on the host's clock places an operation.
The program renders on one stream, so the launch calls in host order and
the operations in device order are one sequence each, and they pair one to
one at one shift: the operations of the first launches may be missing
(the device tracing comes up a little after the host's, and drift moves
operations across the slice's ends), and so may those of the last.  A
shift pairs when every pair agrees in kind (a kernel launch with a kernel,
a copy with a copy, a set with a set) and in owner (a launch call inside
cr.k1, cr.k2 or cr.k3 with that kernel of the program, any other with no
kernel of the program).  The slice has a pairing only where exactly one
shift pairs.  The card's traces show the launch calls of the program's own
kernels (cudaLaunchKernel inside cr.k1 and cr.k3), so every operation has
a launch call to pair with.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from benchmark.trace import Event, TraceSlice

PREFIX = "cr."
PLAN = "cr.plan"
CORE = "cr.core"
BUILD = "cr.plan.build."
KERNEL_SPANS = {"cr.k1": "k1", "cr.k2": "k2", "cr.k3": "k3"}
# a launch call's kind by name prefix, and a device operation's by category
CALL_KINDS = (("cudaLaunch", "kernel"), ("cuLaunch", "kernel"),
              ("cudaMemcpy", "gpu_memcpy"), ("cuMemcpy", "gpu_memcpy"),
              ("cudaMemset", "gpu_memset"), ("cuMemset", "gpu_memset"))
LAUNCH_PREFIXES = tuple(prefix for prefix, _ in CALL_KINDS)
# calls after which the host waits for the device
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
                   "cuCtxSynchronize", "cuEventSynchronize", "cuMemcpy"})
HOST_API = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Pairing:
    device: List[Tuple[Event, Tuple[str, ...]]]  # (operation, its spans)
    unpaired: Tuple[int, int]  # launch calls with no operation: first, last


def spans(t: TraceSlice) -> List[Event]:
    """The program's spans in the slice, by start."""
    return sorted((e for e in t.host if e.cat == "cpu_op"
                   and e.name.startswith(PREFIX)), key=lambda e: e.ts)


def enclosing(spans_: List[Event], times: List[float]
              ) -> List[Tuple[str, ...]]:
    """For each of the sorted `times`, the names of the spans that hold
    it, outermost first.  Spans nest by containment (one host thread)."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans_) and spans_[i].ts <= t:
            s = spans_[i]
            while stack and stack[-1].end < s.ts:
                stack.pop()
            stack.append(s)
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        # where rounding lets a child end past its parent, the parent
        # still holds t only if it has not ended
        out.append(tuple(s.name for s in stack if s.end >= t))
    return out


def _kind(name: str) -> str:
    return next(kind for prefix, kind in CALL_KINDS
                if name.startswith(prefix))


def pair(t: TraceSlice) -> Optional[Pairing]:
    """Each device operation of the slice with the spans around its launch
    call, or None where the launches and the operations do not pair."""
    calls = sorted((e for e in t.host if e.cat in HOST_API
                    and e.name.startswith(LAUNCH_PREFIXES)
                    and e.ts >= t.start), key=lambda e: e.ts)
    chains = enclosing(spans(t), [c.ts for c in calls])
    # what each launch call must pair with: (kind, the program's kernel
    # group or None)
    want = [(_kind(c.name), KERNEL_SPANS.get(ch[-1]) if ch else None)
            for c, ch in zip(calls, chains)]
    device = sorted(t.device, key=lambda e: e.ts)
    have = [(d.cat, next((g for g in KERNEL_SPANS.values()
                          if t.is_kernel(d, g)), None)) for d in device]
    shifts = [s for s in range(len(calls) - len(device) + 1)
              if all(want[s + i] == h for i, h in enumerate(have))]
    if len(shifts) != 1:
        return None
    s = shifts[0]
    return Pairing(list(zip(device, chains[s:])),
                   (s, len(calls) - len(device) - s))


def has_plan(t: TraceSlice) -> bool:
    return any(e.name == PLAN and e.cat == "cpu_op" for e in t.host)


def eager_ms_in(t: TraceSlice, name: str) -> Optional[float]:
    """Device ms per frame of the kernels that are not the program's own
    CUDA kernels, launched inside span `name`; None where the slice has no
    cr.plan span or does not pair."""
    if not t.frames or not has_plan(t):
        return None
    p = pair(t)
    if p is None:
        return None
    us = sum(d.dur for d, chain in p.device if name in chain
             and d.cat == "kernel" and not t.is_kernel(d, "port"))
    return us * 1e-3 / t.frames


def syncs(t: TraceSlice) -> List[Tuple[Event, Tuple[str, ...]]]:
    """The host's waits for the device, each with the spans around it."""
    sp = spans(t)
    calls = sorted((e for e in t.host if e.cat in HOST_API
                    and e.name in SYNCS), key=lambda e: e.ts)
    return list(zip(calls, enclosing(sp, [c.ts for c in calls])))
