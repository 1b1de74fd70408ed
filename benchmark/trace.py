"""Reading a profiler trace of the measured window into per-layer numbers.

The window's traced slice is recorded by torch.profiler (CPU and CUDA
activity) and exported as a Chrome trace.  Every frame of the slice is a
"bench.frame" annotation that the harness itself records.  From the trace
this module keeps the device's work (kernels, copies and sets), the host's
operations and the frames, and answers what the per-layer readers
(metrics/<name>.py) ask of it.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

FRAME_SPAN = "bench.frame"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
HERE = os.path.dirname(os.path.abspath(__file__))


def kernel_names(root: str = HERE) -> Dict[str, List[str]]:
    """The program's own CUDA kernels by group, from kernels/<group>.txt
    (name fragments that a kernel's trace name contains, one a line), and
    all of them as the group "port"."""
    out: Dict[str, List[str]] = {}
    kdir = os.path.join(root, "kernels")
    for name in sorted(os.listdir(kdir)):
        if name.endswith(".txt"):
            with open(os.path.join(kdir, name)) as f:
                out[name[:-4]] = [ln.strip() for ln in f if ln.strip()]
    out["port"] = [frag for frags in out.values() for frag in frags]
    return out


@dataclasses.dataclass
class Event:
    name: str
    cat: str
    ts: float  # microseconds
    dur: float

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclasses.dataclass
class TraceSlice:
    frames: int  # bench.frame spans in the slice
    start: float  # first frame's start, microseconds
    end: float  # last frame's end
    device: List[Event]  # kernels, copies and sets inside [start, end]
    host: List[Event]  # host operations inside [start, end]
    kernels: Dict[str, List[str]]
    _starts: Optional[List[float]] = dataclasses.field(default=None,
                                                       repr=False)

    @property
    def span_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def is_kernel(self, e: Event, group: str) -> bool:
        return e.cat == "kernel" and any(
            frag in e.name for frag in self.kernels[group])

    def device_s(self, group: str) -> float:
        """Summed device seconds of the kernels of `group`."""
        return sum(e.dur for e in self.device
                   if self.is_kernel(e, group)) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device activity, clipped to the slice, sorted."""
        spans = sorted((max(e.ts, self.start), min(e.end, self.end))
                       for e in self.device)
        out: List[List[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def host_at(self, t: float, scan: int = 4096) -> str:
        """The host operation running at time t that started last (the
        innermost, where operations nest)."""
        if self._starts is None:
            self.host.sort(key=lambda e: e.ts)
            self._starts = [e.ts for e in self.host]
        i = bisect.bisect_right(self._starts, t) - 1
        for j in range(i, max(-1, i - scan), -1):
            if self.host[j].end >= t:
                return self.host[j].name
        return "python"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the idle time by
        what the host was doing, each [name, seconds], longest first."""
        ops: Dict[str, float] = defaultdict(float)
        for e in self.device:
            ops[e.name[:120]] += e.dur * 1e-6
        idle: Dict[str, float] = defaultdict(float)
        for a, b in self.idle_gaps():
            idle[self.host_at((a + b) / 2)[:120]] += (b - a) * 1e-6
        return {"device_ops": sorted(([k, v] for k, v in ops.items()),
                                     key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                    key=lambda kv: -kv[1])[:top]}


def read_chrome_trace(path: str,
                      kernels: Optional[Dict[str, List[str]]] = None
                      ) -> Optional[TraceSlice]:
    """The slice between the first and the last bench.frame span of a
    Chrome trace, or None where it holds no frame."""
    with open(path) as f:
        raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    frames, device, host = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        e = Event(str(ev.get("name", "")), str(ev.get("cat", "")),
                  float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0)))
        if e.cat == "user_annotation" and e.name == FRAME_SPAN:
            frames.append(e)
        elif e.cat in DEVICE_CATS:
            device.append(e)
        elif e.cat in HOST_CATS:
            host.append(e)
    if not frames:
        return None
    start = min(e.ts for e in frames)
    end = max(e.end for e in frames)
    return TraceSlice(
        frames=len(frames), start=start, end=end,
        device=[e for e in device if e.end > start and e.ts < end],
        host=[e for e in host if e.end > start and e.ts < end],
        kernels=kernels if kernels is not None else kernel_names())
