"""One run of one cell: set up, warm up, measure, check, report.

Everything that belongs to one cell is found by name: the cell in
BENCHMARK.json, its configuration in configs/<config>.json (scene, eye,
pose, RenderConfig fields), its traffic mix in traffic/<traffic>.json (read
by the one general generator, traffic.py), each per-layer metric's reader
in metrics/<name>.py and the limits of its output check in
limits/<workload>.json.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import scene as S
from benchmark import traffic as T
from benchmark.reference import Reference
from benchmark.trace import read_chrome_trace

HERE = os.path.dirname(os.path.abspath(__file__))
BENCHMARK_JSON = os.path.join(os.path.dirname(HERE), "BENCHMARK.json")
FORBIDDEN = ("jax", "jaxlib", "flax", "compound_ray_tpu")
TRACE_SLICE_S = 2.0  # the traced slice: the window's first seconds


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc), else 0."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load:
    JAX and the JAX package, compared whole."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def load_json(root: str, kind: str, name: str) -> dict:
    with open(os.path.join(root, kind, name + ".json")) as f:
        return json.load(f)


def metrics_of(bench: dict, workload: str, kind: str) -> List[dict]:
    """The cell's metrics of `kind` ("end_to_end" or "per_layer"): those
    that list it, or list no cells and move a metric the cell reports."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def _e2e(name: str, run: dict) -> float:
    lat = np.asarray(run["latency_s"])
    if name == "rays_per_s":
        return run["rays_per_frame"] * len(lat) / run["window_s"]
    if name == "frame_ms_p95":
        return float(np.percentile(lat, 95.0)) * 1e3
    if name == "setup_s":
        return run["setup_s"]
    raise KeyError(f"no end-to-end metric named {name!r}")


def compare(got: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    gap = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    if not np.isfinite(gap).all():
        return {"max_abs_gap": float("inf"), "mean_abs_gap": float("inf")}
    return {"max_abs_gap": float(gap.max()),
            "mean_abs_gap": float(gap.mean())}


def check_frames(scene, omms, samples, seed, frames, device,
                 dtype=torch.float32, lit: bool = False
                 ) -> List[Dict[str, float]]:
    """The compared numbers of each checked frame (frame index, pose, the
    program's (N, 3) means) against the reference's frame."""
    ref = Reference(scene, device, dtype=dtype)
    return [compare(got, ref.frame(
        omms, pose[:3], S.pose_local_space(*pose[3:]), samples, seed, index,
        lit)) for index, pose, got in frames]


def widest(gaps: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(g[k] for g in gaps) for k in gaps[0]}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t0: float, bench: Optional[dict] = None, root: str = HERE,
             device="cuda", limits: Optional[dict] = None,
             log: Callable[[str], None] = None) -> dict:
    """One run; returns the result line's object (see README.md)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    if bench is None:
        with open(BENCHMARK_JSON) as f:
            bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = load_json(root, "configs", cell["config"])
    traffic = load_json(root, "traffic", cell["traffic"])
    if limits is None:
        limits = load_json(root, "limits", workload)
    phases = [("start", t0), ("imports", time.perf_counter())]
    scene = S.build_scene(cfg, root)
    omms = S.build_eye(cfg, root)
    samples = int(traffic["samples"])
    warm_poses, poses = T.pose_streams(cfg, traffic, scene, omms, seed)
    phases.append(("scene", time.perf_counter()))

    from benchmark.system import System  # the program, from here on

    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    system = System(cfg, traffic, scene, omms, seed, dev)
    phases.append(("renderer", time.perf_counter()))
    for pose in warm_poses:  # the cell's own shapes and plans
        system.view(pose)
    phases.append(("warm-up", time.perf_counter()))
    log("set-up: " + ", ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b) in zip(phases,
                                                          phases[1:])))
    current = [p for p in warm_poses if p is not None][-1]
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's way

    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]
            + ([torch.profiler.ProfilerActivity.CUDA]
               if dev.type == "cuda" else []))
        prof.start()
    tracing = trace
    latency, outputs = [], []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    slice_end = t_start + min(seconds, TRACE_SLICE_S)
    while time.perf_counter() < deadline:
        pose = poses[len(latency) % len(poses)]
        current = current if pose is None else pose
        index = system.frames
        a = time.perf_counter()
        if tracing:
            with torch.profiler.record_function("bench.frame"):
                out = system.view(pose)
        else:
            out = system.view(pose)
        b = time.perf_counter()
        latency.append(b - a)
        outputs.append((index, current, np.array(out, np.float32)))
        if tracing and b >= slice_end:
            prof.stop()
            tracing = False
    t_end = time.perf_counter()
    gc.unfreeze()
    if tracing:
        prof.stop()
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    run = {"latency_s": latency, "window_s": t_end - t_start,
           "setup_s": t_start - t0, "rays_per_frame": len(omms) * samples}
    log(f"window: {len(latency)} frames in {run['window_s']:.6f} s, set-up "
        f"{run['setup_s']:.6f} s, peak device memory {memory_peak} B")
    system.close()
    del system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    result = {"correct": False, "attempted": len(latency), "failed": 0,
              "metrics": {}, "device": device_info(dev, memory_peak)}
    if trace:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            del prof
            sliced = read_chrome_trace(path)
        finally:
            os.remove(path)
        for m in metrics_of(bench, workload, "per_layer"):
            reader = S.load_plugin("metrics", m["name"], root)
            value = reader.read(sliced) if sliced is not None else None
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value),
                                                "unit": m["unit"]}
        if sliced is not None:
            result["device"]["busy_s"] = sliced.busy_s()
            result["device"]["window_s"] = sliced.span_s
            result["breakdown"] = sliced.breakdown()
            log(f"traced slice: {sliced.frames} frames, "
                f"{sliced.span_s:.6f} s, device busy {sliced.busy_s():.6f} s")
    else:
        for m in metrics_of(bench, workload, "end_to_end"):
            result["metrics"][m["name"]] = {"value": _e2e(m["name"], run),
                                            "unit": m["unit"]}

    # the output check, once the program's state is freed
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, 2])
    n_check = min(int(traffic.get("check_frames", 2)), len(outputs))
    picked = sorted(rng.choice(len(outputs), size=n_check, replace=False))
    a = time.perf_counter()
    gaps = check_frames(scene, omms, samples, seed,
                        [outputs[i] for i in picked], dev,
                        lit=bool(traffic.get("lighting", False)))
    log(f"reference: {n_check} frames ({[outputs[i][0] for i in picked]}) "
        f"in {time.perf_counter() - a:.3f} s")
    result["failed"] = sum(
        any(not v <= limits[k]["limit"] for k, v in g.items()) for g in gaps)
    checks = {k: {"value": v, "limit": float(limits[k]["limit"])}
              for k, v in widest(gaps).items()}
    result["correct"] = bool(gaps) and result["failed"] == 0
    result["checks"] = checks
    return result


def device_info(dev: torch.device, memory_peak: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(memory_peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}
