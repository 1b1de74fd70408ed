"""The port's tools.

The kernel-measurement tools (tools/probe_step.py and tools/microbench_k.py
of the repository, on PyTorch and CUDA):

    python -m compound_ray_tpu_torch.tools.probe_step    # K4, K5 and K1
    python -m compound_ray_tpu_torch.tools.microbench_k  # K6

Both run on the card by default and write their JSON record under
build/compound_ray_tpu_torch/ (or to --out).  With --device cpu they run
the kernels' torch twins at the sizes given, timed on the host clock; such
a record says so and holds no device time.

The eye tools (compound_ray_tpu/tools/*, each with its main(argv)):

    python -m compound_ray_tpu_torch.tools.eye_generator out.eye -n 1000
    python -m compound_ray_tpu_torch.tools.eye_transforms rescale in.eye 0.1
    python -m compound_ray_tpu_torch.tools.eye_visualiser -f in.eye
    python -m compound_ray_tpu_torch.tools.obj_centerer mesh.obj
    python -m compound_ray_tpu_torch.tools.minimum_sample_rate_finder -f scene.gltf
    python -m compound_ray_tpu_torch.tools.variance_mapper -f scene.gltf

eye_generator (its gradient mode), minimum_sample_rate_finder and
variance_mapper run on the card unless given --device cpu; the others are
numpy.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Callable, Optional

import torch

from compound_ray_tpu_torch.trace._build import BUILD_DIR


def card_line() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, or None
    where nvidia-smi is absent."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip().splitlines()[0]


def device_record(device: torch.device) -> dict:
    """What a record's numbers were measured on, and with which clock."""
    if device.type == "cuda":
        return {"device": torch.cuda.get_device_name(device),
                "card": card_line(), "timer": "cuda events"}
    return {"device": str(device), "card": None,
            "timer": "host clock (torch twins; no device time)"}


def time_ms(fn: Callable[[], object], reps: int, device="cuda",
            warmup: int = 1) -> float:
    """Mean ms of `reps` back-to-back calls of fn after `warmup` calls: CUDA
    events around the calls on a card, the host clock on the CPU.  No
    per-call sync, so a call shorter than its launch overhead measures the
    host's launch rate."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def write_record(record: dict, name: str, out: Optional[str]) -> str:
    """Write `record` as JSON to `out`, or to build/compound_ray_tpu_torch/
    <name>.json; returns the path."""
    path = out or os.path.join(BUILD_DIR, f"{name}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return path
