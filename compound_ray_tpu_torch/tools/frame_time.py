"""Times EyeRenderer.render_frame on the bench configuration: the
2000-box procedural scene, a 1000-ommatidium 2.6 degree sphere eye, one
unit above the scene's centre, the far field off (chip_smoke.py's phase 5,
its first path).

    python -m compound_ray_tpu_torch.tools.frame_time --samples 100
    python -m compound_ray_tpu_torch.tools.frame_time --save build/means.npy

After WARMUP frames it times FRAMES synced frames, each with CUDA events
(device ms) and render_frame's own wall ms, and counts the torch
operations one more frame issues on the host (torch.profiler, CPU only).
It prints one JSON line with the card's name and power limit; --save
writes the last frame's camera data, so two trees' frames can be compared
bit for bit.  It uses only the package's entry points, so the same file
times another tree of the package when that tree comes first on
PYTHONPATH and this file is run by its path.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

WARMUP, FRAMES = 5, 30


def bench_renderer(device: str):
    """The bench eye on the bench scene at the bench pose."""
    from compound_ray_tpu_torch import EyeRenderer, config
    from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera
    from compound_ray_tpu_torch.testing import make_big_scene, make_sphere_eye

    config.set_config(config.RenderConfig(farfield="off"))
    r = EyeRenderer(verbose=False, device=device)
    r.scene = make_big_scene(n_boxes=2000, seed=0)
    cam = CompoundEyeCamera("bench-eye", "single_dimension_fast",
                            make_sphere_eye(1000, acceptance_deg=2.6))
    r.scene.cameras.append(cam)
    r.goto_camera(len(r.scene.cameras) - 1)
    c = r.scene.aabb_center()
    cam.set_position((float(c[0]), float(c[1]) + 1.0, float(c[2])))
    return r


def frame_times(r, samples: int) -> dict:
    r.set_current_eye_samples_per_ommatidium(samples)
    for _ in range(WARMUP):
        r.render_frame()
    device_ms, wall_ms = [], []
    for _ in range(FRAMES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        wall_ms.append(r.render_frame())
        end.record()
        torch.cuda.synchronize()
        device_ms.append(start.elapsed_time(end))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r.render_frame()
    ops = [e for e in prof.events() if e.name.startswith("aten::")]
    return dict(samples=samples, frames=FRAMES,
                frame_ms=device_ms, mean_ms=float(np.mean(device_ms)),
                median_ms=float(np.median(device_ms)), wall_ms=wall_ms,
                aten_ops_per_frame=len(ops))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--save", default=None,
                    help="write the last frame's camera data (.npy) here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("frame_time needs a CUDA device")
    from compound_ray_tpu_torch.tools import card_line

    t0 = time.perf_counter()
    r = bench_renderer("cuda")
    rec = frame_times(r, args.samples)
    rec.update(card=card_line(), seconds=time.perf_counter() - t0)
    if args.save:
        np.save(args.save, r.get_camera_data())
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
