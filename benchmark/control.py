"""The output check's control: the reference computed in bfloat16, the
nearest precision below the float32 the configurations state, put in the
program's place.  For each seed it picks the frames a run of the cell
would check (frame indices after the warm-up, poses from the cell's
traffic) and prints the compared numbers against the float32 reference,
which have to come out above the cell's limits.  The benchmark's own runs
never run it.

    python3 -m benchmark.control --workload <name> --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from benchmark import harness
from benchmark import scene as S
from benchmark import traffic as T
from benchmark.reference import Reference


def control_gaps(workload: str, seed: int, bench: dict,
                 root: str = harness.HERE, device="cuda",
                 dtype=torch.bfloat16, frames_in_window: int = 100) -> dict:
    """The compared numbers of the control on the frames a run of
    `seed` would check, were its window `frames_in_window` frames."""
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = harness.load_json(root, "configs", cell["config"])
    traffic = harness.load_json(root, "traffic", cell["traffic"])
    scene = S.build_scene(cfg, root)
    omms = S.build_eye(cfg, root)
    samples = int(traffic["samples"])
    lit = bool(traffic.get("lighting", False))
    warm, poses = T.pose_streams(cfg, traffic, scene, omms, seed)
    current = [p for p in warm if p is not None][-1]
    rng = np.random.default_rng([seed & T.SEED_MASK, 2])
    n_check = min(int(traffic.get("check_frames", 2)), frames_in_window)
    picked = sorted(rng.choice(frames_in_window, size=n_check,
                               replace=False))
    low = Reference(scene, device, dtype=dtype)
    frames = []
    for i in picked:
        pose = poses[i % len(poses)] or current
        index = len(warm) + int(i)
        got = low.frame(omms, pose[:3], S.pose_local_space(*pose[3:]),
                        samples, seed, index, lit)
        frames.append((index, pose, got))
    return harness.widest(harness.check_frames(
        scene, omms, samples, seed, frames, device, lit=lit))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with open(harness.BENCHMARK_JSON) as f:
        bench = json.load(f)
    limits = harness.load_json(harness.HERE, "limits", args.workload)
    for seed in args.seeds:
        gaps = control_gaps(args.workload, seed, bench, device=args.device)
        over = {k: v > limits[k]["limit"] for k, v in gaps.items()}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": gaps, "fails_a_limit": any(
                              over.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
