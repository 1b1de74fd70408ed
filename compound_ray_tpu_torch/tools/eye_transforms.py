"""Eye-file transformation utilities.

Re-implements the reference's small eye tools (data/tools/):
  * rescale     — eyeRescaler.py: scale ommatidial positions so the mean
                  distance from the eye centre hits a target radius
  * split       — eyeSplitter.py: duplicate an eye into left/right halves
                  shifted apart along x, with a configurable overlap band
  * adjust_acceptance — eyeAcceptanceAngleAdjuster.py: set each ommatidium's
                  acceptance angle from the angular distance to its nearest
                  neighbour (assumes a spherical eye)

A copy of compound_ray_tpu/tools/eye_transforms.py on the port's
scene/eye_io.py.
"""

from __future__ import annotations

import argparse
import math
from typing import List

import numpy as np

from compound_ray_tpu_torch.scene.eye_io import (
    Ommatidium,
    read_eye_file,
    write_eye_file,
)


def rescale(omms: List[Ommatidium], target_radius: float) -> List[Ommatidium]:
    """Scale positions so the mean |position| equals target_radius."""
    avg = float(np.mean([np.linalg.norm(o.position) for o in omms]))
    scale = target_radius / avg if avg > 0 else 1.0
    return [
        Ommatidium(o.position * scale, o.direction.copy(),
                   o.acceptance_angle, o.focal_point_offset)
        for o in omms
    ]


def split(
    omms: List[Ommatidium], distance: float, overlap: float
) -> List[Ommatidium]:
    """Split into two eyes along x: ommatidia within the overlap band appear
    in both halves; each half is shifted by ±distance along x."""
    out: List[Ommatidium] = []
    xs = np.asarray([o.position[0] for o in omms])
    span = float(xs.max() - xs.min()) if len(omms) else 0.0
    band = span * overlap / 2.0
    left_shift = np.array([-distance, 0.0, 0.0])
    for o in omms:
        x = o.position[0]
        if x <= band:  # left half (plus overlap)
            out.append(Ommatidium(o.position + left_shift, o.direction.copy(),
                                  o.acceptance_angle, o.focal_point_offset))
        if x >= -band:  # right half (plus overlap)
            out.append(Ommatidium(o.position - left_shift, o.direction.copy(),
                                  o.acceptance_angle, o.focal_point_offset))
    return out


def adjust_acceptance(omms: List[Ommatidium]) -> List[Ommatidium]:
    """Acceptance angle := angular distance to the nearest ommatidium (by
    direction), the densest-packing heuristic of the reference tool."""
    dirs = np.stack([o.direction / np.linalg.norm(o.direction) for o in omms])
    cos = np.clip(dirs @ dirs.T, -1.0, 1.0)
    np.fill_diagonal(cos, -1.0)
    nearest_angle = np.arccos(cos.max(axis=1))
    return [
        Ommatidium(o.position.copy(), o.direction.copy(),
                   float(a), o.focal_point_offset)
        for o, a in zip(omms, nearest_angle)
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description="Transform .eye files")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("rescale")
    r.add_argument("input")
    r.add_argument("radius", type=float)
    r.add_argument("-o", "--output")

    s = sub.add_parser("split")
    s.add_argument("input")
    s.add_argument("-d", "--distance", type=float, required=True)
    s.add_argument("-v", "--overlap", type=float, required=True)
    s.add_argument("-o", "--output")

    a = sub.add_parser("adjust-acceptance")
    a.add_argument("input")
    a.add_argument("-o", "--output")

    args = ap.parse_args(argv)
    omms = read_eye_file(args.input)
    stem = ".".join(args.input.split(".")[:-1])
    if args.cmd == "rescale":
        out = rescale(omms, args.radius)
        path = args.output or f"{stem}-avgRadius-{args.radius}.eye"
    elif args.cmd == "split":
        out = split(omms, args.distance, args.overlap)
        path = args.output or f"{stem}-{args.distance}-{args.overlap}.eye"
    else:
        out = adjust_acceptance(omms)
        path = args.output or f"{stem}-adjusted.eye"
    write_eye_file(path, out)
    print(f"Wrote {len(out)} ommatidia to {path}")


if __name__ == "__main__":
    main()
