"""Render an .eye file to SVG for manual inspection (data/tools/eyeVisualiser.py).

Orthographic projection after yaw/pitch rotation; each ommatidium drawn as a
facet normal line plus a dot at the lens position.  No external SVG
dependency — the file is written directly.

A copy of compound_ray_tpu/tools/eye_visualiser.py on the port's
scene/eye_io.py.
"""

from __future__ import annotations

import argparse
import math
from typing import List

import numpy as np

from compound_ray_tpu_torch.scene.eye_io import Ommatidium, read_eye_file


def _rotation(yaw_deg: float, pitch_deg: float) -> np.ndarray:
    y = math.radians(yaw_deg)
    p = math.radians(pitch_deg)
    ry = np.array([
        [math.cos(y), 0, math.sin(y)],
        [0, 1, 0],
        [-math.sin(y), 0, math.cos(y)],
    ])
    rp = np.array([
        [1, 0, 0],
        [0, math.cos(p), -math.sin(p)],
        [0, math.sin(p), math.cos(p)],
    ])
    return rp @ ry


def eye_to_svg(
    omms: List[Ommatidium],
    yaw: float = 0.0,
    pitch: float = 0.0,
    normal_length: float = 0.02,
    scale: float = 1000.0,
    show_back_facing: bool = False,
) -> str:
    rot = _rotation(yaw, pitch)
    pos = np.stack([o.position for o in omms]) @ rot.T
    dirs = np.stack([o.direction / np.linalg.norm(o.direction) for o in omms]) @ rot.T

    visible = dirs[:, 2] <= 0 if not show_back_facing else np.ones(len(omms), bool)
    pts = pos[visible]
    nrm = dirs[visible]

    if len(pts):
        lo = (pts - normal_length).min(axis=0)[:2]
        hi = (pts + normal_length).max(axis=0)[:2]
    else:
        lo, hi = np.zeros(2), np.ones(2)
    pad = 0.05 * max(hi[0] - lo[0], hi[1] - lo[1], 1e-6)
    lo -= pad
    hi += pad
    w = (hi[0] - lo[0]) * scale
    h = (hi[1] - lo[1]) * scale

    def sx(x):
        return (x - lo[0]) * scale

    def sy(y):
        return h - (y - lo[1]) * scale  # flip y for SVG

    lines = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w:.1f}" '
        f'height="{h:.1f}" viewBox="0 0 {w:.1f} {h:.1f}">'
    ]
    for p, n in zip(pts, nrm):
        e = p + n * normal_length
        lines.append(
            f'<line x1="{sx(p[0]):.2f}" y1="{sy(p[1]):.2f}" '
            f'x2="{sx(e[0]):.2f}" y2="{sy(e[1]):.2f}" '
            'stroke="#1a1a29" stroke-width="0.5"/>'
        )
        lines.append(
            f'<circle cx="{sx(p[0]):.2f}" cy="{sy(p[1]):.2f}" r="1.0" '
            'fill="#c0392b"/>'
        )
    lines.append("</svg>")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Visualise an .eye file as SVG")
    ap.add_argument("-f", "--file", required=True)
    ap.add_argument("-y", "--yaw", type=float, default=0.0)
    ap.add_argument("-p", "--pitch", type=float, default=0.0)
    ap.add_argument("-o", "--output", default="visualisedEye.svg")
    ap.add_argument("-n", "--normal-length", type=float, default=0.02)
    ap.add_argument("-s", "--scale", type=float, default=1000.0)
    ap.add_argument("-b", "--back-facing", action="store_true")
    args = ap.parse_args(argv)
    omms = read_eye_file(args.file)
    svg = eye_to_svg(omms, args.yaw, args.pitch, args.normal_length,
                     args.scale, args.back_facing)
    with open(args.output, "w") as f:
        f.write(svg)
    print(f"Wrote {args.output} ({len(omms)} ommatidia)")


if __name__ == "__main__":
    main()
