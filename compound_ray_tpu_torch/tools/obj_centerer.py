"""Centre an OBJ mesh on the origin (data/tools/objCenterer.py): shifts every
vertex by the negated AABB centre, leaving all other OBJ lines intact.

A copy of compound_ray_tpu/tools/obj_centerer.py.
"""

from __future__ import annotations

import argparse


def center_obj(in_path: str, out_path: str) -> None:
    with open(in_path) as f:
        lines = f.readlines()
    verts = []
    for line in lines:
        if line.startswith("v "):
            parts = line.split()
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    if not verts:
        raise ValueError("no vertices found")
    import numpy as np

    v = np.asarray(verts)
    center = (v.min(axis=0) + v.max(axis=0)) / 2.0
    out = []
    for line in lines:
        if line.startswith("v "):
            parts = line.split()
            xyz = [float(parts[1]) - center[0],
                   float(parts[2]) - center[1],
                   float(parts[3]) - center[2]]
            rest = " ".join(parts[4:])
            out.append("v " + " ".join(f"{c:.6f}" for c in xyz)
                       + ((" " + rest) if rest else "") + "\n")
        else:
            out.append(line)
    with open(out_path, "w") as f:
        f.writelines(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("-o", "--output")
    args = ap.parse_args(argv)
    out = args.output or args.input.replace(".obj", "-centered.obj")
    center_obj(args.input, out)
    print(f"Wrote {out}")


if __name__ == "__main__":
    main()
