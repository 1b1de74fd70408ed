"""`.eye` file IO and the Ommatidium record.

File format (reference data/eyes/eye-specification.txt:1-9): one line per
ommatidium, space separated:
    posX posY posZ dirX dirY dirZ acceptanceAngle(rad) focalPointOffset
all in millimetres, parsed in MulticamScene.cpp:352-361.

A numpy copy of compound_ray_tpu/scene/eye_io.py.
"""

from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

# a C strtof-acceptable float prefix (decimal forms; the .eye format never
# carries inf/nan/hex floats) — see read_eye_file's fallback tokenizer
_FLOAT_PREFIX = re.compile(r"^[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")


@dataclass
class Ommatidium:
    """One ommatidium (cameras/CompoundEyeDataTypes.h:24-30)."""

    position: np.ndarray  # (3,) relative position (mm)
    direction: np.ndarray  # (3,) relative axis direction
    acceptance_angle: float  # radians
    focal_point_offset: float

    def solid_angle(self) -> float:
        """Steradians of the acceptance cone (eyeRendererHelperFunctions.py:20-22)."""
        return 2.0 * math.pi * (1.0 - math.cos(self.acceptance_angle / 2.0))

    def copy(self) -> "Ommatidium":
        return Ommatidium(
            np.array(self.position, dtype=np.float64),
            np.array(self.direction, dtype=np.float64),
            float(self.acceptance_angle),
            float(self.focal_point_offset),
        )


def ommatidia_to_array(omms: Sequence[Ommatidium]) -> np.ndarray:
    """Pack to an (N, 8) float32 array [pos(3), dir(3), angle, focal_offset]."""
    out = np.zeros((len(omms), 8), dtype=np.float32)
    for i, o in enumerate(omms):
        out[i, 0:3] = o.position
        out[i, 3:6] = o.direction
        out[i, 6] = o.acceptance_angle
        out[i, 7] = o.focal_point_offset
    return out


def array_to_ommatidia(arr: np.ndarray) -> List[Ommatidium]:
    """Unpack an (N, 8) array into Ommatidium records (float64)."""
    return [
        Ommatidium(np.array(r[0:3]), np.array(r[3:6]), float(r[6]), float(r[7]))
        for r in np.asarray(arr, dtype=np.float64)
    ]


def read_eye_file(path: str) -> List[Ommatidium]:
    """Parse a .eye CSV file into Ommatidium records.

    Accepts the 8-field format (eye-specification.txt) and the legacy 7-field
    format the reference's eyeGenerator still writes (eyeGenerator/main.cpp:78,
    data/eyes/old-eye-specification/) — a missing focal-point offset reads 0.
    Raises ValueError with the offending line for anything else.

    Pure Python: the parse of compound_ray_tpu/scene/eye_io.py:64 without
    its native fast path (the native parser gives identical rows)."""
    out: List[Ommatidium] = []
    with open(path) as f:
        for line_no, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            vals = []
            for tok in line.split():
                try:
                    vals.append(float(tok))
                    continue
                except ValueError:
                    pass
                # strtof semantics (the native parser): a numeric PREFIX
                # parses ("0.5x" -> 0.5) and consumption stops there — the
                # leftover suffix makes the NEXT strtof fail, ending the
                # row.  A token with no numeric prefix ends the row with
                # no value.  Without this, the same .eye file parsed
                # differently depending on whether native/ was built.
                m = _FLOAT_PREFIX.match(tok)
                if m:
                    vals.append(float(m.group(0)))
                break
            if len(vals) < 7:
                raise ValueError(
                    f"{path}: line {line_no} is not a valid .eye row "
                    "(expected 7 or 8 space-separated numbers: pos dir angle "
                    "[focal_offset])"
                )
            focal = vals[7] if len(vals) >= 8 else 0.0
            out.append(
                Ommatidium(
                    np.array(vals[0:3]), np.array(vals[3:6]), vals[6], focal
                )
            )
    if not out:
        raise ValueError(f"{path}: no ommatidia found (empty .eye file)")
    return out


def write_eye_file(path: str, omms: Sequence[Ommatidium]) -> None:
    """Write .eye format (same 10-dp formatting as eyeRendererHelperFunctions.py:139-151)."""
    with open(path, "w") as f:
        for o in omms:
            f.write(
                "{:0.10f} {:0.10f} {:0.10f} {:0.10f} {:0.10f} {:0.10f} {:0.10f} {:0.10f}\n".format(
                    o.position[0], o.position[1], o.position[2],
                    o.direction[0], o.direction[1], o.direction[2],
                    o.acceptance_angle, o.focal_point_offset,
                )
            )


def resolve_eye_path(eye_path: str, gltf_dir: str) -> Optional[str]:
    """Path resolution order from MulticamScene.cpp:320-351: absolute/cwd-relative
    first, then relative to the glTF file's directory."""
    if os.path.isfile(eye_path):
        return eye_path
    rel = os.path.join(gltf_dir, eye_path)
    if os.path.isfile(rel):
        return rel
    return None


def icosphere_eye(acceptance_angle: Optional[float] = None) -> List[Ommatidium]:
    """12-ommatidium icosahedral eye: the same point set the reference helper
    produces (eyeRendererHelperFunctions.py:171-194) — poles plus two
    5-point rings at latitude ±atan(1/2), the lower ring offset by 36°.

    Default acceptance angle covers 1 steradian per ommatidium
    (cos(a/2) = 1 - 1/(2π)).
    """
    if acceptance_angle is None:
        acceptance_angle = 2.0 * math.acos(1.0 - 1.0 / (2.0 * math.pi))
    ring_lat = math.atan(0.5)
    lon = np.arange(5) * (2.0 * math.pi / 5.0)
    lat = np.concatenate(
        [[math.pi / 2.0], np.full(5, ring_lat), np.full(5, -ring_lat),
         [-math.pi / 2.0]]
    )
    lons = np.concatenate([[0.0], lon, lon + math.pi / 5.0, [0.0]])
    dirs = np.stack(
        [np.cos(lons) * np.cos(lat), np.sin(lat), np.sin(lons) * np.cos(lat)],
        axis=1,
    )
    # poles exactly axial (cos(±π/2) is not exactly 0 in floating point)
    dirs[0] = (0.0, 1.0, 0.0)
    dirs[-1] = (0.0, -1.0, 0.0)
    return [Ommatidium(np.zeros(3), d, acceptance_angle, 0.0) for d in dirs]
