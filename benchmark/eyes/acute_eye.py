"""n ommatidia on a Fibonacci sphere, looking outward, whose acceptance
angle grows from the horizon to the poles: acceptance_deg x (1 + (factor
- 1) |d_y|), with d the unit axis.  The stand-in the heterogeneous
demonstration takes where 1000-horizontallyAcute-variableDegree.eye is
absent.  A frozen copy of compound_ray_tpu_torch.examples.
heterogeneous_demonstration's variable_acceptance_eye over make_sphere_eye
(sphere_eye.py)."""

import math

import numpy as np


def build(n: int, acceptance_deg: float, factor: float, radius: float = 0.1,
          focal_offset: float = 0.0) -> np.ndarray:
    golden = (1.0 + math.sqrt(5.0)) / 2.0
    out = np.zeros((n, 8), np.float32)
    for i in range(n):
        theta = 2.0 * math.pi * i / golden
        z = 1.0 - (2.0 * i + 1.0) / n
        r = math.sqrt(max(0.0, 1.0 - z * z))
        d = np.array([r * math.cos(theta), z, r * math.sin(theta)])
        out[i, 0:3] = d * radius
        out[i, 3:6] = d
        out[i, 6] = (math.radians(acceptance_deg)
                     * (1.0 + (factor - 1.0) * abs(float(d[1]))))
        out[i, 7] = focal_offset
    return out
