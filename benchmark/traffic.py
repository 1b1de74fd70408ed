"""The one general traffic generator: a traffic mix (traffic/<name>.json)
is data that this module reads.

Keys of a mix:
  samples        samples per ommatidium of every frame
  lighting       render lit (set_lighting) or not
  display        project each frame into the speed test's ommatidia x 1
                 display buffer, or keep the means alone
  warmup_frames  frames rendered before the window
  check_frames   window frames the output check compares, drawn from the
                 seed
  poses          absent: every frame at the configuration's pose (the
                 speed test's steady loop); else a new pose before every
                 frame: {"region": [[x0, x1], [y0, y1], [z0, z1]],
                 "yaw": [a, b], "count": n}, positions uniform in the
                 region and a yaw (rotation about +y) uniform in [a, b),
                 redrawn where the eye's sphere would meet a solid of the
                 scene; n poses, taken in turn (position_estimation's
                 view loop).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from benchmark.scene import eye_radius, sphere_meets_solids

Pose = Tuple[float, float, float, float, float, float]
SEED_MASK = 0xFFFFFFFFFFFFFFFF


def draw_poses(rng, spec: dict, count: int, radius: float,
               solids) -> List[Pose]:
    """`count` poses drawn in turn, each position redrawn until the eye's
    sphere clears every solid."""
    lo = np.array([r[0] for r in spec["region"]], np.float64)
    hi = np.array([r[1] for r in spec["region"]], np.float64)
    y0, y1 = spec["yaw"]
    out: List[Pose] = []
    while len(out) < count:
        pos = rng.uniform(lo, hi, size=(count, 3))
        yaw = rng.uniform(y0, y1, size=count)
        clear = ~sphere_meets_solids(pos, radius, solids)
        out += [(float(p[0]), float(p[1]), float(p[2]), 0.0, float(a), 0.0)
                for p, a in zip(pos[clear], yaw[clear])]
    return out[:count]


def pose_streams(cfg: dict, traffic: dict, scene, omms: np.ndarray,
                 seed: int) -> Tuple[List[Optional[Pose]],
                                     List[Optional[Pose]]]:
    """(warm-up poses, window poses), one per frame, taken in turn; a pose
    is set before its frame, None keeps the eye where it is.  The warm-up
    starts at the configuration's pose, which has to clear every solid."""
    radius = eye_radius(omms)
    fixed = tuple(float(v) for v in cfg["pose"]["position"]
                  + cfg["pose"]["rotation"])
    if sphere_meets_solids(np.array([fixed[:3]]), radius, scene.solids)[0]:
        raise ValueError(f"the pose {fixed} puts the eye in a solid")
    warm_n = max(1, int(traffic.get("warmup_frames", 3)))
    spec = traffic.get("poses")
    if spec is None:
        return [fixed] + [None] * (warm_n - 1), [None]
    rng = np.random.default_rng([seed & SEED_MASK, 0])
    window = draw_poses(rng, spec, int(spec["count"]), radius, scene.solids)
    rng = np.random.default_rng([seed & SEED_MASK, 1])
    warm = draw_poses(rng, spec, warm_n - 1, radius, scene.solids)
    return [fixed] + warm, window
