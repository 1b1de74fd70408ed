"""The general traffic generator: the pose sweep rejects eye spheres that
meet a solid, and one seed gives one stream."""

import numpy as np

from benchmark.scene import SceneArrays, sphere_meets_solids
from benchmark.traffic import draw_poses, pose_streams


def test_sweep_rejects_spheres_meeting_a_box():
    solids = np.array([[[-1.0, -5.0, -5.0], [1.0, 5.0, 5.0]]])
    spec = {"region": [[-2, 2], [-1, 1], [-1, 1]], "yaw": [0, 1]}
    poses = draw_poses(np.random.default_rng(0), spec, 500, 0.25, solids)
    pos = np.array([p[:3] for p in poses])
    assert len(poses) == 500
    assert (np.abs(pos[:, 0]) > 1.25).all()  # clear of the box by 0.25
    assert not sphere_meets_solids(pos, 0.25, solids).any()
    assert sphere_meets_solids(np.array([[1.2, 0, 0]]), 0.25, solids)[0]


def test_streams_follow_the_seed():
    scene = SceneArrays(vertices=np.zeros((3, 3)), faces=np.zeros((1, 3)),
                        solids=np.array([[[-1.0, -1, -1], [1, 1, 1]]]))
    omms = np.zeros((4, 8), np.float32)
    omms[:, 0] = 0.1
    cfg = {"pose": {"position": [5.0, 0, 0], "rotation": [0, 0, 0]}}
    traffic = {"samples": 4, "warmup_frames": 3,
               "poses": {"region": [[-3, 3], [-3, 3], [-3, 3]],
                         "yaw": [0, 6], "count": 50}}
    a = pose_streams(cfg, traffic, scene, omms, 2**31 + 7)
    b = pose_streams(cfg, traffic, scene, omms, 2**31 + 7)
    c = pose_streams(cfg, traffic, scene, omms, 2**31 + 8)
    assert a == b and a[1] != c[1]
    assert a[0][0] == (5.0, 0.0, 0.0, 0.0, 0.0, 0.0) and len(a[0]) == 3
    steady = pose_streams(cfg, {"samples": 4}, scene, omms, 1)
    assert steady == ([(5.0, 0.0, 0.0, 0.0, 0.0, 0.0), None, None], [None])
