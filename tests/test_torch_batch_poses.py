"""Port: EyeRenderer.render_batch_poses (tests/test_batched_and_gui.py:30-55
on the port), and the port against the JAX package's render_batch_poses.

The eye is near-deterministic (acceptance 1e-5 degrees), so every sample of
an ommatidium is one ray and the packages' RNGs do not matter; the JAX side
renders on its Pallas path.  Means agree within 2e-4 (the tolerance of
tests/test_torch_frame.py).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from compound_ray_tpu import config as jcfg  # noqa: E402
from compound_ray_tpu import testing as jtesting  # noqa: E402
from compound_ray_tpu.api.renderer import EyeRenderer as JaxRenderer  # noqa: E402
from compound_ray_tpu.cameras.types import CompoundEyeCamera as JaxEye  # noqa: E402
from compound_ray_tpu.trace import lighting as jlighting  # noqa: E402
from compound_ray_tpu_torch import EyeRenderer  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.cameras.types import (  # noqa: E402
    CompoundEyeCamera,
    PerspectiveCamera,
)
from compound_ray_tpu_torch.trace.lighting import default_lights  # noqa: E402

ATOL = 2e-4
POSES = [
    ((0.0, 100.0, 0.0), (0.0, 0.0, 0.0)),
    ((5.0, 100.0, 5.0), (0.0, 1.0, 0.0)),
    ((0.0, 0.9, 0.0), (0.2, 0.0, 0.0)),
]


@pytest.fixture()
def renderer():
    r = EyeRenderer(verbose=False, device="cpu")
    r.scene = ttesting.make_box_scene(background="white")
    r.scene.cameras.append(CompoundEyeCamera(
        "eye", "single_dimension_fast",
        ttesting.make_sphere_eye(24, acceptance_deg=1e-5)))
    r._lights = default_lights(r.scene.aabb_min, r.scene.aabb_max)
    return r


def test_batched_poses_match_sequential(renderer):
    batched = renderer.render_batch_poses(POSES)
    assert batched.shape == (3, 24, 3) and batched.dtype == np.float32
    assert renderer.current_camera().rng_frame == 1
    seq = []
    for pos, rot in POSES:
        renderer.set_camera_pose(*pos, *rot)
        renderer.render_frame()
        seq.append(renderer.get_camera_data().copy())
    np.testing.assert_allclose(batched, np.stack(seq), atol=ATOL)


def test_batched_poses_with_matrix(renderer):
    batched = renderer.render_batch_poses([((0.0, 100.0, 0.0), np.eye(3))])
    assert batched.shape == (1, 24, 3)
    up = renderer.current_camera().ommatidia[:, 4] > 0.3
    np.testing.assert_allclose(batched[0][up], 1.0, atol=1e-6)


def test_batched_poses_need_a_compound_eye(renderer):
    renderer.scene.cameras.insert(0, PerspectiveCamera("pinhole"))
    renderer.goto_camera(0)
    with pytest.raises(RuntimeError, match="compound eye"):
        renderer.render_batch_poses(POSES)


def test_batched_poses_match_jax(renderer):
    old = jcfg.get_config()
    jcfg.set_config(dataclasses.replace(old, farfield="off", sky_split=False,
                                        affine_rays=False))
    try:
        jr = JaxRenderer(verbose=False)
        jr.scene = jtesting.make_box_scene(background="white")
        jr.scene.cameras.append(JaxEye(
            "eye", "single_dimension_fast",
            jtesting.make_sphere_eye(24, acceptance_deg=1e-5)))
        jr._lights = jlighting.default_lights(jr.scene.aabb_min,
                                              jr.scene.aabb_max)
        jr._backend = "pallas"
        want = jr.render_batch_poses(POSES)
    finally:
        jcfg.set_config(old)
    got = renderer.render_batch_poses(POSES)
    assert got.shape == want.shape == (3, 24, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)
