"""Port vs JAX: the cameras (cameras/types.py) and the real cameras' ray
generation and brute-force image (cameras/raygen.py).

The cases of tests/test_cameras.py on the port's camera types, each
raygen against the JAX package's on one pose (rays within f32 rounding),
and render_camera_image against the JAX package's at 40 x 24 on the
scene of tests/test_fast_image.py: uint8 channels within 1.
"""

import math

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from compound_ray_tpu import testing as jtesting  # noqa: E402
from compound_ray_tpu.cameras import raygen as JR  # noqa: E402
from compound_ray_tpu.trace.lighting import default_lights  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.cameras import raygen as TR  # noqa: E402
from compound_ray_tpu_torch.cameras.types import (  # noqa: E402
    CompoundEyeCamera,
    PerspectiveCamera,
    rotate_point,
)
from compound_ray_tpu_torch.scene.eye_io import icosphere_eye  # noqa: E402
from compound_ray_tpu_torch.trace.shade import miss_id  # noqa: E402

# the pose and parameters of tests/test_fast_image.py
POS = np.asarray([0.0, 3.0, 40.0], np.float32)
LS = np.diag([1.0, 1.0, -1.0]).astype(np.float32)  # looks along -z
PARAMS = {"pinhole": [0.6, 0.6, 1.0], "panoramic": [0.0],
          "orthographic": [30.0, 20.0]}


def test_rotate_point_quarter_turn():
    out = rotate_point(np.array([1.0, 0.0, 0.0]), math.pi / 2,
                       np.array([0.0, 1.0, 0.0]))
    np.testing.assert_allclose(out, [0.0, 0.0, -1.0], atol=1e-12)


def test_rotate_point_unnormalised_axis():
    p = np.array([1.0, 0.0, 0.0])
    np.testing.assert_allclose(rotate_point(p, 0.3, np.array([0.0, 5.0, 0.0])),
                               rotate_point(p, 0.3, np.array([0.0, 1.0, 0.0])),
                               atol=1e-12)


def test_rotate_point_zero_axis_is_identity():
    p = np.array([1.0, 2.0, 3.0])
    out = rotate_point(p, 0.7, np.zeros(3))
    np.testing.assert_allclose(out, p, atol=0)
    assert np.all(np.isfinite(out))


def test_camera_rotate_preserves_orthonormal():
    cam = PerspectiveCamera("c")
    cam.rotate_around(0.7, (1.0, 2.0, 0.5))
    cam.rotate_locally_around(-1.2, (0.0, 1.0, 0.0))
    ls = cam.local_space
    np.testing.assert_allclose(ls @ ls.T, np.eye(3), atol=1e-12)


def test_set_pose_order():
    cam = PerspectiveCamera("c")
    cam.set_pose(1.0, 2.0, 3.0, 0.1, 0.2, 0.3)
    # reset, Rx, Ry, Rz (world axes), translate
    expect = PerspectiveCamera("m")
    expect.reset_pose()
    expect.rotate_around(0.1, (1, 0, 0))
    expect.rotate_around(0.2, (0, 1, 0))
    expect.rotate_around(0.3, (0, 0, 1))
    expect.move((1.0, 2.0, 3.0))
    np.testing.assert_allclose(cam.local_space, expect.local_space,
                               atol=1e-14)
    np.testing.assert_allclose(cam.position, [1, 2, 3])


def test_move_locally():
    cam = PerspectiveCamera("c")
    cam.rotate_around(math.pi / 2, (0, 1, 0))  # x -> -z
    cam.move_locally((1.0, 0.0, 0.0))
    np.testing.assert_allclose(cam.position, [0.0, 0.0, -1.0], atol=1e-12)


def test_fov_math():
    cam = PerspectiveCamera("c")
    cam.set_y_fov(90.0)
    assert np.isclose(cam.scale[1], 1.0) and np.isclose(cam.scale[0], 1.0)
    cam.set_aspect_ratio(2.0)
    assert np.isclose(cam.scale[0], 2.0) and np.isclose(cam.scale[1], 1.0)


def test_set_x_fov_mirrors_set_y_fov():
    cam = PerspectiveCamera("c")
    cam.set_aspect_ratio(2.0)
    cam.set_x_fov(90.0)
    assert np.isclose(cam.scale[0], 1.0) and np.isclose(cam.scale[1], 0.5)
    cam.set_x_fov(90.0)  # idempotent
    assert np.isclose(cam.scale[1], 0.5)
    other = PerspectiveCamera("o")
    other.set_aspect_ratio(2.0)
    other.set_y_fov(math.degrees(2.0 * math.atan(0.5)))
    np.testing.assert_allclose(cam.scale, other.scale, atol=1e-12)


def test_compound_sample_reset():
    cam = CompoundEyeCamera("e", "single_dimension_fast", icosphere_eye())
    cam.rng_frame = 5
    cam.set_samples_per_ommatidium(32)
    assert cam.samples_per_ommatidium == 32 and cam.rng_frame == 0
    # the reference re-inits curand on every setSamplesPerOmmatidium call
    cam.rng_frame = 7
    cam.set_samples_per_ommatidium(32)
    assert cam.rng_frame == 0
    cam.change_samples_per_ommatidium_by(-31)
    assert cam.samples_per_ommatidium == 1
    cam.change_samples_per_ommatidium_by(-10)  # floor at 1
    assert cam.samples_per_ommatidium == 1


def test_set_ommatidia_resets_rng_only_on_count_change():
    cam = CompoundEyeCamera("e", "single_dimension_fast", icosphere_eye())
    same = cam.ommatidia.copy()
    cam.rng_frame = 3
    cam.set_ommatidia(same)
    assert cam.rng_frame == 3
    cam.set_ommatidia(same[: len(same) // 2])
    assert cam.rng_frame == 0


def test_set_pose_matrix_columns():
    cam = PerspectiveCamera("c")
    m = np.eye(4)
    m[:3, 0] = [0, 0, 1]
    m[:3, 1] = [0, 1, 0]
    m[:3, 2] = [-1, 0, 0]
    m[:3, 3] = [5, 6, 7]
    cam.set_pose_matrix(m)
    np.testing.assert_allclose(cam.local_space[0], [0, 0, 1])
    np.testing.assert_allclose(cam.local_space[2], [-1, 0, 0])
    np.testing.assert_allclose(cam.position, [5, 6, 7])


@pytest.mark.parametrize("kind", list(PARAMS))
def test_raygen_matches_jax(kind):
    """A turned pose, so that every local-space row is used; 13 x 7 pixels
    (the convention's row 0 at d.y = -1)."""
    cam = PerspectiveCamera("c")
    cam.rotate_around(0.4, (0.3, 1.0, 0.2))
    ls = np.asarray(cam.local_space, np.float32)
    param = np.asarray(PARAMS[kind] if kind != "panoramic" else [2.5],
                       np.float32)
    fn = {"pinhole": "pinhole_rays", "panoramic": "panoramic_rays",
          "orthographic": "orthographic_rays"}[kind]
    p = param if kind != "panoramic" else param[0]
    want = getattr(JR, fn)(jnp.asarray(POS), jnp.asarray(ls), jnp.asarray(p),
                           13, 7)
    got = getattr(TR, fn)(torch.tensor(POS), torch.tensor(ls),
                          torch.tensor(p), 13, 7)
    assert got[2] == want[2] == 0.01
    for g, w in zip(got[:2], want[:2]):
        w = np.broadcast_to(np.asarray(w), (13 * 7, 3))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
    dx, dy = TR._pixel_grid(13, 7, "cpu")
    assert float(dx[0]) == -1.0 and float(dy[0]) == -1.0
    np.testing.assert_allclose([float(dx[1]), float(dy[13])],
                               [2.0 / 13 - 1.0, 2.0 / 7 - 1.0], rtol=1e-6)


CAMERA_CASES = [(k, False) for k in PARAMS] + [("pinhole", True)]


@pytest.mark.parametrize("kind,lit", CAMERA_CASES,
                         ids=[k + ("-lit" if lit else "")
                              for k, lit in CAMERA_CASES])
def test_render_camera_image_matches_jax(kind, lit):
    js = jtesting.make_big_scene(n_boxes=80, seed=9)
    ts = ttesting.make_big_scene(n_boxes=80, seed=9)
    bg = miss_id(ts.background_shader)
    param = np.asarray(PARAMS[kind], np.float32)
    lights = default_lights(js.aabb_min, js.aabb_max)
    want = np.asarray(JR.render_camera_image(
        js.device_triangles(), kind, jnp.asarray(POS), jnp.asarray(LS),
        jnp.asarray(param), 40, 24, bg, lit,
        jnp.asarray(lights) if lit else None))
    got = TR.render_camera_image(ts.device_triangles("cpu"), kind, POS, LS,
                                 param, 40, 24, bg, lit,
                                 lights if lit else None)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (24, 40, 4)
    got = got.numpy().astype(int)
    assert (got[..., 3] == 255).all()
    assert np.abs(got - want.astype(int)).max() <= 1
    assert (got[..., :3] != got[0, 0, :3]).any()  # the image is not flat


def test_render_camera_image_refuses_unknown_kind():
    ts = ttesting.make_box_scene()
    with pytest.raises(ValueError, match="kind"):
        TR.render_camera_image(ts.device_triangles("cpu"), "fisheye", POS,
                               LS, [1.0, 1.0, 1.0], 4, 4, 0)
