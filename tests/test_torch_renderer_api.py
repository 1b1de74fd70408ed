"""The port's EyeRenderer API surface against the JAX package's, on the CPU.

The cases of tests/test_renderer_api.py on EyeRenderer(device="cpu"), with
the port's frame_seed in place of the JAX frame keys; then the two
packages' renderers side by side: the pose family on the same calls, a
display projection and raw samples end to end at an acceptance angle of
1e-6 rad (every sample of an ommatidium is the same ray, so the two RNGs
need not agree; means and samples within 2e-4, as
tests/test_torch_frame.py), and the API's own bookkeeping (unsynced and
pipelined frames, stop, the profile, the frame buffer).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from compound_ray_tpu import config as jcfg  # noqa: E402
from compound_ray_tpu import testing as jtesting  # noqa: E402
from compound_ray_tpu.api.renderer import EyeRenderer as JaxRenderer  # noqa: E402
from compound_ray_tpu.cameras.types import CompoundEyeCamera as JaxEye  # noqa: E402
from compound_ray_tpu.cameras.types import PerspectiveCamera as JaxPerspective  # noqa: E402
from compound_ray_tpu.scene.flat import HitboxMesh as JaxHitbox  # noqa: E402
from compound_ray_tpu_torch import config as tcfg  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.api.renderer import EyeRenderer, frame_seed  # noqa: E402
from compound_ray_tpu_torch.cameras.types import (  # noqa: E402
    CompoundEyeCamera,
    PerspectiveCamera,
)
from compound_ray_tpu_torch.eye.pipeline import render_means  # noqa: E402
from compound_ray_tpu_torch.projection import project_frame  # noqa: E402
from compound_ray_tpu_torch.scene.eye_io import icosphere_eye  # noqa: E402
from compound_ray_tpu_torch.scene.flat import HitboxMesh, MeshRecord  # noqa: E402
from compound_ray_tpu_torch.trace.shade import miss_id  # noqa: E402

ATOL = 2e-4


def _renderer_with_box_scene(projection="single_dimension_fast",
                             background="white"):
    r = EyeRenderer(verbose=False, device="cpu")
    r.scene = ttesting.make_box_scene(background=background)
    r.scene.cameras.append(CompoundEyeCamera(
        "eye", projection, ttesting.make_sphere_eye(64)))
    return r


def test_white_background_means_exact():
    # eye far above the scene: the upper hemisphere's ommatidia see only
    # the miss shader, so their means are exactly 1.0
    r = _renderer_with_box_scene(background="white")
    r.current_camera().set_position((0.0, 100.0, 0.0))
    assert r.render_frame() > 0.0
    data = r.get_camera_data()
    assert data.shape == (64, 3)
    up = r.current_camera().ommatidia[:, 4] > 0.3
    np.testing.assert_allclose(data[up], 1.0, atol=1e-6)


def test_render_frame_buffer_and_projection():
    r = _renderer_with_box_scene(projection="spherical_orientationwise")
    r.set_render_size(32, 16)
    r.render_frame()
    frame = r.get_frame_pointer()
    assert frame.shape == (16, 32, 4) and frame.dtype == np.uint8
    assert frame[..., 3].min() == 255


def test_samples_controls():
    r = _renderer_with_box_scene()
    assert r.is_compound_eye_active()
    assert r.get_current_eye_samples_per_ommatidium() == 1
    r.set_current_eye_samples_per_ommatidium(8)
    assert r.get_current_eye_samples_per_ommatidium() == 8
    r.change_current_eye_samples_per_ommatidium_by(-4)
    assert r.get_current_eye_samples_per_ommatidium() == 4
    assert r.get_current_eye_ommatidial_count() == 64
    r.render_frame()
    assert r.get_camera_data().shape == (64, 3)


def test_set_ommatidia():
    r = _renderer_with_box_scene()
    r.set_ommatidia(icosphere_eye())
    assert r.get_current_eye_ommatidial_count() == 12
    r.render_frame()
    assert r.get_camera_data().shape == (12, 3)


def test_camera_cycling_and_names():
    r = _renderer_with_box_scene()
    assert r.get_camera_count() == 1
    assert r.goto_camera_by_name("eye")
    assert not r.goto_camera_by_name("nonexistent")
    assert r.get_current_camera_name() == "eye"


def test_geometry_bounds():
    r = _renderer_with_box_scene()
    mx = r.get_geometry_max_bounds("box-scene")
    mn = r.get_geometry_min_bounds("box-scene")
    assert (mx > mn).all()
    assert (r.get_geometry_max_bounds("missing") == 0).all()


def test_config_env_parsing(monkeypatch):
    # empty value = unset (the `CR_TPU_X= cmd` shell idiom must not crash)
    monkeypatch.setenv("CR_TPU_SEED", "")
    assert (tcfg.RenderConfig.from_env().base_seed
            == tcfg.RenderConfig().base_seed)
    monkeypatch.setenv("CR_TPU_SEED", "7")
    assert tcfg.RenderConfig.from_env().base_seed == 7
    monkeypatch.setenv("CR_TPU_SEED", "banana")
    with pytest.raises(ValueError, match="CR_TPU_SEED"):
        tcfg.RenderConfig.from_env()


def test_base_seed_comes_from_config(monkeypatch):
    # CR_TPU_SEED -> config.base_seed reaches the frame's generator (the
    # analogue of the reference's curand_init seed)
    monkeypatch.setattr(tcfg, "_global_config",
                        tcfg.RenderConfig(base_seed=7))
    r = _renderer_with_box_scene(background="default_background")
    cam = r.current_camera()
    cam.set_position((0.0, 1.5, 3.0))
    r.set_current_eye_samples_per_ommatidium(8)
    cam.rng_frame = 3
    r.render_frame()
    gen = torch.Generator().manual_seed(frame_seed(7, 3))
    want = render_means(
        r.scene, r.scene.device_triangles("cpu"), cam.ommatidia,
        np.asarray(cam.position, np.float32),
        np.asarray(cam.local_space, np.float32), gen, 8,
        miss_id(r.scene.background_shader)).numpy()
    np.testing.assert_array_equal(r.get_camera_data(), want)
    assert frame_seed(7, 3) != frame_seed(42, 3) != frame_seed(7, 4)


def test_rng_stability_and_frames():
    r = _renderer_with_box_scene(background="default_background")
    r.set_current_eye_samples_per_ommatidium(4)
    r.render_frame()
    d1 = r.get_camera_data().copy()
    # re-setting the sample count rewinds the stream (the reference re-inits
    # its curand states on every setSamplesPerOmmatidium call)
    r.set_current_eye_samples_per_ommatidium(4)
    r.render_frame()
    np.testing.assert_array_equal(d1, r.get_camera_data())
    r.render_frame()  # frame 1: other jitter
    assert not np.array_equal(d1, r.get_camera_data())


def test_full_reference_scene(test_scene_path):
    r = EyeRenderer(verbose=False, device="cpu")
    r.load_gltf_scene(test_scene_path)
    assert r.get_camera_count() == 6
    r.set_render_size(24, 18)
    while r.is_compound_eye_active():
        r.next_camera()
    r.render_frame()  # a real camera's image
    frame = r.get_frame_pointer()
    assert frame.shape == (18, 24, 4) and frame[..., :3].any()
    assert r.goto_camera_by_name("insect-cam-2")
    assert r.is_compound_eye_active()
    r.set_current_eye_samples_per_ommatidium(2)
    r.render_frame()
    data = r.get_camera_data()
    assert data.shape == (100, 3)
    assert np.isfinite(data).all() and data.max() > 0.0
    assert r.get_frame_pointer().shape == (18, 24, 4)


def test_save_ppm(tmp_path):
    r = _renderer_with_box_scene(projection="spherical_orientationwise")
    r.set_render_size(8, 4)
    r.render_frame()
    p = tmp_path / "out.ppm"
    r.save_frame_as(str(p))
    blob = p.read_bytes()
    header = b"P6\n8 4\n255\n"
    assert blob.startswith(header) and len(blob) == len(header) + 8 * 4 * 3
    # rows flipped (buffer row 0 is the bottom scanline), alpha dropped
    rgb = np.frombuffer(blob[len(header):], np.uint8).reshape(4, 8, 3)
    np.testing.assert_array_equal(rgb, r.get_frame_pointer()[::-1, :, :3])


def test_set_get_lights_roundtrip_and_validation():
    r = _renderer_with_box_scene()
    full = r.get_lights()
    assert full.shape == (4, 7) and full.dtype == np.float32
    full[0, 3] = 99.0  # the getter returns a copy, not the live array
    assert r.get_lights()[0, 3] != 99.0
    r.set_lights(r.get_lights()[:2])
    assert r.get_lights().shape == (2, 7)
    with pytest.raises(ValueError):
        r.set_lights(np.zeros((3, 6), np.float32))
    with pytest.raises(ValueError):
        r.set_lights(np.zeros((0, 7), np.float32))
    # a lit frame renders under the reduced light set
    r.set_lights(np.asarray([[1.0, 1.0, 1.0, 5.0, 0.0, 50.0, 0.0]],
                            np.float32))
    r.set_lighting(True)
    r.current_camera().set_position((0.0, 100.0, 0.0))
    r.render_frame()
    assert r.get_camera_data().shape == (64, 3)


def test_geometry_bounds_multi_primitive_mesh():
    # a multi-primitive glTF mesh stores one MeshRecord per primitive, all
    # sharing the mesh name; the bounds cover all of them
    r = _renderer_with_box_scene()
    r.scene.mesh_records = [
        MeshRecord("tree", np.array([0.0, 0.0, 0.0]),
                   np.array([1.0, 2.0, 1.0])),
        MeshRecord("tree", np.array([-1.0, 1.0, 0.0]),
                   np.array([0.5, 5.0, 1.0])),
    ]
    np.testing.assert_allclose(r.get_geometry_min_bounds("tree"),
                               [-1.0, 0.0, 0.0])
    np.testing.assert_allclose(r.get_geometry_max_bounds("tree"),
                               [1.0, 5.0, 1.0])
    np.testing.assert_allclose(r.get_geometry_min_bounds("absent"), 0.0)


def test_camera_cycling_empty_scene_is_noop():
    r = EyeRenderer(verbose=False, device="cpu")
    r.scene = ttesting.make_box_scene()
    r.scene.cameras = []
    r.next_camera()  # must not raise ZeroDivisionError
    r.previous_camera()
    assert r.get_current_camera_index() == 0


# ------------------------------------------------- against the JAX renderer
def _pair_with_cameras():
    """The JAX and the port's renderer on the box scene with the same three
    cameras (two eyes, one of them with a data path, and a pinhole)."""
    out = []
    for r, pkg, eye, pinhole in (
            (JaxRenderer(verbose=False), jtesting, JaxEye, JaxPerspective),
            (EyeRenderer(verbose=False, device="cpu"), ttesting,
             CompoundEyeCamera, PerspectiveCamera)):
        r.scene = pkg.make_box_scene()
        r.scene.eye_data_path = "eyes/scene.eye"
        r.scene.cameras += [
            eye("a", "single_dimension", pkg.make_sphere_eye(8)),
            eye("b", "spherical_orientationwise", pkg.make_sphere_eye(12),
                eye_data_path="eyes/b.eye"),
            pinhole("pin")]
        out.append(r)
    return out


def _state(r):
    cams = r.scene.cameras
    return (r.get_current_camera_index(), r.get_current_camera_name(),
            r.is_compound_eye_active(), r.get_eye_data_path(),
            r.get_current_eye_data_path(),
            r.get_current_eye_samples_per_ommatidium(),
            r.get_current_eye_ommatidial_count(),
            [getattr(c, "projection", None) for c in cams],
            np.concatenate([np.r_[c.position, c.local_space.ravel()]
                            for c in cams]))


def test_camera_and_eye_controls_match_jax():
    """The pose family (plural forms included), camera navigation and the
    eye controls, the same calls on both renderers."""
    jr, tr = _pair_with_cameras()
    calls = [
        ("next_camera",), ("set_camera_position", 1.0, 2.0, 3.0),
        ("rotate_camera_around", 0.3, 0.0, 1.0, 0.0),
        ("rotate_camera_locally_around", -0.2, 1.0, 0.0, 0.0),
        ("translate_camera", 0.5, 0.0, -1.0),
        ("translate_camera_locally", 0.0, 0.25, 1.0),
        ("translate_cameras_locally", 1.0, 0.0, 0.0),
        ("rotate_cameras_around", 0.7, 1.0, 1.0, 0.0),
        ("rotate_cameras_locally_around", 0.1, 0.0, 0.0, 1.0),
        ("previous_camera",), ("set_camera_pose", 1, 2, 3, 0.1, 0.2, 0.3),
        ("set_camera_local_space", 0, 1, 0, -1, 0, 0, 0, 0, 1),
        ("set_current_eye_samples_per_ommatidium", 9),
        ("change_current_eye_samples_per_ommatidium_by", -4),
        ("set_current_eye_shader_name",
         "__raygen__compound_projection_spherical_positionwise_ids"),
        ("goto_camera", 1), ("reset_camera_pose",),
        ("set_current_eye_shader_name", "raw_ommatidial_samples"),
        ("set_camera_pose_matrix", np.arange(16.0).reshape(4, 4)),
        ("goto_camera_by_name", "pin"),
        ("set_current_eye_samples_per_ommatidium", 5),
        ("set_camera_pose", 0, 0, 1, 0, 0.5, 0),
        ("goto_camera_by_name", "b"), ("set_ommatidia", icosphere_eye()),
        ("goto_camera", 5),
    ]
    for name, *args in calls:
        got, want = getattr(tr, name)(*args), getattr(jr, name)(*args)
        assert got == want, name
        gs, ws = _state(tr), _state(jr)
        assert gs[:-1] == ws[:-1], name
        np.testing.assert_allclose(gs[-1], ws[-1], atol=1e-12,
                                   err_msg=name)
    assert tr.get_camera_position() == jr.get_camera_position()


def test_scene_queries_match_jax():
    verts, faces = ttesting.box_mesh((0.0, 0.0, 0.0), (2.0, 1.0, 1.0))
    tri = verts[faces]
    xf = np.eye(4)
    xf[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    xf[:3, 3] = (5.0, 0.0, 0.0)
    jr, tr = _pair_with_cameras()
    lo, hi = tri.reshape(-1, 3).min(0), tri.reshape(-1, 3).max(0)
    jr.scene.hitboxes = [JaxHitbox("hb", xf, tri, lo, hi)]
    tr.scene.hitboxes = [HitboxMesh("hb", xf, tri, lo, hi)]
    for p in [(5.0, 0.0, 0.0), (5.0, 0.9, 0.0), (5.9, 0.0, 0.0),
              (0.0, 0.0, 0.0), (5.2, -0.8, 0.4)]:
        assert (tr.is_inside_hit_geometry(*p, "hb")
                == jr.is_inside_hit_geometry(*p, "hb")), p
    assert not tr.is_inside_hit_geometry(0.0, 0.0, 0.0, "absent")
    for name in ("hb", "box-scene", "absent"):
        np.testing.assert_allclose(tr.get_geometry_min_bounds(name),
                                   jr.get_geometry_min_bounds(name))
        np.testing.assert_allclose(tr.get_geometry_max_bounds(name),
                                   jr.get_geometry_max_bounds(name))


@pytest.fixture
def jax_unlit(monkeypatch):
    old = jcfg.get_config()
    jcfg.set_config(dataclasses.replace(
        old, farfield="off", sky_split=False, affine_rays=False,
        backend="pallas"))
    monkeypatch.setattr(tcfg, "_global_config",
                        tcfg.RenderConfig(farfield="off"))
    yield
    jcfg.set_config(old)


def _bench_like(pkg_testing, eye_cls, projection, renderer):
    """tests/test_torch_frame.py's bench-like pose on a 60-box scene, 32
    ommatidia at 1e-6 rad, 16 samples, a 48 x 24 display."""
    renderer.scene = pkg_testing.make_big_scene(n_boxes=60, seed=5)
    cam = eye_cls("eye", projection, pkg_testing.make_sphere_eye(
        32, np.degrees(1e-6)))
    renderer.scene.cameras.append(cam)
    c = renderer.scene.aabb_center()
    cam.set_position((float(c[0]), float(c[1]) + 1.0, float(c[2])))
    renderer.goto_camera(len(renderer.scene.cameras) - 1)
    renderer.set_current_eye_samples_per_ommatidium(16)
    renderer.set_render_size(48, 24)
    return renderer


@pytest.mark.parametrize("projection", ["spherical_orientationwise",
                                        "raw_ommatidial_samples"])
def test_display_and_raw_samples_match_jax_end_to_end(jax_unlit, projection):
    jr = _bench_like(jtesting, JaxEye, projection, JaxRenderer(verbose=False))
    jr.render_frame()
    tr = _bench_like(ttesting, CompoundEyeCamera, projection,
                     EyeRenderer(verbose=False, device="cpu"))
    tr.render_frame()
    np.testing.assert_allclose(tr.get_camera_data(), jr.get_camera_data(),
                               atol=ATOL)
    got, want = tr.get_frame_pointer(), jr.get_frame_pointer()
    assert got.shape == want.shape == (24, 48, 4)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    if projection == "raw_ommatidial_samples":
        raw = tr._raw_samples.numpy()
        assert raw.shape == (16, 32, 3)
        np.testing.assert_allclose(raw, np.asarray(jr._raw_samples),
                                   atol=ATOL)
        np.testing.assert_allclose(raw.mean(axis=0), tr.get_camera_data(),
                                   atol=1e-6)


def test_raw_samples_mean_equals_the_means_frame(jax_unlit):
    """One seed, the far field off: the raw samples' mean is the means
    path's frame (the same pack and angles)."""
    r = _renderer_with_box_scene("raw_ommatidial_samples",
                                 "default_background")
    cam = r.current_camera()
    cam.set_position((0.0, 1.5, 3.0))
    r.set_current_eye_samples_per_ommatidium(24)
    r.render_frame()
    raw = r._raw_samples
    assert raw.shape == (24, 64, 3)
    r.set_current_eye_shader_name("single_dimension")
    r.set_current_eye_samples_per_ommatidium(24)
    r.render_frame()
    np.testing.assert_allclose(raw.mean(dim=0).numpy(), r.get_camera_data(),
                               atol=1e-6)
    assert raw.std(dim=0).max() > 0  # the samples are not one value


def test_unsynced_and_pipelined_frames_equal_synced_ones():
    r = _renderer_with_box_scene("spherical_orientationwise",
                                 "default_background")
    r.current_camera().set_position((0.0, 1.5, 3.0))
    r.set_render_size(16, 8)
    r.set_current_eye_samples_per_ommatidium(8)
    for _ in range(3):
        r.render_frame()
    want, want_frame = r.get_camera_data().copy(), r.get_frame_pointer()
    r.set_current_eye_samples_per_ommatidium(8)
    ms = r.render_frames_pipelined(3)
    assert ms > 0 and r.current_camera().rng_frame == 3
    np.testing.assert_array_equal(r.get_camera_data(), want)
    np.testing.assert_array_equal(r.get_frame_pointer(), want_frame)
    # the 3 synced frames; the burst records no per-frame time, as in the
    # JAX package
    stats = r.frame_time_stats()
    assert stats["count"] == 3 and stats["min_ms"] <= stats["median_ms"]
    assert EyeRenderer(verbose=False, device="cpu").frame_time_stats() == {
        "count": 0}


def test_unsynced_lit_frame_audits_at_sync():
    r = _renderer_with_box_scene(background="black")
    r.current_camera().set_position((0.0, 1.5, 3.0))
    r.set_lighting(True)
    r.render_frame(sync=False)
    assert r._pending_shadow_audit is not None
    assert r.last_shadow_audit is None
    r.sync()
    assert r._pending_shadow_audit is None
    assert r.last_shadow_audit.shape[0] >= 2
    assert r.last_shadow_audit[1] > 0  # lit hits were audited


def test_frame_buffer_stop_and_verbosity(capsys):
    r = _renderer_with_box_scene("spherical_positionwise_ids")
    r.set_render_size(12, 6)
    assert not r.get_frame_pointer().any()  # before any frame: zeros
    r.render_frame()
    frame = r.get_frame_pointer()
    assert frame is r.get_frame_pointer()  # copied once
    means = r._device_means
    np.testing.assert_array_equal(frame, project_frame(
        "spherical_positionwise_ids", means, None,
        *r.current_camera().device_ommatidia("cpu")[1:], 12, 6).numpy())
    r.set_verbosity(True)
    r.stop()
    assert "Cleaning" in capsys.readouterr().out
    assert r.scene is None and r._device_frame is None
    assert r._device_means is None and r._raw_samples is None
    r.set_verbosity(False)
    with pytest.raises(RuntimeError):
        r.render_frame()


def test_profile_writes_a_chrome_trace(tmp_path):
    r = _renderer_with_box_scene()
    r.start_profile(str(tmp_path / "prof"))
    r.render_frame()
    path = r.stop_profile()
    assert os.path.dirname(path) == str(tmp_path / "prof")
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    with pytest.raises(RuntimeError):
        r.stop_profile()
