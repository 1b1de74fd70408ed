"""Port: the viewer (compound_ray_tpu_torch/gui/viewer.py), the headless
viewer tests of tests/test_batched_and_gui.py on the port, on the CPU.
The web viewer's end-to-end test there (a WebAgg server in a subprocess on
the reference test scene) has no counterpart here."""

import numpy as np
import pytest

from compound_ray_tpu_torch.api.renderer import EyeRenderer
from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera
from compound_ray_tpu_torch.gui.viewer import FlyController, Viewer
from compound_ray_tpu_torch.testing import make_box_scene, make_sphere_eye
from compound_ray_tpu_torch.trace.lighting import default_lights


@pytest.fixture()
def renderer():
    r = EyeRenderer(verbose=False, device="cpu")
    r.scene = make_box_scene(background="white")
    r.scene.cameras.append(
        CompoundEyeCamera("eye", "single_dimension_fast",
                          make_sphere_eye(24, acceptance_deg=1e-5))
    )
    r._lights = default_lights(r.scene.aabb_min, r.scene.aabb_max)
    return r


def test_fly_controller_movement(renderer):
    v = Viewer(renderer, width=8, height=4)
    p0 = np.array(renderer.current_camera().position)
    v.controller.press("w")
    v.tick()
    p1 = np.array(renderer.current_camera().position)
    assert not np.allclose(p0, p1)
    # forward = local z
    np.testing.assert_allclose(
        p1 - p0, renderer.current_camera().local_space[2] * FlyController.MOVE_SPEED,
        atol=1e-12,
    )
    v.controller.release("w")
    v.controller.press("q")
    v.tick()
    assert v.dirty


def test_viewer_keys(renderer, tmp_path, monkeypatch):
    v = Viewer(renderer, width=8, height=4)
    assert renderer.get_current_eye_samples_per_ommatidium() == 1
    v.handle_key("pageup")
    assert renderer.get_current_eye_samples_per_ommatidium() == 2
    v.handle_key("pagedown")
    assert renderer.get_current_eye_samples_per_ommatidium() == 1
    v.handle_key("n")
    v.handle_key("b")
    assert renderer.get_current_camera_name() == "eye"
    monkeypatch.chdir(tmp_path)
    v.frame()
    path = v.handle_key("c")
    assert path and (tmp_path / path).exists()
    assert v.handle_key("escape") == "quit"


def test_viewer_frame_orientation(renderer):
    v = Viewer(renderer, width=8, height=4)
    img = v.frame()
    assert img.shape == (4, 8, 3)


def test_viewer_run_loop_headless(renderer, tmp_path, monkeypatch):
    """Drive the REAL Viewer.run() loop under the Agg backend: open, render,
    fly forward (held key -> release), save a PPM, quit via Esc — the
    newGuiEyeRenderer validation loop (gui.cpp:191-275) without a
    display."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    from matplotlib.backend_bases import KeyEvent

    monkeypatch.chdir(tmp_path)
    v = Viewer(renderer, width=8, height=4)
    p0 = np.array(renderer.current_camera().position)
    script = {
        0: ("key_press_event", "w"),
        2: ("key_release_event", "w"),
        3: ("key_press_event", "c"),
        4: ("key_press_event", "escape"),
    }

    def on_frame(i, canvas):
        if i in script:
            name, key = script[i]
            KeyEvent(name, canvas, key)._process()

    v.run(max_frames=20, on_frame=on_frame)
    p1 = np.array(renderer.current_camera().position)
    assert not np.allclose(p0, p1), "held W must move the camera"
    ppm = tmp_path / "gui-capture-0.ppm"
    assert ppm.exists(), "C must save the frame as PPM"
    with open(ppm, "rb") as f:
        assert f.read(2) == b"P6"


# -- parity with the JAX package's viewer on the same scene and keys ----------

KEYS = ("w", "a", "left", "up", "q", "r")


@pytest.fixture()
def jax_unlit(monkeypatch):
    pytest.importorskip("jax")
    import dataclasses

    from compound_ray_tpu import config as jcfg
    from compound_ray_tpu_torch import config as tcfg

    old = jcfg.get_config()
    jcfg.set_config(dataclasses.replace(
        old, farfield="off", sky_split=False, affine_rays=False,
        backend="pallas"))
    monkeypatch.setattr(tcfg, "_global_config",
                        tcfg.RenderConfig(farfield="off"))
    yield
    jcfg.set_config(old)


def _viewer_pair(projection):
    """The port's and the JAX package's viewers at 16 x 8 on the same
    60-box scene and 24-ommatidium 1e-5 degree eye (one ray per sample, so
    the packages' RNGs do not matter)."""
    from compound_ray_tpu import testing as jtesting
    from compound_ray_tpu.api.renderer import EyeRenderer as JaxRenderer
    from compound_ray_tpu.cameras.types import CompoundEyeCamera as JaxEye
    from compound_ray_tpu.gui.viewer import Viewer as JaxViewer
    from compound_ray_tpu_torch import testing as ttesting

    out = []
    for testing, eye_cls, viewer_cls, renderer in (
            (ttesting, CompoundEyeCamera, Viewer,
             EyeRenderer(verbose=False, device="cpu")),
            (jtesting, JaxEye, JaxViewer, JaxRenderer(verbose=False))):
        renderer.scene = testing.make_big_scene(n_boxes=60, seed=5)
        cam = eye_cls("eye", projection, testing.make_sphere_eye(
            24, acceptance_deg=1e-5))
        renderer.scene.cameras.append(cam)
        c = renderer.scene.aabb_center()
        cam.set_position((float(c[0]), float(c[1]) + 1.0, float(c[2])))
        renderer.goto_camera(len(renderer.scene.cameras) - 1)
        out.append(viewer_cls(renderer, width=16, height=8))
    return out


def test_fly_controller_matches_jax(jax_unlit):
    """The same keys held over the same ticks leave both cameras at the
    same position and local space."""
    ours, theirs = _viewer_pair("single_dimension_fast")
    for v in (ours, theirs):
        for key in KEYS:
            v.handle_key(key)
        for _ in range(3):
            v.tick()
        v.controller.release("left")
        v.tick()
    a, b = ours.renderer.current_camera(), theirs.renderer.current_camera()
    assert not np.allclose(a.position, (0.0, 0.0, 0.0))
    np.testing.assert_allclose(a.position, b.position, rtol=0, atol=1e-12)
    np.testing.assert_allclose(a.local_space, b.local_space, rtol=0,
                               atol=1e-12)


def test_viewer_frame_matches_jax(jax_unlit):
    """Viewer.frame() against the JAX viewer's after the same keys: the
    means within 2e-4 (tests/test_torch_frame.py's tolerance) and every
    pixel within 1 of 255, on an image that is not its own vertical or
    horizontal mirror, so a flip or a transpose would show."""
    ours, theirs = _viewer_pair("spherical_orientationwise")
    imgs = []
    for v in (ours, theirs):
        v.handle_key("left")
        v.tick()
        imgs.append(np.asarray(v.frame()).astype(int))
    got, want = imgs
    assert got.shape == want.shape == (8, 16, 3)
    np.testing.assert_allclose(ours.renderer.get_camera_data(),
                               theirs.renderer.get_camera_data(), atol=2e-4)
    assert np.abs(got - want).max() <= 1
    assert np.abs(got - got[::-1]).max() > 1
    assert np.abs(got - got[:, ::-1]).max() > 1
