"""ctypes-shim conformance of the port (compound_ray_tpu_torch.api.shim):
the cases of tests/test_shim.py, the primary-example and
minimumSampleRateFinder call patterns verbatim, on device="cpu"."""

import inspect
from ctypes import c_char_p, c_float, c_int

import numpy as np
import pytest

from compound_ray_tpu_torch import eye_tools as eyeTools
from compound_ray_tpu_torch import load_eye_renderer
from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera
from compound_ray_tpu_torch.testing import make_box_scene, make_sphere_eye


@pytest.fixture()
def shim():
    s = load_eye_renderer(verbose=False, device="cpu")
    s.renderer.scene = make_box_scene(background="simple_sky")
    s.renderer.scene.cameras.append(
        CompoundEyeCamera("eye", "single_dimension_fast", make_sphere_eye(32)))
    return s


def test_configure_and_calls(shim):
    eyeTools.configureFunctions(shim)
    assert shim.getCameraCount() == 1
    assert shim.getCurrentCameraName() == b"eye"  # c_char_p restype -> bytes
    assert shim.isCompoundEyeActive() is True
    assert shim.gotoCameraByName(c_char_p(b"eye")) is True
    assert shim.gotoCameraByName(b"missing") is False


def test_render_and_frame_pointer(shim):
    eyeTools.configureFunctions(shim)
    eyeTools.setRenderSize(shim, 32, 4)
    ms = shim.renderFrame()
    assert isinstance(ms, float) and ms > 0
    frame = shim.getFramePointer()
    assert isinstance(frame, np.ndarray)
    assert frame.shape == (4, 32, 4)
    assert frame.dtype == np.uint8
    assert frame[0].any() and not frame[1:].any()  # single_dimension_fast


def test_samples_and_ommatidium_controls(shim):
    shim.setCurrentEyeSamplesPerOmmatidium(c_int(4))
    assert shim.getCurrentEyeSamplesPerOmmatidium() == 4
    shim.changeCurrentEyeSamplesPerOmmatidiumBy(-3)
    assert shim.getCurrentEyeSamplesPerOmmatidium() == 1
    omms = eyeTools.getIcoOmmatidia()
    eyeTools.setOmmatidiaFromOmmatidiumList(shim, omms)
    assert shim.getCurrentEyeOmmatidialCount() == 12
    shim.renderFrame()
    data = shim.getCameraData()
    assert data.shape == (12, 3)


def test_pose_functions(shim):
    shim.setCameraPosition(c_float(1.0), c_float(2.0), c_float(3.0))
    pos = shim.getCameraPosition()
    np.testing.assert_allclose(pos.reshape(3), [1, 2, 3])
    shim.setCameraPose(0.0, 0.0, 0.0, 0.0, 0.5, 0.0)
    shim.rotateCameraAround(0.25, 0.0, 1.0, 0.0)
    shim.translateCameraLocally(0.0, 0.0, 1.0)
    shim.resetCameraPose()
    np.testing.assert_allclose(shim.getCameraPosition().reshape(3), 0.0)


def test_geometry_bounds_cfloat3(shim):
    v = shim.getGeometryMaxBounds(b"box-scene")
    assert hasattr(v, "x") and hasattr(v, "toNumpy")
    assert v.toNumpy().shape == (3,)
    assert (v.toNumpy() > shim.getGeometryMinBounds(b"box-scene")
            .toNumpy()).all()


def test_save_frame(shim, tmp_path):
    eyeTools.setRenderSize(shim, 8, 2)
    shim.renderFrame()
    p = str(tmp_path / "x.ppm")
    shim.saveFrameAs(c_char_p(p.encode()))
    assert (tmp_path / "x.ppm").read_bytes().startswith(b"P6\n8 2\n255\n")
    shim.displayFrame()  # no-op hook must exist
    shim.stop()
    assert shim.renderer.scene is None


def test_eye_tools_roundtrip(tmp_path):
    omms = eyeTools.getIcoOmmatidia()
    assert np.isclose(omms[0].getSolidAngle(), 1.0, rtol=1e-6)
    p = str(tmp_path / "a.eye")
    eyeTools.saveEyeFile(p, omms)
    back = eyeTools.readEyeFile(p)
    assert len(back) == 12
    assert np.isclose(back[3].acceptanceAngle, omms[3].acceptanceAngle)


def test_id_decode():
    assert eyeTools.decodeProjectionMapID([0, 0, 1, 4]) == 260
    assert eyeTools.decodeProjectionMapID([1, 0, 0, 0]) == 1 << 24


def test_load_eye_renderer_defaults_to_the_card():
    """verbose first as in the JAX shim, the device keyword-only and the
    card by default."""
    params = inspect.signature(load_eye_renderer).parameters
    assert list(params)[:2] == ["_path", "verbose"]
    assert params["device"].kind == inspect.Parameter.KEYWORD_ONLY
    assert params["device"].default == "cuda"


def test_eye_tools_match_jax(tmp_path):
    """The port's eye_tools against the JAX package's: the icosphere, the
    .eye text and the projection-map re-projection."""
    pytest.importorskip("jax")
    from compound_ray_tpu import eye_tools as jaxTools

    got, want = eyeTools.getIcoOmmatidia(), jaxTools.getIcoOmmatidia()
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.direction, b.direction)
        assert a.acceptanceAngle == b.acceptanceAngle
    eyeTools.saveEyeFile(str(tmp_path / "t.eye"), got)
    jaxTools.saveEyeFile(str(tmp_path / "j.eye"), want)
    assert ((tmp_path / "t.eye").read_text()
            == (tmp_path / "j.eye").read_text())
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 300, size=(6, 6))
    id_map = np.stack([(ids >> s) & 0xFF for s in (24, 16, 8, 0)],
                      axis=-1).astype(np.uint8)
    vec = rng.integers(0, 255, size=300)
    np.testing.assert_array_equal(
        eyeTools.getProjectionImageUsingMap(vec, id_map, 6, 6),
        jaxTools.getProjectionImageUsingMap(vec, id_map, 6, 6))
