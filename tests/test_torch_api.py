"""EyeRenderer's defaults and bookkeeping in the port against the JAX
package's (compound_ray_tpu/api/renderer.py)."""

import inspect

import pytest

pytest.importorskip("jax")

from compound_ray_tpu.api.renderer import EyeRenderer as JaxEyeRenderer  # noqa: E402
from compound_ray_tpu_torch.api.renderer import EyeRenderer  # noqa: E402


def test_verbose_default_equals_the_jax_package():
    want = inspect.signature(JaxEyeRenderer.__init__).parameters["verbose"]
    got = inspect.signature(EyeRenderer.__init__).parameters["verbose"]
    assert got.default is want.default is True
    assert got.kind == want.kind == inspect.Parameter.POSITIONAL_OR_KEYWORD
    assert list(inspect.signature(EyeRenderer.__init__).parameters)[1] == (
        "verbose")
    assert EyeRenderer(device="cpu").verbose
    assert not EyeRenderer(False, device="cpu").verbose


def test_frame_times_are_trimmed_as_in_the_jax_package(capsys):
    """Past 10,000 entries the oldest 5000 go
    (compound_ray_tpu/api/renderer.py:327-329), filled through the
    renderer's own bookkeeping without rendering."""
    r = EyeRenderer(verbose=False, device="cpu")
    for i in range(10000):
        r._note_frame_time(float(i))
    assert len(r.frame_times_ms) == 10000 and r.frame_times_ms[0] == 0.0
    r._note_frame_time(10000.0)
    assert len(r.frame_times_ms) == 5001
    assert r.frame_times_ms[0] == 5000.0 and r.frame_times_ms[-1] == 10000.0
    for i in range(4999):
        r._note_frame_time(0.5)
    assert len(r.frame_times_ms) == 10000
    r._note_frame_time(0.5)
    assert len(r.frame_times_ms) == 5001
    assert capsys.readouterr().out == ""


def test_render_frame_goes_through_the_trimmed_bookkeeping(monkeypatch):
    import numpy as np

    from compound_ray_tpu_torch import testing as ttesting
    from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera

    r = EyeRenderer(verbose=False, device="cpu")
    r.scene = ttesting.make_box_scene()
    r.scene.cameras.append(CompoundEyeCamera(
        "eye", "single_dimension_fast", ttesting.make_sphere_eye(8, 5.0)))
    r.goto_camera(len(r.scene.cameras) - 1)
    r.set_current_eye_samples_per_ommatidium(16)
    r.frame_times_ms.extend([1.0] * 10000)
    ms = r.render_frame()
    assert len(r.frame_times_ms) == 5001 and r.frame_times_ms[-1] == ms
    assert np.isfinite(r.get_camera_data()).all()
