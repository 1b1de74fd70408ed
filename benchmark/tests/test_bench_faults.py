"""The output check on small copies of the cells, run on the CPU: sound
runs pass, and a run with its timed path broken underneath comes out not
correct, once for each fault a cell can have."""

import numpy as np
import pytest

from bench_util import run_small

CELLS = ("small.ofstad", "small.sweep", "small.lit")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    res = run_small(root, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert list(res)[-1] == "checks"


def _stale(monkeypatch):
    """Every frame returns the frame before it: a step that leaves its
    state unchanged."""
    from compound_ray_tpu_torch.api.renderer import EyeRenderer

    real = EyeRenderer.get_camera_data
    last = {}

    def stale(self):
        now = np.array(real(self))
        out = last.get("data", now)
        last["data"] = now
        return out

    monkeypatch.setattr(EyeRenderer, "get_camera_data", stale)


def _half_samples(monkeypatch):
    """The second half of each ommatidium's samples repeats the first: the
    mean is taken over half of them."""
    from compound_ray_tpu_torch.eye import pipeline

    real = pipeline.sample_angles_ns

    def half(generator, sd, samples):
        splay, spin = real(generator, sd, samples)
        h = samples // 2
        splay[:, h:2 * h] = splay[:, :h]
        spin[:, h:2 * h] = spin[:, :h]
        return splay, spin

    monkeypatch.setattr(pipeline, "sample_angles_ns", half)


def _altered(monkeypatch):
    """One ommatidium's mean is altered where it is produced."""
    from compound_ray_tpu_torch.api.renderer import EyeRenderer

    real = EyeRenderer.get_camera_data

    def altered(self):
        out = np.array(real(self))
        out[7] = np.clip(out[7] + 0.2, 0.0, None)
        return out

    monkeypatch.setattr(EyeRenderer, "get_camera_data", altered)


@pytest.mark.parametrize("fault", [_stale, _half_samples, _altered],
                         ids=["stale", "half_samples", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run_small(root, cell)
    assert not res["correct"], res["checks"]
