"""The horizontally acute eye's configuration: its frozen generator
against the program's example, the configuration and traffic files as the
harness loads them, their entries in BENCHMARK.json, and the far-field
span's reader on a hand-built trace."""

import json

import numpy as np
import pytest

from benchmark import harness
from benchmark import scene as S
from benchmark.scene import load_plugin
from test_bench_spans import EAGER, events, launch, sliced_of, span

CELLS = ("natural-1000.steady-s3200", "natural-acute-10k.steady-s320")


def test_acute_eye_matches_the_example_rule():
    from compound_ray_tpu_torch.examples.heterogeneous_demonstration import (
        variable_acceptance_eye,
    )
    from compound_ray_tpu_torch.scene.eye_io import ommatidia_to_array

    got = load_plugin("eyes", "acute_eye").build(8, 2.6, 4.0)
    want = ommatidia_to_array(variable_acceptance_eye(8, 2.6, 4.0))
    np.testing.assert_array_equal(got, want)
    # 2.6 degrees where the axis is level, 4 x that at |d_y| = 1
    np.testing.assert_allclose(
        got[:, 6], np.radians(2.6) * (1 + 3 * np.abs(got[:, 4])), rtol=1e-6)


def test_configuration_and_traffic_load():
    cfg = harness.load_json(harness.HERE, "configs", "natural-acute-10k")
    base = harness.load_json(harness.HERE, "configs", "natural-1000")
    for key in ("scene", "projection", "render_config", "reduced"):
        assert cfg[key] == base[key]
    assert cfg["pose"]["position"] == base["pose"]["position"]
    assert cfg["pose"]["rotation"] == base["pose"]["rotation"]
    omms = S.build_eye(cfg)
    assert omms.shape == (10000, 8) and omms.dtype == np.float32
    deg = np.degrees(omms[:, 6])
    assert 2.6 <= deg.min() < 2.601 and 10.399 < deg.max() <= 10.4
    traffic = harness.load_json(harness.HERE, "traffic", "steady-s320")
    assert traffic == {"samples": 320, "lighting": False, "display": True,
                       "warmup_frames": 4, "check_frames": 6}
    with open(harness.BENCHMARK_JSON) as f:
        bench = json.load(f)
    conf = {c["name"]: c for c in bench["configs"]}["natural-acute-10k"]
    assert conf["file"] == "benchmark/configs/natural-acute-10k.json"
    assert conf["source"] == cfg["source"]
    cells = {w["name"]: w for w in bench["workloads"]}
    for name in CELLS:
        assert cells[name]["chips"] == 1
        assert harness.load_json(harness.HERE, "limits", name)
        per_layer = [m["name"] for m in
                     harness.metrics_of(bench, name, "per_layer")]
        assert "farfield_ms_per_frame" in per_layer


def read(t):
    return load_plugin("metrics", "farfield_ms_per_frame").read(t)


def test_farfield_reader(tmp_path):
    """Frame 2's shading holds a cr.core.farfield span around one eager
    kernel of 30 us: 0.015 ms a frame.  The parent's trace has no such
    span: no reading."""
    evs = events()
    evs += [span("cr.core.farfield", 1405, 60), launch(1410),
            {"ph": "X", "name": EAGER, "cat": "kernel", "ts": 1420,
             "dur": 30}]
    # the span lies inside cr.core.shade, as in the frame core
    next(e for e in evs if e["name"] == "cr.core.shade"
         and e["ts"] == 1260)["dur"] = 240
    assert read(sliced_of(tmp_path, evs)) == pytest.approx(0.015)
    assert read(sliced_of(tmp_path, events())) is None
