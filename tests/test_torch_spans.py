"""The port's spans (compound_ray_tpu_torch/spans.py) in a profiler's trace,
on the CPU: their category, their nesting, the plan-build spans that only
a memo miss records, and that spans leave a frame's means as they are."""

import json

import numpy as np
import torch

from compound_ray_tpu_torch import spans
from compound_ray_tpu_torch import testing as ttesting
from compound_ray_tpu_torch.api.renderer import EyeRenderer
from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera

BUILDS = "cr.plan.build."


def _renderer(lit: bool = False) -> EyeRenderer:
    r = EyeRenderer(verbose=False, device="cpu")
    r.scene = ttesting.make_box_scene()
    r.scene.cameras.append(CompoundEyeCamera(
        "eye", "single_dimension_fast", ttesting.make_sphere_eye(32)))
    r.set_current_eye_samples_per_ommatidium(8)
    r.set_render_size(32, 1)
    r.set_lighting(lit)
    r.current_camera().set_position((0.5, 1.5, 2.5))
    return r


def _traced(fn, tmp_path):
    """fn() under torch.profiler (CPU activity); the program's spans of
    the exported Chrome trace as (name, cat, start, end), by start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["cat"], float(e["ts"]),
                    float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("ph") == "X" and e["name"].startswith("cr.")),
                  key=lambda s: s[2])


def _frame(r):
    r.render_frame()
    return r.get_camera_data()


def _inside(inner, outer):
    return outer[2] <= inner[2] and inner[3] <= outer[3]


def test_spans_are_cpu_ops_and_nest_in_the_frame(tmp_path):
    got = _traced(lambda: _frame(_renderer()), tmp_path)
    assert got and {cat for _, cat, _, _ in got} == {"cpu_op"}
    names = [s[0] for s in got]
    assert names.count("cr.frame") == 1
    frame = next(s for s in got if s[0] == "cr.frame")
    for name in ("cr.plan", "cr.plan.farfield", "cr.plan.angles", "cr.core",
                 "cr.core.rays", "cr.core.shade", "cr.project"):
        assert names.count(name) == 1, name
        assert _inside(next(s for s in got if s[0] == name), frame), name
    plan = next(s for s in got if s[0] == "cr.plan")
    core = next(s for s in got if s[0] == "cr.core")
    assert plan[3] <= core[2]  # the plan, then the frame core
    for name in ("cr.plan.farfield", "cr.plan.angles"):
        assert _inside(next(s for s in got if s[0] == name), plan), name
    for name in ("cr.core.rays", "cr.core.shade"):
        assert _inside(next(s for s in got if s[0] == name), core), name
    readback = next(s for s in got if s[0] == "cr.readback")
    assert readback[2] >= frame[3]  # get_camera_data after render_frame
    # the CPU renders through the kernels' twins: no kernel span
    assert not any(n.startswith("cr.k") for n in names)


def test_builds_only_where_a_memo_misses(tmp_path):
    r = _renderer()
    first = [s[0] for s in _traced(lambda: _frame(r), tmp_path)]
    # one pass measures the widths and packs: one pack build, no other
    assert first.count("cr.plan.build.pack") == 1
    assert "cr.plan.build.widths" not in first
    again = [s[0] for s in _traced(lambda: _frame(r), tmp_path)]
    assert "cr.plan" in again
    assert not [n for n in again if n.startswith(BUILDS)]
    r.current_camera().set_position((0.5, 1.5, 3.0))  # a new pose
    moved = [s[0] for s in _traced(lambda: _frame(r), tmp_path)]
    assert moved.count("cr.plan.build.pack") == 1
    assert "cr.plan.build.widths" not in moved


def test_lit_frame_records_lit_epilogue_and_shadow_build(tmp_path):
    r = _renderer(lit=True)
    got = _traced(lambda: _frame(r), tmp_path)
    names = [s[0] for s in got]
    assert names.count("cr.core.lit") == 1
    shade = next(s for s in got if s[0] == "cr.core.shade")
    assert _inside(next(s for s in got if s[0] == "cr.core.lit"), shade)
    build = next(s for s in got if s[0] == "cr.plan.build.shadow")
    assert _inside(build, next(s for s in got if s[0] == "cr.plan"))
    again = [s[0] for s in _traced(lambda: _frame(r), tmp_path)]
    assert "cr.core.lit" in again and "cr.plan.build.shadow" not in again


def test_burst_plans_once(tmp_path):
    r = _renderer()
    got = [s[0] for s in _traced(lambda: r.render_frames_pipelined(4),
                                 tmp_path)]
    assert got.count("cr.plan") == 1 and got.count("cr.plan.angles") == 1
    assert got.count("cr.core") == 1  # 4 x 8 samples stack into one core
    assert "cr.frame" not in got


def test_spans_off_without_a_profiler_and_frames_unchanged(tmp_path):
    assert spans.span("cr.anything") is spans.span("cr.other")
    assert not torch.autograd.profiler._is_profiler_enabled
    r = _renderer(lit=True)
    plain = _frame(r).copy()
    r.current_camera().rng_frame -= 1  # the same frame once more
    traced = []
    got = _traced(lambda: traced.append(_frame(r).copy()), tmp_path)
    assert "cr.core" in [s[0] for s in got]
    np.testing.assert_array_equal(traced[0], plain)
