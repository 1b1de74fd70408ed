"""The meadow's configuration: its frozen scene generator, the
configuration and traffic files as the harness loads them, the pose
stream at grass height, the entries in BENCHMARK.json, and the readers of
the far-field cache build's two spans on a hand-built trace."""

import json

import numpy as np
import pytest

from benchmark import harness
from benchmark import scene as S
from benchmark import traffic as T
from benchmark.scene import load_plugin
from test_bench_spans import EAGER, events, launch, sliced_of, span

MEADOW = "meadow-1000.posesweep-s1000"
READERS = ("cache_cull_ms_per_frame", "cache_trace_ms_per_frame")
K2 = "(anonymous namespace)::cluster_tracer_kernel(int const*)"


def test_generator_is_frozen_and_full_size():
    gen = load_plugin("scenes", "tussock_meadow")
    a = gen.build(n_tussocks=8, blades=4, seed=3)
    b = gen.build(n_tussocks=8, blades=4, seed=3)
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.vertex_colors, b.vertex_colors)
    assert a.num_triangles == 8 * 4 * 3 + 12
    assert not np.array_equal(
        gen.build(n_tussocks=8, blades=4, seed=4).vertices, a.vertices)
    cfg = harness.load_json(harness.HERE, "configs", "meadow-1000")
    scene = S.build_scene(cfg)
    assert scene.num_triangles == 589836
    blades = scene.vertices[:-8]
    # every blade stands on the slab's top and no higher than 1.2
    assert blades[:, 1].min() == pytest.approx(-0.75)
    assert blades[:, 1].max() <= -0.75 + 1.2
    assert np.abs(blades[:, [0, 2]]).max() < 51.0
    np.testing.assert_array_equal(scene.solids, [[[-100, -1.25, -100],
                                                  [100, -0.75, 100]]])
    assert ((scene.vertex_colors >= 0) & (scene.vertex_colors <= 1)).all()


def test_configuration_and_traffic_load():
    cfg = harness.load_json(harness.HERE, "configs", "meadow-1000")
    base = harness.load_json(harness.HERE, "configs", "natural-1000")
    for key in ("eye", "projection", "render_config", "guarantees",
                "reduced"):
        assert cfg[key] == base[key]
    assert cfg["scene"]["generator"] == "tussock_meadow"
    sweep = harness.load_json(harness.HERE, "traffic", "posesweep-s1000")
    assert sweep["samples"] == 1000 and not sweep["lighting"]
    assert sweep["poses"]["region"][1] == [-0.6, 0.5]
    # 1000 x 1000 rays reach the cache's gate at width 1024
    assert 1000 * sweep["samples"] >= 1024 * 512


def test_pose_stream_clears_the_slab():
    cfg = harness.load_json(harness.HERE, "configs", "meadow-1000")
    sweep = harness.load_json(harness.HERE, "traffic", "posesweep-s1000")
    gen = load_plugin("scenes", "tussock_meadow")
    scene = gen.build(n_tussocks=8, blades=4)  # the same slab, few blades
    omms = S.build_eye(cfg)
    warm, window = T.pose_streams(cfg, sweep, scene, omms, 2**31 + 9)
    assert len(warm) == 24 and len(window) == 4096
    ys = np.array([p[1] for p in warm + window])
    radius = S.eye_radius(omms)
    assert radius == pytest.approx(0.1)
    assert (ys - radius > gen.GROUND_Y).all()
    assert ys[1:].min() >= -0.6 and ys.max() <= 0.5


def test_entries_are_discovered():
    with open(harness.BENCHMARK_JSON) as f:
        bench = json.load(f)
    conf = {c["name"]: c for c in bench["configs"]}["meadow-1000"]
    assert conf["file"] == "benchmark/configs/meadow-1000.json"
    assert conf["source"] == harness.load_json(
        harness.HERE, "configs", "meadow-1000")["source"]
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[MEADOW]["config"] == "meadow-1000"
    assert cells[MEADOW]["traffic"] == "posesweep-s1000"
    assert cells[MEADOW]["chips"] == 1
    limits = harness.load_json(harness.HERE, "limits", MEADOW)
    for key in ("max_abs_gap", "mean_abs_gap"):
        lim = limits[key]
        assert lim["lower"] < lim["limit"] < lim["upper"], key
    for name in cells:
        per_layer = [m["name"] for m in
                     harness.metrics_of(bench, name, "per_layer")]
        if name == MEADOW:
            assert set(READERS) <= set(per_layer)
            # the planning and frame-core layers the cell runs
            assert {"plan_ms_per_frame", "plan_builds_per_frame",
                    "plan_syncs_per_frame", "core_ms_per_frame",
                    "farfield_ms_per_frame"} <= set(per_layer)
        else:
            assert not set(READERS) & set(per_layer), name


def cache_build_events():
    """events() with a cache build in frame 2's plan: a cull span around
    one eager kernel of 10 us, then a trace span around K2 (40 us, in
    cr.k2) and one eager kernel of 20 us."""
    evs = events()
    evs += [span("cr.plan.build.cache", 1050, 45),
            span("cr.plan.cache.cull", 1052, 15), launch(1055),
            {"ph": "X", "name": EAGER, "cat": "kernel", "ts": 1056,
             "dur": 10},
            span("cr.plan.cache.trace", 1070, 24),
            span("cr.k2", 1072, 6), launch(1073),
            {"ph": "X", "name": K2, "cat": "kernel", "ts": 1076, "dur": 40},
            launch(1085),
            {"ph": "X", "name": EAGER, "cat": "kernel", "ts": 1117,
             "dur": 20}]
    return evs


def read(name, t):
    return load_plugin("metrics", name).read(t)


def test_cache_span_readers(tmp_path):
    t = sliced_of(tmp_path, cache_build_events())
    # over the slice's 2 frames: the cull's 10 us, the trace's 40 + 20
    assert read("cache_cull_ms_per_frame", t) == pytest.approx(0.005)
    assert read("cache_trace_ms_per_frame", t) == pytest.approx(0.030)
    # the plan's eager kernels hold the cull's and the trace's eager ones,
    # not K2
    assert read("plan_ms_per_frame", t) == pytest.approx(0.040)
    # the two inner spans lie outside cr.plan.build.*: the cache build
    # counts as one build beside the widths build of frame 1
    assert read("plan_builds_per_frame", t) == pytest.approx(1.0)
    # the parent's trace, or a window that builds no cache: no reading
    for name in READERS:
        assert read(name, sliced_of(tmp_path, events())) is None
