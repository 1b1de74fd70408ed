"""A small tussock meadow (benchmark/scenes/tussock_meadow.py) through
EyeRenderer with the far-field cache on, as the benchmark's meadow pose
sweep renders it at full size: the cache frame against the benchmark's
plain reference (benchmark/reference.py, every ray traced to its exact
hit) and the dense frame (farfield "off") against it too, one cache build
per new pose and none on a repeated one (pipeline.cache_builds), and the
build's two spans, cr.plan.cache.cull and cr.plan.cache.trace, inside
cr.plan.build.cache.

32 tussocks of 16 blades in a 20 x 20 patch (1548 triangles, 16 clusters
of 128: more than the cache's 8) under 64 ommatidia of 20 degrees, so D
= 2.70 and the patch straddles it; 32 samples each fill a 64-wide cache,
whose 5.6-degree pixels are 0.66 sd of these cones (twice the ratio of
tests/test_torch_farfield_sphere.py, at a quarter of its rays).
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.reference import Reference
from benchmark.scene import load_plugin, pose_local_space
from compound_ray_tpu_torch import EyeRenderer
from compound_ray_tpu_torch import config as tcfg
from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera
from compound_ray_tpu_torch.eye import pipeline as TP
from compound_ray_tpu_torch.scene.flat import build_scene_from_arrays

WIDTH = 64
SAMPLES = 32
SEED = 2**31 + 23
# (x, y, z, rx, ry, rz): among the blades, then the same pose, then a
# second one turned about +y
POSE_A = (-1.0, -0.25, 0.0, 0.0, 0.0, 0.0)
POSE_B = (2.0, 0.1, 3.0, 0.0, 1.0, 0.0)
CACHE = "cr.plan.build.cache"
CULL, TRACE = "cr.plan.cache.cull", "cr.plan.cache.trace"


@pytest.fixture(scope="module")
def meadow():
    scene = load_plugin("scenes", "tussock_meadow").build(
        n_tussocks=32, blades=16, seed=0, extent=10.0)
    omms = load_plugin("eyes", "sphere_eye").build(64, 20.0)
    return scene, omms


def renderer(meadow, farfield: str) -> EyeRenderer:
    scene, omms = meadow
    tcfg.set_config(tcfg.RenderConfig(farfield=farfield,
                                      farfield_cache_width=WIDTH,
                                      base_seed=SEED))
    r = EyeRenderer(verbose=False, device="cpu")
    r.scene = build_scene_from_arrays(
        scene.vertices, scene.faces, vertex_colors=scene.vertex_colors,
        background_shader=scene.background, name="meadow")
    r.scene.cameras.append(CompoundEyeCamera(
        "eye", "single_dimension_fast", []))
    r.goto_camera(len(r.scene.cameras) - 1)
    r.set_ommatidia(omms)
    r.set_current_eye_samples_per_ommatidium(SAMPLES)
    return r


def view(r: EyeRenderer, pose) -> np.ndarray:
    r.set_camera_pose(*pose)
    r.render_frame()
    return r.get_camera_data().copy()


@pytest.fixture(scope="module")
def frames(meadow, tmp_path_factory):
    """The cache renderer's three views (A traced, A, B) with the builds
    each made and the spans of the first, the dense view of A and the
    reference's frame 0 at A."""
    saved = tcfg._global_config
    try:
        r = renderer(meadow, "auto")
        builds, views = [], []
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            before = TP.cache_builds
            views.append(view(r, POSE_A))
            builds.append(TP.cache_builds - before)
        for pose in (POSE_A, POSE_B):
            before = TP.cache_builds
            views.append(view(r, pose))
            builds.append(TP.cache_builds - before)
        splan = r.scene._kernel_plan
        dense = view(renderer(meadow, "off"), POSE_A)
    finally:
        tcfg._global_config = saved
    path = tmp_path_factory.mktemp("meadow") / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e["name"] in (CACHE, CULL, TRACE)]
    scene, omms = meadow
    want = Reference(scene, "cpu").frame(
        omms, POSE_A[:3], pose_local_space(*POSE_A[3:]), SAMPLES, SEED, 0)
    return dict(views=views, builds=builds, spans=spans, splan=splan,
                dense=dense, want=want)


def test_meadow_counts(meadow):
    scene, _ = meadow
    assert scene.num_triangles == 32 * 16 * 3 + 12
    assert scene.solids.shape == (1, 2, 3)  # the slab alone


def test_cache_frame_matches_the_reference(frames):
    """The cache engages with near and far clusters both present.  Its
    pixels (0.66 sd of a cone) blur the far blades' edges, and a blade
    straddling D is seen in part through the cache: 0.12 of a colour at
    most (0.049 seen) and 0.01 on average (0.0025 seen), the far-field
    tests' margins over their readings."""
    splan = frames["splan"]
    near, _, _ = next(iter(splan.cache_store.values()))
    assert 0 < int(near.sum()) < splan.num_clusters
    gap = np.abs(frames["views"][0] - frames["want"])
    assert gap.max() <= 0.12 and gap.mean() <= 0.01, (gap.max(),
                                                       gap.mean())


def test_dense_frame_matches_the_reference(frames):
    """farfield "off" traces every ray to its exact hit as the reference
    does, on the same draw: float32 rounding apart (2e-7 seen)."""
    assert np.abs(frames["dense"] - frames["want"]).max() <= 1e-5


def test_one_cache_build_per_new_pose(frames):
    assert frames["builds"] == [1, 0, 1]
    assert len(frames["splan"].cache_store) == 2


def test_cache_build_spans_nest(frames):
    spans = frames["spans"]
    names = [s[0] for s in spans]
    assert sorted(names) == sorted([CACHE, CULL, TRACE])
    build = next(s for s in spans if s[0] == CACHE)
    cull = next(s for s in spans if s[0] == CULL)
    trace = next(s for s in spans if s[0] == TRACE)
    for inner in (cull, trace):
        assert build[1] <= inner[1] and inner[2] <= build[2], inner[0]
    assert cull[2] <= trace[1]  # the shortlists, then the trace


def test_blade_beside_the_eye_far_from_the_origin():
    """A meadow view whose ommatidium 88 (of the 1000-ommatidium eye)
    looks up at a blade 3.4-5.8 cm from its origin, 36 units from the
    world's origin: the blade's three triangles alone, 1000 samples.
    With edge moments rounded in float32 the side products' error matched
    their size there, and 489 of 1000 rays missed the blade (0.27 off
    the reference); rounded once from float64 they agree to a few rays
    on its edges: 0.005 of a colour (0.0005 seen)."""
    full = load_plugin("scenes", "tussock_meadow").build()
    blade = SimpleNamespace(
        vertices=full.vertices, faces=full.faces[490812:490815],
        vertex_colors=full.vertex_colors, background=full.background,
        uv=None, mat_id=None, mat_color=None, mat_tex=None, textures=[],
        solids=None, num_triangles=3,
        corners=lambda: full.vertices[full.faces[490812:490815]])
    omms = load_plugin("eyes", "sphere_eye").build(1000, 2.6)[[88]]
    pose = (-23.823389887068032, -0.4301279330248059, 26.79926006538488,
            0.0, 3.188299053271333, 0.0)
    saved = tcfg._global_config
    try:
        tcfg.set_config(tcfg.RenderConfig(farfield="off", base_seed=SEED))
        r = EyeRenderer(verbose=False, device="cpu")
        r.scene = build_scene_from_arrays(
            blade.vertices, blade.faces, vertex_colors=blade.vertex_colors,
            background_shader=blade.background, name="blade")
        r.scene.cameras.append(CompoundEyeCamera(
            "eye", "single_dimension_fast", []))
        r.goto_camera(len(r.scene.cameras) - 1)
        r.set_ommatidia(omms)
        r.set_current_eye_samples_per_ommatidium(1000)
        got = view(r, pose)
    finally:
        tcfg._global_config = saved
    want = Reference(blade, "cpu").frame(
        omms, pose[:3], pose_local_space(*pose[3:]), 1000, SEED, 0)
    assert np.abs(got - want).max() <= 0.005
