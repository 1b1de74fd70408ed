"""The port's sharded path with real collectives: four gloo ranks on the CPU.

One module-scoped fixture starts four ranks of tests/_torch_sharding_worker.py
as subprocesses, joined through a file:// store under tmp_path (no TCP port,
so parallel test workers cannot collide), each with its own time limit, so a
hung collective fails the fixture (TimeoutExpired) and not the suite.  The ranks render on a
(2, 2) mesh: the public render_means_sharded_packed unlit and lit,
render_means_sharded_angles, render_samples_sharded_packed, a two-frame
render_means_sharded_packed_frames, and EyeRenderer at backend "auto" taking
the "sharded" routes for render_frame, raw samples and
render_frames_pipelined (the JAX package's tests/test_pipelined_scan.py:
96-125).  Every check is exact: the ranks sum two partial means, which is
commutative, and the in-process combine runs the same shard cores.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _torch_sharding_worker as W
from compound_ray_tpu_torch.api.renderer import frame_seed
from compound_ray_tpu_torch.config import get_config
from compound_ray_tpu_torch.parallel import sharding as S
from compound_ray_tpu_torch.trace.shade import miss_id

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SHAPE = {"omm": 2, "sample": 2}
RANK_TIMEOUT_S = 120
KEYS = ("unlit", "frames", "frames_sequential", "angles", "lit", "raw",
        "renderer_unlit_frames", "renderer_unlit_burst",
        "renderer_lit_frames", "renderer_lit_burst", "renderer_raw",
        "renderer_raw_means", "routes")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results, after all four exited 0 within their time."""
    tmp = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("CR_TPU_BACKEND", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "_torch_sharding_worker.py"),
         str(r), str(WORLD), str(tmp / "store"), str(tmp)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    logs = []
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [(r, p.returncode, log[-2000:])
              for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    assert not failed, failed
    return [np.load(tmp / f"rank{r}.npz") for r in range(WORLD)]


def test_rank_coordinates(ranks):
    """Rank r sits at (r // 2, r % 2): JAX's devices.reshape(2, 2)."""
    assert [tuple(x["coords"]) for x in ranks] == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]


@pytest.mark.parametrize("key", KEYS)
def test_ranks_bit_equal(ranks, key):
    """Every rank returns the whole result, the same on every rank."""
    for x in ranks[1:]:
        np.testing.assert_array_equal(x[key], ranks[0][key])


def _in_process(case):
    """The case's result from every shard core in this process, combined
    as the collectives would, on the ranks' inputs."""
    if case in ("unlit", "angles"):
        scene, omms, pos, samples, bg = W.unlit_case()
        angles = (W.numpy_angles(omms, samples, SHAPE["omm"])
                  if case == "angles" else None)
        plan = S._plan_for_mesh(scene, scene.device_triangles("cpu"), omms,
                                pos, W.LS, W._gen(9), samples, bg, SHAPE,
                                angles=angles)
        return W.combine_in_process(plan, SHAPE)
    if case == "lit":
        scene, omms, pos, samples, bg, lights = W.lit_case()
        plan = S._plan_for_mesh(scene, scene.device_triangles("cpu"), omms,
                                pos, W.LS, W._gen(5), samples, bg, SHAPE,
                                lights=lights)
        return W.combine_in_process(plan, SHAPE)
    scene, omms, pos, samples, bg = W.raw_case()
    plan = S._plan_for_mesh(scene, scene.device_triangles("cpu"), omms, pos,
                            W.LS, W._gen(11), samples, bg, SHAPE,
                            allow_cache=False)
    return W.combine_in_process(plan, SHAPE, want_samples=True)


@pytest.mark.parametrize("case", ["unlit", "angles", "lit", "raw"])
def test_rank0_equals_in_process_combine(ranks, case):
    want = _in_process(case).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(ranks[0][case], want)


@pytest.mark.parametrize("kind", ["functions", "renderer_unlit",
                                  "renderer_lit"])
def test_burst_equals_sequential_frames(ranks, kind):
    """A sharded burst's frames equal as many sequential sharded frames:
    the function's both frames, the renderer's last."""
    r0 = ranks[0]
    if kind == "functions":
        got, want = r0["frames"], r0["frames_sequential"]
        assert got.shape == (2, 48, 3)
        assert not np.array_equal(got[0], got[1])
    else:
        got, want = r0[f"{kind}_burst"], r0[f"{kind}_frames"]
    np.testing.assert_array_equal(got, want)


def test_renderer_takes_the_sharded_routes(ranks):
    """Backend "auto" under four ranks: both bursts and the raw frame take
    the mesh."""
    assert list(ranks[0]["routes"]) == ["sharded"] * 3


def test_lit_frame_lights_something(ranks):
    """The lit sharded canopy frame adds GGX light over the base colours
    (0.4, 0.5, 0.6), as tests/test_sharding.py:153 asks of the JAX one."""
    assert ranks[0]["lit"].max() > 0.7


def test_renderer_raw_samples_equal_in_process_combine(ranks):
    """The renderer's raw frame is render_samples_sharded_packed's on its
    frame-0 generator, and its camera data their mean."""
    r = W.renderer(raw=True)
    cam = r.current_camera()
    gen = torch.Generator().manual_seed(frame_seed(get_config().base_seed,
                                                   0))
    plan = S._plan_for_mesh(
        r.scene, r.scene.device_triangles("cpu"), cam.ommatidia,
        np.asarray(cam.position, np.float32),
        np.asarray(cam.local_space, np.float32), gen,
        cam.samples_per_ommatidium, miss_id(r.scene.background_shader),
        SHAPE, allow_cache=False)
    want = W.combine_in_process(plan, SHAPE, want_samples=True).numpy()
    np.testing.assert_array_equal(ranks[0]["renderer_raw"], want)
    np.testing.assert_allclose(ranks[0]["renderer_raw_means"],
                               want.mean(axis=0), atol=1e-6)
