"""Port vs JAX: the tile-culled camera image on K2 (cameras/fast_image.py).

The cases of tests/test_fast_image.py on the port (the K2 image against
the port's brute-force image: under 1 % of pixels with a channel off by
more than 2), and render_camera_image_fast against the JAX package's at
40 x 24, which pads 960 pixels to 1024 and so runs pad_edge: the same
rule.  On the CPU, K2 is its torch twin.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from compound_ray_tpu import testing as jtesting  # noqa: E402
from compound_ray_tpu.cameras.fast_image import (  # noqa: E402
    render_camera_image_fast as j_fast,
)
from compound_ray_tpu_torch import EyeRenderer  # noqa: E402
from compound_ray_tpu_torch import config as tcfg  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.cameras import fast_image as FI  # noqa: E402
from compound_ray_tpu_torch.cameras import raygen  # noqa: E402
from compound_ray_tpu_torch.cameras import types as cam_types  # noqa: E402
from compound_ray_tpu_torch.trace import cluster_tracer as CT  # noqa: E402
from compound_ray_tpu_torch.trace.shade import miss_id  # noqa: E402

POS = np.asarray([0.0, 3.0, 40.0], np.float32)
LS = np.diag([1.0, 1.0, -1.0]).astype(np.float32)  # looks along -z
KINDS = [("pinhole", [0.6, 0.6, 1.0]), ("panoramic", [0.0]),
         ("orthographic", [30.0, 20.0])]
MAX_OFF = 0.01  # share of pixels with a channel off by more than 2


def _off_share(got, want) -> float:
    diff = got[..., :3].astype(int) - want[..., :3].astype(int)
    return float((np.abs(diff).max(axis=-1) > 2).mean())


@pytest.mark.parametrize("kind,param", KINDS, ids=[k for k, _ in KINDS])
def test_fast_image_matches_oracle(kind, param):
    scene = ttesting.make_big_scene(n_boxes=80, seed=9)
    dev = scene.device_triangles("cpu")
    bg = miss_id(scene.background_shader)
    param = np.asarray(param, np.float32)
    ref = raygen.render_camera_image(dev, kind, POS, LS, param, 40, 24, bg).numpy()
    got = FI.render_camera_image_fast(scene, dev, kind, POS, LS, param, 40,
                                      24, bg).numpy()
    assert got.shape == ref.shape == (24, 40, 4)
    assert _off_share(got, ref) < MAX_OFF


@pytest.mark.parametrize("kind,param", KINDS, ids=[k for k, _ in KINDS])
def test_fast_image_matches_jax(kind, param):
    js = jtesting.make_big_scene(n_boxes=80, seed=9)
    ts = ttesting.make_big_scene(n_boxes=80, seed=9)
    bg = miss_id(ts.background_shader)
    param = np.asarray(param, np.float32)
    want = np.asarray(j_fast(js, js.device_triangles(), kind, POS, LS, param,
                             40, 24, bg))
    got = FI.render_camera_image_fast(ts, ts.device_triangles("cpu"), kind,
                                      POS, LS, param, 40, 24, bg).numpy()
    assert got.shape == want.shape == (24, 40, 4)
    assert _off_share(got, want) < MAX_OFF


def test_fast_image_textured_matches_jax():
    """The textured path (the quad table, one texture, a coloured box) on
    the mixed flat scene, a pinhole looking down from (0, 5, 0)."""
    js, ts = jtesting.make_mixed_flat_scene(), ttesting.make_mixed_flat_scene()
    pos = np.asarray([0.0, 5.0, 0.0], np.float32)
    ls = np.asarray([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32)
    param = np.asarray([1.2, 1.2, 1.0], np.float32)
    bg = miss_id(ts.background_shader)
    want = np.asarray(j_fast(js, js.device_triangles(), "pinhole", pos, ls,
                             param, 40, 24, bg))
    got = FI.render_camera_image_fast(ts, ts.device_triangles("cpu"),
                                      "pinhole", pos, ls, param, 40, 24,
                                      bg).numpy()
    assert FI.scene_plan(ts, "cpu").textured
    assert len(np.unique(got[..., :3].reshape(-1, 3), axis=0)) > 8
    assert _off_share(got, want) < MAX_OFF


def test_image_trace_inputs_pad_edge():
    """40 x 24 = 960 pixels in 4 tiles of 256: the 64 padding rays repeat
    the last pixel's direction and origin (their tmin is 0), so the last
    tile's cone stays as narrow as its pixels'; shortlists are sorted
    nearest first."""
    scene = ttesting.make_big_scene(n_boxes=80, seed=9)
    splan = FI.scene_plan(scene, "cpu")
    kmax = min(splan.num_clusters, FI.KMAX_CAP)
    counts, ids, dmin, rays, dirs_n = FI.image_trace_inputs(
        splan.sphere_center, splan.sphere_radius, torch.tensor(POS),
        torch.tensor(LS), torch.tensor([0.6, 0.6, 1.0]), "pinhole", 40, 24,
        kmax)
    assert tuple(rays.shape) == (1024, CT.RAY_COMPS)
    assert tuple(dirs_n.shape) == (960, 3)
    assert torch.equal(rays[960:, :9], rays[959:960, :9].expand(64, -1))
    assert (rays[960:, 9] == 0.0).all() and (rays[:960, 9] > 0.0).all()
    assert ids.shape[1] == 128 and counts.dtype == torch.int32
    assert (counts > 0).all() and (counts <= kmax).all()
    d = torch.where(dmin < 3e38, dmin, torch.inf)
    assert (d[:, 1:] >= d[:, :-1]).all()


def test_renderer_uses_fast_image_path(monkeypatch):
    """An unlit pinhole on an 80-box scene (972 triangles, at least
    min_triangles_for_culling) renders through K2 (its twin on the CPU);
    backend="naive" and lighting take the oracle."""
    r = EyeRenderer(verbose=False, device="cpu")
    r.scene = ttesting.make_big_scene(n_boxes=80, seed=9)
    cam = cam_types.PerspectiveCamera("view")
    cam.set_y_fov(60.0)
    cam.set_position((0.0, 3.0, 40.0))
    cam.set_local_space((1, 0, 0), (0, 1, 0), (0, 0, -1))
    r.scene.cameras.append(cam)
    r.set_render_size(32, 24)
    calls = []
    twin = CT.cluster_tracer_reference
    monkeypatch.setattr(CT, "cluster_tracer_reference",
                        lambda *a, **k: calls.append(1) or twin(*a, **k))
    r.render_frame()
    frame = r.get_frame_pointer()
    assert frame.shape == (24, 32, 4) and frame[..., :3].any()
    assert len(calls) == 1
    monkeypatch.setattr(tcfg, "_global_config",
                        tcfg.RenderConfig(backend="naive"))
    r.render_frame()
    assert len(calls) == 1
    naive = r.get_frame_pointer().astype(int)
    assert _off_share(naive, frame) < MAX_OFF
    monkeypatch.setattr(tcfg, "_global_config", tcfg.RenderConfig())
    r.set_lighting(True)
    r.render_frame()
    assert len(calls) == 1
    lit = r.get_frame_pointer().astype(int)
    assert (lit >= naive).all() and (lit > naive).any()
