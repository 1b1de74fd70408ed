"""Port vs JAX: the culled backend "xla" (trace/culled.py, trace/dispatch.py,
accel/cull.py, accel/clusters.py), the cases of tests/test_accel.py:45-117.

The cone cull is conservative (every triangle a sample ray hits lies in a
surviving cluster) and equals the JAX cull; the culled sweep on pre-drawn
angles equals the JAX sweep on the same numpy angles, and the brute-force
oracle on the same generator, within 1e-5; render_means_fast (the K-class
dispatch) and EyeRenderer under backend "xla" meet the oracle within 1e-5.
The JAX side's cluster split is pinned to numpy.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from compound_ray_tpu import native_ext  # noqa: E402
from compound_ray_tpu import testing as jtesting  # noqa: E402
from compound_ray_tpu.accel import clusters as JC  # noqa: E402
from compound_ray_tpu.accel import cull as JK  # noqa: E402
from compound_ray_tpu.scene.eye_io import ommatidia_to_array  # noqa: E402
from compound_ray_tpu.trace import culled as JU  # noqa: E402
from compound_ray_tpu_torch import EyeRenderer  # noqa: E402
from compound_ray_tpu_torch import config as tcfg  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.accel.clusters import scene_clusters  # noqa: E402
from compound_ray_tpu_torch.accel.cull import (  # noqa: E402
    cone_cull_clusters,
    shortlist_from_mask,
)
from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera  # noqa: E402,E501
from compound_ray_tpu_torch.eye.render import render_compound_means  # noqa: E402,E501
from compound_ray_tpu_torch.eye.sampling import ommatidial_rays  # noqa: E402
from compound_ray_tpu_torch.trace import dispatch as TD  # noqa: E402
from compound_ray_tpu_torch.trace.culled import (  # noqa: E402
    render_means_culled,
    render_means_culled_angles,
)
from compound_ray_tpu_torch.trace.intersect import intersect_rays  # noqa: E402
from compound_ray_tpu_torch.trace.lighting import default_lights  # noqa: E402
from compound_ray_tpu_torch.trace.shade import miss_id  # noqa: E402

LS = np.eye(3, dtype=np.float32)
ATOL = 1e-5


@pytest.fixture
def numpy_split(monkeypatch):
    monkeypatch.setattr(native_ext, "build_cluster_order",
                        lambda *a, **k: None)
    monkeypatch.setattr(tcfg, "_global_config", tcfg.RenderConfig())


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_clusters_and_cull_match_jax(numpy_split):
    """scene_clusters at leaf 32 equals the JAX cluster set (numpy split),
    device_arrays its tables, and the cone cull its mask and counts."""
    js = jtesting.make_big_scene(n_boxes=120, seed=3)
    ts = ttesting.make_big_scene(n_boxes=120, seed=3)
    jcs, tcs = JC.scene_clusters(js, 32), scene_clusters(ts, 32)
    assert scene_clusters(ts, 32) is tcs  # kept on the scene
    np.testing.assert_array_equal(tcs.tri_id, jcs.tri_id)
    jd, td = jcs.device_arrays(), tcs.device_arrays("cpu")
    assert td is tcs.device_arrays("cpu")
    for k in ("normal", "c0", "tri_id", "v0", "sphere_center",
              "sphere_radius"):
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
    # the edge moments a x b: rounded once from float64 in the port, every
    # product in float32 in the JAX package; the directions b - a exactly
    bound = ttesting.edge_moment_bounds(tcs.v0, tcs.e1, tcs.e2)
    ttesting.assert_equal_but_moments(
        td["edge6"].numpy(), np.asarray(jd["edge6"]),
        (bound[:, :, None] * np.array([1, 1, 1, 0, 0, 0])).reshape(
            td["edge6"].shape), err_msg="edge6")
    omms = ommatidia_to_array(jtesting.make_sphere_eye(40, 8.0))
    pos = np.array([0.0, 3.0, 0.0], np.float32)
    want = JK.cone_cull_clusters(jnp.asarray(omms), jnp.asarray(pos),
                                 jnp.asarray(LS), jd["sphere_center"],
                                 jd["sphere_radius"], 5.0)
    got = cone_cull_clusters(torch.tensor(omms), torch.tensor(pos),
                             torch.tensor(LS), td["sphere_center"],
                             td["sphere_radius"], 5.0)
    # a cluster at the cone's edge may fall either side of f32 rounding
    assert (got["mask"].numpy() == np.asarray(want["mask"])).mean() > 0.999
    k = int(got["count"].max())
    ids, valid = shortlist_from_mask(got["mask"], k)
    jids, jvalid = JK.shortlist_from_mask(jnp.asarray(got["mask"].numpy()),
                                          k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_cone_cull_conservative(numpy_split):
    """tests/test_accel.py:45: every triangle a sample ray hits lies in a
    cluster the ommatidium's cone keeps."""
    scene = ttesting.make_big_scene(n_boxes=120, seed=3)
    cs = scene_clusters(scene, 32)
    cdev = cs.device_arrays("cpu")
    omms = torch.tensor(ommatidia_to_array(
        ttesting.make_sphere_eye(40, acceptance_deg=8.0)))
    pos, ls = torch.tensor([0.0, 3.0, 0.0]), torch.tensor(LS)
    mask = cone_cull_clusters(omms, pos, ls, cdev["sphere_center"],
                              cdev["sphere_radius"], 5.0)["mask"].numpy()
    s = 16
    o, d, tmin = ommatidial_rays(omms, pos, ls, s, _gen(0))
    dev = scene.device_triangles("cpu")
    hit = intersect_rays(o, d, dev["v0"], dev["e1"], dev["e2"], tmin, 1e16)
    tri_ids = hit["tri_id"].numpy().reshape(s, 40)
    tri_to_cluster = np.full(scene.num_triangles, -1)
    for ci in range(cs.num_clusters):
        live = cs.tri_id[ci] >= 0
        tri_to_cluster[cs.tri_id[ci][live]] = ci
    si, oi = np.nonzero(tri_ids >= 0)
    assert si.size > 50, "the case must hit"
    assert mask[oi, tri_to_cluster[tri_ids[si, oi]]].all()


def test_culled_matches_jax_and_bruteforce(numpy_split):
    """tests/test_accel.py:80: the culled sweep at leaf 32 in chunks of 16
    ommatidia and 4 samples against the JAX sweep on the same numpy angles
    and against the oracle on the same generator."""
    js = jtesting.make_big_scene(n_boxes=120, seed=1)
    ts = ttesting.make_big_scene(n_boxes=120, seed=1)
    dev = ts.device_triangles("cpu")
    cdev = scene_clusters(ts, 32).device_arrays("cpu")
    omms_np = ommatidia_to_array(jtesting.make_sphere_eye(48, 6.0))
    omms = torch.tensor(omms_np)
    pos_np = np.array([2.0, 2.5, -1.0], np.float32)
    pos, ls = torch.tensor(pos_np), torch.tensor(LS)
    s, bg = 8, miss_id(ts.background_shader)
    cull = cone_cull_clusters(omms, pos, ls, cdev["sphere_center"],
                              cdev["sphere_radius"], 5.0)
    ids, valid = shortlist_from_mask(cull["mask"],
                                     max(int(cull["count"].max()), 1))
    ref = render_compound_means(dev, omms_np, pos_np, LS, _gen(7), s,
                                bg).numpy()
    got = render_means_culled(dev, cdev, omms, pos, ls, _gen(7), ids, valid,
                              s, bg, omm_chunk=16, sample_chunk=4).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    rng = np.random.default_rng(2)
    sd = omms_np[:, 6] / 2.35482004503094938
    splay = (rng.standard_normal((s, 48)) * sd).astype(np.float32)
    spin = (rng.uniform(size=(s, 48)) * np.pi).astype(np.float32)
    got = render_means_culled_angles(
        dev, cdev, omms, pos, ls, torch.tensor(splay), torch.tensor(spin),
        ids, valid, bg, omm_chunk=16, sample_chunk=4).numpy()
    want = np.asarray(JU.render_means_culled_angles(
        js.device_triangles(), JC.scene_clusters(js, 32).device_arrays(),
        jnp.asarray(omms_np), jnp.asarray(pos_np), jnp.asarray(LS),
        jnp.asarray(splay), jnp.asarray(spin), jnp.asarray(ids.numpy()),
        jnp.asarray(valid.numpy()), bg, omm_chunk=16, sample_chunk=4))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_dispatch_smoke(numpy_split):
    """tests/test_accel.py:105: render_means_fast against the oracle on one
    generator; the K-class padding is the JAX package's."""
    scene = ttesting.make_big_scene(n_boxes=120, seed=2)
    dev = scene.device_triangles("cpu")
    omms = ommatidia_to_array(ttesting.make_sphere_eye(32))
    pos = np.array([0.0, 2.0, 0.0], np.float32)
    bg = miss_id(scene.background_shader)
    out = TD.render_means_fast(scene, dev, omms, pos, LS, _gen(0), 4, bg)
    ref = render_compound_means(dev, omms, pos, LS, _gen(0), 4, bg)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    from compound_ray_tpu.trace import dispatch as JD

    for n in (1, 64, 65, 700, 1025, 3000):
        assert TD._pad_count(n) == JD._pad_count(n) >= n


def test_dispatch_cones_that_meet_no_cluster_see_the_sky(monkeypatch):
    """An eye high above the box scene (culling forced on for its 36
    triangles), most of its cones meeting no cluster: those ommatidia are
    shaded as misses, as the oracle shades them (the JAX dispatch starts
    its classes at one cluster and leaves their means 0)."""
    monkeypatch.setattr(tcfg, "_global_config",
                        tcfg.RenderConfig(min_triangles_for_culling=0))
    scene = ttesting.make_box_scene()
    dev = scene.device_triangles("cpu")
    omms = ommatidia_to_array(ttesting.make_sphere_eye(32, 2.0))
    pos = np.array([0.0, 20.0, 0.0], np.float32)
    bg = miss_id(scene.background_shader)
    cdev = scene_clusters(scene, 16).device_arrays("cpu")
    counts = cone_cull_clusters(torch.tensor(omms), torch.tensor(pos),
                                torch.tensor(LS), cdev["sphere_center"],
                                cdev["sphere_radius"], 4.0)["count"]
    assert (counts == 0).any() and (counts > 0).any()
    out = TD.render_means_fast(scene, dev, omms, pos, LS, _gen(1), 4,
                               bg).numpy()
    ref = render_compound_means(dev, omms, pos, LS, _gen(1), 4, bg).numpy()
    assert (out[counts.numpy() == 0] > 0).any(axis=1).all()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_eye_renderer_xla_backend_routes(monkeypatch):
    """EyeRenderer under backend "xla": the means through the culled sweep
    (one host read of the counts per frame), raw samples, lit frames and
    scenes under min_triangles_for_culling through the oracle, bursts frame
    by frame; each meets the oracle on the frame's generator."""
    monkeypatch.setattr(tcfg, "_global_config",
                        tcfg.RenderConfig(backend="xla"))
    calls = []
    real = TD.render_means_culled_angles
    monkeypatch.setattr(TD, "render_means_culled_angles",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    r = EyeRenderer(verbose=False, device="cpu")
    r.scene = ttesting.make_big_scene(n_boxes=120, seed=2)
    cam = CompoundEyeCamera("eye", "single_dimension_fast",
                            ttesting.make_sphere_eye(32))
    cam.set_position((0.0, 2.0, 0.0))
    r.scene.cameras.append(cam)
    r.goto_camera(len(r.scene.cameras) - 1)
    r.set_current_eye_samples_per_ommatidium(4)
    assert r._burst_route() is None
    r.render_frame()
    assert calls
    got = r.get_camera_data()
    dev = r.scene.device_triangles("cpu")
    ref = render_compound_means(dev, cam.ommatidia, cam.position,
                                cam.local_space, r._generator(0), 4,
                                miss_id(r.scene.background_shader)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    cam.projection = "raw_ommatidial_samples"
    n = len(calls)
    r.render_frame()
    assert len(calls) == n and r._raw_samples.shape == (4, 32, 3)
    r.render_frames_pipelined(2)
    assert len(calls) == n and cam.rng_frame == 4
    cam.projection = "single_dimension_fast"
    r._lights = default_lights(r.scene.aabb_min, r.scene.aabb_max)
    r.set_lighting(True)
    r.render_frame()
    assert len(calls) == n
    lit = render_compound_means(dev, cam.ommatidia, cam.position,
                                cam.local_space, r._generator(4), 4,
                                miss_id(r.scene.background_shader), True,
                                r._lights).numpy()
    np.testing.assert_allclose(r.get_camera_data(), lit, atol=ATOL)
