"""Port vs JAX: the sharded path's plans and its shard core at every mesh
coordinate, in one process.

1. eye_plan with ng_multiple, the shard-major shadow plan (shards=4, the
   JAX side at one row per block) and pick_sample_parallel, against the
   JAX package's.
2. Each case of tests/test_sharding.py (:43, :56, :69, :119, :160, :185,
   :205, :239): the JAX sharded function on the 8-device virtual CPU mesh
   of tests/conftest.py, against the port's shard core run for every
   (omm, sample) coordinate of the same mesh shape on the same global
   angles (the JAX package's own draw, _draw_angles), combined as the two
   collectives would (the sum over the sample axis, then the omm axis's
   rows: combine_in_process, test code in tests/_torch_sharding_worker.py).
   Tolerances are the JAX tests' own: 2e-6 unlit, 2e-5 lit, raw samples
   and cache + sky, the metallic-roughness scene's lit frame also 2e-5 of
   the value (MR_NORMAL_RTOL); the statistical case draws the port's own
   angles and holds the mean to 0.05.  The lit cases also hold the port's
   shards against its dense frame on the same angles, the comparison the
   JAX tests make.
3. The port's routes in one process: backend "sharded" renders through the
   oracle, as the JAX renderer does on one device.

The JAX side is pinned as the port's other parity tests pin it: the far
field, the sky split and affine rays off (but in the cache case), one
shadow row per block, the plain local resolve, its numpy cluster order,
and K1 and K3 in interpret mode at precision "highest".
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_sharding_worker as W  # noqa: E402
from compound_ray_tpu import config as jcfg  # noqa: E402
from compound_ray_tpu import native_ext  # noqa: E402
from compound_ray_tpu import testing as jtesting  # noqa: E402
from compound_ray_tpu.eye import pipeline as JP  # noqa: E402
from compound_ray_tpu.parallel import sharding as JS  # noqa: E402
from compound_ray_tpu.scene.eye_io import Ommatidium  # noqa: E402
from compound_ray_tpu.scene.eye_io import ommatidia_to_array  # noqa: E402
from compound_ray_tpu.scene.flat import (  # noqa: E402
    build_scene_from_arrays as jbuild,
)
from compound_ray_tpu.trace import lighting as JL  # noqa: E402
from compound_ray_tpu.trace import mm_tracer as JM  # noqa: E402
from compound_ray_tpu.trace.shade import miss_id  # noqa: E402
from compound_ray_tpu_torch import EyeRenderer  # noqa: E402
from compound_ray_tpu_torch import config as tcfg  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.eye import pipeline as TP  # noqa: E402
from compound_ray_tpu_torch.parallel import sharding as TS  # noqa: E402
from compound_ray_tpu_torch.scene.flat import (  # noqa: E402
    build_scene_from_arrays as tbuild,
)
from test_torch_lit import PLAN_RTOL, _angles, _group_columns, _scenes  # noqa: E402,E501

UNLIT_ATOL = 2e-6
LIT_ATOL = 2e-5
# the metallic-roughness scene's lit frame against JAX's also relative:
# GGX lights it up to radiance ~11.7, where torch's and XLA's f32 maths
# differ by more than 2e-5.  The difference is between the libraries, not
# the mesh: on the same angles the port's sharded frame meets its dense
# frame at LIT_ATOL, and that dense frame differs from JAX's as much
# (test_sharded_lit_matches_jax holds both)
MR_NORMAL_RTOL = 2e-5
LS = np.eye(3, dtype=np.float32)


@pytest.fixture
def pinned(monkeypatch):
    old = jcfg.get_config()
    jcfg.set_config(dataclasses.replace(
        old, farfield="off", sky_split=False, affine_rays=False,
        shadow_rpb=1, lit_local_resolve=False))
    monkeypatch.setattr(native_ext, "build_cluster_order",
                        lambda *a, **k: None)
    monkeypatch.setattr(JM, "PRECISION", "highest")
    monkeypatch.setattr(JM, "SHADOW_PRECISION", "highest")
    monkeypatch.setattr(JP, "_eye_plans", {})
    monkeypatch.setattr(TP, "_eye_plans", {})
    monkeypatch.setattr(tcfg, "_global_config",
                        tcfg.RenderConfig(farfield="off"))
    jax.clear_caches()
    yield monkeypatch
    jcfg.set_config(old)
    jax.clear_caches()  # no trace at the pinned precision outlives the test


# ---------------------------------------------------------------- plans


@pytest.mark.parametrize("n, samples, ng_multiple", [
    (37, 2, 8), (40, 4, 8), (48, 8, 4), (64, 128, 4), (1000, 100, 2)])
def test_eye_plan_ng_multiple_matches_jax(n, samples, ng_multiple):
    omms = ommatidia_to_array(jtesting.make_sphere_eye(n))
    want = JP.eye_plan(omms, samples, ng_multiple=ng_multiple)
    got = TP.eye_plan(omms, samples, ng_multiple=ng_multiple)
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.inv_valid, want.inv_valid)
    assert (got.n_pad, got.ng, got.g, got.rb_size) == (
        want.n_pad, want.ng, want.g, want.rb_size)
    assert got.ng % ng_multiple == 0
    # another padding is another plan: no pose memo serves the other's pack
    assert (got.sig == TP.eye_plan(omms, samples).sig) == (ng_multiple == 1)


def _shard_plans(monkeypatch, shards, ng_multiple=4):
    """Both packages' shard-major shadow plans of the canopy scene's eye at
    64 samples, its groups padded to a multiple of ng_multiple, probing the
    same numpy angles."""
    js, ts, omms, pos, lights = _scenes("canopy")
    samples = 64
    jsp, tsp = JP.scene_plan(js), TP.scene_plan(ts, "cpu")
    je = JP.eye_plan(omms, samples, ng_multiple=ng_multiple)
    te = TP.eye_plan(omms, samples, ng_multiple=ng_multiple)
    jo = jnp.asarray(omms[je.perm])
    to, _ = te.device_arrays(omms, "cpu")
    jpos, jls = jnp.asarray(pos), jnp.asarray(LS)
    tpos, tls = torch.as_tensor(pos), torch.as_tensor(LS)
    kc, rmax = JP._plan_widths(jsp, je, jo, jpos, jls,
                               (je.sig, samples, b"shards"))
    jrc, jpm, _, _ = JP._pack_fused(
        jsp.mm_flat, jsp.slot_center_cl, jsp.slot_radius_cl,
        jsp.half_center, jsp.half_radius, jo, jpos, jls, g=je.g, kcand=kc,
        rmax=rmax, cull_sigmas=4.0, tri_cl=jsp.slot_tri_cl)
    trc, tpm, *tw = TP._pack_fused(
        tsp.mm_flat, tsp.slot_center_cl, tsp.slot_radius_cl,
        tsp.half_center, tsp.half_radius, to, tpos, tls, g=te.g, kmin=kc,
        rmin=rmax, cull_sigmas=4.0, tri_cl=tsp.slot_tri_cl)
    assert tuple(tw) == (kc, rmax)
    splay, spin = _angles(omms[je.perm], samples, 3)
    monkeypatch.setattr(JP, "sample_angles_ns",
                        lambda key, sd, s: (jnp.asarray(splay),
                                            jnp.asarray(spin)))
    sig = (pos.tobytes(), LS.tobytes())
    jplan = JP._shadow_plan(jsp, je, jo, jpos, jls, sig, lights, samples,
                            jax.random.PRNGKey(0), jpm, jrc, rmax,
                            shards=shards)
    tplan = TP._shadow_plan(tsp, te, to, tpos, tls, sig, lights, samples,
                            torch.tensor(splay), torch.tensor(spin), tpm,
                            trc, rmax, shards=shards)
    return jplan, tplan, te.ng


def test_shard_major_shadow_plan_matches_jax(pinned):
    """Each shard's counts, r2v, flag and rows equal the JAX package's
    (rows as tests/test_torch_lit.py's _assert_plans_equal compares them:
    per virtual group, sorted, to f32 rounding)."""
    shards = 4
    jplan, tplan, ng = _shard_plans(pinned, shards)
    jc, jr2v, jflag, jflat, jsph = (np.asarray(x) for x in jplan)
    tc, tr2v, tflag, tflat, tsph = (x.numpy() for x in tplan)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tr2v, jr2v)
    np.testing.assert_array_equal(tflag, jflag)
    assert tflat.shape == jflat.shape and tflat.shape[0] % (64 * shards) == 0
    np.testing.assert_allclose(tsph, jsph, rtol=PLAN_RTOL, atol=1e-6)
    ngl, tb = ng // shards, tflat.shape[0] // shards
    live_shards = 0
    for k in range(shards):
        rows = slice(k * tb, (k + 1) * tb)
        ck = tc[:, k * ngl:(k + 1) * ngl]
        n_live = int(ck.sum())
        live_shards += n_live > 0
        # shard-local virtual groups, padding at the end of each part
        assert (tr2v[rows] < ck.size).all()
        assert (tflag[rows][:n_live] > 0).all()
        assert not tflag[rows][n_live:].any()
        np.testing.assert_array_equal(tflat[rows][n_live:], 0.0)
        for a, b in zip(_group_columns(ck, jflat[rows]),
                        _group_columns(ck, tflat[rows])):
            assert a.shape == b.shape
            np.testing.assert_allclose(b, a, rtol=PLAN_RTOL, atol=1e-6)
    assert live_shards > 1, "the shards must split the occluder rows"


def test_shard_plan_is_memoised_per_shard_count(pinned):
    """One and four shards of one eye plan are two memoised plans with the
    same rows per group, laid out two ways."""
    _, one, _ = _shard_plans(pinned, 1)
    _, four, _ = _shard_plans(pinned, 4)
    assert one[1].shape != four[1].shape  # one table, four parts
    np.testing.assert_array_equal(one[0].numpy(), four[0].numpy())
    assert int((one[2] > 0).sum()) == int((four[2] > 0).sum()) == int(
        one[0].sum())


@pytest.mark.parametrize("samples", [1, 2, 3, 4, 7, 64, 100, 3200])
def test_pick_sample_parallel_matches_jax(samples):
    for n in (1, 2, 3, 4, 6, 8):
        assert TS.pick_sample_parallel(samples, n) == \
            JS.pick_sample_parallel(samples, n)
        assert samples % TS.pick_sample_parallel(samples, n) == 0
    # no process group here: the world is one rank
    assert TS.pick_sample_parallel(samples) == \
        JS.pick_sample_parallel(samples, 1)


# --------------------------------------------- the shard core vs the mesh


def _jax_vs_port(js, ts, omms, pos, key, samples, bg, shape, lights=None,
                 raw=False):
    """(JAX sharded result on the 8-device mesh, the port's shards combined,
    the port's mesh plan) on the JAX package's global angles."""
    jmesh = JS.make_eye_mesh(8, sample_parallel=shape["sample"])
    assert dict(jmesh.shape) == shape
    jdev = js.device_triangles()
    jpos, jls = jnp.asarray(pos), jnp.asarray(LS)
    if raw:
        want = JS.render_samples_sharded_packed(
            js, jdev, omms, jpos, jls, key, samples, bg, jmesh)
    else:
        want = JS.render_means_sharded_packed(
            js, jdev, omms, jpos, jls, key, samples, bg, jmesh,
            lights=lights)
    args = JS._plan_for_mesh(  # memoised by the call above
        js, jdev, omms, jpos, jls, samples, jmesh, lights_np=lights,
        key=key, background=bg, allow_cache=not raw)
    splay, spin = (torch.tensor(np.asarray(a)) for a in
                   JS._draw_angles(key, args["omms_p"], samples))
    plan = TS._plan_for_mesh(ts, ts.device_triangles("cpu"), omms, pos, LS,
                             None, samples, bg, shape, lights=lights,
                             allow_cache=not raw, angles=(splay, spin))
    got = W.combine_in_process(plan, shape, want_samples=raw).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return want, got, plan


def _box_setup(n_omm):
    js = jtesting.make_box_scene(background="white")
    ts = ttesting.make_box_scene(background="white")
    omms = ommatidia_to_array(jtesting.make_sphere_eye(n_omm))
    return js, ts, omms, np.array([0.0, 0.9, 0.0], np.float32)


@pytest.mark.parametrize("n_omm, samples, seed", [
    (40, 4, 3),  # tests/test_sharding.py:43, the omm axis only
    (37, 2, 1),  # :56, group padding to the mesh
])
def test_omm_sharded_means_match_jax(pinned, n_omm, samples, seed):
    js, ts, omms, pos = _box_setup(n_omm)
    want, got, _ = _jax_vs_port(js, ts, omms, pos, jax.random.PRNGKey(seed),
                                samples, miss_id(js.background_shader),
                                {"omm": 8, "sample": 1})
    assert got.shape == (n_omm, 3)
    assert got.min() >= 0.0 and got.max() <= 1.0 + 1e-5
    np.testing.assert_allclose(got, want, atol=UNLIT_ATOL)


def test_sharded_packed_matches_jax(pinned):
    """tests/test_sharding.py:69: 120 boxes, 48 ommatidia at 5 degrees, 8
    samples over a (4, 2) mesh."""
    js = jtesting.make_big_scene(n_boxes=120, seed=6)
    ts = ttesting.make_big_scene(n_boxes=120, seed=6)
    omms = ommatidia_to_array(jtesting.make_sphere_eye(48,
                                                       acceptance_deg=5.0))
    want, got, _ = _jax_vs_port(js, ts, omms, np.array([1.0, 2.0, 3.0],
                                                       np.float32),
                                jax.random.PRNGKey(9), 8,
                                miss_id(js.background_shader),
                                {"omm": 4, "sample": 2})
    np.testing.assert_allclose(got, want, atol=UNLIT_ATOL)


def _grid_eye(spacing, y):
    """The 8 x 4 downward fan of tests/test_sharding.py:132-137 and :219-224
    at 1e-6 rad acceptance."""
    omms = []
    for ix in range(8):
        for iz in range(4):
            p = np.array([spacing * (ix - 3.5), y, spacing * (iz - 1.5)])
            d = np.array([0.1 * (ix - 3.5), -1.0, 0.1 * (iz - 1.5)])
            omms.append(Ommatidium(p, d / np.linalg.norm(d), 1e-6, 0.0))
    return ommatidia_to_array(omms)


def _floor_canopy(box_mesh, build):
    v1, f1 = box_mesh((0.0, -1.0, 0.0), (20.0, 0.2, 20.0))  # floor
    v2, f2 = box_mesh((3.0, 3.0, 0.0), (4.0, 0.2, 4.0))  # partial canopy
    return build(np.concatenate([v1, v2]),
                 np.concatenate([f1, f2 + len(v1)]),
                 base_color=(0.4, 0.5, 0.6), background_shader="black")


@pytest.mark.parametrize("name", ["canopy", "mr_normal"])
def test_sharded_lit_matches_jax(pinned, name):
    """tests/test_sharding.py:119 (floor and canopy) and :205 (the
    metallic-roughness and normal-map scene): lit, 2 samples, (4, 2)."""
    if name == "canopy":
        js = _floor_canopy(jtesting.box_mesh, jbuild)
        ts = _floor_canopy(ttesting.box_mesh, tbuild)
        omms, key, floor = _grid_eye(1.0, 2.0), jax.random.PRNGKey(5), 0.6
    else:
        js, ts = jtesting.make_mr_normal_scene(), \
            ttesting.make_mr_normal_scene()
        omms, key, floor = _grid_eye(2.0, 3.0), jax.random.PRNGKey(11), 0.1
    lights = JL.default_lights(js.aabb_min, js.aabb_max)
    pos = np.zeros(3, np.float32)
    want, got, plan = _jax_vs_port(js, ts, omms, pos, key, 2, 2,
                                   {"omm": 4, "sample": 2}, lights=lights)
    assert got.max() > floor, "lighting must actually contribute"
    # the JAX test's own comparison, made in the port: the sharded frame
    # against the dense frame on the same angles (the mesh plan's, moved to
    # the dense plan's rows; the eye's 1e-6 rad cone still moves the rays
    # of another draw, and GGX on the metallic-roughness scene shows it)
    f = ttesting.frame_pack(ts, omms, 2, pos, "cpu")
    for k in ("splay", "spin"):
        getattr(f, k)[f.inv] = plan.kw[k][plan.inv_valid]
    dense = ttesting.lit_frame_means(ts, f, lights)
    np.testing.assert_allclose(got, dense, atol=LIT_ATOL)
    rtol = MR_NORMAL_RTOL if name == "mr_normal" else 0.0
    np.testing.assert_allclose(dense, want, rtol=rtol, atol=LIT_ATOL)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=LIT_ATOL)


def test_sharded_raw_samples_match_jax(pinned):
    """tests/test_sharding.py:160: raw samples (S, N, 3) over (4, 2)."""
    js = jtesting.make_big_scene(n_boxes=60, seed=2)
    ts = ttesting.make_big_scene(n_boxes=60, seed=2)
    omms = ommatidia_to_array(jtesting.make_sphere_eye(
        32, acceptance_deg=1e-5))
    want, got, _ = _jax_vs_port(js, ts, omms, np.array([0.0, 2.0, 0.0],
                                                       np.float32),
                                jax.random.PRNGKey(11), 4,
                                miss_id(js.background_shader),
                                {"omm": 4, "sample": 2}, raw=True)
    assert got.shape == (4, 32, 3)
    np.testing.assert_allclose(got, want, atol=LIT_ATOL)


def test_sharded_statistical_agreement_with_jax(pinned):
    """tests/test_sharding.py:185: the port's own draw over (4, 2) against
    the JAX sharded frame's draw, 64 samples; the means agree to 0.05."""
    js, ts, omms, pos = _box_setup(40)
    bg = miss_id(js.background_shader)
    want = np.asarray(JS.render_means_sharded_packed(
        js, js.device_triangles(), omms, jnp.asarray(pos), jnp.asarray(LS),
        jax.random.PRNGKey(1), 64, bg, JS.make_eye_mesh(8,
                                                        sample_parallel=2)))
    shape = {"omm": 4, "sample": 2}
    plan = TS._plan_for_mesh(ts, ts.device_triangles("cpu"), omms, pos, LS,
                             torch.Generator().manual_seed(2), 64, bg, shape)
    got = W.combine_in_process(plan, shape).numpy()
    assert got.shape == want.shape == (40, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got.mean(), want.mean(), atol=0.05)


def test_sharded_cache_and_sky_match_jax(pinned):
    """tests/test_sharding.py:239: the far-field cache (64 wide) and the
    sky split on 200 boxes, 64 ommatidia at 4 degrees, 128 samples over
    (4, 2); both packages' mesh sky plans engage.  The port's cache shows
    everything beyond its far-field sphere, the JAX package's the far
    clusters alone (tests/test_torch_farfield.py), so the JAX package's
    memo is given the port's cache before its mesh frame: both sky plans
    are built from it, and the port's shards, combined with every near hit
    kept (its far-field sphere at an infinite radius, the JAX package's
    composition), are held to the JAX mesh frame.  The port's own frame,
    at its real D, is its shards combined, held to its mesh plan traced
    whole on the same angles."""
    jcfg.set_config(dataclasses.replace(
        jcfg.get_config(), farfield="auto", farfield_cache_width=64,
        sky_split=True, big_table_bf16_bytes=0))
    tcfg.set_config(tcfg.RenderConfig(farfield="auto",
                                      farfield_cache_width=64,
                                      sky_split=True))
    js = jtesting.make_big_scene(n_boxes=200, seed=11)
    ts = ttesting.make_big_scene(n_boxes=200, seed=11)
    omms = ommatidia_to_array(jtesting.make_sphere_eye(64,
                                                       acceptance_deg=4.0))
    pos, samples, bg = np.array([0.0, 2.0, 0.0], np.float32), 128, 3
    jsp, tsp = JP.scene_plan(js), TP.scene_plan(ts, "cpu")
    _, tcache, (centre, d) = TP._farfield_plan(
        tsp, TP.eye_plan(omms, samples), ts.device_triangles("cpu"), omms,
        pos, LS, samples, bg, tcfg.get_config())
    assert JP._farfield_plan(jsp, JP.eye_plan(omms, samples),
                             js.device_triangles(), omms, pos, LS, samples,
                             bg, None, jcfg.get_config())[0]
    assert len(jsp.cache_store) == 1
    for key in jsp.cache_store:
        jsp.cache_store[key] = jnp.asarray(tcache.numpy())
    want, _, plan = _jax_vs_port(js, ts, omms, pos, jax.random.PRNGKey(7),
                                 samples, bg, {"omm": 4, "sample": 2})
    assert len(jsp.cache_store) == 1, "the JAX mesh must read the port's cache"
    for splan in (jsp, tsp):
        assert [v for v in splan.sky_store.values() if v is not None], \
            "the mesh sky plan must engage"
    assert plan.kw["far_sphere"][1] == d
    every_hit = dataclasses.replace(
        plan, kw=dict(plan.kw, far_sphere=(centre, math.inf)))
    got = W.combine_in_process(every_hit, {"omm": 4, "sample": 2}).numpy()
    np.testing.assert_allclose(got, want, atol=LIT_ATOL)
    got = W.combine_in_process(plan, {"omm": 4, "sample": 2}).numpy()
    whole = TP._trace_shade_angles(**plan.kw)[plan.inv_valid].numpy()
    np.testing.assert_allclose(got, whole, atol=LIT_ATOL)
    assert np.abs(got - want).max() > 0.0


# ------------------------------------------------- routes in one process


def _renderer(raw=False):
    r = W.renderer(raw=raw)
    r.set_current_eye_samples_per_ommatidium(4)
    return r


def test_single_process_sharded_backend_renders_through_the_oracle(
        monkeypatch):
    """In one process backend "sharded" takes none of the packed branches,
    so a frame reaches the brute-force oracle, as in the JAX renderer
    (compound_ray_tpu/api/renderer.py:646-703); raw samples take the
    packed path (:615-640), and there is no burst."""
    monkeypatch.setattr(tcfg, "_global_config",
                        tcfg.RenderConfig(backend="sharded"))
    sharded = _renderer()
    assert not sharded._sharded() and sharded._burst_route() is None
    sharded.render_frame()
    raw_sharded = _renderer(raw=True)
    raw_sharded.render_frame()
    monkeypatch.setattr(tcfg, "_global_config",
                        tcfg.RenderConfig(backend="naive"))
    oracle = _renderer()
    oracle.render_frame()
    np.testing.assert_array_equal(sharded.get_camera_data(),
                                  oracle.get_camera_data())
    monkeypatch.setattr(tcfg, "_global_config", tcfg.RenderConfig())
    raw_packed = _renderer(raw=True)
    raw_packed.render_frame()
    np.testing.assert_array_equal(raw_sharded._raw_samples.numpy(),
                                  raw_packed._raw_samples.numpy())


def test_one_rank_mesh_equals_render_means():
    """The public function on a (1, 1) mesh with no process group is the
    dense frame bit for bit (one shard, factor 1.0): the chip check's
    first sharded phase at a small size."""
    scene, omms, pos, samples, bg = W.unlit_case()
    dev = scene.device_triangles("cpu")
    mesh = TS.make_eye_mesh(device="cpu")
    assert mesh.shape == {"omm": 1, "sample": 1} and mesh.coords == (0, 0)
    got = TS.render_means_sharded_packed(scene, dev, omms, pos, LS,
                                         W._gen(3), samples, bg, mesh)
    want = TP.render_means(scene, dev, omms, pos, LS, W._gen(3), samples, bg)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="whole"):
        TS.make_eye_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        TS._plan_for_mesh(scene, dev, omms, pos, LS, W._gen(3), 7, bg,
                          {"omm": 2, "sample": 2})
