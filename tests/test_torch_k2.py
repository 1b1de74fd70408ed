"""K2, the cluster-shortlist closest-hit tracer: the port's torch twin
against the JAX kernel (interpret mode on CPU, as tests/test_pallas_tracer.py
runs it).

Inputs are the far-field cache's own K2 inputs (what the port's
_render_cache traces) at the sky-split test pose of tests/test_sky_split.py:
make_big_scene(200, seed=11), 32 clusters, 16 of them far from a
64-ommatidium 4-degree eye at (0, 2, 0), and a 64-wide cache (8 tiles of
256 rays, KP 128, kmax 32), once with the frame's near/far split and once
with every cluster in the cache.  Thresholds on the live groups
(counts > 0): cluster ids and lanes equal, t within rtol 1e-6 (both sides
sum the same products in the same order), u and v within atol 1e-5 (XLA
may fuse the edge products into FMAs, which moves a barycentric near 0 by
a few 1e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from compound_ray_tpu import config as jcfg  # noqa: E402
from compound_ray_tpu import native_ext  # noqa: E402
from compound_ray_tpu.accel.clusters import build_clusters as jax_clusters  # noqa: E402
from compound_ray_tpu.eye import pipeline as JP  # noqa: E402
from compound_ray_tpu.trace.pallas_tracer import (  # noqa: E402
    build_kernel_payload as jax_payload,
    run_tracer_kernel as jax_k2,
)
from compound_ray_tpu_torch import config as tcfg  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.eye import pipeline as TP  # noqa: E402
from compound_ray_tpu_torch.scene.eye_io import ommatidia_to_array  # noqa: E402
from compound_ray_tpu_torch.trace import cluster_tracer as CT  # noqa: E402

T_RTOL = 1e-6
UV_ATOL = 1e-5
WIDTH = 64
POS = np.array([0.0, 2.0, 0.0], np.float32)


@pytest.fixture
def pinned(monkeypatch):
    """JAX side: numpy cluster order, far field on at the test width, sky
    split and affine rays off, f32 tables; port: the same far field."""
    old = jcfg.get_config()
    jcfg.set_config(dataclasses.replace(
        old, farfield="auto", farfield_cache_width=WIDTH, sky_split=False,
        affine_rays=False, big_table_bf16_bytes=0))
    monkeypatch.setattr(native_ext, "build_cluster_order",
                        lambda *a, **k: None)
    monkeypatch.setattr(tcfg, "_global_config", tcfg.RenderConfig(
        farfield="auto", farfield_cache_width=WIDTH))
    yield
    jcfg.set_config(old)


def _cache_inputs(split="far"):
    """K2's inputs of the port's cache at the test pose (the inputs
    _render_cache traces): (counts, ids, dmin, payload, rays, shape
    kwargs) as numpy arrays.  split "far" is the frame's own near/far split
    (few far boxes, so few hits); "all" puts every cluster, the ground
    included, into the cache."""
    scene = ttesting.make_big_scene(n_boxes=200, seed=11)
    omms = ommatidia_to_array(ttesting.make_sphere_eye(64, 4.0))
    c = ttesting.cache_trace_inputs(scene, omms, POS, "cpu", WIDTH,
                                    split=split)
    assert c.far.sum() == (16 if split == "far" else 32)
    return (*(x.numpy() for x in (c.counts, c.ids, c.dmin, c.payload,
                                  c.rays)), c.kw)


def _run_both(counts, ids, dmin, payload, rays, kw, early_exit):
    want = np.asarray(jax_k2(
        jnp.asarray(counts), jnp.asarray(ids), jnp.asarray(dmin),
        jnp.asarray(payload), jnp.asarray(rays), early_exit=early_exit,
        **kw))
    got = CT.cluster_tracer_reference(
        *(torch.tensor(x) for x in (counts, ids, dmin, payload, rays)),
        early_exit=early_exit, **kw).numpy()
    live = np.repeat(counts > 0, kw["nrb"] * kw["rb_size"])
    return want[live], got[live]


def _payload_moment_bounds(v0, e1, e2) -> np.ndarray:
    """The (C, 16, 128) payload's bounds: the w1 and w2 moments
    (components 0-2 and 6-8) from each slot's corners, 0 elsewhere."""
    edge = ttesting.edge_moment_bounds(v0, e1, e2)
    comp = np.zeros((len(edge), CT.PAYLOAD_COMPS))
    comp[:, 0:3] = edge[:, 1:2]  # w1, the edge opposite v1
    comp[:, 6:9] = edge[:, 2:3]  # w2, the edge opposite v2
    return comp.reshape(-1, CT.KERNEL_LEAF, CT.PAYLOAD_COMPS).transpose(
        0, 2, 1)


def test_kernel_payload_equals_jax(pinned):
    """Bit for bit but the edge moments, which the port rounds once from
    float64 (testing.edge_moment_bounds)."""
    scene = ttesting.make_big_scene(n_boxes=200, seed=11)
    cs = jax_clusters(scene.v0, scene.e1, scene.e2, leaf_size=128)
    want = jax_payload(cs)
    ttesting.assert_equal_but_moments(
        CT.build_kernel_payload(cs), want,
        _payload_moment_bounds(cs.v0, cs.e1, cs.e2), err_msg="payload")
    assert want.shape == (32, 16, 128)
    jplan = JP.scene_plan(ttesting.make_big_scene(n_boxes=200, seed=11))
    tplan = TP.scene_plan(scene, "cpu")
    tri = tplan.slot_tri_cl.numpy().reshape(-1, 9)
    ttesting.assert_equal_but_moments(
        tplan.payload.numpy(), np.asarray(jplan.payload),
        _payload_moment_bounds(tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]),
        err_msg="scene plan payload")


@pytest.mark.parametrize("split", ["far", "all"])
@pytest.mark.parametrize("early_exit", [True, False])
def test_twin_matches_jax_kernel(pinned, early_exit, split):
    counts, ids, dmin, payload, rays, kw = _cache_inputs(split)
    assert (counts > 0).sum() >= 4 and kw["kmax"] == 32
    assert ids.shape == (counts.shape[0], 128)
    want, got = _run_both(counts, ids, dmin, payload, rays, kw, early_exit)
    hits = np.isfinite(want[:, 0])
    assert hits.sum() >= (10 if split == "far" else 0.2 * len(hits)), (
        "the case must produce real hits")
    np.testing.assert_array_equal(got[:, 3:5], want[:, 3:5])
    np.testing.assert_array_equal(np.isfinite(got[:, 0]), hits)
    np.testing.assert_allclose(got[hits, 0], want[hits, 0], rtol=T_RTOL)
    np.testing.assert_allclose(got[:, 1:3], want[:, 1:3], atol=UV_ATOL)
    # misses: t = +inf, u = v = 0, cluster -1, lane 0
    assert (got[~hits, 3] == -1).all() and (got[~hits, 1:3] == 0).all()
    assert (got[~hits, 4] == 0).all()
    np.testing.assert_array_equal(got[:, 5:], 0.0)


def test_early_exit_keeps_the_closest_hit(pinned):
    counts, ids, dmin, payload, rays, kw = _cache_inputs("all")
    args = [torch.tensor(x) for x in (counts, ids, dmin, payload, rays)]
    full = CT.cluster_tracer_reference(*args, early_exit=False, **kw)
    early = CT.cluster_tracer_reference(*args, early_exit=True, **kw)
    assert torch.equal(full, early)


@pytest.mark.parametrize("early_exit", [True, False])
def test_twin_winner_order_on_ties(pinned, early_exit):
    """A shortlist that holds one cluster twice (the copy appended as a new
    cluster id) and a cluster whose lane 100 copies lane 3: exact ties.
    The earlier shortlist entry and then the lower lane must win, as in the
    TPU kernel's per-lane strict < and first-lane argmin."""
    counts, ids, dmin, payload, rays, kw = _cache_inputs("all")
    g = int(np.argmax(counts))
    c0 = int(ids[g, 0])
    payload = np.concatenate([payload, payload[c0:c0 + 1]])
    payload[c0, :, 100] = payload[c0, :, 3]
    payload[-1, :, 100] = payload[-1, :, 3]
    dup = payload.shape[0] - 1
    ids, dmin, counts = ids.copy(), dmin.copy(), counts.copy()
    kmax = kw["kmax"]
    n = min(int(counts[g]), kmax - 1)
    ids[g, 1:n + 1] = ids[g, 0:n].copy()
    dmin[g, 1:n + 1] = dmin[g, 0:n].copy()
    ids[g, 1] = dup
    counts[g] = n + 1
    want, got = _run_both(counts, ids, dmin, payload, rays, kw, early_exit)
    np.testing.assert_array_equal(got[:, 3:5], want[:, 3:5])
    rg = kw["nrb"] * kw["rb_size"]
    live_g = np.flatnonzero(counts > 0)
    pos = int(np.flatnonzero(live_g == g)[0])
    rows = got[pos * rg:(pos + 1) * rg]
    won = rows[np.isfinite(rows[:, 0])]
    assert won.size, "the tied tile must see hits"
    assert not (won[:, 3] == dup).any(), "the first copy must win its ties"
    assert not ((won[:, 3] == c0) & (won[:, 4] == 100)).any(), (
        "lane 3 must beat its copy at lane 100")


def test_wrapper_takes_the_twin_on_cpu_and_counts_no_launch(pinned):
    counts, ids, dmin, payload, rays, kw = _cache_inputs()
    args = [torch.tensor(x) for x in (counts, ids, dmin, payload, rays)]
    before = CT.launches
    out = CT.run_tracer_kernel(*args, early_exit=True, **kw)
    assert CT.launches == before
    assert torch.equal(out, CT.cluster_tracer_reference(*args,
                                                        early_exit=True,
                                                        **kw))


def test_wrapper_rejects_bad_inputs():
    counts = torch.ones(2, dtype=torch.int32)
    ids = torch.zeros((2, 128), dtype=torch.int32)
    dmin = torch.zeros((2, 128))
    payload = torch.zeros((3, 16, 128))
    rays = torch.zeros((2 * 256, 16))
    kw = dict(ng=2, nrb=1, rb_size=256, kmax=3)
    CT.run_tracer_kernel(counts, ids, dmin, payload, rays, **kw)
    bad = [
        ((counts.long(), ids, dmin, payload, rays), kw, TypeError),
        ((counts, ids.float(), dmin, payload, rays), kw, TypeError),
        ((counts, ids, dmin[:, :64], payload, rays), kw, ValueError),
        ((counts, ids, dmin, payload[:, :8], rays), kw, ValueError),
        ((counts, ids, dmin, payload, rays[:256]), kw, ValueError),
        ((counts, ids, dmin, payload, rays.t().contiguous().t()), kw,
         ValueError),
        ((counts, ids, dmin, payload, rays), dict(kw, rb_size=200),
         ValueError),
        ((counts, ids, dmin, payload, rays), dict(kw, kmax=129), ValueError),
        (tuple(x.to("meta") for x in (counts, ids, dmin, payload, rays)), kw,
         ValueError),
    ]
    for args, k, exc in bad:
        with pytest.raises(exc):
            CT.run_tracer_kernel(*args, **k)


def test_padding_lanes_and_empty_groups_miss():
    """All-zero payload lanes (den = 0) mask themselves, and a group with
    counts 0 gives miss rows."""
    g, rg = 2, 256
    rng = np.random.default_rng(3)
    d = rng.standard_normal((g * rg, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = rng.standard_normal((g * rg, 3)).astype(np.float32)
    rays = CT.pack_rays(torch.tensor(d), torch.tensor(o), torch.zeros(g * rg))
    assert rays.shape == (g * rg, 16)
    torch.testing.assert_close(rays[:, 3:6],
                               torch.linalg.cross(torch.tensor(o),
                                                  torch.tensor(d)))
    for early in (True, False):
        out = CT.cluster_tracer_reference(
            torch.tensor([2, 0], dtype=torch.int32),
            torch.zeros((g, 128), dtype=torch.int32),
            torch.zeros((g, 128)), torch.zeros((1, 16, 128)), rays, ng=g,
            nrb=1, rb_size=rg, kmax=2, early_exit=early)
        assert torch.isinf(out[:, 0]).all() and (out[:, 3] == -1).all()
        assert (out[:, 4] == 0).all() and (out[:, 1:3] == 0).all()
