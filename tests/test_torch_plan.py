"""Port vs JAX: frame planning (scene tables, eye layout, pose pack and its
widths).

Both packages build their tables from the same procedural scene.  The JAX
package may order clusters by its native median split; these tests pin it
to the numpy split both packages share, so the tables must agree exactly,
save K1's edge moments: the port rounds a x b once from float64, the JAX
package every product in float32, so those agree within 4 ulp of |a| |b|
(testing.edge_moment_bounds).
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from compound_ray_tpu import config as jcfg  # noqa: E402
from compound_ray_tpu import native_ext  # noqa: E402
from compound_ray_tpu import testing as jtesting  # noqa: E402
from compound_ray_tpu.eye import pipeline as JP  # noqa: E402
from compound_ray_tpu.scene.eye_io import ommatidia_to_array  # noqa: E402
from compound_ray_tpu_torch import config as tcfg  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.eye import pipeline as TP  # noqa: E402
from compound_ray_tpu_torch.trace import lighting as TL  # noqa: E402

SAMPLES = 640  # g = 1, rg = 640 -> rb_size 768 (tests/test_pallas_tracer.py)
POS = np.array([0.0, 2.0, 0.0], np.float32)
LS = np.eye(3, dtype=np.float32)


@pytest.fixture
def pinned(monkeypatch):
    """JAX side: far field, sky split and affine rays off, numpy cluster
    order; both sides: fresh eye-plan caches (their width hints are
    high-water marks shared by every caller)."""
    old = jcfg.get_config()
    jcfg.set_config(dataclasses.replace(
        old, farfield="off", sky_split=False, affine_rays=False))
    monkeypatch.setattr(native_ext, "build_cluster_order",
                        lambda *a, **k: None)
    monkeypatch.setattr(JP, "_eye_plans", {})
    monkeypatch.setattr(TP, "_eye_plans", {})
    monkeypatch.setattr(tcfg, "_global_config", tcfg.RenderConfig())
    yield
    jcfg.set_config(old)


def _both(accept_deg):
    js = jtesting.make_big_scene(n_boxes=60, seed=5)
    ts = ttesting.make_big_scene(n_boxes=60, seed=5)
    omms = ommatidia_to_array(jtesting.make_sphere_eye(16, accept_deg))
    return js, ts, omms


def _widths_and_pack(js, ts, omms):
    jsp, tsp = JP.scene_plan(js), TP.scene_plan(ts, "cpu")
    je, te = JP.eye_plan(omms, SAMPLES), TP.eye_plan(omms, SAMPLES)
    jo = jnp.asarray(omms[je.perm])
    to, _ = te.device_arrays(omms, "cpu")
    jpos, jls = jnp.asarray(POS), jnp.asarray(LS)
    tpos, tls = torch.as_tensor(POS), torch.as_tensor(LS)
    jw = JP._plan_widths(jsp, je, jo, jpos, jls, (je.sig, SAMPLES, b"plan"))
    kcand, rmax = jw
    jrc, jpm, _, _ = JP._pack_fused(
        jsp.mm_flat, jsp.slot_center_cl, jsp.slot_radius_cl,
        jsp.half_center, jsp.half_radius, jo, jpos, jls, g=je.g,
        kcand=kcand, rmax=rmax, cull_sigmas=4.0, tri_cl=jsp.slot_tri_cl)
    # the port's one pass at the fresh eye plan's hints
    trc, tpm, *tw = TP._pack_fused(
        tsp.mm_flat, tsp.slot_center_cl, tsp.slot_radius_cl,
        tsp.half_center, tsp.half_radius, to, tpos, tls, g=te.g,
        kmin=te.kmax_hint, rmin=te.rmax_hint, cull_sigmas=4.0,
        tri_cl=tsp.slot_tri_cl)
    return tuple(jw), tuple(tw), (np.asarray(jrc), np.asarray(jpm)), (
        trc.numpy(), tpm.numpy())


def _slot_multisets(row_counts, packed):
    """Per group: sorted slot ids of its live (non-padding) columns."""
    out = []
    for g, cnt in enumerate(row_counts):
        feats = packed[g, :cnt]  # (cnt, 16, 512)
        # a slot is live when any of its four columns holds a feature:
        # padding columns are all zero (slot id feature included)
        nz = np.any(feats != 0, axis=1).reshape(cnt, 4, 128).any(axis=1)
        ids = feats[:, 10, 0:128][nz]
        out.append(sorted(ids.astype(np.int64).tolist()))
    return out


def _mm_moment_bounds(tsp) -> np.ndarray:
    """mm_flat's (rows, 64) bounds: K1's w1 and w2 moments (column block 0
    and 1, features 0-2) from each slot's corners, 0 everywhere else."""
    tri = tsp.slot_tri_cl.numpy().reshape(-1, 9)
    edge = ttesting.edge_moment_bounds(tri[:, 0:3], tri[:, 3:6], tri[:, 6:9])
    bound = np.zeros((tsp.mm_flat.shape[0], 4, 16))
    bound[:len(tri), 0, 0:3] = edge[:, 1:2]  # w1, the edge opposite v1
    bound[:len(tri), 1, 0:3] = edge[:, 2:3]  # w2, the edge opposite v2
    return bound.reshape(tsp.mm_flat.shape)


@pytest.mark.parametrize("accept_deg", [4.0, 20.0])
def test_scene_tables_equal(pinned, accept_deg):
    js, ts, _ = _both(accept_deg)
    jsp, tsp = JP.scene_plan(js), TP.scene_plan(ts, "cpu")
    for name in ("attr_table", "slot_center_cl", "slot_radius_cl",
                 "slot_tri_cl", "half_center", "half_radius", "quad_table"):
        np.testing.assert_array_equal(
            getattr(tsp, name).numpy(), np.asarray(getattr(jsp, name)),
            err_msg=name)
    ttesting.assert_equal_but_moments(
        tsp.mm_flat.numpy(), np.asarray(jsp.mm_flat), _mm_moment_bounds(tsp),
        err_msg="mm_flat")
    assert tsp.num_clusters == jsp.num_clusters
    assert (tsp.textured, tsp.tex_only) == (jsp.textured, jsp.tex_only)


@pytest.mark.parametrize("accept_deg", [4.0, 20.0])
def test_eye_plan_equal(pinned, accept_deg):
    _, _, omms = _both(accept_deg)
    for samples in (SAMPLES, 40):
        je, te = JP.eye_plan(omms, samples), TP.eye_plan(omms, samples)
        np.testing.assert_array_equal(te.perm, je.perm)
        np.testing.assert_array_equal(te.inv_valid, je.inv_valid)
        assert (te.g, te.ng, te.rb_size, te.nrb, te.rg_pad) == (
            je.g, je.ng, je.rb_size, je.nrb, je.rg_pad)


@pytest.mark.parametrize("accept_deg", [4.0, 20.0])
def test_widths_and_pack_equal(pinned, accept_deg):
    js, ts, omms = _both(accept_deg)
    jw, tw, (jrc, jpm), (trc, tpm) = _widths_and_pack(js, ts, omms)
    assert tw == jw
    np.testing.assert_array_equal(trc, jrc)
    assert (trc > 0).any(), "the pose must pack some geometry"
    assert tpm.shape == jpm.shape
    # equal distances may pack in another order (the JAX co-sort is not
    # stable): compare each group's slot multiset, not the layout
    assert _slot_multisets(trc, tpm) == _slot_multisets(jrc, jpm)


def test_packed_store_is_a_bounded_lru(pinned, monkeypatch):
    monkeypatch.setattr(tcfg, "_global_config",
                        tcfg.RenderConfig(packed_store_size=2))
    ts = ttesting.make_big_scene(n_boxes=60, seed=5)
    omms = ommatidia_to_array(ttesting.make_sphere_eye(16, 4.0))
    splan = TP.scene_plan(ts, "cpu")
    eplan = TP.eye_plan(omms, SAMPLES)
    to, _ = eplan.device_arrays(omms, "cpu")
    packs = []
    for y in (1.0, 2.0, 3.0):
        pos = torch.tensor([0.0, y, 0.0])
        sig = (pos.numpy().tobytes(), LS.tobytes())
        packs.append(TP._packed_plan(splan, eplan, to, pos,
                                     torch.as_tensor(LS), sig, SAMPLES))
    assert len(splan.packed_store) == 2
    # the newest pose is served from the store, not re-packed
    again = TP._packed_plan(splan, eplan, to, pos, torch.as_tensor(LS), sig,
                            SAMPLES)
    assert again is packs[-1]


def _pack_at(splan, eplan, to, y):
    pos = torch.tensor([0.0, y, 0.0])
    sig = (pos.numpy().tobytes(), LS.tobytes())
    return TP._packed_plan(splan, eplan, to, pos, torch.as_tensor(LS), sig,
                           SAMPLES)


def test_packed_store_evicts_by_bytes(pinned, monkeypatch):
    """With the byte bound at about two packs the store keeps the newest
    packs that fit, oldest out first, whatever its count bound."""
    ts = ttesting.make_big_scene(n_boxes=60, seed=5)
    omms = ommatidia_to_array(ttesting.make_sphere_eye(16, 4.0))
    splan = TP.scene_plan(ts, "cpu")
    eplan = TP.eye_plan(omms, SAMPLES)
    to, _ = eplan.device_arrays(omms, "cpu")
    first = _pack_at(splan, eplan, to, 1.0)
    size = TP._pack_nbytes(first)
    assert size == sum(t.numel() * t.element_size() for t in first[:2]) > 0
    splan.packed_store.clear()
    monkeypatch.setattr(tcfg, "_global_config", tcfg.RenderConfig(
        packed_store_size=8, packed_store_bytes=int(2.5 * size)))
    packs = [_pack_at(splan, eplan, to, y) for y in (1.0, 1.0001, 1.0002)]
    sizes = [TP._pack_nbytes(p) for p in packs]
    assert max(sizes) <= 1.2 * size  # neighbouring poses, like packs
    held = list(splan.packed_store.values())
    assert sum(map(TP._pack_nbytes, held)) <= int(2.5 * size)
    assert len(held) == 2 and held[-1] is packs[-1] and held[0] is packs[1]
    # the newest is served from the store, not re-packed
    assert _pack_at(splan, eplan, to, 1.0002) is packs[-1]


def test_packed_store_serves_but_keeps_no_pack_over_its_bound(pinned,
                                                              monkeypatch):
    """A pack larger than the whole byte bound is returned for its frame
    and not kept; the store keeps what it held."""
    ts = ttesting.make_big_scene(n_boxes=60, seed=5)
    omms = ommatidia_to_array(ttesting.make_sphere_eye(16, 4.0))
    splan = TP.scene_plan(ts, "cpu")
    eplan = TP.eye_plan(omms, SAMPLES)
    to, _ = eplan.device_arrays(omms, "cpu")
    kept = _pack_at(splan, eplan, to, 1.0)
    size = TP._pack_nbytes(kept)
    monkeypatch.setattr(tcfg, "_global_config", tcfg.RenderConfig(
        packed_store_bytes=size))
    big = TP.eye_plan(np.concatenate([omms, omms]), SAMPLES)  # 2x the bytes
    bo, _ = big.device_arrays(np.concatenate([omms, omms]), "cpu")
    out = _pack_at(splan, big, bo, 1.0)
    assert TP._pack_nbytes(out) > size and out[0].shape[0] == 2 * len(omms)
    assert list(splan.packed_store.values()) == [kept]
    assert _pack_at(splan, big, bo, 1.0) is not out  # packed again


def test_eye_plan_store_is_a_bounded_lru(monkeypatch):
    """Many distinct eyes never hold more than EYE_PLAN_STORE_SIZE plans;
    a used plan is refreshed, and a plan built again has the signature the
    width and pack memos are keyed by."""
    monkeypatch.setattr(TP, "_eye_plans", {})
    monkeypatch.setattr(TP, "EYE_PLAN_STORE_SIZE", 3)
    base = ommatidia_to_array(ttesting.make_sphere_eye(8, 4.0))
    eyes = [base + np.float32(0.01 * i) for i in range(7)]
    first = TP.eye_plan(eyes[0], SAMPLES)
    for i, e in enumerate(eyes[1:], 1):
        TP.eye_plan(e, SAMPLES)
        assert len(TP._eye_plans) == min(i + 1, 3)
        if i == 1:
            assert TP.eye_plan(eyes[0], SAMPLES) is first  # refreshed
    assert len(TP._eye_plans) == 3
    last = TP.eye_plan(eyes[-1], SAMPLES)
    assert any(p is last for p in TP._eye_plans.values())
    again = TP.eye_plan(eyes[0], SAMPLES)
    assert again is not first and again.sig == first.sig
    np.testing.assert_array_equal(again.perm, first.perm)


def test_refine_chunks_cover_every_group(monkeypatch):
    monkeypatch.setattr(TP, "_REFINE_CHUNK_ELEMS", 3 * 2 * 128)
    chunks = TP._refine_chunks(ng=10, g=2, kcand=1)
    assert chunks[0] == (0, 3) and chunks[-1] == (9, 10)
    assert [a for a, _ in chunks[1:]] == [b for _, b in chunks[:-1]]


def test_chunked_pack_equals_unchunked(pinned, monkeypatch):
    """Group chunking only bounds memory: one group per chunk, each
    measuring its own rows, must pack the same payload at the same widths
    as a single chunk."""
    ts = ttesting.make_big_scene(n_boxes=60, seed=5)
    omms = ommatidia_to_array(ttesting.make_sphere_eye(16, 20.0))
    splan = TP.scene_plan(ts, "cpu")
    eplan = TP.eye_plan(omms, SAMPLES)
    to, _ = eplan.device_arrays(omms, "cpu")
    pos, ls = torch.as_tensor(POS), torch.as_tensor(LS)
    args = (splan.mm_flat, splan.slot_center_cl, splan.slot_radius_cl,
            splan.half_center, splan.half_radius, to, pos, ls)
    kw = dict(g=eplan.g, kmin=8, rmin=1, cull_sigmas=4.0,
              tri_cl=splan.slot_tri_cl)
    rc1, pm1, kc1, rm1 = TP._pack_fused(*args, **kw)
    monkeypatch.setattr(TP, "_REFINE_CHUNK_ELEMS", 1)
    rc2, pm2, kc2, rm2 = TP._pack_fused(*args, **kw)
    assert len(TP._refine_chunks(eplan.ng, eplan.g, kc1)) == eplan.ng > 1
    # the widest group sets rmax, and most groups refine fewer rows
    assert rm1 == int(rc1.max()) + int(rc1.max()) % 2
    assert (rc1 < rc1.max()).any()
    assert (kc1, rm1) == (kc2, rm2)
    assert torch.equal(rc1, rc2) and torch.equal(pm1, pm2)


def test_pose_packed_again_after_eviction_keeps_its_rows(pinned,
                                                         monkeypatch):
    """With one pack in the store, a pose, a pose that needs wider
    widths, then the first pose again: the first pose is packed again at
    the raised widths with the rows and live slots of its first pack, and
    renders the same frame."""
    monkeypatch.setattr(tcfg, "_global_config",
                        tcfg.RenderConfig(farfield="off",
                                          packed_store_size=1))
    ts = ttesting.make_big_scene(n_boxes=200, seed=11)
    omms = ommatidia_to_array(ttesting.make_sphere_eye(64, 4.0))
    tdev = ts.device_triangles("cpu")

    def frame(pos):
        kw, inv = TP._plan_frame(ts, tdev, omms, np.array(pos, np.float32),
                                 LS, torch.Generator().manual_seed(3), 8, 3)
        return kw, TP._trace_shade_angles(**kw)[inv]

    first, means = frame((0.0, 2.0, 0.0))
    wide, _ = frame((2.0, 3.0, 2.0))
    assert wide["rmax"] > first["rmax"]
    again, means2 = frame((0.0, 2.0, 0.0))
    assert len(TP.scene_plan(ts, "cpu").packed_store) == 1
    assert again["packed_mm"] is not first["packed_mm"]  # packed again
    assert again["rmax"] == wide["rmax"]
    assert torch.equal(again["row_counts"], first["row_counts"])
    assert _slot_multisets(again["row_counts"].numpy(),
                           again["packed_mm"].numpy()) == _slot_multisets(
        first["row_counts"].numpy(), first["packed_mm"].numpy())
    r = first["rmax"]
    assert torch.equal(again["packed_mm"][:, :r], first["packed_mm"])
    assert not again["packed_mm"][:, r:].any()  # the wider rows are padding
    assert torch.equal(means2, means)


def test_scene_plan_memos_stay_bounded_over_a_pose_sweep(pinned,
                                                         monkeypatch):
    """Twenty new poses of one eye, unlit with the far-field cache and the
    sky split, every fifth lit: every dict on the scene plan stays within
    its bound (each store's configured size; the sky split's high-water
    holds one entry per eye, sample count and quantum)."""
    cfg = tcfg.RenderConfig(farfield="auto", farfield_cache_width=32,
                            sky_split=True, packed_store_size=3,
                            shadow_store_size=2)
    monkeypatch.setattr(tcfg, "_global_config", cfg)
    ts = ttesting.make_big_scene(n_boxes=200, seed=11)
    omms = ommatidia_to_array(ttesting.make_sphere_eye(64, 4.0))
    tdev = ts.device_triangles("cpu")
    lights = TL.default_lights(ts.aabb_min, ts.aabb_max)
    for i in range(20):
        pos = np.array([0.02 * i, 2.0, 0.01 * i], np.float32)
        lit = i % 5 == 4  # at 8 samples: a small shadow probe
        TP._plan_frame(ts, tdev, omms, pos, LS,
                       torch.Generator().manual_seed(i), 8 if lit else 128,
                       3, lights=lights if lit else None)
    splan = TP.scene_plan(ts, "cpu")
    assert any(v is not None for v in splan.sky_store.values())
    bounds = dict(packed_store=cfg.packed_store_size,
                  sky_store=cfg.packed_store_size,
                  shadow_store=cfg.shadow_store_size,
                  cache_store=TP._CACHE_STORE_MAX + 1, sky_ngl=1)
    dicts = {f.name: getattr(splan, f.name)
             for f in dataclasses.fields(splan)
             if isinstance(getattr(splan, f.name), dict)}
    assert set(dicts) == set(bounds)
    assert len(splan.shadow_store) == cfg.shadow_store_size
    for name, d in dicts.items():
        assert len(d) <= bounds[name], (name, len(d))
