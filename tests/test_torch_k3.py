"""Port vs JAX: the any-hit occlusion tracer K3's contract.

rows_occlusion_reference (the torch twin, which run_rows_occlusion takes on
CPU tensors) against the JAX run_rows_occlusion in interpret mode at
precision "highest", on the row tables of tests/test_pallas_tracer.py:549-
636: make_big_scene(60, seed=5), a 16-ommatidium 4-degree eye at
(0, 2, 0), 640 samples (rb_size 768), the pose pack's rows laid out one per
block and sorted by group, with padding rows at the end.  F = 16 traces the
16-feature rays with their direction rows scaled by 50, so t in [0, 1]
spans 50 world units; F = 8 traces the same rows folded with each
group's origin (transform_payload_affine) against [50 d, 1, 0 x 4].
Decisions must be equal on every ray of a group with rows; the JAX kernel
leaves zero-row groups unwritten, the port writes 0.0 there.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from compound_ray_tpu import native_ext  # noqa: E402
from compound_ray_tpu.trace import mm_tracer as JM  # noqa: E402
from compound_ray_tpu.scene.eye_io import ommatidia_to_array  # noqa: E402
from compound_ray_tpu_torch import config as tcfg  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.eye import pipeline as TP  # noqa: E402
from compound_ray_tpu_torch.trace import mm_tracer as TM  # noqa: E402

SAMPLES = 640


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setattr(native_ext, "build_cluster_order",
                        lambda *a, **k: None)
    monkeypatch.setattr(JM, "SHADOW_PRECISION", "highest")
    monkeypatch.setattr(TP, "_eye_plans", {})
    monkeypatch.setattr(tcfg, "_global_config",
                        tcfg.RenderConfig(farfield="off"))
    jax.clear_caches()
    yield
    jax.clear_caches()


def _table(feats=16, skip=()):
    """The pose pack as a K3 table (testing.pack_occlusion_table)."""
    scene = ttesting.make_big_scene(n_boxes=60, seed=5)
    omms = ommatidia_to_array(ttesting.make_sphere_eye(16, 4.0))
    f = ttesting.frame_pack(scene, omms, SAMPLES, (0.0, 2.0, 0.0), "cpu",
                            seed=9)
    return ttesting.pack_occlusion_table(f, feats=feats, skip=skip)


@pytest.mark.parametrize("feats", [16, 8])
def test_twin_matches_jax(pinned, feats):
    r2v, flag, rows, rays, rc, kw = _table(feats, skip=(3,))
    assert rows.shape[1] == rays.shape[0] == feats
    want = np.asarray(JM.run_rows_occlusion(
        *(jnp.asarray(x.numpy()) for x in (r2v, flag, rows, rays)), **kw))
    before = TM.occlusion_launches
    got = TM.run_rows_occlusion(r2v, flag, rows, rays, **kw)
    assert TM.occlusion_launches == before, "the CPU path is the twin"
    ref = TM.rows_occlusion_reference(r2v, flag, rows, rays, **kw)
    assert torch.equal(got, ref) and got.shape == (1, rays.shape[1])
    got = got.numpy()
    live = np.repeat(rc > 0, kw["nrb"] * kw["rb_size"])
    assert set(np.unique(got)) <= {0.0, 1.0}
    np.testing.assert_array_equal(got[0, live], want[0, live])
    assert got[0, live].sum() > 0 and (got[0, live] == 0.0).any()
    # the skipped group and every other zero-row group come out clear
    assert not got[0, ~live].any() and (~live).any()


def test_twin_chunking_and_row_ranges(monkeypatch):
    """Group chunks only bound the twin's memory; the row ranges follow the
    table's sorted layout and ignore padding rows."""
    monkeypatch.setattr(TP, "_eye_plans", {})
    monkeypatch.setattr(tcfg, "_global_config",
                        tcfg.RenderConfig(farfield="off"))
    r2v, flag, rows, rays, rc, kw = _table(skip=(0, 7))
    args = (r2v, flag, rows, rays)
    one = TM.rows_occlusion_reference(*args, **kw)
    monkeypatch.setattr(TM, "_OCC_TWIN_CHUNK_ELEMS", 1)
    assert torch.equal(TM.rows_occlusion_reference(*args, **kw), one)
    start, count = TM._row_ranges(r2v, flag, rc.shape[0])
    np.testing.assert_array_equal(count.numpy(), rc)
    np.testing.assert_array_equal(start.numpy(), np.cumsum(rc) - rc)
    assert count.dtype == start.dtype == torch.int32


@pytest.mark.parametrize("feats", [16, 8])
def test_twin_counts_the_kernels_pair_tests(monkeypatch, feats):
    """The (ray, slot) tests K3's per-thread early exit makes, the products
    its staged tests compute and the tests its warps issue, as the twin
    counts them for the kernel's bound, against a numpy walk of each ray's
    rows: every slot of a row the ray passes, up to the first occluding
    slot of the row that occludes it, and none after; den and w1 for each,
    w2 where a >= 0 and d > 0, tnum where b >= 0 and a + b <= d too."""
    monkeypatch.setattr(TP, "_eye_plans", {})
    monkeypatch.setattr(tcfg, "_global_config",
                        tcfg.RenderConfig(farfield="off"))
    r2v, flag, rows, rays, rc, kw = _table(feats, skip=(3,))
    out, counts = TM._rows_occlusion_twin(
        r2v, flag, rows, rays, **kw, count_tests=True)
    assert torch.equal(out, TM.rows_occlusion_reference(r2v, flag, rows,
                                                        rays, **kw))
    assert TM._rows_occlusion_twin(r2v, flag, rows, rays, **kw)[1] is None
    tests, issued = counts["pair_tests"], counts["warp_issued"]
    rg, leaf = kw["nrb"] * kw["rb_size"], 128
    rows_np, rays_np = rows.numpy(), rays.numpy()
    start = np.cumsum(rc) - rc
    want = want_products = 0
    want_issued = 0
    for v in range(rc.shape[0]):
        ray = rays_np[:, v * rg:(v + 1) * rg]  # (F, rg)
        alive = np.ones(rg, bool)
        for j in range(rc[v]):
            col = rows_np[start[v] + j]  # (F, 512)
            p = ray[0][:, None] * col[0][None, :]
            for k in range(1, feats):
                p = p + ray[k][:, None] * col[k][None, :]
            w1, w2, den, tnum = np.split(p, 4, axis=1)
            s = np.where(den >= 0.0, 1.0, -1.0).astype(np.float32)
            a, b, d, tt = w1 * s, w2 * s, den * s, tnum * s
            ok = ((a >= 0) & (b >= 0) & (a + b <= d) & (tt >= 0) & (tt <= d)
                  & (d > 0))
            hit = ok.any(axis=1)
            first = np.where(hit, ok.argmax(axis=1) + 1, leaf)
            want += int(first[alive].sum())
            s2 = (a >= 0) & (d > 0)
            s3 = s2 & (b >= 0) & (a + b <= d)
            for r in np.flatnonzero(alive):
                n = first[r]
                want_products += int(2 * n + s2[r, :n].sum() + s3[r, :n].sum())
            for r0 in range(0, rg, 32):  # a warp steps to its slowest ray
                seg = first[r0:r0 + 32][alive[r0:r0 + 32]]
                want_issued += 32 * int(seg.max()) if seg.size else 0
            alive &= ~hit
        np.testing.assert_array_equal(
            out[0, v * rg:(v + 1) * rg].numpy() > 0, ~alive)
    assert tests == want
    assert counts["products"] == want_products
    assert 2 * tests < want_products < 4 * tests
    assert issued == want_issued
    assert 0 < tests < int(rc.sum()) * rg * leaf
    assert tests < issued < 32 * tests


def test_twin_counts_a_warp_held_by_one_slow_ray():
    """One warp of 32 rays whose rays are occluded at slot 0, but for one
    ray that no slot occludes: the warp issues all 128 steps of the row
    for 32 rays, so its lane efficiency is (31 + 128) / (32 * 128).  The
    second warp's rays are occluded at slot j (ray j), so it issues 32
    steps.  Column slot k: w1 = k / 128 - x, w2 = 0, den = 1, tnum = 1/2
    on a ray [x, 0, 0, 1, 0 x 4]: slot k occludes iff k >= 128 x (exact
    binary fractions)."""
    leaf = 128
    rows = torch.zeros((1, 8, 512))
    rows[0, 0, 0:leaf] = -1.0
    rows[0, 3, 0:leaf] = torch.arange(leaf) / leaf
    rows[0, 3, 2 * leaf:3 * leaf] = 1.0
    rows[0, 3, 3 * leaf:] = 0.5
    x = torch.zeros(leaf)
    x[5] = 2.0  # never occluded
    x[32:64] = torch.arange(32) / leaf  # ray 32 + j occluded at slot j
    x[64:] = 2.0
    rays = torch.zeros((8, leaf))
    rays[0], rays[3] = x, 1.0
    one = torch.zeros(1, dtype=torch.int32)
    out, counts = TM._rows_occlusion_twin(
        one, one + 2, rows, rays, nrb=1, rb_size=leaf, count_tests=True)
    tests, issued = counts["pair_tests"], counts["warp_issued"]
    want = (out[0] > 0).numpy()
    assert not want[5] and want[:5].all() and want[32:64].all()
    assert not want[64:].any()
    assert tests == 31 + 128 + (32 * 33) // 2 + 64 * 128
    # products: 4 at slot 0 for x = 0, 2 per slot that misses, 4 at the
    # occluding slot j of ray 32 + j
    assert counts["products"] == (31 * 4 + 2 * 128 + (32 * 33 + 2 * 32)
                                  + 64 * 2 * 128)
    assert issued == 32 * (128 + 32 + 128 + 128)
    for live in (4, 8):
        assert torch.equal(TM.rows_occlusion_reference(
            one, one + 2, rows, rays, nrb=1, rb_size=leaf, live_feats=live),
            out)


def test_inputs_are_checked():
    r2v = torch.zeros(4, dtype=torch.int32)
    flag = torch.tensor([2, 1, 1, 0], dtype=torch.int32)
    rows = torch.zeros((4, 8, 512))
    rays = torch.zeros((8, 256))
    ok = dict(nrb=1, rb_size=256)
    assert not TM.run_rows_occlusion(r2v, flag, rows, rays, **ok).any()
    with pytest.raises(ValueError, match="multiple of 128"):
        TM.run_rows_occlusion(r2v, flag, rows, rays, nrb=1, rb_size=200)
    with pytest.raises(ValueError, match="8 or 16"):
        TM.run_rows_occlusion(r2v, flag, torch.zeros((4, 12, 512)),
                              torch.zeros((12, 256)), **ok)
    with pytest.raises(TypeError):
        TM.run_rows_occlusion(r2v.long(), flag, rows, rays, **ok)
    with pytest.raises(ValueError, match="rays"):
        TM.run_rows_occlusion(r2v, flag, rows, torch.zeros((16, 256)), **ok)
    with pytest.raises(ValueError, match="contiguous"):
        TM.run_rows_occlusion(r2v, flag, rows, torch.zeros((256, 8)).t(),
                              **ok)
    with pytest.raises(ValueError, match="both"):
        TM.run_rows_occlusion(r2v[:3], flag, rows, rays, **ok)


@pytest.mark.parametrize("table", ["pose_pack", "canopy_lit"])
def test_live_feats_twin_matches_jax_and_the_full_sum(pinned, table):
    """The twin at live_feats=4 (what the lit frame asks of K3) on F = 8
    tables whose features 4-7 are zero by construction: decisions equal
    to the twin's 8-term sums and to the JAX kernel in interpret mode, on
    every ray of a group with rows.  pose_pack: the reverse-affine table of
    test_twin_matches_jax; canopy_lit: the table and shadow rays of a lit
    frame of the canopy scene with its default lights."""
    from compound_ray_tpu_torch.trace.lighting import default_lights

    if table == "pose_pack":
        r2v, flag, rows, rays, rc, kw = _table(8, skip=(3,))
        kw = dict(kw, live_feats=4)
    else:
        scene = ttesting.make_canopy_scene()
        omms = ommatidia_to_array(ttesting.canopy_eye(2.0))
        f = ttesting.frame_pack(scene, omms, 128, (0.0, 0.0, 0.0), "cpu")
        r2v, flag, rows, rays, kw = ttesting.lit_occlusion_inputs(
            scene, f, default_lights(scene.aabb_min, scene.aabb_max))
        rc = TM._row_ranges(r2v, flag, rays.shape[1] // (
            kw["nrb"] * kw["rb_size"]))[1].numpy()
    assert kw["live_feats"] == TP.SHADOW_LIVE_FEATS == 4
    assert rows.shape[1] == rays.shape[0] == TP.SHADOW_FEATS == 8
    assert not rows[:, 4:].any() and not rays[4:].any()
    got = TM.run_rows_occlusion(r2v, flag, rows, rays, **kw)
    full = TM.rows_occlusion_reference(r2v, flag, rows, rays,
                                       **dict(kw, live_feats=None))
    assert torch.equal(got, full)
    want = np.asarray(JM.run_rows_occlusion(
        *(jnp.asarray(x.numpy()) for x in (r2v, flag, rows, rays)),
        nrb=kw["nrb"], rb_size=kw["rb_size"]))
    live = np.repeat(rc > 0, kw["nrb"] * kw["rb_size"])
    np.testing.assert_array_equal(got.numpy()[0, live], want[0, live])
    assert got[0, live].any() and not got[0, live].all()


@pytest.mark.parametrize("feats,live", [(8, 16), (16, 12), (8, 2),
                                        (8, 0)])
def test_live_feats_are_checked(feats, live):
    """run_rows_occlusion and its twin take live_feats of 4, 8 or 16 and
    at most the table's F; anything else raises."""
    r2v = torch.zeros(2, dtype=torch.int32)
    flag = torch.tensor([2, 1], dtype=torch.int32)
    rows = torch.zeros((2, feats, 512))
    rays = torch.zeros((feats, 128))
    with pytest.raises(ValueError, match="live_feats"):
        TM.run_rows_occlusion(r2v, flag, rows, rays, nrb=1, rb_size=128,
                              live_feats=live)
    with pytest.raises(ValueError, match="live_feats"):
        TM._rows_occlusion_twin(r2v, flag, rows, rays, 1, 128, live,
                                count_tests=True)
    for ok in (4, feats, None):
        assert not TM.run_rows_occlusion(r2v, flag, rows, rays, nrb=1,
                                         rb_size=128, live_feats=ok).any()
