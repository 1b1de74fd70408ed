"""Port vs JAX: affine primary rays (config.affine_rays), the cases of
tests/test_affine_rays.py.

With one ommatidium per group each group's ray origin and tmin fold into
its pose-memoised pack (transform_payload_affine) and the frame traces
[d, 1, 0 x 4] rays on K1's 8-feature form.  The affine frame equals the
16-feature frame up to one more pack-time rounding, so it is held to the
JAX package's tolerances: frames within 2e-3 with a mean under 2e-5 (lit:
5e-5), raw samples > 99.9 % within 2e-3, the g > 1 gate bit-identical, a
stacked burst bit-equal to its frames, the shard core at every mesh
coordinate within 2e-5 of the dense affine frame.  K1's twin at
ray_feats=8 meets the JAX kernel (interpret mode) as the 16-feature twin
does (tests/test_torch_k1.py): slots on >= 99.9 % of live rays, t rtol
1e-5.  The JAX side runs with the far field, the sky split and its numpy
cluster split pinned, K1 at precision "highest".  Not mirrored:
test_affine_textured_uvs_emit, which tests the "uvs" emit variant the port
does not have.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import _torch_sharding_worker as W  # noqa: E402
from compound_ray_tpu import config as jcfg  # noqa: E402
from compound_ray_tpu import native_ext  # noqa: E402
from compound_ray_tpu import testing as jtesting  # noqa: E402
from compound_ray_tpu.eye import pipeline as JP  # noqa: E402
from compound_ray_tpu.scene.eye_io import ommatidia_to_array  # noqa: E402
from compound_ray_tpu.trace import mm_tracer as JM  # noqa: E402
from compound_ray_tpu_torch import config as tcfg  # noqa: E402
from compound_ray_tpu_torch import interop  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.eye import pipeline as TP  # noqa: E402
from compound_ray_tpu_torch.parallel import sharding as TS  # noqa: E402
from compound_ray_tpu_torch.trace import mm_tracer as TM  # noqa: E402
from compound_ray_tpu_torch.trace.lighting import default_lights  # noqa: E402
from compound_ray_tpu_torch.trace.shade import miss_id  # noqa: E402

SAMPLES = 128  # one ommatidium per group from 128 samples up
SLOT_AGREE = 0.999
T_RTOL = 1e-5
FRAME_ATOL, FRAME_MEAN = 2e-3, 2e-5
LIT_MEAN = 5e-5
SHARD_ATOL = 2e-5
POS = np.array([3.0, 2.0, -5.0], np.float32)
LS = np.eye(3, dtype=np.float32)


def _pin(monkeypatch):
    """The JAX side: far field, sky split and affine rays off, the numpy
    cluster split, K1 at precision "highest"; both sides: fresh eye-plan
    caches.  Returns the JAX config to restore."""
    old = jcfg.get_config()
    jcfg.set_config(dataclasses.replace(
        old, farfield="off", sky_split=False, affine_rays=False))
    monkeypatch.setattr(native_ext, "build_cluster_order",
                        lambda *a, **k: None)
    monkeypatch.setattr(JM, "PRECISION", "highest")
    monkeypatch.setattr(JP, "_eye_plans", {})
    monkeypatch.setattr(TP, "_eye_plans", {})
    return old


@pytest.fixture
def pinned(monkeypatch):
    old = _pin(monkeypatch)
    yield monkeypatch
    jcfg.set_config(old)


def _affine(monkeypatch, on: bool):
    monkeypatch.setattr(tcfg, "_global_config", tcfg.RenderConfig(
        farfield="off", affine_rays=on))


def _angles(omms_p, samples, seed):
    rng = np.random.default_rng(seed)
    sd = omms_p[:, 6] / JP.FWHM_SD_RATIO
    shape = (omms_p.shape[0], samples)
    return ((rng.standard_normal(shape) * sd[:, None]).astype(np.float32),
            (rng.uniform(size=shape) * np.pi).astype(np.float32))


def _hold_frames(got, want, mean=FRAME_MEAN):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=FRAME_ATOL)
    assert np.abs(got - want).mean() < mean


def test_transform_algebra_matches_jax_and_full_features():
    """transform_payload_affine equals the JAX fold, keeps the metadata
    rows 8-15 byte for byte, and [d, 1, 0 x 4] rays against the folded
    payload give the products [d, m, -o', 1, 0 x 6] rays give against the
    original (tests/test_affine_rays.py:42)."""
    rng = np.random.default_rng(0)
    ng, rmax, r = 3, 2, 64
    pm = rng.normal(size=(ng, rmax, 16, 512)).astype(np.float32)
    o_g = (rng.normal(size=(ng, 3)) * 5.0).astype(np.float32)
    tmin = rng.uniform(0.0, 0.3, size=ng).astype(np.float32)
    q = TM.transform_payload_affine(*(torch.tensor(x) for x in (pm, o_g,
                                                                tmin)))
    want = np.asarray(JM.transform_payload_affine(jnp.asarray(pm),
                                                  jnp.asarray(o_g),
                                                  jnp.asarray(tmin)))
    np.testing.assert_allclose(q.numpy(), want, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(q[:, :, 8:16].numpy(), pm[:, :, 8:16])
    np.testing.assert_array_equal(q[:, :, 4:8].numpy(), 0.0)
    d = rng.normal(size=(ng, r, 3))
    d = torch.tensor((d / np.linalg.norm(d, axis=-1, keepdims=True))
                     .astype(np.float32))
    for g in range(ng):
        f16 = TM.pack_rays_mm(d[g], torch.tensor(o_g[g]).expand(r, 3),
                              torch.full((r,), float(tmin[g])))
        f8 = TM.pack_rays_affine(d[g])
        assert tuple(f8.shape) == (8, r)
        np.testing.assert_array_equal(f8[4:].numpy(), 0.0)
        np.testing.assert_array_equal(f8[3].numpy(), 1.0)
        for j in range(rmax):
            full = (f16.t() @ torch.tensor(pm[g, j])).numpy()
            aff = (f8.t() @ q[g, j, 0:8]).numpy()
            np.testing.assert_allclose(aff, full,
                                       atol=3e-5 * (np.abs(full).max() + 1))


@pytest.fixture(scope="module")
def jax_case():
    """The JAX package's plain and affine packs of make_big_scene(120, 4)
    at POS for a 32-ommatidium eye at 2.6 degrees and 128 samples, its
    affine rays on numpy angles, its K1 on them (ray_feats=8, interpret
    mode) and its affine frame means on the same angles, built once for
    the module under the pinned settings."""
    with pytest.MonkeyPatch.context() as mp:
        old = _pin(mp)
        try:
            yield _jax_affine_case()
        finally:
            jcfg.set_config(old)


def _jax_affine_case():
    js = jtesting.make_big_scene(n_boxes=120, seed=4)
    omms = ommatidia_to_array(jtesting.make_sphere_eye(32, 2.6))
    splan, eplan = JP.scene_plan(js), JP.eye_plan(omms, SAMPLES)
    assert eplan.g == 1
    omms_p = omms[eplan.perm]
    jo, jpos, jls = jnp.asarray(omms_p), jnp.asarray(POS), jnp.asarray(LS)
    kcand, rmax = JP._plan_widths(splan, eplan, jo, jpos, jls,
                                  (eplan.sig, SAMPLES, b"affine"))
    packs = {}
    for affine in (False, True):
        rc, pm, _, _ = JP._pack_fused(
            splan.mm_flat, splan.slot_center_cl, splan.slot_radius_cl,
            splan.half_center, splan.half_radius, jo, jpos, jls, g=1,
            kcand=kcand, rmax=rmax, cull_sigmas=4.0,
            tri_cl=splan.slot_tri_cl, affine=affine)
        packs[affine] = (np.asarray(rc), np.asarray(pm))
    splay, spin = _angles(omms_p, SAMPLES, 7)
    rays, _, _ = JP._gen_ray_features(
        jo, jpos, jls, jnp.asarray(splay), jnp.asarray(spin),
        samples=SAMPLES, ng=eplan.ng, g=1, nrb=eplan.nrb,
        rb_size=eplan.rb_size, affine=True)
    kw = dict(ng=eplan.ng, nrb=eplan.nrb, rb_size=eplan.rb_size, rmax=rmax)
    rc, pm = packs[True]
    k1 = np.asarray(JM.run_packed_tracer(
        jnp.asarray(rc), jnp.asarray(pm), rays, emit="bary", ray_feats=8,
        precision="highest", **kw))
    means = np.asarray(JP._trace_shade_angles(
        jnp.asarray(pm), jnp.asarray(rc), splan.attr_table,
        js.device_triangles(), splan.quad_table, jo, jpos, jls,
        jnp.asarray(splay), jnp.asarray(spin), samples=SAMPLES,
        background=miss_id(js.background_shader), ng=eplan.ng, g=1,
        nrb=eplan.nrb, rb_size=eplan.rb_size, rmax=rmax,
        textured=splan.textured, tex_only=splan.tex_only,
        tex_static=splan.tex_static, quad_gray=splan.quad_gray,
        affine=True, precision="highest", direct1=False))
    return dict(splan=splan, omms=omms, omms_p=omms_p, packs=packs,
                kcand=kcand, rays=np.asarray(rays), kw=kw, k1=k1,
                means=means, splay=splay, spin=spin)


def _port_plan(case):
    return interop.scene_plan_from_arrays(
        "cpu", **{k: np.asarray(getattr(case["splan"], k)) for k in (
            "mm_flat", "attr_table", "slot_center_cl", "slot_radius_cl",
            "slot_tri_cl", "half_center", "half_radius", "quad_table",
            "payload", "sphere_center_np", "sphere_radius_np")},
        textured=case["splan"].textured, tex_only=case["splan"].tex_only)


def test_pack_fused_affine_folds_each_groups_origin(pinned, jax_case):
    """The port's affine pack is its plain pack folded at each group's
    ommatidial origin and tmin, with the same row counts, and the JAX
    package's affine pack is its plain pack folded the same way."""
    case = jax_case
    tplan = _port_plan(case)
    to = torch.tensor(case["omms_p"])
    tpos, tls = torch.tensor(POS), torch.tensor(LS)
    widths = (case["kcand"], case["kw"]["rmax"])
    kw = dict(g=1, kmin=widths[0], rmin=widths[1], cull_sigmas=4.0,
              tri_cl=tplan.slot_tri_cl)
    args = (tplan.mm_flat, tplan.slot_center_cl, tplan.slot_radius_cl,
            tplan.half_center, tplan.half_radius, to, tpos, tls)
    rc0, pm0, *w0 = TP._pack_fused(*args, **kw)
    rc1, pm1, *w1 = TP._pack_fused(*args, affine=True, **kw)
    assert tuple(w0) == tuple(w1) == widths
    (ox, oy, oz), tmin, _, _ = TP._omm_world_origins(to, tpos, tls)
    torch.testing.assert_close(rc1, rc0, rtol=0, atol=0)
    torch.testing.assert_close(pm1, TM.transform_payload_affine(
        pm0, torch.stack([ox, oy, oz], dim=-1), tmin), rtol=0, atol=0)
    jrc, jpm0 = case["packs"][False]
    np.testing.assert_array_equal(case["packs"][True][0], jrc)
    folded = TM.transform_payload_affine(
        torch.tensor(jpm0), torch.stack([ox, oy, oz], dim=-1), tmin)
    np.testing.assert_allclose(case["packs"][True][1], folded.numpy(),
                               rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError, match="one ommatidium per group"):
        TP._pack_fused(*args, **dict(kw, g=2), affine=True)


def test_twin_at_ray_feats_8_matches_jax_kernel(pinned, jax_case):
    """K1's twin at ray_feats=8 on the JAX affine pack and rays against
    the JAX kernel run_packed_tracer(ray_feats=8) in interpret mode; the
    rays' feature count must match ray_feats."""
    case = jax_case
    rc, pm = interop.packed_from_arrays(*case["packs"][True], "cpu")
    rays = torch.tensor(case["rays"])
    kw = case["kw"]
    got = TM.packed_tracer_reference(rc, pm, rays, ray_feats=8, **kw).numpy()
    want = case["k1"]
    live = np.repeat(case["packs"][True][0] > 0, kw["nrb"] * kw["rb_size"])
    agree = want[3][live] == got[3][live]
    both = agree & np.isfinite(want[0][live])
    assert np.isfinite(want[0][live]).mean() > 0.1, "the case must hit"
    assert agree.mean() >= SLOT_AGREE
    np.testing.assert_allclose(got[0][live][both], want[0][live][both],
                               rtol=T_RTOL)
    np.testing.assert_array_equal(got[4:], 0.0)
    # the wrapper takes the twin on CPU tensors, at either form
    torch.testing.assert_close(TM.run_packed_tracer(rc, pm, rays,
                                                    ray_feats=8, **kw),
                               torch.tensor(got), rtol=0, atol=0)
    with pytest.raises(ValueError, match="ray_feats"):
        TM.run_packed_tracer(rc, pm, rays, **kw)
    with pytest.raises(ValueError, match="ray_feats"):
        TM.packed_tracer_reference(rc, pm, rays, ray_feats=12, **kw)


def test_affine_frame_matches_jax_and_standard(pinned, jax_case):
    """The port's affine frame core on the JAX affine pack and angles
    against the JAX affine frame; and the port's affine render_means
    against its 16-feature one on one generator
    (tests/test_affine_rays.py:73)."""
    case = jax_case
    tplan = _port_plan(case)
    ts = ttesting.make_big_scene(n_boxes=120, seed=4)
    rc, pm = interop.packed_from_arrays(*case["packs"][True], "cpu")
    got = TP._trace_shade_angles(
        pm, rc, tplan.attr_table, ts.device_triangles("cpu"),
        tplan.quad_table, torch.tensor(case["omms_p"]), torch.tensor(POS),
        torch.tensor(LS), torch.tensor(case["splay"]),
        torch.tensor(case["spin"]), samples=SAMPLES,
        background=miss_id(ts.background_shader), g=1,
        textured=tplan.textured, tex_only=tplan.tex_only, affine=True,
        **case["kw"])
    _hold_frames(got.numpy(), case["means"])
    frames = {}
    for on in (False, True):
        _affine(pinned, on)
        frames[on] = TP.render_means(
            ts, ts.device_triangles("cpu"), case["omms"], POS, LS,
            torch.Generator().manual_seed(3), SAMPLES,
            miss_id(ts.background_shader)).numpy()
    _hold_frames(frames[True], frames[False])


def _small_case():
    ts = ttesting.make_big_scene(n_boxes=120, seed=4)
    omms = ommatidia_to_array(ttesting.make_sphere_eye(24, 2.6))
    return ts, ts.device_triangles("cpu"), omms, miss_id(ts.background_shader)


def test_affine_raw_samples_match(pinned):
    """Raw samples: the same rays on both forms, so a disagreement is a
    winner flip at a shared edge (tests/test_affine_rays.py:91)."""
    ts, dev, omms, bg = _small_case()
    out = {}
    for on in (False, True):
        _affine(pinned, on)
        out[on] = TP.render_samples(ts, dev, omms, POS, LS,
                                    torch.Generator().manual_seed(5),
                                    SAMPLES, bg).numpy()
    assert out[True].shape == (SAMPLES, 24, 3)
    assert np.isclose(out[True], out[False], atol=2e-3).mean() > 0.999


def test_affine_gated_off_for_grouped_eyes(pinned):
    """At 1 sample an ommatidium's rays fill no ray block, so groups hold
    several ommatidia and the flag renders the 16-feature frame bit for bit
    (tests/test_affine_rays.py:149)."""
    ts, dev, omms, bg = _small_case()
    assert TP.eye_plan(omms, 1).g > 1
    out = {}
    for on in (False, True):
        _affine(pinned, on)
        kw, _ = TP._plan_frame(ts, dev, omms, POS, LS,
                               torch.Generator().manual_seed(11), 1, bg)
        assert kw["affine"] is False
        out[on] = TP.render_means(ts, dev, omms, POS, LS,
                                  torch.Generator().manual_seed(11), 1,
                                  bg).numpy()
    np.testing.assert_array_equal(out[True], out[False])


def test_affine_lit_frame_matches(pinned):
    """Lit frames ride the affine pack too: the primary trace and the
    shadow plan's probe take the 8-feature form, the shadow rows keep
    their own reverse-affine form (tests/test_affine_rays.py:197)."""
    ts = ttesting.make_big_scene(n_boxes=60, seed=5)
    dev = ts.device_triangles("cpu")
    omms = ommatidia_to_array(ttesting.make_sphere_eye(16, 2.6))
    lights = default_lights(ts.aabb_min, ts.aabb_max)
    pos = np.array([0.0, 2.0, 0.0], np.float32)
    out = {}
    for on in (False, True):
        _affine(pinned, on)
        kw, _ = TP._plan_frame(ts, dev, omms, pos, LS,
                               torch.Generator().manual_seed(17), SAMPLES,
                               0, lights=lights)
        assert kw["affine"] is on
        out[on] = TP.render_means(ts, dev, omms, pos, LS,
                                  torch.Generator().manual_seed(17), SAMPLES,
                                  0, lights=lights).numpy()
    assert (out[True] > 0).any()
    _hold_frames(out[True], out[False], mean=LIT_MEAN)


def test_affine_stacked_burst_bit_identical(pinned):
    """A stacked affine burst (F x S on one sample axis, one K1 launch)
    equals its affine frames bit for bit (tests/test_affine_rays.py:245)."""
    ts, dev, omms, bg = _small_case()
    _affine(pinned, True)
    gens = [torch.Generator().manual_seed(23 + f) for f in range(2)]
    burst = TP.render_means_frames(ts, dev, omms, POS, LS, gens, SAMPLES,
                                   bg).numpy()
    seq = np.stack([TP.render_means(ts, dev, omms, POS, LS,
                                    torch.Generator().manual_seed(23 + f),
                                    SAMPLES, bg).numpy() for f in range(2)])
    np.testing.assert_array_equal(burst, seq)


def test_affine_shard_core_matches_dense(pinned):
    """The fold is per group and groups shard whole over "omm": every
    coordinate of a (2, 2) mesh through the shard core, combined, meets the
    dense affine frame on the same angles (tests/test_affine_rays.py:174)."""
    ts = ttesting.make_big_scene(n_boxes=120, seed=4)
    dev = ts.device_triangles("cpu")
    omms = ommatidia_to_array(ttesting.make_sphere_eye(32, 2.6))
    bg = miss_id(ts.background_shader)
    shape = {"omm": 2, "sample": 2}
    _affine(pinned, True)
    splay, spin = W.numpy_angles(omms, SAMPLES, shape["omm"], seed=13)
    plan = TS._plan_for_mesh(ts, dev, omms, POS, LS, None, SAMPLES, bg,
                             shape, angles=(splay, spin))
    assert plan.kw["affine"] is True
    got = W.combine_in_process(plan, shape).numpy()
    kw, inv = TP._plan_frame(ts, dev, omms, POS, LS, None, SAMPLES, bg,
                             angles=(splay, spin))
    assert kw["packed_mm"].shape[0] == plan.kw["packed_mm"].shape[0]
    want = TP._trace_shade_angles(**kw)[inv].numpy()
    np.testing.assert_allclose(got, want, atol=SHARD_ATOL)


def test_plan_keys_keep_affine_and_plain_packs_apart(pinned):
    """One scene plan renders a plain, an affine and again a plain frame
    at one pose: the store keeps both packs under keys that differ in the
    flag, and the second plain frame equals the first bit for bit."""
    ts, dev, omms, bg = _small_case()
    out = []
    for on in (False, True, False):
        _affine(pinned, on)
        out.append(TP.render_means(ts, dev, omms, POS, LS,
                                   torch.Generator().manual_seed(2),
                                   SAMPLES, bg).numpy())
    store = TP.scene_plan(ts, "cpu").packed_store
    assert sorted(k[-1] for k in store) == [False, True]
    np.testing.assert_array_equal(out[2], out[0])
    assert not np.array_equal(out[1], out[0])
    _hold_frames(out[1], out[0])
