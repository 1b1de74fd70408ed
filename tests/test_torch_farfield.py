"""Port vs JAX: the far-field radiance cache and the sky split.

The setup of tests/test_sky_split.py:35-49: make_big_scene(200, seed=11)
(32 clusters, 16 of them far), a 64-ommatidium 4-degree eye at (0, 2, 0),
128 samples, and a 64-wide cache (64 x 128 rays >= 64 x 32 cache pixels, so
the cache gate holds).  The port's cache is not the JAX package's: it
shows everything beyond the far-field sphere, near clusters' parts
included, as a mean over each pixel's area, and the port's frame counts a
near hit only inside the sphere (_farfield_plan).  So the split, the packs,
the cache renderer at the JAX package's arguments and the functions that
read a cache are held to the JAX package on the same inputs, and the
port's cache frame to its dense frame.  The textured case adds, from arrays and in both
packages alike, a near and a far textured quad to the same box field.  The
JAX side runs with farfield="auto", affine rays off, f32 tables
(big_table_bf16_bytes=0), the exact equirect addressing (fast=False), its
numpy cluster order and K1 at precision "highest"; K2 runs in interpret
mode.  Both packages see the same numpy splay and spin angles.

Tolerances: equirect lookups, the cache image and the sky expectation
atol 1e-5 (transcendentals of two libraries); frame means atol 2e-4 (the
tolerance of tests/test_torch_frame.py); plans and masks exactly; the
cache frame against the dense frame as set out at its test.
"""

import dataclasses
import math
from types import SimpleNamespace

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
from compound_ray_tpu_torch import EyeRenderer  # noqa: E402
from compound_ray_tpu_torch import config as tcfg  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera  # noqa: E402
from compound_ray_tpu_torch.eye import pipeline as TP  # noqa: E402

LOOKUP_ATOL = 1e-5
MEANS_ATOL = 2e-4
WIDTH = 64
SAMPLES = 128
BG = 3  # simple_sky
POS = np.array([0.0, 2.0, 0.0], np.float32)
LS = np.eye(3, dtype=np.float32)


def _configs(sky_split=False):
    return (dataclasses.replace(
        jcfg.RenderConfig(), farfield="auto", farfield_cache_width=WIDTH,
        sky_split=sky_split, affine_rays=False, big_table_bf16_bytes=0),
        tcfg.RenderConfig(farfield="auto", farfield_cache_width=WIDTH,
                          sky_split=sky_split))


@pytest.fixture
def pinned(monkeypatch):
    old = jcfg.get_config()
    jc, tc = _configs()
    jcfg.set_config(jc)
    monkeypatch.setattr(native_ext, "build_cluster_order",
                        lambda *a, **k: None)
    monkeypatch.setattr(JP, "_eye_plans", {})
    monkeypatch.setattr(TP, "_eye_plans", {})
    monkeypatch.setattr(tcfg, "_global_config", tc)
    yield
    jcfg.set_config(old)


def _pair(textured=False, samples=SAMPLES):
    """Both packages' scene, plans and permuted eye at the test pose."""
    js = jtesting.make_big_scene(n_boxes=200, seed=11)
    ts = ttesting.make_big_scene(n_boxes=200, seed=11)
    if textured:
        js = ttesting.add_textured_quads(js)
        ts = ttesting.add_textured_quads(ts)
    omms = ommatidia_to_array(jtesting.make_sphere_eye(64, 4.0))
    jsp, tsp = JP.scene_plan(js), TP.scene_plan(ts, "cpu")
    assert tsp.num_clusters == jsp.num_clusters == 32
    assert tsp.textured == jsp.textured == textured
    je, te = JP.eye_plan(omms, samples), TP.eye_plan(omms, samples)
    to, _ = te.device_arrays(omms, "cpu")
    return SimpleNamespace(
        js=js, ts=ts, jsp=jsp, tsp=tsp, je=je, te=te, omms=omms,
        jo=jnp.asarray(omms[je.perm]), to=to, samples=samples,
        jdev=js.device_triangles(), tdev=ts.device_triangles("cpu"),
        jpos=jnp.asarray(POS), jls=jnp.asarray(LS),
        tpos=torch.tensor(POS), tls=torch.tensor(LS))


def _farfield_both(p):
    """Both packages' (near mask, cache, D); the port's far-field sphere
    (centre, D) in place of its D."""
    juse, jnear, jcache, jd = JP._farfield_plan(
        p.jsp, p.je, p.jdev, p.omms, POS, LS, p.samples, BG, None,
        jcfg.get_config())
    tnear, tcache, tsphere = TP._farfield_plan(
        p.tsp, p.te, p.tdev, p.omms, POS, LS, p.samples, BG,
        tcfg.get_config())
    assert juse and tnear is not None, "the cache must engage at this pose"
    return (jnear, jcache, jd), (tnear, tcache, tsphere)


def _packs(p, jnear, tnear):
    """Near-masked packs of both packages at the JAX package's widths."""
    kcand, rmax = JP._plan_widths(p.jsp, p.je, p.jo, p.jpos, p.jls,
                                  (p.je.sig, p.samples, b"ff"))
    jrc, jpm, _, _ = JP._pack_fused(
        p.jsp.mm_flat, p.jsp.slot_center_cl, p.jsp.slot_radius_cl,
        p.jsp.half_center, p.jsp.half_radius, p.jo, p.jpos, p.jls,
        g=p.je.g, kcand=kcand, rmax=rmax, cull_sigmas=4.0,
        near_mask=jnear, use_cache=True, tri_cl=p.jsp.slot_tri_cl)
    trc, tpm, *tw = TP._pack_fused(
        p.tsp.mm_flat, p.tsp.slot_center_cl, p.tsp.slot_radius_cl,
        p.tsp.half_center, p.tsp.half_radius, p.to, p.tpos, p.tls,
        g=p.te.g, kmin=kcand, rmin=rmax, cull_sigmas=4.0,
        tri_cl=p.tsp.slot_tri_cl, near_mask=tnear)
    assert tuple(tw) == (kcand, rmax)
    np.testing.assert_array_equal(trc.numpy(), np.asarray(jrc))
    return kcand, rmax, (jrc, jpm), (trc, tpm)


def _angles(n, samples, seed=11):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((n, samples)) * 0.03).astype(np.float32),
            (rng.uniform(size=(n, samples)) * np.pi).astype(np.float32))


def _frames(p, jpack, tpack, jcache, tcache, rmax, ng, omms_f, splay, spin,
            sky=(None, None, None, None), frames=1, far_sphere=None):
    """Means of both packages' _trace_shade_angles on the same angles;
    frames > 1 stacks that many frames of p.samples each on the sample axis
    in one ray block per group, padded to 256 rays.  far_sphere is the
    port's (centre, D) of its cache frame."""
    jsky_means, jscatter, tsky_means, tscatter = sky
    jo, to = omms_f
    geo = dict(samples=p.samples, background=BG, ng=ng, g=p.je.g,
               nrb=p.je.nrb, rb_size=p.je.rb_size, rmax=rmax,
               textured=p.jsp.textured, tex_only=p.jsp.tex_only)
    if frames > 1:
        rg = p.je.g * frames * p.samples
        geo.update(samples=frames * p.samples, nrb=1,
                   rb_size=-(-rg // 256) * 256, frames=frames)
    want = np.asarray(JP._trace_shade_angles(
        jpack[1], jpack[0], p.jsp.attr_table, p.jdev, p.jsp.quad_table, jo,
        p.jpos, p.jls, jnp.asarray(splay), jnp.asarray(spin),
        cache=jcache, use_cache=True, cache_shape=(WIDTH // 2, WIDTH),
        tex_static=p.jsp.tex_static, quad_gray=p.jsp.quad_gray,
        precision="highest", direct1=False, sky_means=jsky_means,
        sky_scatter=jscatter, **geo))
    got = TP._trace_shade_angles(
        tpack[1], tpack[0], p.tsp.attr_table, p.tdev, p.tsp.quad_table, to,
        p.tpos, p.tls, torch.tensor(splay), torch.tensor(spin), cache=tcache,
        cache_shape=(WIDTH // 2, WIDTH), far_sphere=far_sphere,
        sky_means=tsky_means, sky_scatter=tscatter, **geo).numpy()
    return want, got


def test_equirect_helpers_match_jax():
    h, w = WIDTH // 2, WIDTH
    np.testing.assert_allclose(
        TP._equirect_pixel_dirs(w, h, "cpu").numpy(),
        np.asarray(JP._equirect_pixel_dirs(w, h)), atol=1e-6)
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(h, w, 3)).astype(np.float32)
    jq = np.asarray(JP.build_equirect_quads(jnp.asarray(img)))
    tq = TP.build_equirect_quads(torch.tensor(img)).numpy()
    np.testing.assert_array_equal(tq, jq)
    d = rng.standard_normal((4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:8] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1],
             [0, 0, -1], [-1, 0, 1e-7], [-1, 0, -1e-7]]
    ji, jfx, jfy = (np.asarray(x) for x in JP._equirect_coords_c(
        h, w, *(jnp.asarray(d[:, i]) for i in range(3)), fast=False))
    ti, tfx, tfy = (x.numpy() for x in TP._equirect_coords_c(
        h, w, *(torch.tensor(d[:, i]) for i in range(3))))
    assert (ti == ji).mean() > 0.999
    same = ti == ji
    # fx, fy are fractions of x = u * w - 0.5, which reaches w: a few f32
    # ulps of x at w = 64 are a few 1e-6 each
    np.testing.assert_allclose(tfx[same], jfx[same], atol=5e-5)
    np.testing.assert_allclose(tfy[same], jfy[same], atol=5e-5)
    np.testing.assert_allclose(
        TP.sample_equirect(torch.tensor(tq), torch.tensor(d)).numpy(),
        np.asarray(JP.sample_equirect(jnp.asarray(jq), jnp.asarray(d))),
        atol=LOOKUP_ATOL)


def test_threshold_and_near_mask_match_jax(pinned):
    p = _pair()
    assert TP._farfield_threshold(p.omms, 0.25) == JP._farfield_threshold(
        p.omms, 0.25) > 0.0
    (jnear, _, jd), (tnear, _, (centre, td)) = _farfield_both(p)
    assert td == jd
    np.testing.assert_allclose(centre.numpy(),
                               POS + p.omms[:, 0:3].mean(axis=0), atol=1e-6)
    np.testing.assert_array_equal(tnear.numpy(), np.asarray(jnear))
    assert int((~tnear).sum()) == 16
    # fewer rays than cache pixels: the gate keeps the cache off
    few = TP.eye_plan(p.omms, 16)
    assert TP._farfield_plan(p.tsp, few, p.tdev, p.omms, POS, LS, 16, BG,
                             tcfg.get_config()) == (None, None, None)
    off = tcfg.RenderConfig(farfield="off", farfield_cache_width=WIDTH)
    assert TP._farfield_plan(p.tsp, p.te, p.tdev, p.omms, POS, LS,
                             SAMPLES, BG, off) == (None, None, None)


@pytest.mark.parametrize("textured", [False, True],
                         ids=["untextured", "textured"])
@pytest.mark.parametrize("far", ["split", "all"])
def test_render_cache_matches_jax(pinned, textured, far):
    p = _pair(textured)
    if far == "split":
        (jnear, _, _), _ = _farfield_both(p)
        far_np = ~np.asarray(jnear)
    else:
        far_np = np.ones(32, bool)
    center = POS + p.omms[:, 0:3].mean(axis=0)
    kw = dict(width=WIDTH, background=BG, kmax=32, textured=textured,
              tex_only=False)
    want = np.asarray(JP._render_cache(
        p.jsp.payload, p.jsp.attr_table, p.jdev, p.jsp.quad_table,
        p.jsp.half_center, p.jsp.half_radius, jnp.asarray(center),
        jnp.asarray(far_np), **kw))
    got = TP._render_cache(
        p.tsp.payload, p.tsp.attr_table, p.tdev, p.tsp.quad_table,
        p.tsp.half_center, p.tsp.half_radius, torch.tensor(center),
        torch.tensor(far_np), **kw).numpy()
    assert got.shape == (WIDTH // 2, WIDTH, 3)
    np.testing.assert_allclose(got, want, atol=LOOKUP_ATOL)
    sky = np.asarray(JP._render_cache(
        p.jsp.payload, p.jsp.attr_table, p.jdev, p.jsp.quad_table,
        p.jsp.half_center, p.jsp.half_radius, jnp.asarray(center),
        jnp.zeros(32, bool), **kw))
    assert np.abs(want - sky).max() > 0.1, "the cache must show geometry"


@pytest.mark.parametrize("textured", [False, True],
                         ids=["untextured", "textured"])
def test_trace_shade_angles_with_cache_matches_jax(pinned, textured):
    """The near-masked packs equal the JAX package's; the frame through
    the port's cache, on them, against the port's dense frame on the same
    angles.  The frame reads the port's cache at twice the JAX setup's
    width (the most its 8192 rays engage), as the near mask and D do not
    depend on it.  The gap is the cache's: its 2.8-degree pixels (0.7 of
    this eye's 4-degree cones) blur the far boxes' and the ground's edges
    beyond D, so a cone looking at an edge may be off by much of its
    contrast (max 0.2; 0.10 seen), but not many (mean 0.012; 0.0040
    seen); the JAX package's composition, where the ground's near cluster
    hides far boxes, is not what is held here."""
    p = _pair(textured)
    (jnear, _, _), (tnear, tcache, tsphere) = _farfield_both(p)
    assert tuple(tcache.shape) == (
        (p.tsp.quad_table.shape[0] + WIDTH * WIDTH // 2, 16) if textured
        else (WIDTH // 2, WIDTH, 16))
    fine = 2 * WIDTH  # 64 x 128 pixels: the most these 8192 rays engage
    _, tcache, fsphere = TP._farfield_plan(
        p.tsp, p.te, p.tdev, p.omms, POS, LS, p.samples, BG,
        dataclasses.replace(tcfg.get_config(), farfield_cache_width=fine))
    assert fsphere[1] == tsphere[1]
    kcand, rmax, _, tpack = _packs(p, jnear, tnear)
    dense = TP._pack_fused(
        p.tsp.mm_flat, p.tsp.slot_center_cl, p.tsp.slot_radius_cl,
        p.tsp.half_center, p.tsp.half_radius, p.to, p.tpos, p.tls,
        g=p.te.g, kmin=p.tsp.num_clusters, rmin=p.tsp.num_clusters,
        cull_sigmas=4.0, tri_cl=p.tsp.slot_tri_cl)[:2]
    splay, spin = (torch.tensor(a) for a in _angles(p.te.n_pad, p.samples))
    geo = dict(samples=p.samples, background=BG, ng=p.te.ng, g=p.te.g,
               nrb=p.te.nrb, rb_size=p.te.rb_size,
               textured=p.tsp.textured, tex_only=p.tsp.tex_only)
    args = (p.tsp.attr_table, p.tdev, p.tsp.quad_table, p.to, p.tpos, p.tls,
            splay, spin)
    got = TP._trace_shade_angles(
        tpack[1], tpack[0], *args, rmax=rmax, cache=tcache,
        cache_shape=(fine // 2, fine), far_sphere=fsphere, **geo).numpy()
    want = TP._trace_shade_angles(dense[1], dense[0], *args,
                                  rmax=p.tsp.num_clusters, **geo).numpy()
    assert np.isfinite(got).all() and got.shape == (64, 3)
    gap = np.abs(got - want)
    assert gap.max() <= 0.2 and gap.mean() <= 0.012, (gap.max(), gap.mean())


@pytest.mark.parametrize("textured", [False, True],
                         ids=["untextured", "textured"])
def test_sky_expectation_matches_jax(pinned, textured):
    """Both packages' expectation over the port's cache."""
    p = _pair(textured)
    _, (_, tcache, _) = _farfield_both(p)
    ch, cw = WIDTH // 2, WIDTH
    off = tcache.shape[0] - ch * cw if textured else 0
    want = np.asarray(JP._sky_expectation(
        jnp.asarray(tcache.numpy()), p.jo, p.jls, nq_splay=16, nq_spin=8,
        cache_shape=(ch, cw), row_offset=off))
    got = TP._sky_expectation(tcache, p.to, p.tls, 16, 8, (ch, cw),
                              off).numpy()
    assert got.shape == (64, 3)
    np.testing.assert_allclose(got, want, atol=LOOKUP_ATOL)


def test_sky_plan_and_means_match_jax(pinned):
    """Both packages' sky plan over the port's cache, and their frames on
    it with every near hit kept (the port's far-field sphere at an infinite
    radius, the JAX package's composition)."""
    jcfg.set_config(_configs(sky_split=True)[0])
    tcfg.set_config(_configs(sky_split=True)[1])
    p = _pair()
    (jnear, _, _), (tnear, tcache, (centre, _)) = _farfield_both(p)
    jcache = jnp.asarray(tcache.numpy())
    kcand, rmax, jpack, tpack = _packs(p, jnear, tnear)
    jsky = JP._sky_build(p.jsp, p.je, p.jo, p.jls, p.samples, kcand, rmax,
                         jcache, jpack[0], jpack[1])
    tsky = TP._sky_build(p.tsp, p.te, p.to, p.tls, p.samples, kcand, rmax,
                         tcache, (WIDTH // 2, WIDTH), tpack[0], tpack[1])
    assert jsky is not None and tsky is not None, "the split must engage"
    (jpm, jrc, jo, jscatter, jmeans, jngl, _, _) = jsky
    (tpm, trc, to, tscatter, tmeans, tngl, _, _) = tsky
    assert tngl == jngl == 64
    np.testing.assert_array_equal(tscatter.numpy(), np.asarray(jscatter))
    np.testing.assert_array_equal(trc.numpy(), np.asarray(jrc))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert (trc.numpy() == 0).sum() > 0 and (tscatter.numpy() == 64).any()
    np.testing.assert_allclose(tmeans.numpy(), np.asarray(jmeans),
                               atol=LOOKUP_ATOL)
    splay, spin = _angles(tngl, p.samples, seed=4)
    want, got = _frames(p, (jrc, jpm), (trc, tpm), jcache, tcache, rmax,
                        tngl, (jo, to), splay, spin,
                        sky=(jmeans, jscatter, tmeans, tscatter),
                        far_sphere=(centre, math.inf))
    assert got.shape == (64, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=MEANS_ATOL)


def test_dense_and_cache_packs_never_share_a_key(pinned, monkeypatch):
    """A dense frame and then a cache frame at one pose: two pack builds
    under keys that differ in the far-field split, and the cache frame
    traces only the near clusters."""
    p = _pair()
    gen = torch.Generator().manual_seed(1)
    args = (p.ts, p.tdev, p.omms, POS, LS)
    pack = TP._pack_fused
    builds = []
    monkeypatch.setattr(TP, "_pack_fused",
                        lambda *a, **k: builds.append(1) or pack(*a, **k))
    tcfg.set_config(tcfg.RenderConfig(farfield="off",
                                      farfield_cache_width=WIDTH))
    TP.render_means(*args, gen, p.samples, BG)
    dense = list(p.tsp.packed_store.values())
    tcfg.set_config(_configs()[1])
    TP.render_means(*args, gen, p.samples, BG)
    assert len(builds) == 2
    assert len(p.tsp.packed_store) == 2 and len(p.tsp.cache_store) == 1
    assert [k[3] for k in p.tsp.packed_store] == [False, True]  # use_cache
    near_rc = list(p.tsp.packed_store.values())[1][0]
    # the near-masked pack drops the far clusters' rows
    assert (near_rc <= dense[0][0]).all() and (near_rc < dense[0][0]).any()


def _port_renderer(samples, sky_split, cache_width=WIDTH):
    tcfg.set_config(tcfg.RenderConfig(
        farfield="auto", farfield_cache_width=cache_width,
        sky_split=sky_split))
    r = EyeRenderer(verbose=False, device="cpu")
    r.scene = ttesting.make_big_scene(n_boxes=200, seed=11)
    r.scene.cameras.append(CompoundEyeCamera(
        "eye", "single_dimension_fast", ttesting.make_sphere_eye(64, 4.0)))
    r.goto_camera(len(r.scene.cameras) - 1)
    r.current_camera().set_position((0.0, 2.0, 0.0))
    r.set_current_eye_samples_per_ommatidium(samples)
    return r


def test_eye_renderer_far_field_matches_direct_frame(pinned):
    """The same generator seed with the cache on and off: the same rays,
    so the frames differ only by the cache's resolution and parallax
    (bound of tests/test_pallas_tracer.py:219-220)."""
    r = _port_renderer(SAMPLES, sky_split=False)
    r.render_frame()
    cached = r.get_camera_data().copy()
    splan = r.scene._kernel_plan
    assert len(splan.cache_store) == 1
    tcfg.set_config(tcfg.RenderConfig(farfield="off"))
    r.current_camera().rng_frame -= 1
    r.render_frame()
    direct = r.get_camera_data()
    assert np.isfinite(cached).all()
    assert cached.min() >= 0.0 and cached.max() <= 1.0 + 1e-5
    assert np.abs(cached - direct).mean() < 0.02


def test_eye_renderer_sky_split(pinned, monkeypatch):
    """Sky split on: close to the dense cache frame, sky groups identical
    across seeds, the dense pack evicted, and the memoised pose served
    without building a pack (tests/test_sky_split.py:143-205)."""
    r = _port_renderer(SAMPLES, sky_split=False)
    r.render_frame()
    dense = r.get_camera_data().copy()
    tcfg.set_config(_configs(sky_split=True)[1])
    r.current_camera().rng_frame -= 1
    r.render_frame()
    split = r.get_camera_data().copy()
    splan = r.scene._kernel_plan
    plans = [v for v in splan.sky_store.values() if v is not None]
    assert len(plans) == 1, "the split must engage at this pose"
    assert not any(k[3] for k in splan.packed_store), (
        "the compacted plan replaces the cache frame's dense pack")
    calls = []
    monkeypatch.setattr(TP, "_pack_fused",
                        lambda *a, **k: calls.append(1))
    r.render_frame()
    split2 = r.get_camera_data()
    assert not calls, "a memoised sky pose builds no pack"
    scatter = plans[0][3].numpy()
    eplan = TP.eye_plan(r.current_camera().ommatidia, SAMPLES)
    live = np.unique(scatter[scatter < eplan.ng])
    sky_orig = eplan.perm[np.setdiff1d(np.arange(eplan.ng), live)]
    assert sky_orig.size > 0
    assert np.isfinite(split).all()
    assert np.abs(split - dense).mean() < 0.02
    np.testing.assert_array_equal(split[sky_orig], split2[sky_orig])
