"""Port vs JAX: the lit frame (GGX light, the shadow plan, the audit).

Both packages build their own plans from the same scenes.  The JAX side
runs as its own tests run it: the far field, the sky split, affine rays and
the one-hot local resolve off, one shadow row per block, its numpy cluster
order, and K1 and K3 in interpret mode at precision "highest"
(mm_tracer.PRECISION and SHADOW_PRECISION pinned and the jit caches
cleared: the tuning read at import would give f32x1).  Its shadow probe
draws its angles from the frame's key; here that draw is replaced by the
numpy angles the port's probe gets, so both probe the same rays.

Tolerances: the lighting maths atol 1e-5 (transcendentals of two
libraries); transform_payload_affine atol 1e-6; the shadow plan's counts,
r2v and flag exactly, its rows and shaft spheres to f32 rounding
(rtol 2.5e-7: XLA contracts the payload transform's cross products into
FMAs, and K1's t differs from the twin's in the last bit, which moves the
probed hit points); lit frame means atol 2e-3, the JAX package's own lit
tolerance (tests/test_lighting.py:111).
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from compound_ray_tpu import config as jcfg  # noqa: E402
from compound_ray_tpu import native_ext  # noqa: E402
from compound_ray_tpu import testing as jtesting  # noqa: E402
from compound_ray_tpu.api.renderer import EyeRenderer as JaxRenderer  # noqa: E402
from compound_ray_tpu.cameras.types import CompoundEyeCamera as JaxEye  # noqa: E402
from compound_ray_tpu.eye import pipeline as JP  # noqa: E402
from compound_ray_tpu.scene.eye_io import Ommatidium  # noqa: E402
from compound_ray_tpu.scene.eye_io import ommatidia_to_array  # noqa: E402
from compound_ray_tpu.scene.flat import (  # noqa: E402
    build_scene_from_arrays as jbuild,
)
from compound_ray_tpu.trace import lighting as JL  # noqa: E402
from compound_ray_tpu.trace import mm_tracer as JM  # noqa: E402
from compound_ray_tpu_torch import EyeRenderer  # noqa: E402
from compound_ray_tpu_torch import config as tcfg  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera  # noqa: E402
from compound_ray_tpu_torch.eye import pipeline as TP  # noqa: E402
from compound_ray_tpu_torch.trace import lighting as TL  # noqa: E402
from compound_ray_tpu_torch.trace import mm_tracer as TM  # noqa: E402

MATH_ATOL = 1e-5
PLAN_RTOL = 2.5e-7
LIT_ATOL = 2e-3
POS = np.zeros(3, np.float32)
LS = np.eye(3, dtype=np.float32)


@pytest.fixture
def pinned(monkeypatch):
    old = jcfg.get_config()
    jcfg.set_config(dataclasses.replace(
        old, farfield="off", sky_split=False, affine_rays=False,
        shadow_rpb=1, lit_local_resolve=False, backend="pallas"))
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


def _jax_canopy_scene():
    """make_canopy_scene built with the JAX package's factory."""
    v1, f1 = jtesting.box_mesh((0.0, -1.0, 0.0), (20.0, 0.2, 20.0))
    v2, f2 = jtesting.box_mesh((3.0, 3.0, 0.0), (4.0, 0.2, 4.0))
    v3, f3 = jtesting.box_mesh((-4.0, 1.0, 0.0), (0.2, 4.0, 6.0))
    verts = np.concatenate([v1, v2, v3])
    faces = np.concatenate([f1, f2 + len(v1), f3 + len(v1) + len(v2)])
    return jbuild(verts, faces, base_color=(0.4, 0.5, 0.6),
                  background_shader="black")


def _scenes(name):
    """(JAX scene, port scene, ommatidia (N, 8), pose, lights)."""
    if name == "canopy":
        js, ts = _jax_canopy_scene(), ttesting.make_canopy_scene()
        omms = ommatidia_to_array(ttesting.canopy_eye(2.0))
        pos = POS
    else:
        js, ts = jtesting.make_mr_normal_scene(), \
            ttesting.make_mr_normal_scene()
        omms = ommatidia_to_array(jtesting.make_sphere_eye(24, 5.0))
        pos = np.array([0.0, 5.0, 0.0], np.float32)
    lights = JL.default_lights(js.aabb_min, js.aabb_max)
    return js, ts, omms, pos, lights


def _angles(omms_p, samples, seed):
    rng = np.random.default_rng(seed)
    sd = omms_p[:, 6] / JP.FWHM_SD_RATIO
    shape = (omms_p.shape[0], samples)
    splay = (rng.standard_normal(shape) * sd[:, None]).astype(np.float32)
    spin = (rng.uniform(size=shape) * np.pi).astype(np.float32)
    return splay, spin


class _Pair:
    """Both packages' plans, packs and first-frame shadow plans of one scene,
    eye and pose, the probe tracing the numpy angles of `probe_seed`."""

    def __init__(self, monkeypatch, js, ts, omms, pos, lights, samples,
                 probe_seed):
        self.js, self.ts, self.lights, self.samples = js, ts, lights, samples
        self.jsp, self.tsp = JP.scene_plan(js), TP.scene_plan(ts, "cpu")
        self.je, self.te = JP.eye_plan(omms, samples), TP.eye_plan(omms,
                                                                    samples)
        self.omms_p = omms[self.je.perm]
        self.jo = jnp.asarray(self.omms_p)
        self.to, _ = self.te.device_arrays(omms, "cpu")
        self.jpos, self.jls = jnp.asarray(pos), jnp.asarray(LS)
        self.tpos, self.tls = torch.as_tensor(pos), torch.as_tensor(LS)
        self.sig = (pos.tobytes(), LS.tobytes())
        kc, self.rmax = JP._plan_widths(self.jsp, self.je, self.jo,
                                        self.jpos, self.jls,
                                        (self.je.sig, samples, b"lit"))
        self.jrc, self.jpm, _, _ = JP._pack_fused(
            self.jsp.mm_flat, self.jsp.slot_center_cl,
            self.jsp.slot_radius_cl, self.jsp.half_center,
            self.jsp.half_radius, self.jo, self.jpos, self.jls, g=self.je.g,
            kcand=kc, rmax=self.rmax, cull_sigmas=4.0,
            tri_cl=self.jsp.slot_tri_cl)
        self.trc, self.tpm, *tw = TP._pack_fused(
            self.tsp.mm_flat, self.tsp.slot_center_cl,
            self.tsp.slot_radius_cl, self.tsp.half_center,
            self.tsp.half_radius, self.to, self.tpos, self.tls, g=self.te.g,
            kmin=kc, rmin=self.rmax, cull_sigmas=4.0,
            tri_cl=self.tsp.slot_tri_cl)
        assert tuple(tw) == (kc, self.rmax)
        self.probe = _angles(self.omms_p, samples, probe_seed)
        self.replan(monkeypatch)

    def replan(self, monkeypatch):
        """(Re)build both shadow plans from the probe angles."""
        splay, spin = self.probe
        monkeypatch.setattr(JP, "sample_angles_ns",
                            lambda key, sd, s: (jnp.asarray(splay),
                                                jnp.asarray(spin)))
        self.jplan = JP._shadow_plan(
            self.jsp, self.je, self.jo, self.jpos, self.jls, self.sig,
            self.lights, self.samples, jax.random.PRNGKey(0), self.jpm,
            self.jrc, self.rmax)
        self.tplan = TP._shadow_plan(
            self.tsp, self.te, self.to, self.tpos, self.tls, self.sig,
            self.lights, self.samples, torch.tensor(splay),
            torch.tensor(spin), self.tpm, self.trc, self.rmax)

    def frames(self, seed, audit=False):
        """Both packages' lit means (permuted order) from the numpy angles
        of `seed`, and their audits when asked."""
        splay, spin = _angles(self.omms_p, self.samples, seed)
        ep = self.je
        geo = dict(samples=self.samples, background=2, ng=ep.ng, g=ep.g,
                   nrb=ep.nrb, rb_size=ep.rb_size, rmax=self.rmax,
                   textured=self.jsp.textured, tex_only=self.jsp.tex_only)
        jc, jr2v, jflag, jflat, jsph = self.jplan
        want = JP._trace_shade_angles(
            self.jpm, self.jrc, self.jsp.attr_table,
            self.js.device_triangles(), self.jsp.quad_table, self.jo,
            self.jpos, self.jls, jnp.asarray(splay), jnp.asarray(spin),
            lights=jnp.asarray(self.lights), slot_tri=self.jsp.slot_tri,
            shadow_counts=jc, shadow_r2v=jr2v, shadow_flag=jflag,
            shadow_flat=jflat, shadow_sph=jsph, shadow_audit=audit,
            tex_static=self.jsp.tex_static, quad_gray=self.jsp.quad_gray,
            precision="highest", direct1=False, **geo)
        scene_dev = self.ts.device_triangles("cpu")
        got = TP._trace_shade_angles(
            self.tpm, self.trc, self.tsp.attr_table, scene_dev,
            self.tsp.quad_table, self.to, self.tpos, self.tls,
            torch.tensor(splay), torch.tensor(spin),
            lights=torch.as_tensor(self.lights), slot_tri=self.tsp.slot_tri,
            shading_rows=TP._shading_rows(self.tsp, scene_dev),
            shadow=self.tplan, shadow_audit=audit, **geo)
        if audit:
            return (np.asarray(want[0]), np.asarray(want[1]),
                    got[0].numpy(), got[1].numpy())
        return np.asarray(want), got.numpy()


def test_default_lights_equal():
    for lo, hi in ((np.zeros(3), np.ones(3) * 10),
                   (np.array([-50.0, -1.25, -50.0]),
                    np.array([50.0, 6.2, 50.0]))):
        want = JL.default_lights(lo, hi)
        got = TL.default_lights(lo, hi)
        assert got.dtype == np.float32 and got.shape == (4, 7)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["canopy", "mr_normal"])
def test_shading_rows_equal(name):
    js, ts, _, _, _ = _scenes(name)
    want = np.asarray(JL.build_shading_rows(js.device_triangles()))
    got = TL.build_shading_rows(ts.device_triangles("cpu"))
    assert got.shape == want.shape == (
        (js.num_triangles, 26) if name == "mr_normal"
        else (js.num_triangles, 18))
    np.testing.assert_array_equal(got.numpy(), want)
    tri = np.random.default_rng(1).integers(0, js.num_triangles, 40)
    jcols = JL.unpack_shading_cols(jnp.asarray(want[tri].T))
    tcols = TL.unpack_shading_cols(got[torch.as_tensor(tri)].t())

    def flat(cols):
        return [c for x in cols for c in (x if isinstance(x, tuple) else (x,))]

    assert len(flat(tcols)) == len(flat(jcols)) == 18
    for a, b in zip(flat(jcols), flat(tcols)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_material_keys_only_with_material_textures():
    plain = ttesting.make_textured_quad_scene().device_triangles("cpu")
    assert "mat_mr_tex" not in plain and "mat_normal_tex" not in plain
    mod = ttesting.make_mr_normal_scene().device_triangles("cpu")
    assert "mat_mr_tex" in mod and "mat_normal_tex" in mod


def test_ggx_planar_matches_jax():
    rng = np.random.default_rng(5)
    r = 256

    def unit(x):
        return x / np.linalg.norm(x, axis=0, keepdims=True)

    n = unit(rng.normal(size=(3, r))).astype(np.float32)
    view = unit(n + 0.8 * rng.normal(size=(3, r))).astype(np.float32)
    l = unit(n + 0.8 * rng.normal(size=(3, r))).astype(np.float32)
    base = rng.uniform(0.0, 1.0, (3, r)).astype(np.float32)
    metallic = rng.uniform(0.0, 1.0, r).astype(np.float32)
    roughness = rng.uniform(0.05, 1.0, r).astype(np.float32)
    lcol = np.array([1.0, 0.9, 0.8], np.float32)
    (jr, jg, jb), jf = JL.ggx_light_contrib_planar(
        tuple(jnp.asarray(x) for x in n), tuple(jnp.asarray(x) for x in view),
        tuple(jnp.asarray(x) for x in l), tuple(jnp.asarray(x) for x in base),
        jnp.asarray(metallic), jnp.asarray(roughness), jnp.asarray(lcol),
        jnp.float32(3.0))
    def planes(x):
        return tuple(torch.tensor(c) for c in x)

    (tr, tg, tb), tf = TL.ggx_light_contrib_planar(
        planes(n), planes(view), planes(l), planes(base),
        torch.tensor(metallic), torch.tensor(roughness), torch.tensor(lcol),
        torch.tensor(3.0))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tf.any() and not tf.all()
    for a, b in ((jr, tr), (jg, tg), (jb, tb)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=MATH_ATOL)


def test_material_textures_match_jax():
    js, ts = jtesting.make_mr_normal_scene(), ttesting.make_mr_normal_scene()
    jdev, tdev = js.device_triangles(), ts.device_triangles("cpu")
    rows = np.asarray(JL.build_shading_rows(jdev))
    rng = np.random.default_rng(7)
    r = 200
    tri = rng.integers(0, js.num_triangles, r)
    u = rng.uniform(0.0, 0.5, r).astype(np.float32)
    v = rng.uniform(0.0, 0.5, r).astype(np.float32)
    n = rng.normal(size=(r, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    metallic = rng.uniform(0.0, 1.0, r).astype(np.float32)
    roughness = rng.uniform(0.0, 1.0, r).astype(np.float32)
    want = JL.apply_material_textures_from_rows(
        jdev, jnp.asarray(rows[tri]), jnp.asarray(n), jnp.asarray(metallic),
        jnp.asarray(roughness), jnp.asarray(u), jnp.asarray(v))
    got = TL.apply_material_textures_from_rows(
        tdev, torch.tensor(rows[tri]), torch.tensor(n),
        torch.tensor(metallic), torch.tensor(roughness), torch.tensor(u),
        torch.tensor(v))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=MATH_ATOL)
    # the maps act: the left half of the quad (u < 0.5 in texture space)
    # modulates roughness, so some rays differ from the inputs
    assert np.abs(got[2].numpy() - roughness).max() > 1e-3


def test_transform_payload_affine_matches_jax():
    rng = np.random.default_rng(9)
    pm = rng.uniform(-1.0, 1.0, (3, 2, 16, 512)).astype(np.float32)
    o = rng.uniform(-1.0, 1.0, (3, 3)).astype(np.float32)
    tmin = rng.uniform(0.0, 0.5, 3).astype(np.float32)
    want = np.asarray(JM.transform_payload_affine(
        jnp.asarray(pm), jnp.asarray(o), jnp.asarray(tmin)))
    got = TM.transform_payload_affine(torch.tensor(pm), torch.tensor(o),
                                      torch.tensor(tmin)).numpy()
    assert got.shape == pm.shape
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(got[:, :, 8:], pm[:, :, 8:])
    np.testing.assert_array_equal(got[:, :, 4:8], 0.0)


def _group_columns(counts, flat):
    """Per virtual group, its live occluder columns (the 8 feature rows of
    the four column blocks, 32 values each), sorted: the any-hit result
    does not depend on the order, and equal distances may pack in another
    order than the JAX package's unstable co-sort."""
    out, row = [], 0
    for c in counts.reshape(-1):
        cols = (flat[row:row + c].reshape(c, 8, 4, 128)
                .transpose(0, 3, 1, 2).reshape(-1, 32))
        cols = cols[np.any(cols != 0.0, axis=1)]
        key = np.round(cols, 3)
        out.append(cols[np.lexsort(key.T[::-1])])
        row += c
    return out


def _assert_plans_equal(jplan, tplan):
    jc, jr2v, jflag, jflat, jsph = (np.asarray(x) for x in jplan)
    tc, tr2v, tflag, tflat, tsph = (x.numpy() for x in tplan)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tr2v, jr2v)
    np.testing.assert_array_equal(tflag, jflag)
    assert tflat.shape == jflat.shape
    np.testing.assert_array_equal(tflat[int(tc.sum()):], 0.0)
    for a, b in zip(_group_columns(jc, jflat), _group_columns(tc, tflat)):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=PLAN_RTOL, atol=1e-6)
    np.testing.assert_allclose(tsph, jsph, rtol=PLAN_RTOL, atol=1e-6)


def test_shadow_plan_matches_jax(pinned):
    js, ts, omms, pos, lights = _scenes("canopy")
    p = _Pair(pinned, js, ts, omms, pos, lights, 64, probe_seed=3)
    _assert_plans_equal(p.jplan, p.tplan)
    counts, r2v, flag, flat, sph = p.tplan
    assert flat.shape[0] % 64 == 0 and flat.shape[1:] == (8, 512)
    rows = int(counts.sum())
    assert rows > 0 and (flag[:rows] > 0).all() and not flag[rows:].any()
    # padding rows inherit the last live group
    assert (r2v[rows:] == r2v[rows - 1]).all()
    # the plan is memoised: the same key serves the same tuple
    again = TP._shadow_plan(p.tsp, p.te, p.to, p.tpos, p.tls, p.sig,
                            lights, 64, None, None, p.tpm, p.trc, p.rmax)
    assert again is p.tplan


def test_sound_shadow_plans_match_jax(pinned):
    """The corrective modes: guaranteed bounds for some groups, then for
    every group, in both packages."""
    js, ts, omms, pos, lights = _scenes("canopy")
    p = _Pair(pinned, js, ts, omms, pos, lights, 64, probe_seed=3)
    for groups in ([1, 4], None):
        assert JP.mark_shadow_unsound(js, leak_groups=groups)
        assert TP.mark_shadow_unsound(ts, leak_groups=groups)
        assert not p.tsp.shadow_store
        p.replan(pinned)
        _assert_plans_equal(p.jplan, p.tplan)
    assert p.tsp.shadow_sound_all and p.tsp.shadow_unsound_groups == {1, 4}


@pytest.mark.parametrize("name", ["canopy", "mr_normal"])
def test_lit_trace_shade_angles_matches_jax(pinned, name):
    js, ts, omms, pos, lights = _scenes(name)
    p = _Pair(pinned, js, ts, omms, pos, lights, 64, probe_seed=3)
    for seed in (3, 4):  # the probe's own frame, then a later one
        want, got = p.frames(seed)
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=LIT_ATOL)
    # light does something here: some ommatidia exceed their base colour
    assert got.max() > (0.7 if name == "canopy" else 0.3)


def _bench_like(pkg_testing, eye_cls, n_omm, accept_rad):
    scene = pkg_testing.make_big_scene(n_boxes=60, seed=5)
    eye = pkg_testing.make_sphere_eye(n_omm, np.degrees(accept_rad))
    cam = eye_cls("eye", "single_dimension_fast", eye)
    scene.cameras.append(cam)
    c = scene.aabb_center()
    cam.set_position((float(c[0]), float(c[1]) + 1.0, float(c[2])))
    return scene


def test_eye_renderer_lit_matches_jax_end_to_end(pinned):
    """set_lighting(True) with the default lights at the bench protocol's
    pose, cut to a 60-box scene, 32 ommatidia and 48 samples; an
    acceptance of 1e-6 rad makes the two packages' angle draws
    immaterial."""
    jr = JaxRenderer(verbose=False)
    jr.scene = _bench_like(jtesting, JaxEye, 32, 1e-6)
    jr._lights = JL.default_lights(jr.scene.aabb_min, jr.scene.aabb_max)
    jr.goto_camera(len(jr.scene.cameras) - 1)
    jr.set_current_eye_samples_per_ommatidium(48)
    jr.set_lighting(True)
    jr.render_frame()
    want = jr.get_camera_data()

    tr = EyeRenderer(verbose=False, device="cpu")
    tr.scene = _bench_like(ttesting, CompoundEyeCamera, 32, 1e-6)
    np.testing.assert_array_equal(tr.get_lights(), jr._lights)
    tr.goto_camera(len(tr.scene.cameras) - 1)
    tr.set_current_eye_samples_per_ommatidium(48)
    tr.set_lighting(True)
    tr.render_frame()
    got = tr.get_camera_data()
    assert got.shape == (32, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=LIT_ATOL)
    assert got.max() > 1.0, "GGX adds unclamped light"
    tr.set_lighting(False)
    tr.render_frame()
    assert (got >= tr.get_camera_data() - 1e-6).all()


# the adversarial leak geometry of tests/test_shadow_leak.py:33-41
SIGMA = 0.03
ACCEPT = SIGMA * 2.3548
PILLAR_HALF_W = 2.0 * np.tan(2.6 * SIGMA)


def _edge_eye(n=32):
    omms = []
    for i in range(n):
        d = np.array([0.0, (i - n / 2) * 0.002, -1.0])
        omms.append(Ommatidium(np.zeros(3), d / np.linalg.norm(d), ACCEPT,
                               0.0))
    return ommatidia_to_array(omms)


def test_shadow_audit_matches_jax_and_corrects(pinned):
    js = jtesting.make_silhouette_leak_scene(pillar_half_width=PILLAR_HALF_W)
    ts = ttesting.make_silhouette_leak_scene(pillar_half_width=PILLAR_HALF_W)
    lights = ttesting.leak_scene_light()
    np.testing.assert_array_equal(lights, jtesting.leak_scene_light())
    p = _Pair(pinned, js, ts, _edge_eye(), POS, lights, 64, probe_seed=100)
    _assert_plans_equal(p.jplan, p.tplan)
    leaked = None
    for seed in range(8):
        jm, ja, tm, ta = p.frames(seed, audit=True)
        np.testing.assert_array_equal(ta, ja)
        assert ta.shape == (2 + p.te.ng,) and ta[1] > 0
        assert ta[0] == ta[2:].sum()
        np.testing.assert_allclose(tm, jm, atol=LIT_ATOL)
        if ta[0] > 0 and leaked is None:
            leaked = ta
    assert leaked is not None, "the geometry produced no leak to correct"
    # the renderer's hook: below the tolerance it only warns; at or above
    # it the leaking groups replan and the memoised plans go
    r = EyeRenderer(verbose=False, device="cpu")
    r.scene = ts
    assert p.tsp.shadow_store
    r._check_shadow_audit(np.asarray([1, 10 ** 6] + [0] * p.te.ng))
    assert p.tsp.shadow_store and not p.tsp.shadow_unsound_groups
    assert leaked[0] / leaked[1] >= tcfg.get_config().shadow_leak_tolerance
    r._check_shadow_audit(leaked)
    assert not p.tsp.shadow_store
    assert p.tsp.shadow_unsound_groups == set(np.nonzero(leaked[2:])[0])
    assert not p.tsp.shadow_sound_all
    # a tail-less audit flips the whole scene
    r._check_shadow_audit(np.asarray([1, 50]))
    assert p.tsp.shadow_sound_all
    assert not TP.mark_shadow_unsound(ts)  # already flipped


def test_lit_and_cache_frames_do_not_share_plans(monkeypatch):
    """At one pose a lit frame plans the dense pack with no cache and the
    unlit cache frame its near-masked pack with a cache: neither is served
    the other's plan, and each renders what it renders alone."""
    monkeypatch.setattr(TP, "_eye_plans", {})
    monkeypatch.setattr(tcfg, "_global_config", tcfg.RenderConfig(
        farfield="auto", farfield_cache_width=64))
    omms = ommatidia_to_array(ttesting.make_sphere_eye(64, 4.0))
    pos = np.array([0.0, 2.0, 0.0], np.float32)

    def frame(scene, lights, seed=1):
        gen = torch.Generator().manual_seed(seed)
        return TP.render_means(scene, scene.device_triangles("cpu"), omms,
                               pos, LS, gen, 128, 3, lights=lights).numpy()

    scene = ttesting.make_big_scene(200, seed=11)
    lights = TL.default_lights(scene.aabb_min, scene.aabb_max)
    cache_frame = frame(scene, None)
    splan = TP.scene_plan(scene, "cpu")
    assert len(splan.cache_store) == 1 and len(splan.packed_store) == 1
    lit = frame(scene, lights)
    assert len(splan.packed_store) == 2 and len(splan.shadow_store) == 1
    assert len(splan.cache_store) == 1, "the lit frame must not add a cache"
    keys = list(splan.packed_store)
    assert {k[3] for k in keys} == {True, False}  # use_cache
    np.testing.assert_array_equal(frame(scene, None), cache_frame)
    fresh = ttesting.make_big_scene(200, seed=11)
    np.testing.assert_array_equal(frame(fresh, lights), lit)
    assert not TP.scene_plan(fresh, "cpu").cache_store


def test_shadow_config_and_store_bound(monkeypatch):
    """The lit settings read the JAX package's env names, and the shadow
    store keeps at most shadow_store_size plans (a new light set replans
    once and evicts the oldest)."""
    for name, value in (("CR_TPU_SHADOW_STORE", "1"),
                        ("CR_TPU_SHADOW_LEAK_TOL", "0.01"),
                        ("CR_TPU_SHADOW_CHUNK", "8")):
        monkeypatch.setenv(name, value)
    cfg = tcfg.RenderConfig.from_env()
    assert (cfg.shadow_store_size, cfg.shadow_leak_tolerance,
            cfg.shadow_pack_chunk) == (1, 0.01, 8)
    with pytest.raises(ValueError, match="shadow_store_size"):
        tcfg.RenderConfig(shadow_store_size=0)
    monkeypatch.setattr(tcfg, "_global_config", dataclasses.replace(
        cfg, farfield="off"))
    monkeypatch.setattr(TP, "_eye_plans", {})
    r = EyeRenderer(verbose=False, device="cpu")
    r.scene = ttesting.make_canopy_scene()
    r.scene.cameras.append(CompoundEyeCamera(
        "e", "single_dimension_fast", ttesting.canopy_eye(2.0)))
    r.set_current_eye_samples_per_ommatidium(32)
    r.set_lighting(True)
    r.render_frame()
    splan = TP.scene_plan(r.scene, "cpu")
    first = next(iter(splan.shadow_store))
    lights = r.get_lights()
    lights[:, 3] *= 2.0
    r.set_lights(lights)
    r.render_frame()
    assert len(splan.shadow_store) == 1 and first not in splan.shadow_store
    assert r.last_shadow_audit is not None and r.last_shadow_audit[1] > 0
