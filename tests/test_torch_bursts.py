"""Port: frame bursts (render_means_frames and
EyeRenderer.render_frames_pipelined).

1. The frame core with frames = F: the port's and the JAX package's
   _trace_shade_angles(frames=F) on one carried-across pack and the same
   stacked numpy angles (column f * S + s is frame f's sample s), at the
   tolerance of tests/test_torch_frame.py (max abs 2e-4), dense and under
   the sky split.  Both take the port's burst layout (one ray block per
   group, padded to 256 rays).
2. tests/test_pipelined_scan.py:26-83 on the port: a burst equals as many
   render_frame() calls bit for bit (means and display buffer, unlit and
   lit), the RNG stream carries across a burst, and the stacked burst (one
   K1 launch) equals the scanned one (one per frame).
3. tests/test_sky_split.py:155-180: a sky-split burst equals sequential
   frames bit for bit.
4. tests/test_pose_stream.py:52-74: an unsynced pose stream equals the
   synced one.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from compound_ray_tpu import config as jcfg  # noqa: E402
from compound_ray_tpu import testing as jtesting  # noqa: E402
from compound_ray_tpu.eye import pipeline as JP  # noqa: E402
from compound_ray_tpu.scene.eye_io import ommatidia_to_array  # noqa: E402
from compound_ray_tpu.trace.shade import miss_id  # noqa: E402
from compound_ray_tpu_torch import EyeRenderer  # noqa: E402
from compound_ray_tpu_torch import config as tcfg  # noqa: E402
from compound_ray_tpu_torch import interop  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.api.renderer import frame_seed  # noqa: E402
from compound_ray_tpu_torch.cameras.types import (  # noqa: E402
    CompoundEyeCamera,
    PerspectiveCamera,
)
from compound_ray_tpu_torch.eye import pipeline as TP  # noqa: E402
from compound_ray_tpu_torch.trace.lighting import default_lights  # noqa: E402
from test_torch_farfield import (  # noqa: E402
    BG,
    LS,
    POS,
    WIDTH,
    _configs,
    _farfield_both,
    _frames,
    _packs,
    _pair,
    pinned,  # noqa: F401 (a fixture)
)

ATOL = 2e-4
FRAMES = 3


@pytest.fixture
def jax_unlit(monkeypatch):
    old = jcfg.get_config()
    jcfg.set_config(dataclasses.replace(
        old, farfield="off", sky_split=False, affine_rays=False,
        backend="pallas"))
    monkeypatch.setattr(tcfg, "_global_config",
                        tcfg.RenderConfig(farfield="off"))
    yield
    jcfg.set_config(old)


def _stacked_angles(n, samples, frames, seed):
    """(n, F * S) splay and spin, frame f's S columns drawn in turn."""
    rng = np.random.default_rng(seed)
    shape = (n, frames * samples)
    return ((rng.standard_normal(shape) * 0.03).astype(np.float32),
            (rng.uniform(size=shape) * np.pi).astype(np.float32))


def _burst_layout(g, samples, frames):
    return dict(samples=frames * samples, nrb=1,
                rb_size=-(-g * frames * samples // 256) * 256)


def test_stacked_frame_core_matches_jax(jax_unlit):
    """The box scene, 24 ommatidia at 6 degrees, 8 samples x 3 frames."""
    samples = 8
    js, ts = jtesting.make_box_scene(), ttesting.make_box_scene()
    omms = ommatidia_to_array(jtesting.make_sphere_eye(24, 6.0))
    splan = JP.scene_plan(js)
    eplan = JP.eye_plan(omms, samples)
    omms_p = omms[eplan.perm]
    jpos = jnp.asarray([0.0, 1.5, 3.0], jnp.float32)
    jls = jnp.eye(3, dtype=jnp.float32)
    kcand, rmax = JP._plan_widths(splan, eplan, jnp.asarray(omms_p), jpos,
                                  jls, (eplan.sig, samples, b"burst"))
    rc, pmm, _, _ = JP._pack_fused(
        splan.mm_flat, splan.slot_center_cl, splan.slot_radius_cl,
        splan.half_center, splan.half_radius, jnp.asarray(omms_p), jpos, jls,
        g=eplan.g, kcand=kcand, rmax=rmax, cull_sigmas=4.0,
        tri_cl=splan.slot_tri_cl)
    assert (np.asarray(rc) > 0).any(), "the pose must see geometry"
    splay, spin = _stacked_angles(omms_p.shape[0], samples, FRAMES, seed=5)
    geo = dict(background=miss_id(js.background_shader), ng=eplan.ng,
               g=eplan.g, rmax=rmax, textured=splan.textured,
               tex_only=splan.tex_only, frames=FRAMES,
               **_burst_layout(eplan.g, samples, FRAMES))
    want = np.asarray(JP._trace_shade_angles(
        pmm, rc, splan.attr_table, js.device_triangles(), splan.quad_table,
        jnp.asarray(omms_p), jpos, jls, jnp.asarray(splay),
        jnp.asarray(spin), tex_static=splan.tex_static,
        quad_gray=splan.quad_gray, precision="highest", direct1=False,
        **geo))
    tplan = interop.scene_plan_from_arrays(
        "cpu", **{k: np.asarray(getattr(splan, k)) for k in (
            "mm_flat", "attr_table", "slot_center_cl", "slot_radius_cl",
            "slot_tri_cl", "half_center", "half_radius", "quad_table",
            "payload", "sphere_center_np", "sphere_radius_np")},
        textured=splan.textured, tex_only=splan.tex_only)
    trc, tpm = interop.packed_from_arrays(rc, pmm, "cpu")
    got = TP._trace_shade_angles(
        tpm, trc, tplan.attr_table, ts.device_triangles("cpu"),
        tplan.quad_table, torch.tensor(omms_p),
        torch.tensor(np.asarray(jpos)), torch.eye(3), torch.tensor(splay),
        torch.tensor(spin), **geo).numpy()
    assert got.shape == want.shape == (omms_p.shape[0], FRAMES, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # each frame's means are that frame's single-frame core on its columns
    for f in (0, FRAMES - 1):
        cols = slice(f * samples, (f + 1) * samples)
        one = TP._trace_shade_angles(
            tpm, trc, tplan.attr_table, ts.device_triangles("cpu"),
            tplan.quad_table, torch.tensor(omms_p),
            torch.tensor(np.asarray(jpos)), torch.eye(3),
            torch.tensor(splay[:, cols]), torch.tensor(spin[:, cols]),
            samples=samples, background=geo["background"], ng=eplan.ng,
            g=eplan.g, nrb=eplan.nrb, rb_size=eplan.rb_size, rmax=rmax,
            textured=splan.textured, tex_only=splan.tex_only).numpy()
        np.testing.assert_array_equal(got[:, f], one)


def test_stacked_frame_core_with_the_sky_split_matches_jax(pinned):
    """tests/test_torch_farfield.py's sky-split setup (32 clusters, 64
    ommatidia, 128 samples, a 64-wide cache) with 3 stacked frames: the
    live groups' means scattered over the frame-invariant sky means.  As
    there, both packages read the port's cache and keep every near hit
    (the port's far-field sphere at an infinite radius)."""
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
    (jpm, jrc, jo, jscatter, jmeans, jngl, _, _) = jsky
    (tpm, trc, to, tscatter, tmeans, tngl, _, _) = tsky
    splay, spin = _stacked_angles(tngl, p.samples, FRAMES, seed=4)
    want, got = _frames(p, (jrc, jpm), (trc, tpm), jcache, tcache, rmax,
                        tngl, (jo, to), splay, spin,
                        sky=(jmeans, jscatter, tmeans, tscatter),
                        frames=FRAMES, far_sphere=(centre, math.inf))
    assert got.shape == (64, FRAMES, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the sky groups hold their expectation in every frame
    sky_rows = np.setdiff1d(np.arange(64), tscatter.numpy())
    assert sky_rows.size > 0
    for f in range(FRAMES):
        np.testing.assert_array_equal(got[sky_rows, f],
                                      tmeans.numpy()[sky_rows])


def _renderer(lighting=False, samples=7):
    """tests/test_pipelined_scan.py's renderer on the port."""
    r = EyeRenderer(verbose=False, device="cpu")
    r.scene = ttesting.make_box_scene()
    cam = CompoundEyeCamera("eye", "spherical_positionwise",
                            ttesting.make_sphere_eye(64))
    cam.set_samples_per_ommatidium(samples)
    r.scene.cameras.append(cam)
    r.goto_camera(len(r.scene.cameras) - 1)
    r.set_render_size(16, 8)
    if lighting:
        r._lights = default_lights(r.scene.aabb_min, r.scene.aabb_max)
        r.set_lighting(True)
    return r


def _count(monkeypatch, name):
    """Count the calls of pipeline.<name> (K1 or K3 or their twins)."""
    calls = []
    real = getattr(TP, name)

    def counted(*a, **k):
        calls.append(k.get("rb_size"))
        return real(*a, **k)

    monkeypatch.setattr(TP, name, counted)
    return calls


@pytest.mark.parametrize("lit", [False, True], ids=["unlit", "lit"])
def test_burst_matches_sequential_frames(lit, monkeypatch):
    seq = _renderer(lit)
    assert seq._scan_frames_ok() and seq._burst_route() == "pallas"
    for _ in range(FRAMES):
        seq.render_frame()
    burst = _renderer(lit)
    k1 = _count(monkeypatch, "run_packed_tracer")
    k3 = _count(monkeypatch, "run_rows_occlusion")
    ms = burst.render_frames_pipelined(FRAMES)
    # one K1 launch over 3 x 7 samples per ommatidium (plus the shadow
    # plan's probe of frame 0 when lit), one K3 launch
    assert len(k1) == (2 if lit else 1) and len(k3) == (1 if lit else 0)
    g = TP.eye_plan(burst.current_camera().ommatidia, 7).g
    assert k1[-1] == -(-g * FRAMES * 7 // 256) * 256
    np.testing.assert_array_equal(seq.get_camera_data(),
                                  burst.get_camera_data())
    np.testing.assert_array_equal(seq.get_frame_pointer(),
                                  burst.get_frame_pointer())
    assert (burst.current_camera().rng_frame
            == seq.current_camera().rng_frame == FRAMES)
    # a burst records no per-frame time
    assert ms > 0 and burst.frame_time_stats() == {"count": 0}


def test_burst_then_sequential_keeps_rng_stream():
    seq = _renderer()
    for _ in range(3):
        seq.render_frame()
    mixed = _renderer()
    mixed.render_frames_pipelined(2)
    mixed.render_frame()
    np.testing.assert_array_equal(seq.get_camera_data(),
                                  mixed.get_camera_data())


def test_stacked_burst_matches_scanned(monkeypatch):
    stacked = _renderer(samples=8)
    stacked.render_frames_pipelined(FRAMES)
    monkeypatch.setattr(TP, "STACK_BURST_MAX_SAMPLES", 0)
    k1 = _count(monkeypatch, "run_packed_tracer")
    scanned = _renderer(samples=8)
    scanned.render_frames_pipelined(FRAMES)
    g = TP.eye_plan(scanned.current_camera().ommatidia, 8).g
    assert k1 == [-(-g * 8 // 256) * 256] * FRAMES  # the frame's own blocks
    np.testing.assert_array_equal(stacked.get_camera_data(),
                                  scanned.get_camera_data())
    np.testing.assert_array_equal(stacked.get_frame_pointer(),
                                  scanned.get_frame_pointer())


def test_burst_route():
    """Raw samples, backend "naive" and a real camera render frame by
    frame; n = 0 renders nothing."""
    r = _renderer()
    r.render_frames_pipelined(0)
    assert r.current_camera().rng_frame == 0
    r.set_current_eye_shader_name("raw_ommatidial_samples")
    assert r._burst_route() is None
    r.render_frames_pipelined(2)
    assert r.current_camera().rng_frame == 2
    assert r.frame_time_stats()["count"] == 2  # the per-frame loop's
    r.set_current_eye_shader_name("spherical_positionwise")
    assert r._burst_route() == "pallas"
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tcfg, "_global_config", tcfg.RenderConfig(backend="naive"))
        assert r._burst_route() is None
    r.scene.cameras.append(PerspectiveCamera("pinhole"))
    r.goto_camera(len(r.scene.cameras) - 1)
    assert r._burst_route() is None and not r._scan_frames_ok()


def test_sky_split_burst_matches_sequential(pinned):
    """tests/test_sky_split.py:155-180: three frames at 128 samples with
    the split active, as sequential frames and as one burst."""
    tcfg.set_config(_configs(sky_split=True)[1])
    p = _pair()
    gens = [torch.Generator().manual_seed(frame_seed(0, i))
            for i in (3, 4, 5)]
    args = (p.ts, p.tdev, p.omms, POS, LS)
    seq = np.stack([TP.render_means(*args, gens[i], p.samples, BG).numpy()
                    for i in range(3)])
    assert [v for v in p.tsp.sky_store.values() if v is not None], (
        "the split must engage")
    for i, gen in enumerate(gens):
        gen.manual_seed(frame_seed(0, 3 + i))
    burst = TP.render_means_frames(*args, gens, p.samples, BG).numpy()
    assert burst.shape == (3, 64, 3)
    np.testing.assert_array_equal(seq, burst)


def test_pose_stream_matches_synced():
    """tests/test_pose_stream.py:52-74 on the port: render_frame(sync=False)
    per pose and one sync() leave the synced loop's last frame."""
    rng = np.random.default_rng(0)
    poses = [(0.0, 2.0, 0.0)] + [
        tuple(np.float64([0.0, 2.0, 0.0]) + rng.uniform(-0.5, 0.5, 3))
        for _ in range(3)]

    def renderer():
        r = EyeRenderer(verbose=False, device="cpu")
        r.scene = ttesting.make_big_scene(n_boxes=60, seed=3)
        r.scene.cameras.append(CompoundEyeCamera(
            "eye", "single_dimension_fast",
            ttesting.make_sphere_eye(64, acceptance_deg=4.0)))
        r.set_render_size(64, 1)
        r.require_noncompound_pipeline = False
        r.set_current_eye_samples_per_ommatidium(8)
        return r

    r1, r2 = renderer(), renderer()
    for p in poses:
        r1.current_camera().set_position(p)
        r1.render_frame()
    for p in poses:
        r2.current_camera().set_position(p)
        r2.render_frame(sync=False)
    r2.sync()
    np.testing.assert_array_equal(r1.get_camera_data(),
                                  r2.get_camera_data())
