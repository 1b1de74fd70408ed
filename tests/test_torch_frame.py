"""Port vs JAX: the unlit compound-eye frame, and the port's boundaries.

1. _trace_shade_angles on the same pose pack (carried across with
   compound_ray_tpu_torch.interop) and the same numpy splay/spin angles:
   the means, and with want_samples the samples before the mean.
2. EyeRenderer end to end, each package with its own RNG: an acceptance
   angle of 1e-6 rad makes every sample of an ommatidium the same ray, so
   the two draws do not matter.
Both at max abs 2e-4 on the means (the tolerance of tests/test_emit_flat.py).
Both packages run with the far field off (tests/test_torch_farfield.py
holds the cache); the JAX side also with the sky split and affine rays off and
K1 at precision "highest" (the port's f32 contract); its emit mode follows
the scene (uv/uvs/flat/bary), the port always emits bary.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from compound_ray_tpu import config as jcfg  # noqa: E402
from compound_ray_tpu import testing as jtesting  # noqa: E402
from compound_ray_tpu.api.renderer import EyeRenderer as JaxRenderer  # noqa: E402
from compound_ray_tpu.cameras.types import CompoundEyeCamera as JaxEye  # noqa: E402
from compound_ray_tpu.eye import pipeline as JP  # noqa: E402
from compound_ray_tpu.scene.eye_io import ommatidia_to_array  # noqa: E402
from compound_ray_tpu.trace.shade import miss_id  # noqa: E402
from compound_ray_tpu_torch import EyeRenderer  # noqa: E402
from compound_ray_tpu_torch import config as tcfg  # noqa: E402
from compound_ray_tpu_torch import interop  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.cameras.types import (  # noqa: E402
    CompoundEyeCamera,
    PerspectiveCamera,
)
from compound_ray_tpu_torch.eye import pipeline as TP  # noqa: E402

ATOL = 2e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# (factory name, kwargs, eye position, ommatidia, acceptance deg, samples)
CASES = [
    ("make_box_scene", {}, (0.0, 1.5, 3.0), 24, 6.0, 64),
    ("make_textured_quad_scene", {}, (0.0, 5.0, 0.0), 24, 5.0, 128),
    ("make_mixed_flat_scene", {}, (0.0, 5.0, 0.0), 24, 5.0, 96),
    ("make_two_texture_scene", {}, (0.0, 5.0, 0.0), 24, 5.0, 200),
    ("make_big_scene", {"n_boxes": 60, "seed": 5}, (0.0, 2.0, 0.0), 16,
     20.0, 640),
]


def _shared_angle_frames(case, want_samples: bool):
    """The JAX and the port's _trace_shade_angles on one pose pack (carried
    across) and the same numpy angles: (port result, JAX result)."""
    name, kwargs, pos, n_omm, accept, samples = case
    js = getattr(jtesting, name)(**kwargs)
    ts = getattr(ttesting, name)(**kwargs)
    omms = ommatidia_to_array(jtesting.make_sphere_eye(n_omm, accept))
    splan = JP.scene_plan(js)
    eplan = JP.eye_plan(omms, samples)
    omms_p = omms[eplan.perm]
    jpos = jnp.asarray(np.asarray(pos, np.float32))
    jls = jnp.eye(3, dtype=jnp.float32)
    kcand, rmax = JP._plan_widths(splan, eplan, jnp.asarray(omms_p), jpos,
                                  jls, (eplan.sig, samples, name.encode()))
    rc, pmm, _, _ = JP._pack_fused(
        splan.mm_flat, splan.slot_center_cl, splan.slot_radius_cl,
        splan.half_center, splan.half_radius, jnp.asarray(omms_p), jpos, jls,
        g=eplan.g, kcand=kcand, rmax=rmax, cull_sigmas=4.0,
        tri_cl=splan.slot_tri_cl)
    assert (np.asarray(rc) > 0).any(), "the pose must see geometry"
    rng = np.random.default_rng(11)
    sd = omms_p[:, 6] / JP.FWHM_SD_RATIO
    shape = (omms_p.shape[0], samples)
    splay = (rng.standard_normal(shape) * sd[:, None]).astype(np.float32)
    spin = (rng.uniform(size=shape) * np.pi).astype(np.float32)
    bg = miss_id(js.background_shader)
    geo = dict(samples=samples, background=bg, ng=eplan.ng, g=eplan.g,
               nrb=eplan.nrb, rb_size=eplan.rb_size, rmax=rmax,
               textured=splan.textured, tex_only=splan.tex_only,
               want_samples=want_samples)
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
        tplan.quad_table, torch.tensor(omms_p), torch.tensor(np.asarray(jpos)),
        torch.eye(3), torch.tensor(splay), torch.tensor(spin), **geo).numpy()
    return got, want


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_trace_shade_angles_matches_jax(jax_unlit, case):
    got, want = _shared_angle_frames(case, want_samples=False)
    assert got.shape == (want.shape[0], 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_trace_shade_angles_samples_match_jax(jax_unlit, case):
    """want_samples: the (Np, S, 3) samples before the mean, which the raw
    projection reads (compound_ray_tpu/eye/pipeline.py:1516-1517)."""
    got, want = _shared_angle_frames(case, want_samples=True)
    assert got.shape == want.shape == (want.shape[0], case[5], 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _bench_like(pkg_testing, eye_cls, n_omm, accept_rad):
    scene = pkg_testing.make_big_scene(n_boxes=60, seed=5)
    eye = pkg_testing.make_sphere_eye(n_omm, np.degrees(accept_rad))
    cam = eye_cls("eye", "single_dimension_fast", eye)
    scene.cameras.append(cam)
    c = scene.aabb_center()
    cam.set_position((float(c[0]), float(c[1]) + 1.0, float(c[2])))
    return scene


def test_eye_renderer_matches_jax_end_to_end(jax_unlit):
    """The bench protocol's pose (scene AABB centre + 1 in y, last camera),
    cut to a 60-box scene, 32 ommatidia and 48 samples."""
    jr = JaxRenderer(verbose=False)
    jr.scene = _bench_like(jtesting, JaxEye, 32, 1e-6)
    jr.goto_camera(len(jr.scene.cameras) - 1)
    jr.set_current_eye_samples_per_ommatidium(48)
    jr.render_frame()
    want = jr.get_camera_data()

    tr = EyeRenderer(verbose=False, device="cpu")
    tr.scene = _bench_like(ttesting, CompoundEyeCamera, 32, 1e-6)
    tr.goto_camera(len(tr.scene.cameras) - 1)
    assert tr.is_compound_eye_active()
    tr.set_current_eye_samples_per_ommatidium(48)
    ms = tr.render_frame()
    got = tr.get_camera_data()
    assert ms > 0 and tr.frame_times_ms == [ms]
    assert got.shape == (32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_eye_renderer_frames_advance_the_rng(jax_unlit):
    tr = EyeRenderer(verbose=False, device="cpu")
    tr.scene = _bench_like(ttesting, CompoundEyeCamera, 16, np.radians(5.0))
    tr.goto_camera(len(tr.scene.cameras) - 1)
    tr.set_current_eye_samples_per_ommatidium(32)
    tr.render_frame()
    a = tr.get_camera_data().copy()
    tr.render_frame()
    b = tr.get_camera_data().copy()
    assert not np.array_equal(a, b), "frames must draw new angles"
    assert np.isfinite(a).all() and a.min() >= 0 and a.max() <= 1 + 1e-5
    # resetting the sample count restarts the eye's stream (the reference
    # re-initialises its curand states there)
    tr.set_current_eye_samples_per_ommatidium(32)
    tr.render_frame()
    np.testing.assert_array_equal(tr.get_camera_data(), a)


def test_eye_renderer_refuses_what_is_not_ported(tmp_path):
    """A .blend scene loads (scene/blend.py) and a file that is not one
    raises ValueError.  A real camera at a non-zero render size and raw
    samples with lighting on render (the brute-force oracle on this
    36-triangle scene)."""
    tr = EyeRenderer(verbose=False, device="cpu")
    with pytest.raises(RuntimeError):
        tr.render_frame()
    path = ttesting.write_blend(
        str(tmp_path / "scene.blend"),
        ttesting.big_scene_blend_meshes(n_boxes=2, seed=0))
    tr.load_gltf_scene(path)
    assert tr.scene.num_triangles == 36 and tr.get_lights().shape == (4, 7)
    (tmp_path / "junk.blend").write_bytes(b"not a blender file" * 4)
    with pytest.raises(ValueError, match="not a .blend"):
        tr.load_gltf_scene(str(tmp_path / "junk.blend"))
    tr = EyeRenderer(verbose=False, device="cpu")
    with pytest.raises(RuntimeError, match="lights"):
        tr.get_lights()  # lights come with a scene
    for bad in (np.zeros((4, 6)), np.zeros(7), np.zeros((0, 7))):
        with pytest.raises(ValueError, match="lights"):
            tr.set_lights(bad)
    tr.scene = ttesting.make_box_scene()
    tr.scene.cameras.append(PerspectiveCamera("pinhole"))
    tr.render_frame()  # size 0 x 0: nothing to render, as in the JAX package
    tr.set_render_size(16, 8)
    tr.set_require_noncompound_pipeline(False)
    tr.render_frame()  # the display pipeline is not required
    tr.set_require_noncompound_pipeline(True)
    tr.render_frame()
    frame = tr.get_frame_pointer()
    assert frame.shape == (8, 16, 4) and (frame[..., 3] == 255).all()
    tr.scene.cameras.append(CompoundEyeCamera(
        "raw", "raw_ommatidial_samples", ttesting.make_sphere_eye(4)))
    tr.next_camera()
    assert tr.is_compound_eye_active()
    tr.render_frame()  # raw samples, unlit
    assert tr.get_frame_pointer().shape == (8, 16, 4)
    unlit = tr.get_camera_data().copy()
    tr.set_lighting(True)
    tr.scene.cameras[-1].rng_frame = 0  # the unlit frame's angles
    tr.render_frame()  # raw samples, lit: the oracle
    assert tuple(tr._raw_samples.shape) == (1, 4, 3)
    assert (tr.get_camera_data() >= unlit - 1e-6).all()
    assert tr.get_frame_pointer().shape == (8, 16, 4)


def test_config_refuses_the_far_field(monkeypatch):
    """The far field is on ("auto") by default, as in the JAX package
    (compound_ray_tpu/config.py:64); "off" is accepted and any other mode
    is refused."""
    for name in ("CR_TPU_FARFIELD", "CR_TPU_SKY_SPLIT",
                 "CR_TPU_FARFIELD_WIDTH"):
        monkeypatch.delenv(name, raising=False)
    cfg = tcfg.RenderConfig.from_env()
    assert (cfg.farfield, cfg.farfield_tolerance, cfg.farfield_cache_width,
            cfg.sky_split, cfg.sky_quad_splay, cfg.sky_quad_spin) == (
        "auto", 0.25, 1024, False, 16, 8)
    for mode in ("on", "AUTO", ""):
        with pytest.raises(ValueError, match="farfield"):
            tcfg.RenderConfig(farfield=mode)
    monkeypatch.setenv("CR_TPU_FARFIELD", "always")
    with pytest.raises(ValueError):
        tcfg.RenderConfig.from_env()
    with pytest.raises(ValueError, match="multiple of 32"):
        tcfg.RenderConfig(farfield_cache_width=100)
    monkeypatch.setenv("CR_TPU_FARFIELD", "off")
    monkeypatch.setenv("CR_TPU_CULL_SIGMAS", "3.5")
    monkeypatch.setenv("CR_TPU_SEED", "7")
    monkeypatch.setenv("CR_TPU_SKY_SPLIT", "1")
    monkeypatch.setenv("CR_TPU_FARFIELD_WIDTH", "256")
    cfg = tcfg.RenderConfig.from_env()
    assert (cfg.farfield, cfg.cull_sigmas, cfg.base_seed, cfg.sky_split,
            cfg.farfield_cache_width) == ("off", 3.5, 7, True, 256)
    monkeypatch.setenv("CR_TPU_SKY_SPLIT", "off")
    assert tcfg.RenderConfig.from_env().sky_split is False
    for mode in ("sphere", "fast"):
        with pytest.raises(NotImplementedError, match="exact"):
            tcfg.RenderConfig(refine_mode=mode)
    monkeypatch.setenv("CR_TPU_REFINE", "sphere")
    with pytest.raises(NotImplementedError):
        tcfg.RenderConfig.from_env()


def test_config_backend(monkeypatch):
    """backend takes "auto" (the default), "naive" and "pallas" (a synonym
    of "auto", so one CR_TPU_BACKEND serves both packages); the JAX
    package's "xla" and "sharded" are refused, and so is anything else."""
    monkeypatch.delenv("CR_TPU_BACKEND", raising=False)
    monkeypatch.delenv("CR_TPU_MIN_TRIS_CULL", raising=False)
    cfg = tcfg.RenderConfig.from_env()
    assert (cfg.backend, cfg.min_triangles_for_culling) == ("auto", 512)
    for mode in ("auto", "naive", "pallas"):
        assert tcfg.RenderConfig(backend=mode).backend == mode
    for mode, why in (("xla", "culled"), ("sharded", "multi-device")):
        with pytest.raises(NotImplementedError, match=why):
            tcfg.RenderConfig(backend=mode)
    with pytest.raises(ValueError, match="backend"):
        tcfg.RenderConfig(backend="fast")
    monkeypatch.setenv("CR_TPU_BACKEND", "naive")
    monkeypatch.setenv("CR_TPU_MIN_TRIS_CULL", "64")
    cfg = tcfg.RenderConfig.from_env()
    assert (cfg.backend, cfg.min_triangles_for_culling) == ("naive", 64)
    monkeypatch.setenv("CR_TPU_BACKEND", "xla")
    with pytest.raises(NotImplementedError):
        tcfg.RenderConfig.from_env()


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import compound_ray_tpu_torch\n"
        "import compound_ray_tpu_torch.interop, compound_ray_tpu_torch.testing\n"
        "import compound_ray_tpu_torch.trace._build\n"
        "import compound_ray_tpu_torch.api.shim, compound_ray_tpu_torch.eye_tools\n"
        "import compound_ray_tpu_torch.projection\n"
        "import compound_ray_tpu_torch.trace.intersect\n"
        "import compound_ray_tpu_torch.eye.render\n"
        "import compound_ray_tpu_torch.cameras.raygen\n"
        "import compound_ray_tpu_torch.cameras.fast_image\n"
        "import compound_ray_tpu_torch.gui, compound_ray_tpu_torch.gui.viewer\n"
        "import compound_ray_tpu_torch.tools.eye_generator\n"
        "import compound_ray_tpu_torch.tools.eye_transforms\n"
        "import compound_ray_tpu_torch.tools.eye_visualiser\n"
        "import compound_ray_tpu_torch.tools.obj_centerer\n"
        "import compound_ray_tpu_torch.tools.minimum_sample_rate_finder\n"
        "import compound_ray_tpu_torch.tools.variance_mapper\n"
        "import compound_ray_tpu_torch.tools.probe_step\n"
        "import compound_ray_tpu_torch.tools.microbench_k\n"
        "import compound_ray_tpu_torch.tools.frame_time\n"
        "import compound_ray_tpu_torch.scene.blend\n"
        "from compound_ray_tpu_torch.examples import (\n"
        "    primary_example, speed_test, plot_speed_test,\n"
        "    alias_quantified_experiment, alias_viewpoint_experiment,\n"
        "    heterogeneous_demonstration, overview_images,\n"
        "    position_estimation)\n"
        "assert 'matplotlib' not in sys.modules, 'the viewer imports it lazily'\n"
        "assert 'PIL' not in sys.modules, 'a textured .blend load imports it'\n"
        "bad = [m for m in sys.modules if m == 'jax' and sys.modules[m]\n"
        "       or m.startswith('jax.') or m == 'compound_ray_tpu'\n"
        "       or m.startswith('compound_ray_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
