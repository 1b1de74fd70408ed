"""Port vs JAX: the two level-2 refine modes (config.refine_mode), the
cases of tests/test_exact_refine.py.

"exact" tests each candidate triangle against the cone after its bounding
sphere; "sphere" keeps every triangle whose bounding sphere meets the cone.
Both keep every triangle a cone meets, so frames agree (2e-5 on an open
scene, the oracle within 2e-4 in the sliver arena, where the eye sits
inside most triangles' spheres), and the exact mode packs fewer rows
there.  The port's sphere-mode widths and packed slot sets equal the JAX
package's (its cluster split pinned to numpy), and the plan keys keep the
modes apart.
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
from compound_ray_tpu_torch.eye.render import render_compound_means  # noqa: E402,E501
from compound_ray_tpu_torch.scene.flat import build_scene_from_arrays  # noqa: E402,E501
from compound_ray_tpu_torch.trace.attrs import KERNEL_LEAF  # noqa: E402
from compound_ray_tpu_torch.trace.lighting import default_lights  # noqa: E402
from compound_ray_tpu_torch.trace.shade import miss_id  # noqa: E402

LS = np.eye(3, dtype=np.float32)
OPEN_POS = np.array([3.0, 2.0, -5.0], np.float32)


@pytest.fixture
def pinned(monkeypatch):
    old = jcfg.get_config()
    jcfg.set_config(dataclasses.replace(
        old, farfield="off", sky_split=False, affine_rays=False))
    monkeypatch.setattr(native_ext, "build_cluster_order",
                        lambda *a, **k: None)
    monkeypatch.setattr(JP, "_eye_plans", {})
    monkeypatch.setattr(TP, "_eye_plans", {})
    yield monkeypatch
    jcfg.set_config(old)


def _mode(monkeypatch, mode: str):
    monkeypatch.setattr(tcfg, "_global_config", tcfg.RenderConfig(
        farfield="off", refine_mode=mode))


def make_sliver_arena(n_wall=64, radius=12.0, height=24.0):
    """tests/test_exact_refine.py's Ofstad-like closed arena in the port: a
    cylinder of full-height wall slivers and floor and ceiling fans, so
    every triangle's bounding sphere holds the centre."""
    ang = np.linspace(0.0, 2.0 * np.pi, n_wall, endpoint=False)
    x, z = radius * np.cos(ang), radius * np.sin(ang)
    verts, faces, cols = [], [], []

    def add_quad(p0, p1, p2, p3, col):
        b = len(verts)
        verts.extend([p0, p1, p2, p3])
        faces.append([b, b + 1, b + 2])
        faces.append([b, b + 2, b + 3])
        cols.extend([list(col) + [1.0]] * 4)

    rng = np.random.default_rng(0)
    for i in range(n_wall):
        j = (i + 1) % n_wall
        add_quad([x[i], -height / 2, z[i]], [x[j], -height / 2, z[j]],
                 [x[j], height / 2, z[j]], [x[i], height / 2, z[i]],
                 rng.uniform(0.2, 1.0, 3))
    for y, col in ((-height / 2, (0.6, 0.5, 0.3)),
                   (height / 2, (0.8, 0.8, 0.9))):
        c = len(verts)
        verts.append([0.0, y, 0.0])
        cols.append(list(col) + [1.0])
        for i in range(n_wall):
            j = (i + 1) % n_wall
            b = len(verts)
            verts.extend([[x[i], y, z[i]], [x[j], y, z[j]]])
            cols.extend([list(col) + [1.0]] * 2)
            faces.append([c, b, b + 1])
    return build_scene_from_arrays(
        np.asarray(verts), np.asarray(faces),
        vertex_colors=np.asarray(cols, np.float32),
        background_shader="simple_sky", name="sliver-arena")


def _frames(monkeypatch, scene, omms, pos, samples, seed, modes,
            fresh=True, **kw):
    """{mode: (N, 3) means} of one generator seed, each mode on a fresh
    scene plan unless fresh is False."""
    dev = scene.device_triangles("cpu")
    out = {}
    for mode in modes:
        _mode(monkeypatch, mode)
        if fresh:
            scene._kernel_plan = None
        out[mode] = TP.render_means(
            scene, dev, omms, pos, LS, torch.Generator().manual_seed(seed),
            samples, miss_id(scene.background_shader), **kw).numpy()
    return out


def _live_slots(rc, pm):
    """Each group's packed slot ids (row 10 of the w1 block), sorted."""
    out = []
    for g in range(rc.shape[0]):
        ids = pm[g, :rc[g], 10, :KERNEL_LEAF].reshape(-1)
        nrm = np.abs(pm[g, :rc[g], 0:3, 2 * KERNEL_LEAF:3 * KERNEL_LEAF]
                     ).sum(axis=1).reshape(-1)
        out.append(np.sort(ids[nrm > 0]))
    return out


def test_sphere_widths_and_pack_match_jax(pinned):
    """refine_mode "sphere" in both packages: the port's one pass at
    fresh hints measures the JAX package's widths at one pose and, per
    group, packs the same row count and slot set at them; the exact refine
    packs no more rows."""
    js = jtesting.make_big_scene(n_boxes=120, seed=4)
    ts = ttesting.make_big_scene(n_boxes=120, seed=4)
    omms = ommatidia_to_array(jtesting.make_sphere_eye(24, 3.0))
    samples = 16
    jcfg.set_config(dataclasses.replace(jcfg.get_config(),
                                        refine_mode="sphere"))
    _mode(pinned, "sphere")
    jsp, tsp = JP.scene_plan(js), TP.scene_plan(ts, "cpu")
    je, te = JP.eye_plan(omms, samples), TP.eye_plan(omms, samples)
    jo = jnp.asarray(omms[je.perm])
    to, _ = te.device_arrays(omms, "cpu")
    jpos, tpos = jnp.asarray(OPEN_POS), torch.as_tensor(OPEN_POS)
    jls, tls = jnp.asarray(LS), torch.as_tensor(LS)
    jw = JP._plan_widths(jsp, je, jo, jpos, jls, (je.sig, samples, b"sph"))
    kcand, rmax = jw
    jrc, jpm, _, _ = JP._pack_fused(
        jsp.mm_flat, jsp.slot_center_cl, jsp.slot_radius_cl,
        jsp.half_center, jsp.half_radius, jo, jpos, jls, g=je.g,
        kcand=kcand, rmax=rmax, cull_sigmas=4.0, tri_cl=None)
    args = (tsp.mm_flat, tsp.slot_center_cl, tsp.slot_radius_cl,
            tsp.half_center, tsp.half_radius, to, tpos, tls)
    trc, tpm, *tw = TP._pack_fused(*args, g=te.g, kmin=te.kmax_hint,
                                   rmin=te.rmax_hint, cull_sigmas=4.0,
                                   tri_cl=None)
    assert tuple(tw) == tuple(jw)
    np.testing.assert_array_equal(trc.numpy(), np.asarray(jrc))
    for a, b in zip(_live_slots(np.asarray(jrc), np.asarray(jpm)),
                    _live_slots(trc.numpy(), tpm.numpy())):
        np.testing.assert_array_equal(b, a)
    erc, _, ek, er = TP._pack_fused(*args, g=te.g, kmin=kcand, rmin=rmax,
                                    cull_sigmas=4.0, tri_cl=tsp.slot_tri_cl)
    assert (ek, er) == (kcand, rmax)
    assert (erc <= trc).all()


def test_exact_equals_sphere_on_open_scene(pinned):
    """tests/test_exact_refine.py:74: 40 ommatidia at 1e-5 degrees."""
    scene = ttesting.make_big_scene(n_boxes=120, seed=4)
    omms = ommatidia_to_array(ttesting.make_sphere_eye(40, 1e-5))
    out = _frames(pinned, scene, omms, OPEN_POS, 2, 1, ("exact", "sphere"))
    assert np.isfinite(out["exact"]).all()
    np.testing.assert_allclose(out["exact"], out["sphere"], atol=2e-5)


@pytest.mark.parametrize("mode", ["exact", "sphere"])
def test_sliver_arena_matches_oracle(pinned, mode):
    """tests/test_exact_refine.py:85: the eye off the arena's centre,
    inside every sliver's bounding sphere; both refines keep every
    triangle a deterministic ray hits."""
    scene = make_sliver_arena()
    dev = scene.device_triangles("cpu")
    omms = ommatidia_to_array(ttesting.make_sphere_eye(64, 1e-5))
    pos = np.array([0.3, 0.4, -0.2], np.float32)
    got = _frames(pinned, scene, omms, pos, 2, 2, (mode,))[mode]
    ref = render_compound_means(dev, omms, pos, LS,
                                torch.Generator().manual_seed(2), 2,
                                miss_id(scene.background_shader)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)


def test_sliver_arena_jittered_matches_sphere_mode(pinned):
    """tests/test_exact_refine.py:104: real cone jitter, the same rays;
    only beyond-4-sigma tails can differ."""
    scene = make_sliver_arena()
    omms = ommatidia_to_array(ttesting.make_sphere_eye(48, 3.0))
    out = _frames(pinned, scene, omms, np.array([0.0, 1.0, 0.0], np.float32),
                  64, 3, ("exact", "sphere"))
    assert np.mean(np.abs(out["exact"] - out["sphere"])) < 1e-3
    np.testing.assert_allclose(out["exact"], out["sphere"], atol=0.06)


def test_exact_culls_harder_in_arena(pinned):
    """tests/test_exact_refine.py:119: exact refine packs at most 0.7 of
    the sphere refine's rows in the arena.  The two frames share one scene
    plan, so the store must keep the packs under keys that differ in the
    mode."""
    scene = make_sliver_arena()
    omms = ommatidia_to_array(ttesting.make_sphere_eye(48, 3.0))
    pos = np.array([0.0, 1.0, 0.0], np.float32)
    scene._kernel_plan = None
    _frames(pinned, scene, omms, pos, 8, 4, ("exact", "sphere"), fresh=False)
    store = TP.scene_plan(scene, "cpu").packed_store
    rows = {k[-2]: float(rc.float().mean())
            for k, (rc, *_) in store.items()}
    assert set(rows) == {"exact", "sphere"}
    assert rows["exact"] <= 0.7 * rows["sphere"], rows


def test_plan_keys_keep_the_modes_apart(pinned):
    """Unlit and lit frames in exact, sphere and again exact mode on one
    scene plan: each mode's frame equals its frame on a fresh plan bit for
    bit (neither is served the other's widths, pack or shadow plan), and
    the modes agree."""
    scene = ttesting.make_big_scene(n_boxes=60, seed=5)
    omms = ommatidia_to_array(ttesting.make_sphere_eye(16, 4.0))
    pos = np.array([0.0, 2.0, 0.0], np.float32)
    lights = default_lights(scene.aabb_min, scene.aabb_max)
    modes = ("exact", "sphere")
    for kw in ({}, {"lights": lights}):
        fresh = _frames(pinned, scene, omms, pos, 16, 9, modes, **kw)
        scene._kernel_plan = None
        shared = _frames(pinned, scene, omms, pos, 16, 9,
                         modes + ("exact",), fresh=False, **kw)
        for mode in modes:
            np.testing.assert_array_equal(shared[mode], fresh[mode])
        np.testing.assert_allclose(fresh["sphere"], fresh["exact"],
                                   atol=2e-5)
    splan = TP.scene_plan(scene, "cpu")
    assert {k[5] for k in splan.shadow_store} == set(modes)
