"""The brute-force oracle's lit path and frames (trace/lighting.py AoS
functions, eye/render.py, eye/sampling.py ommatidial_rays).

The oracle parts of tests/test_lighting.py on the port: GGX adds to the
base colour, shadow rays remove it, the tangents and the material-texture
modulation, the planar BRDF against the AoS one, and the port's packed lit
frame (K1 and K3, their twins on the CPU) against the port's own oracle at
atol 2e-3 on the two scenes of tests/test_lighting.py.  Then
render_compound_samples, lit and unlit, against the JAX package's, fed the
angles that JAX's sample_angles drew from the same key: atol 2e-4.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from compound_ray_tpu import testing as jtesting  # noqa: E402
from compound_ray_tpu.eye import render as JRN  # noqa: E402
from compound_ray_tpu.eye import sampling as JS  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.eye import render as TRN  # noqa: E402
from compound_ray_tpu_torch.eye import sampling as TS  # noqa: E402
from compound_ray_tpu_torch.eye.pipeline import render_means  # noqa: E402
from compound_ray_tpu_torch.scene.eye_io import (  # noqa: E402
    Ommatidium,
    ommatidia_to_array,
)
from compound_ray_tpu_torch.scene import flat  # noqa: E402
from compound_ray_tpu_torch.testing import box_mesh  # noqa: E402
from compound_ray_tpu_torch.trace.intersect import intersect_rays  # noqa: E402
from compound_ray_tpu_torch.trace.lighting import (  # noqa: E402
    apply_material_textures,
    build_shading_rows,
    default_lights,
    ggx_light_contrib,
    ggx_light_contrib_planar,
    shading_basis,
    shading_basis_from_rows,
    triangle_dpduv,
)
from compound_ray_tpu_torch.trace.shade import (  # noqa: E402
    miss_id,
    shade_rays,
)

PACKED_ATOL = 2e-3
ATOL = 2e-4


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _floor_scene():
    v, f = box_mesh((0.0, -1.0, 0.0), (20.0, 0.2, 20.0))
    return flat.build_scene_from_arrays(v, f, base_color=(0.5, 0.5, 0.5),
                                        background_shader="black")


def _hit(dev, o, d):
    return intersect_rays(o, d, dev["v0"], dev["e1"], dev["e2"], 0.0, 1e16)


def test_lighting_adds_to_base_color():
    scene = _floor_scene()
    dev = scene.device_triangles("cpu")
    o, d = _t([[0.0, 5.0, 0.0]]), _t([[0.0, -1.0, 0.0]])
    hit = _hit(dev, o, d)
    assert bool(hit["hit"][0])
    unlit = shade_rays(dev, d, hit, background=2)
    lights = default_lights(scene.aabb_min, scene.aabb_max)
    lit = shade_rays(dev, d, hit, background=2, lighting={"lights": lights},
                     origins=o)
    np.testing.assert_allclose(unlit[0], [0.5, 0.5, 0.5], atol=1e-6)
    assert (lit[0] > unlit[0]).all()


def test_lighting_shadowing():
    """A canopy between the floor point and all four lights: only the base
    colour remains."""
    v1, f1 = box_mesh((0.0, -1.0, 0.0), (20.0, 0.2, 20.0))
    v2, f2 = box_mesh((0.0, 3.0, 0.0), (40.0, 0.2, 40.0))
    scene = flat.build_scene_from_arrays(
        np.concatenate([v1, v2]), np.concatenate([f1, f2 + len(v1)]),
        base_color=(0.5, 0.5, 0.5), background_shader="black")
    dev = scene.device_triangles("cpu")
    o, d = _t([[0.0, 1.0, 0.0]]), _t([[0.0, -1.0, 0.0]])
    hit = _hit(dev, o, d)
    lights = default_lights(scene.aabb_min, scene.aabb_max)
    lights[:, 6] = np.abs(lights[:, 6]) + 30.0  # lights above the canopy
    lights[:, 5] = 20.0
    lit = shade_rays(dev, d, hit, background=2, lighting={"lights": lights},
                     origins=o)
    np.testing.assert_allclose(lit[0], [0.5, 0.5, 0.5], atol=1e-5)


def test_triangle_dpduv_known_quad():
    dev = ttesting.make_mr_normal_scene().device_triangles("cpu")
    dpdu, dpdv = triangle_dpduv(dev, torch.tensor([0, 1]))
    # the quad spans x, z in [-10, 10], u along +x and v along +z
    np.testing.assert_allclose(dpdu, [[20, 0, 0]] * 2, atol=1e-4)
    np.testing.assert_allclose(dpdv, [[0, 0, 20]] * 2, atol=1e-4)


def test_apply_material_textures_semantics():
    """The MR map's left half halves roughness and quarters metallic and
    the normal map tilts the normal toward +x there; the right half is the
    identity."""
    dev = ttesting.make_mr_normal_scene().device_triangles("cpu")
    uv = _t([[0.25, 0.5], [0.75, 0.5]])
    n = _t([[0.0, 1.0, 0.0]] * 2)
    n2, m2, r2 = apply_material_textures(dev, torch.tensor([0, 0]), uv, n,
                                         torch.full((2,), 0.8),
                                         torch.full((2,), 0.6))
    np.testing.assert_allclose(r2, [0.6 * 0.5, 0.6], atol=1e-5)
    np.testing.assert_allclose(m2, [0.8 * 0.25, 0.8], atol=1e-5)
    np.testing.assert_allclose(n2[1], [0.0, 1.0, 0.0], atol=1e-5)
    expect = np.array([0.4, 1.0, 0.0])  # NN = (0.4, 0, 1)
    np.testing.assert_allclose(n2[0], expect / np.linalg.norm(expect),
                               atol=1e-5)


def test_mr_normal_textures_change_lit_result():
    scene = ttesting.make_mr_normal_scene()
    lights = default_lights(scene.aabb_min, scene.aabb_max)
    o = _t([[-5.0, 5.0, 0.0], [5.0, 5.0, 0.0]])
    d = _t([[0.0, -1.0, 0.0], [0.0, -1.0, 0.0]])
    dev = scene.device_triangles("cpu")
    hit = _hit(dev, o, d)
    lit_mod = shade_rays(dev, d, hit, background=2,
                         lighting={"lights": lights}, origins=o)
    plain = ttesting.make_mr_normal_scene()  # the modulation slots cleared
    plain.mat_mr_tex = np.array([-1], np.int32)
    plain.mat_normal_tex = np.array([-1], np.int32)
    plain._device_cache = None
    pdev = plain.device_triangles("cpu")
    assert "mat_mr_tex" not in pdev and "mat_mr_tex" in dev
    lit_plain = shade_rays(pdev, d, hit, background=2,
                           lighting={"lights": lights}, origins=o)
    assert (lit_mod[0] - lit_plain[0]).abs().max() > 1e-3
    np.testing.assert_allclose(lit_mod[1], lit_plain[1], atol=1e-5)


def test_shading_basis_from_rows_matches_gather():
    dev = ttesting.make_mr_normal_scene().device_triangles("cpu")
    tri = torch.tensor([1, 0, 1])
    rows = build_shading_rows(dev)[tri]
    for a, b in zip(shading_basis(dev, tri), shading_basis_from_rows(rows)):
        assert torch.equal(a, b.to(a.dtype))


def test_ggx_planar_matches_aos():
    """The planar BRDF of the packed frame against the oracle's AoS one on
    random inputs (rtol 1e-3 as tests/test_lighting.py: near specular
    peaks the GGX D term amplifies a 1-ulp difference of the dots)."""
    rng = np.random.default_rng(11)
    r = 4096

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    n, view, light = (_t(unit(rng.normal(size=(r, 3)))) for _ in range(3))
    base = _t(rng.uniform(0.0, 1.0, size=(r, 3)))
    metallic = _t(rng.uniform(0.0, 1.0, size=(r,)))
    rough = _t(rng.uniform(0.05, 1.0, size=(r,)))
    lcol, lint = _t([1.0, 0.9, 0.8]), torch.tensor(4.0)
    contrib, facing = ggx_light_contrib(n, view, light, base, metallic,
                                        rough, lcol, lint)
    (cr, cg, cb), facing_p = ggx_light_contrib_planar(
        n.unbind(-1), view.unbind(-1), light.unbind(-1), base.unbind(-1),
        metallic, rough, lcol, lint)
    assert torch.equal(facing, facing_p)
    got = torch.stack([cr, cg, cb], dim=-1)
    np.testing.assert_allclose(got[facing], contrib[facing], rtol=1e-3,
                               atol=2e-6)


def _fan(p_of, d_of):
    omms = []
    for ix in range(6):
        for iz in range(5):
            d = np.asarray(d_of(ix, iz), np.float64)
            omms.append(Ommatidium(np.asarray(p_of(ix, iz), np.float64),
                                   d / np.linalg.norm(d), 1e-6, 0.0))
    return ommatidia_to_array(omms)


PACKED_CASES = {
    # floor, partial canopy and side wall (mixed occlusion)
    "canopy": (ttesting.make_canopy_scene,
               lambda ix, iz: [ix - 2.5, 2.0, iz - 2.0],
               lambda ix, iz: [0.15 * (ix - 2.5), -1.0, 0.1 * (iz - 2.0)],
               0.7),
    "mr_normal": (ttesting.make_mr_normal_scene,
                  lambda ix, iz: [2.0 * ix - 5.0, 3.0, 2.0 * iz - 4.0],
                  lambda ix, iz: [0.2 * (ix - 2.5), -1.0, 0.15 * (iz - 2.0)],
                  0.1),
}


@pytest.mark.parametrize("case", list(PACKED_CASES))
def test_packed_lighting_matches_brute_oracle(case):
    """The packed lit frame (render_means: K1, the shadow plan, K3) against
    render_compound_means on a deterministic eye: an acceptance angle of
    1e-6 rad makes every sample of an ommatidium the same ray, so the two
    draws do not matter."""
    make, p_of, d_of, floor = PACKED_CASES[case]
    scene = make()
    dev = scene.device_triangles("cpu")
    lights = default_lights(scene.aabb_min, scene.aabb_max)
    omms = _fan(p_of, d_of)
    pos, ls = np.zeros(3, np.float32), np.eye(3, dtype=np.float32)
    gen = torch.Generator().manual_seed(3)
    ref = TRN.render_compound_means(dev, omms, pos, ls, gen, 2, 2, True,
                                    lights).numpy()
    got = render_means(scene, dev, omms, pos, ls,
                       torch.Generator().manual_seed(3), 2, 2,
                       lights=lights).numpy()
    assert ref.max() > floor  # the lighting does something here
    np.testing.assert_allclose(got, ref, atol=PACKED_ATOL)


def test_ommatidial_rays_matches_jax():
    omms = ommatidia_to_array(ttesting.make_sphere_eye(12, 5.0))
    omms[:, 7] = 0.05  # a focal offset
    pos = np.asarray([0.3, -1.0, 2.0], np.float32)
    ls = np.linalg.qr(np.random.default_rng(2).normal(size=(3, 3)))[0] \
        .astype(np.float32)  # an orthonormal basis
    key = jax.random.PRNGKey(4)
    splay, spin = JS.sample_angles(key, 12, 5, jnp.asarray(omms[:, 6]))
    want = JS.ommatidial_rays(jnp.asarray(omms), jnp.asarray(pos),
                              jnp.asarray(ls), 5, key)
    got = TS.ommatidial_rays(_t(omms), _t(pos), _t(ls), 5,
                             angles=(_t(splay), _t(spin)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    # the port's own draw: (S, N), normal then uniform, on the generator
    s1, p1 = TS.sample_angles(torch.Generator().manual_seed(9), 12, 5,
                              _t(omms[:, 6]))
    assert tuple(s1.shape) == (5, 12)
    assert (p1 >= 0).all() and (p1 < np.pi).all()
    s2, _ = TS.sample_angles(torch.Generator().manual_seed(9), 12, 5,
                             _t(omms[:, 6]))
    assert torch.equal(s1, s2)


SAMPLE_CASES = [("make_big_scene", {"n_boxes": 60, "seed": 5},
                 (0.0, 2.0, 0.0), False),
                ("make_mixed_flat_scene", {}, (0.0, 5.0, 0.0), False),
                ("make_mixed_flat_scene", {}, (0.0, 5.0, 0.0), True),
                ("make_mr_normal_scene", {}, (0.0, 5.0, 0.0), True)]


@pytest.mark.parametrize(
    "name,kwargs,pos,lit", SAMPLE_CASES,
    ids=[c[0] + ("-lit" if c[3] else "") for c in SAMPLE_CASES])
def test_render_compound_samples_matches_jax(name, kwargs, pos, lit):
    js = getattr(jtesting, name)(**kwargs)
    ts = getattr(ttesting, name)(**kwargs)
    omms = ommatidia_to_array(jtesting.make_sphere_eye(16, 8.0))
    pos = np.asarray(pos, np.float32)
    ls = np.eye(3, dtype=np.float32)
    samples = 6
    bg = miss_id(js.background_shader)
    lights = default_lights(js.aabb_min, js.aabb_max)
    key = jax.random.PRNGKey(5)
    splay, spin = JS.sample_angles(key, omms.shape[0], samples,
                                   jnp.asarray(omms[:, 6]))
    want = np.asarray(JRN.render_compound_samples(
        js.device_triangles(), jnp.asarray(omms), jnp.asarray(pos),
        jnp.asarray(ls), key, samples, bg, lit,
        jnp.asarray(lights) if lit else None))
    kw = dict(angles=(_t(splay), _t(spin)))
    got = TRN.render_compound_samples(
        ts.device_triangles("cpu"), omms, pos, ls, None, samples, bg, lit,
        lights if lit else None, **kw).numpy()
    assert got.shape == want.shape == (samples, 16, 3)
    assert np.isfinite(got).all() and got.max() > 0.0
    np.testing.assert_allclose(got, want, atol=ATOL)
    means = TRN.render_compound_means(
        ts.device_triangles("cpu"), omms, pos, ls, None, samples, bg, lit,
        lights if lit else None, **kw).numpy()
    np.testing.assert_allclose(means, got.mean(axis=0), atol=1e-7)
