"""Port vs JAX: the brute-force oracle's shading (trace/shade.py
miss_color, shade_rays, make_color).

The cases of tests/test_shading.py on the port's functions, and shade_rays
against the JAX package's on the five scenes of tests/test_torch_frame.py:
the same numpy rays and the same hit record (JAX's intersect_rays result)
through both, unlit, and lit with the default lights on two of them (the
shadow rays then go through each package's own intersect_rays).
Radiance within 2e-4, the frame tolerance of tests/test_torch_frame.py.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from compound_ray_tpu import testing as jtesting  # noqa: E402
from compound_ray_tpu.trace import intersect as JI  # noqa: E402
from compound_ray_tpu.trace.lighting import default_lights  # noqa: E402
from compound_ray_tpu.trace.shade import shade_rays as j_shade  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.scene import flat  # noqa: E402
from compound_ray_tpu_torch.trace.intersect import intersect_rays  # noqa: E402
from compound_ray_tpu_torch.trace.shade import (  # noqa: E402
    make_color,
    miss_color,
    miss_id,
    shade_rays,
)

ATOL = 2e-4
# (factory name, kwargs, ray origin): the scenes and eye positions of
# tests/test_torch_frame.py CASES
SCENES = [
    ("make_box_scene", {}, (0.0, 1.5, 3.0)),
    ("make_textured_quad_scene", {}, (0.0, 5.0, 0.0)),
    ("make_mixed_flat_scene", {}, (0.0, 5.0, 0.0)),
    ("make_two_texture_scene", {}, (0.0, 5.0, 0.0)),
    ("make_big_scene", {"n_boxes": 60, "seed": 5}, (0.0, 2.0, 0.0)),
]


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def test_miss_ids():
    assert miss_id("default_background") == 0
    assert miss_id("__miss__white") == 1
    assert miss_id("black") == 2
    assert miss_id("simple_sky") == 3
    assert miss_id("nonexistent") == 0


def test_white_black():
    d = _t([[1.0, 0.3, 0.2], [0.0, -1.0, 0.0]])
    assert (miss_color(d, 1) == 1.0).all()
    assert (miss_color(d, 2) == 0.0).all()


def test_simple_sky_gradient():
    upper = np.array([1.0, 31.0, 117.0]) / 255.0
    lower = np.array([143.0, 179.0, 203.0]) / 255.0 * 0.8
    np.testing.assert_allclose(miss_color(_t([[0.0, 1.0, 0.0]]), 3)[0],
                               upper, atol=1e-6)
    # downward and horizontal rays: the mix clamps at 0, the lower colour
    np.testing.assert_allclose(miss_color(_t([[0.0, -1.0, 0.0]]), 3)[0],
                               lower, atol=1e-6)
    np.testing.assert_allclose(miss_color(_t([[1.0, 0.0, 0.0]]), 3)[0],
                               lower, atol=1e-6)


def test_default_background_axis_lines():
    # near-axis directions are black
    assert (miss_color(_t([[1.0, 0.005, 0.005]]), 0)[0] == 0.0).all()
    # off-axis: uv encoding, blue channel 0
    c = miss_color(_t([[0.5, 0.5, 0.70710678]]), 0)[0].numpy()
    assert c[2] == 0.0
    assert 0.0 < c[0] < 1.0 and 0.0 < c[1] < 1.0


def test_make_color_gamma():
    out = make_color(_t([[0.0, 1.0, 0.5], [2.0, -1.0, 0.2176376]])).numpy()
    assert out.shape == (2, 4) and out.dtype == np.uint8
    assert out[0, 0] == 0 and out[0, 1] == 255
    assert out[0, 2] == 186  # 0.5^(1/2.2) * 255 = 186.5 truncates
    assert out[1, 0] == 255 and out[1, 1] == 0  # clamped
    assert out[1, 2] == 127  # 0.2176376^(1/2.2) * 255 = 127.5
    assert (out[:, 3] == 255).all()


def _hit_at_x(scene):
    dev = scene.device_triangles("cpu")
    o, d = _t([[5.0, 0.0, 0.0]]), _t([[-1.0, 0.0, 0.0]])
    hit = intersect_rays(o, d, dev["v0"], dev["e1"], dev["e2"], 0.0, 1e16)
    assert bool(hit["hit"][0])
    return dev, d, hit


def test_shade_vertex_color_priority():
    dev, d, hit = _hit_at_x(ttesting.make_box_scene())
    rgb = shade_rays(dev, d, hit, background=3)
    # the red cube's vertex colour (0.9, 0.2, 0.1), linearised by pow 2.2
    np.testing.assert_allclose(rgb[0], np.power([0.9, 0.2, 0.1], 2.2),
                               atol=1e-5)


def test_shade_material_fallback():
    v, f = ttesting.box_mesh((0, 0, 0), (1, 1, 1))
    dev, d, hit = _hit_at_x(flat.build_scene_from_arrays(
        v, f, base_color=(0.8, 0.8, 0.8)))
    # no vertex colours, no texture: baseColorFactor as is (not linearised)
    np.testing.assert_allclose(shade_rays(dev, d, hit, background=3)[0],
                               [0.8, 0.8, 0.8], atol=1e-6)


SHADE_CASES = [(c, False) for c in SCENES] + [(SCENES[2], True),
                                               (SCENES[4], True)]


@pytest.mark.parametrize(
    "case,lit", SHADE_CASES,
    ids=[c[0] + ("-lit" if lit else "") for c, lit in SHADE_CASES])
def test_shade_rays_matches_jax(case, lit):
    name, kwargs, pos = case
    js = getattr(jtesting, name)(**kwargs)
    ts = getattr(ttesting, name)(**kwargs)
    rng = np.random.default_rng(3)
    n = 400
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2, 1] = -np.abs(d[: n // 2, 1])  # half of them look down
    o = np.broadcast_to(np.asarray(pos, np.float32), (n, 3)).copy()
    jdev = js.device_triangles()
    hit = JI.intersect_rays(jnp.asarray(o), jnp.asarray(d), jdev["v0"],
                            jdev["e1"], jdev["e2"], 0.0, 1e16)
    hit_np = {k: np.asarray(v) for k, v in hit.items()}
    assert 0 < hit_np["hit"].sum() < n
    bg = miss_id(js.background_shader)
    lights = default_lights(js.aabb_min, js.aabb_max)
    want = np.asarray(jax.jit(j_shade, static_argnums=3)(
        jdev, jnp.asarray(d), hit, bg,
        lighting={"lights": jnp.asarray(lights)} if lit else None,
        origins=jnp.asarray(o)))
    got = shade_rays(ts.device_triangles("cpu"), _t(d),
                     {k: torch.tensor(v) for k, v in hit_np.items()}, bg,
                     lighting={"lights": lights} if lit else None,
                     origins=_t(o)).numpy()
    assert got.shape == (n, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)
