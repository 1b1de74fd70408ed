"""The plain reference on hand-worked cases: closest hits and shading on a
one-box scene, texture sampling on a textured quad, and the cull against
brute force over the whole soup."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import Reference, draw_angles, eye_rays
from benchmark.scene import SceneArrays, Texture, load_plugin

box_mesh = load_plugin("scenes", "boxes_field").box_mesh
COLOUR = np.array([0.5, 0.25, 0.8, 1.0], np.float32)
SKY_UP = np.array([1.0, 31.0, 117.0]) / 255.0
SKY_LOW = np.array([143.0, 179.0, 203.0]) / 255.0 * 0.8


def one_box(*more):
    verts, faces, cols = [], [], []
    for centre, colour in ((np.array([0.0, 0.0, -5.0]), COLOUR),) + more:
        v, f = box_mesh(centre, (2.0, 2.0, 2.0))
        faces.append(f + 8 * len(verts))
        verts.append(v)
        cols.append(np.tile(colour, (8, 1)))
    return SceneArrays(vertices=np.concatenate(verts),
                       faces=np.concatenate(faces),
                       vertex_colors=np.concatenate(cols).astype(np.float32))


def trace_shade(scene, origins, dirs):
    ref = Reference(scene, "cpu")
    o = torch.tensor(origins, dtype=torch.float32)
    d = torch.tensor(dirs, dtype=torch.float32)[:, None, :]
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    t, u, v, tri = ref.trace(o, d, torch.zeros(len(o)))
    return t[:, 0].numpy(), ref.shade(d, u, v, tri)[:, 0].numpy()


def test_box_hits_and_sky():
    far = (np.array([0.0, 0.0, -9.0]), np.array([0.1, 0.9, 0.1, 1.0],
                                                 np.float32))
    t, rgb = trace_shade(
        one_box(far),
        [[0, 0, 0], [0, 0, 0], [0, 0, 0], [1.5, 0, 0], [0.5, 0.5, 0]],
        [[0, 0, -1], [0, 1, 0], [0, 0, 1], [0, 0, -1], [0, 0, -1]])
    want = COLOUR[:3].astype(np.float64) ** 2.2
    np.testing.assert_allclose(t[[0, 4]], [4.0, 4.0], rtol=1e-6)
    np.testing.assert_allclose(rgb[0], want, rtol=1e-5)  # nearer box wins
    np.testing.assert_allclose(rgb[4], want, rtol=1e-5)
    assert np.isinf(t[1:4]).all()
    np.testing.assert_allclose(rgb[1], SKY_UP, atol=1e-6)  # straight up
    np.testing.assert_allclose(rgb[2], SKY_LOW, atol=1e-6)  # horizon
    np.testing.assert_allclose(rgb[3], SKY_LOW, atol=1e-6)  # beside it


@pytest.mark.parametrize("filt", [0, 1], ids=["nearest", "bilinear"])
def test_textured_quad(filt):
    texels = np.array([[[1, 0, 0, 1], [0, 1, 0, 1]],
                       [[0, 0, 1, 1], [1, 1, 1, 1]]], np.float32)
    verts = np.array([[-1, -1, -2], [1, -1, -2], [1, 1, -2], [-1, 1, -2]],
                     np.float64)
    faces = np.array([[0, 1, 2], [0, 2, 3]])
    uv = ((verts[faces][..., :2] + 1) / 2).astype(np.float32)
    scene = SceneArrays(
        vertices=verts, faces=faces, uv=uv, mat_id=np.zeros(2, np.int32),
        mat_color=np.array([[0.8, 0.8, 0.8, 1]], np.float32),
        mat_tex=np.array([0], np.int32),
        textures=[Texture(texels, wrap_s=0, wrap_t=1, filter=filt)])
    # uv (0.25, 0.25) is texel (0, 0)'s centre; (0.5, 0.25) the edge
    # between texels (0, 0) and (1, 0); (0.75, 0.75) texel (1, 1)
    _, rgb = trace_shade(scene, [[-0.5, -0.5, 0], [0.0, -0.5, 0],
                                 [0.5, 0.5, 0]], [[0, 0, -1]] * 3)
    np.testing.assert_allclose(rgb[0], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(rgb[2], [1, 1, 1], atol=1e-6)
    if filt == 1:
        np.testing.assert_allclose(rgb[1], [0.5, 0.5, 0], atol=1e-6)
    else:  # rounds half to even: texel 0
        np.testing.assert_allclose(rgb[1], [1, 0, 0], atol=1e-6)


def test_cull_keeps_every_hit():
    """The per-ommatidium cone cull gives the brute-force closest hits."""
    scene = load_plugin("scenes", "boxes_field").build(n_boxes=150, seed=3)
    omms = load_plugin("eyes", "sphere_eye").build(n=40, acceptance_deg=8.0)
    splay, spin = draw_angles(omms, 24, 9, 0, "cpu")
    ls = np.eye(3)
    o, d, tmin = eye_rays(omms, (3.0, 1.5, -2.0), ls, splay, spin)
    ref = Reference(scene, "cpu", budget=1 << 14)
    t, u, v, tri = ref.trace(o, d, tmin)
    n_tri = scene.num_triangles
    ids = torch.arange(n_tri)[None].expand(len(omms), n_tri)
    live = torch.ones(len(omms), n_tri, dtype=torch.bool)
    bt, bu, bv, btri = ref._closest(o, d, tmin, ids, live)
    assert (tri == btri).all()
    assert torch.equal(t, bt)
    assert (tri >= 0).any() and (tri < 0).any()


def test_draw_is_the_documented_one():
    """The angles: a generator seeded (base_seed << 32 | frame), normal
    splay (sd = acceptance / FWHM ratio) then uniform spin over the
    ommatidia in group order."""
    omms = load_plugin("eyes", "sphere_eye").build(n=6, acceptance_deg=3.0)
    splay, spin = draw_angles(omms, 200, 3, 5, "cpu")  # one omm per group
    gen = torch.Generator().manual_seed((3 << 32) | 5)
    z = torch.randn((6, 200), generator=gen)
    assert sorted(np.round(splay[:, 0].numpy() /
                           math.radians(3.0) * 2.35482004503094938, 5)) \
        == sorted(np.round(z[:, 0].numpy(), 5))
    assert float(spin.min()) >= 0.0 and float(spin.max()) < math.pi
