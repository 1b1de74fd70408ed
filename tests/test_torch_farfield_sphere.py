"""The far-field split as a sphere of radius D about the eye centre: the
frame traces the clusters that meet it and counts a near hit only inside
it, and the cache shows everything beyond it (compound_ray_tpu_torch/eye/
pipeline.py _farfield_plan).  Frames through EyeRenderer with the cache on
are held to the same frames with it off and to the benchmark's plain
reference (benchmark/reference.py, which traces every ray to its exact
hit); the split is held to exact point-to-triangle distances.

The scenes are built with compound_ray_tpu_torch.testing's box helpers,
and handed to the reference as plain arrays.  A ground
slab under a ring of boxes beyond D makes the case the split has to get
right: the slab's cluster meets the sphere, so it is near, yet it runs on
far past the ring, and a ray that passes over the near ground towards a
ring box must show the box, not the ground behind it.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.reference import Reference
from compound_ray_tpu_torch import EyeRenderer
from compound_ray_tpu_torch import config as tcfg
from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera
from compound_ray_tpu_torch.examples.heterogeneous_demonstration import (
    variable_acceptance_eye)
from compound_ray_tpu_torch.eye import pipeline as TP
from compound_ray_tpu_torch.scene.eye_io import ommatidia_to_array
from compound_ray_tpu_torch.scene.flat import build_scene_from_arrays
from compound_ray_tpu_torch.testing import (box_mesh, make_big_scene,
                                            make_sphere_eye)

# cache pixels of 2.8 degrees, each the mean of 2 x 2 rays: small enough
# for the CPU twin; a frame needs 128 x 64 rays or more to engage it
WIDTH = 128
SEED = 11
POS = (0.0, 1.0, 0.0)


def soup(verts, faces, cols) -> SimpleNamespace:
    """The arrays the reference reads of a vertex-coloured triangle soup
    under the simple_sky miss shader, and the port's scene of them."""
    out = SimpleNamespace(
        vertices=verts, faces=faces, vertex_colors=cols,
        background="simple_sky", uv=None, mat_id=None, mat_color=None,
        mat_tex=None, textures=[], num_triangles=faces.shape[0],
        corners=lambda: verts[faces])
    out.flat = build_scene_from_arrays(verts, faces, vertex_colors=cols,
                                       background_shader=out.background,
                                       name="ring")
    return out


def ring_scene(radius: float, seed: int = 3) -> SimpleNamespace:
    """A 200 x 200 ground slab (top at y = -0.75), 84 boxes 1.5 high on a
    ring of `radius` about the eye's axis standing on it, and one small
    box at 0.45 radius, 0.5 up; vertex colours from `seed`."""
    rng = np.random.default_rng(seed)
    side = 0.35 * radius / 6.0
    boxes = [((0.0, -1.0, 0.0), (200.0, 0.5, 200.0))]
    boxes += [((radius * math.cos(a), -0.25, radius * math.sin(a)),
               (side, 1.5, side))
              for a in 2.0 * math.pi * np.arange(84) / 84]
    boxes.append(((0.45 * radius, 0.5, 0.0), (0.4, 0.4, 0.4)))
    verts, faces, cols = [], [], []
    for centre, size in boxes:
        v, f = box_mesh(centre, size)
        faces.append(f + 8 * len(verts))
        verts.append(v)
        cols.append(np.tile(np.append(rng.uniform(0.1, 1.0, 3), 1.0),
                            (8, 1)))
    return soup(np.concatenate(verts), np.concatenate(faces),
                np.concatenate(cols).astype(np.float32))


def sphere_eye(n: int, acceptance_deg: float) -> np.ndarray:
    return ommatidia_to_array(make_sphere_eye(n, acceptance_deg))


def acute_eye(n: int) -> np.ndarray:
    """The horizontally acute eye: 2.6 degrees at the horizon to 10.4 at
    the poles."""
    return ommatidia_to_array(variable_acceptance_eye(n, 2.6, 4.0))


def frame(scene, omms, samples, farfield, sky_split=False):
    """One frame through EyeRenderer at POS: (N, 3) means, and the scene
    plan it rendered with."""
    tcfg.set_config(tcfg.RenderConfig(farfield=farfield,
                                      farfield_cache_width=WIDTH,
                                      sky_split=sky_split, base_seed=SEED))
    r = EyeRenderer(verbose=False, device="cpu")
    r.scene = scene.flat
    r.scene.cameras.append(CompoundEyeCamera(
        "eye", "single_dimension_fast", []))
    r.goto_camera(len(r.scene.cameras) - 1)
    r.set_ommatidia(omms)
    r.current_camera().set_position(POS)
    r.set_current_eye_samples_per_ommatidium(samples)
    r.render_frame()
    return r.get_camera_data().copy(), r.scene._kernel_plan


@pytest.fixture
def restore_config(monkeypatch):
    monkeypatch.setattr(tcfg, "_global_config", tcfg.RenderConfig())


def _gaps(scene, omms, samples, sky_split=False):
    """|frame - reference| with the cache on and off, and the cache's
    scene plan and D."""
    want = Reference(scene, "cpu").frame(omms, POS, np.eye(3), samples,
                                         SEED, 0)
    on, splan = frame(scene, omms, samples, "auto", sky_split)
    off, _ = frame(scene, omms, samples, "off")
    assert len(splan.cache_store) == 1, "the cache must engage"
    d = TP._farfield_threshold(omms, tcfg.RenderConfig().farfield_tolerance)
    return np.abs(on - want), np.abs(off - want), splan, d


def test_ring_beyond_d_is_not_hidden_by_the_near_ground(restore_config):
    """32 ommatidia of 20 degrees at 256 samples (D = 2.70): the ring at 6
    lies beyond D in clusters of its own, the ground's cluster is near, and
    the small box straddles D (2.5 to 2.9).  Cache off, the frame is the
    reference's to float rounding.  Cache on, its 2.8-degree pixels (0.33
    sd of these cones) blur each ring box's edges: the most an ommatidium
    may be off is 0.15 of a colour (0.061 seen) and 0.015 on average
    (0.0042 seen).  Where the ground's far part hides the ring, ommatidia
    looking at the ring see the ground's colour: 0.29 and 0.020."""
    scene = ring_scene(6.0)
    on, off, splan, d = _gaps(scene, sphere_eye(32, 20.0), 256)
    assert 2.5 < d < 2.9
    corners = scene.corners()
    straddle = (np.linalg.norm(corners - np.array(POS), axis=2).min(axis=1)
                < d) & (np.linalg.norm(corners - np.array(POS), axis=2)
                        .max(axis=1) > d)
    assert straddle[-12:].any(), "the small box must straddle D"
    assert off.max() <= 1e-5
    assert on.max() <= 0.15 and on.mean() <= 0.015, (on.max(), on.mean())


def test_acute_eye_with_far_field_matches_reference(restore_config):
    """64 ommatidia of 2.6 degrees at the horizon to 10.4 at the poles
    (D = 19.8 from the narrowest, 2.7 degrees at n = 64) before the ring
    at 45, 128 samples each: the pack's widths come from the widest cones,
    the split from the narrowest.  Cache off: the reference to float
    rounding.  Cache on: its pixels are 2.8 degrees, 2.4 sd of the
    narrowest cones, so a horizon ommatidium on a ring box's edge may be
    off by up to 0.25 (0.13 seen), the eye 0.01 on average (0.003)."""
    omms = acute_eye(64)
    assert np.ptp(omms[:, 6]) > 0.5 * omms[:, 6].max()
    on, off, _, d = _gaps(ring_scene(45.0), omms, 128)
    assert 19.0 < d < 21.0
    assert off.max() <= 1e-5
    assert on.max() <= 0.25 and on.mean() <= 0.01, (on.max(), on.mean())


def test_sky_split_over_the_far_sphere_matches_reference(restore_config):
    """The sky split on the ring scene of the first test, at 128 samples
    (a group is one ommatidium, as the split needs) and 64 ommatidia of 20
    degrees: the groups with no near cluster (those above the horizon)
    take the cone's expectation over the cache, the others the frame's
    near hits inside D and the cache beyond.  The live rows draw their
    angles in the compacted order, so a frame is not the reference's ray
    for ray: the gap is the cache's (as in the first test) and the
    expectation's quadrature over it, within the first test's limits of
    0.15 (0.068 seen) and 0.015 on average (0.0071 seen); with every near
    hit kept, 0.32 and 0.022."""
    on, off, splan, d = _gaps(ring_scene(6.0), sphere_eye(64, 20.0), 128,
                              sky_split=True)
    sky = [v for v in splan.sky_store.values() if v is not None]
    assert len(sky) == 1, "the sky split must engage"
    scatter = sky[0][3].numpy()
    assert 0 < int((scatter < 64).sum()) < 60, "some groups are sky"
    assert 2.5 < d < 2.9
    assert off.max() <= 1e-5
    assert on.max() <= 0.15 and on.mean() <= 0.015, (on.max(), on.mean())


def _triangle_distances(p, a, b, c):
    """(T,) least and greatest distance from point p (3,) to triangles
    with corners a, b, c (T, 3): the closest point by its Voronoi region
    (Ericson, Real-Time Collision Detection, 5.1.5), the farthest at a
    corner."""
    ab, ac = b - a, c - a

    def dot(x, y):
        return np.sum(x * y, axis=-1)

    ap, bp, cp = p - a, p - b, p - c
    d1, d2 = dot(ab, ap), dot(ac, ap)
    d3, d4 = dot(ab, bp), dot(ac, bp)
    d5, d6 = dot(ab, cp), dot(ac, cp)
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / (va + vb + vc)
        q = a + ab * (vb * inv)[:, None] + ac * (vc * inv)[:, None]
        regions = [  # lowest priority first: each overrides the last
            ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
             b + (c - b) * ((d4 - d3) / ((d4 - d3) + (d5 - d6)))[:, None]),
            ((vb <= 0) & (d2 >= 0) & (d6 <= 0),
             a + ac * (d2 / (d2 - d6))[:, None]),
            ((d6 >= 0) & (d5 <= d6), c),
            ((vc <= 0) & (d1 >= 0) & (d3 <= 0),
             a + ab * (d1 / (d1 - d3))[:, None]),
            ((d3 >= 0) & (d4 <= d3), b),
            ((d1 <= 0) & (d2 <= 0), a)]
        for sel, point in regions:
            q = np.where(sel[:, None], point, q)
    far = np.max([np.linalg.norm(x - p, axis=1) for x in (a, b, c)], axis=0)
    return np.linalg.norm(q - p, axis=1), far


@pytest.mark.parametrize("pos", [(-1.0, 1.0, 0.0), (12.0, 2.5, -7.0),
                                 (30.0, 6.0, 30.0)])
def test_every_triangle_within_d_is_near(pos):
    """The field of 200 boxes (19 clusters) and the acute eye at three
    poses: a triangle with any point within D of the eye centre lies in a
    near cluster (near_mask), and one with any point beyond D in a cluster
    the cache traces (_farfield_reach).  The distances are exact
    point-to-triangle distances in float64; the check of the first half
    has a margin of 1e-4 for the float32 spheres."""
    scene = make_big_scene(200, seed=0)
    omms = acute_eye(64)
    splan = TP.scene_plan(scene, "cpu")
    far, centre, d = TP._farfield_split(
        splan, omms, np.asarray(pos, np.float32), np.eye(3), 0.25)
    reach = TP._farfield_reach(splan, centre, d)
    assert far.any() and (~far).any() and (reach & ~far).any()
    near_d, far_d = _triangle_distances(
        centre, *(np.asarray(c, np.float64)
                  for c in (scene.v0, scene.v0 + scene.e1,
                            scene.v0 + scene.e2)))
    slot_tri = splan.slot_tri.numpy()
    cluster = np.empty(scene.v0.shape[0], np.int64)
    live = slot_tri >= 0
    cluster[slot_tri[live]] = np.flatnonzero(live) // 128
    within = near_d <= d - 1e-4
    assert within.any() and (~within).any()
    assert (~far[cluster[within]]).all()
    assert reach[cluster[far_d > d + 1e-4]].all()
