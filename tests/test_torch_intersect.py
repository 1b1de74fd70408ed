"""Port vs JAX: the brute-force closest hit (trace/intersect.py) and the
Plücker form (trace/plucker.py).

The cases of tests/test_intersect.py and tests/test_plucker.py on the
port's functions, and intersect_rays against the JAX package's on one
scene and the same numpy rays: tri_id equal except at near-ties (the two
closest t within 1e-6 relative), t, u and v within 1e-5.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from compound_ray_tpu import testing as jtesting  # noqa: E402
from compound_ray_tpu.trace import intersect as JI  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.trace import intersect as TI  # noqa: E402
from compound_ray_tpu_torch.trace.plucker import (  # noqa: E402
    plucker_closest_hit,
    ray6,
    triangle_constants,
)

TOL = 1e-5
NEAR_TIE = 1e-6


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _tri(v0, v1, v2):
    v0 = np.asarray(v0, np.float32)
    return (_t([v0]), _t([np.asarray(v1, np.float32) - v0]),
            _t([np.asarray(v2, np.float32) - v0]))


def _one(o, d, tris, tmin=0.0, tmax=1e16, **kw):
    return TI.intersect_rays(_t(o), _t(d), *tris, tmin, tmax, **kw)


def test_single_hit():
    res = _one([[0.0, 0.0, 0.0]], [[0.0, 0.0, 1.0]],
               _tri([-1, -1, 5], [1, -1, 5], [0, 1, 5]))
    assert bool(res["hit"][0])
    assert np.isclose(float(res["t"][0]), 5.0, atol=1e-5)


def test_both_sided():
    # hit from behind (reversed winding relative to the ray) counts
    res = _one([[0.0, 0.0, 0.0]], [[0.0, 0.0, 1.0]],
               _tri([-1, -1, 5], [0, 1, 5], [1, -1, 5]))
    assert bool(res["hit"][0])


def test_miss_outside():
    res = _one([[5.0, 5.0, 0.0]], [[0.0, 0.0, 1.0]],
               _tri([-1, -1, 5], [1, -1, 5], [0, 1, 5]))
    assert not bool(res["hit"][0])
    assert int(res["tri_id"][0]) == -1 and float(res["t"][0]) == np.inf


def test_tmin_tmax_window():
    res = _one([[0.0, 0.0, 0.0]] * 3, [[0.0, 0.0, 1.0]] * 3,
               _tri([-1, -1, 5], [1, -1, 5], [0, 1, 5]),
               _t([0.0, 6.0, 0.0]), _t([1e16, 1e16, 4.0]))
    assert res["hit"].tolist() == [True, False, False]


def test_unnormalised_direction_t_units():
    res = _one([[0.0, 0.0, 0.0]], [[0.0, 0.0, 2.0]],  # |d| = 2 -> t = 2.5
               _tri([-1, -1, 5], [1, -1, 5], [0, 1, 5]))
    assert np.isclose(float(res["t"][0]), 2.5, atol=1e-5)


def test_closest_of_many():
    v0 = _t([[-1, -1, z] for z in (9.0, 3.0, 6.0)])
    e1, e2 = _t([[2, 0, 0]] * 3), _t([[1, 2, 0]] * 3)
    res = _one([[0.0, 0.0, 0.0]], [[0.0, 0.0, 1.0]], (v0, e1, e2))
    assert int(res["tri_id"][0]) == 1
    assert res["tri_id"].dtype == torch.int32
    assert np.isclose(float(res["t"][0]), 3.0, atol=1e-5)


def test_chunking_consistency():
    """Results do not depend on the chunk sizes: equal (not close)."""
    rng = np.random.default_rng(0)
    n_tris, n_rays = 333, 77
    v0 = _t(rng.uniform(-5, 5, (n_tris, 3)))
    e1 = _t(rng.uniform(-1, 1, (n_tris, 3)))
    e2 = _t(rng.uniform(-1, 1, (n_tris, 3)))
    o = _t(rng.uniform(-6, 6, (n_rays, 3)))
    d = _t(rng.normal(size=(n_rays, 3)))
    a = TI.intersect_rays(o, d, v0, e1, e2, 0.0, 1e16, ray_chunk=512,
                          tri_chunk=2048)
    b = TI.intersect_rays(o, d, v0, e1, e2, 0.0, 1e16, ray_chunk=16,
                          tri_chunk=64)
    assert a["hit"].any()
    for k in ("tri_id", "t", "u", "v", "hit"):
        assert torch.equal(a[k], b[k]), k


def test_barycentrics():
    res = _one([[0.5, 0.5, 0.0]], [[0.0, 0.0, 1.0]],
               _tri([0, 0, 5], [2, 0, 5], [0, 2, 5]))
    # P = v0 + u e1 + v e2 -> u = v = 0.25
    assert np.isclose(float(res["u"][0]), 0.25, atol=1e-6)
    assert np.isclose(float(res["v"][0]), 0.25, atol=1e-6)


def test_no_triangles_all_miss():
    empty = torch.zeros((0, 3))
    res = TI.intersect_rays(_t([[0.0, 0.0, 0.0]] * 2),
                            _t([[0.0, 0.0, 1.0]] * 2), empty, empty, empty,
                            0.0, 1e16)
    assert res["tri_id"].tolist() == [-1, -1] and not res["hit"].any()
    assert torch.isinf(res["t"]).all()


def test_oracle_ray_chunk():
    """512 on the CPU; on a card the chunk pairs fill CUDA_CHUNK_ELEMS."""
    assert TI.oracle_ray_chunk("cpu") == 512
    assert TI.oracle_ray_chunk(torch.device("cuda")) * 2048 \
        == TI.CUDA_CHUNK_ELEMS


def _random_rays(n, seed=0, span=60.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


def _near_ties(o, d, v0, e1, e2):
    """(R,) bool: rays whose two closest valid t lie within NEAR_TIE
    relative (numpy f64 over the f32 Möller-Trumbore t of the port)."""
    t, _, _, ok = TI.moller_trumbore(_t(o), _t(d), v0, e1, e2)
    t = torch.where(ok & (t >= 0.0), t, torch.inf).double()
    two = torch.topk(t, 2, dim=1, largest=False).values
    return ((two[:, 1] - two[:, 0]) <= NEAR_TIE * two[:, 0].abs()).numpy()


def test_intersect_rays_matches_jax():
    """make_big_scene(60), 500 random rays, the same numpy arrays through
    both packages (and the port with small chunks)."""
    scene = ttesting.make_big_scene(n_boxes=60, seed=5)
    js = jtesting.make_big_scene(n_boxes=60, seed=5)
    np.testing.assert_array_equal(scene.v0, js.v0)
    o, d = _random_rays(500, seed=1)
    tris = tuple(_t(getattr(scene, k)) for k in ("v0", "e1", "e2"))
    got = TI.intersect_rays(_t(o), _t(d), *tris, 0.0, 1e16)
    small = TI.intersect_rays(_t(o), _t(d), *tris, 0.0, 1e16, ray_chunk=64,
                              tri_chunk=128)
    want = JI.intersect_rays(jnp.asarray(o), jnp.asarray(d),
                             *(jnp.asarray(getattr(js, k))
                               for k in ("v0", "e1", "e2")), 0.0, 1e16)
    want = {k: np.asarray(v) for k, v in want.items()}
    for k in ("tri_id", "t", "u", "v", "hit"):
        assert torch.equal(got[k], small[k]), k
    hit = want["hit"]
    assert 50 < hit.sum() < 500
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    same = got["tri_id"].numpy() == want["tri_id"]
    assert not (~same & ~_near_ties(o, d, *tris)).any()
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(got[k].numpy()[hit & same],
                                   want[k][hit & same], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["t"].numpy()[hit], want["t"][hit],
                               rtol=TOL)


def test_ray6():
    o, d = _random_rays(8, seed=3)
    r6 = ray6(_t(o), _t(d)).numpy()
    np.testing.assert_array_equal(r6[:, :3], d)
    np.testing.assert_allclose(r6[:, 3:], np.cross(o, d), rtol=1e-6,
                               atol=1e-4)


def test_plucker_matches_mt_on_scene():
    scene = ttesting.make_big_scene(n_boxes=60, seed=5)
    tri = triangle_constants(scene.v0, scene.e1, scene.e2)
    tri_id = torch.arange(scene.num_triangles, dtype=torch.int32)
    o, d = (_t(x) for x in _random_rays(500, seed=1))
    ref = TI.intersect_rays(o, d, _t(scene.v0), _t(scene.e1), _t(scene.e2),
                            0.0, 1e16)
    t, u, v, tid, hit = plucker_closest_hit(o, d, tri, tri_id, 0.0, 1e16)
    ref_hit, got_hit = ref["hit"].numpy(), hit.numpy()
    # the same hit/miss classification but for grazing boundary rays
    assert (ref_hit != got_hit).sum() <= 2
    both = ref_hit & got_hit
    np.testing.assert_allclose(t.numpy()[both], ref["t"].numpy()[both],
                               rtol=2e-4, atol=1e-4)
    same = tid.numpy()[both] == ref["tri_id"].numpy()[both]
    assert same.mean() > 0.995
    for got_c, k in ((u, "u"), (v, "v")):
        np.testing.assert_allclose(got_c.numpy()[both][same],
                                   ref[k].numpy()[both][same], rtol=5e-3,
                                   atol=2e-4)


def test_plucker_tmin_tmax():
    tri = triangle_constants(np.asarray([[-1, -1, 5]], np.float32),
                             np.asarray([[2, 0, 0]], np.float32),
                             np.asarray([[1, 2, 0]], np.float32))
    o = _t([[0.0, 0.0, 0.0]] * 3)
    d = _t([[0.0, 0.0, 1.0]] * 3)
    t, u, v, i, hit = plucker_closest_hit(o, d, tri, torch.tensor([0]),
                                          _t([0.0, 6.0, 0.0]), 1e16)
    assert hit.tolist() == [True, False, True]
    assert np.isclose(float(t[0]), 5.0) and int(i[1]) == -1


def test_plucker_padding_misses():
    z = np.zeros((4, 3), np.float32)
    tri = triangle_constants(z, z, z)
    o, d = (_t(x) for x in _random_rays(16))
    t, u, v, i, hit = plucker_closest_hit(o, d, tri,
                                          torch.full((4,), -1), 0.0)
    assert not hit.any() and (i == -1).all()
