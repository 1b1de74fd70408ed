"""The far-field cache's cull and shortlist (run_cache_shortlist) on the CPU.

Its twin, cache_shortlist_reference, must give the counts, ids and dmin
that the eager chain it was moved from gave, bit for bit: clusters fewer
than the shortlist's 128-column width (id 0 past them), a tile that meets
no cluster, a tile that meets more clusters than its columns, ties in the
distance key (ordered by id), far_mask excluding clusters, the cache's
centre inside sub-spheres, and the 8 sub-spheres of a small scene's
clusters.  _eager_* below is that chain as _cache_trace_inputs ran it
before csrc/cache_cull.cu, kept frozen here.  The kernel itself is held to
the twin on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from compound_ray_tpu_torch import testing
from compound_ray_tpu_torch.eye import pipeline as P
from compound_ray_tpu_torch.scene.eye_io import ommatidia_to_array

WIDTH = 64  # a 64 x 32 cache: 8 tiles of 16 x 16 pixels


def _eager_tile_cones(width):
    height = width // 2
    dirs = P._equirect_pixel_dirs(width, height, "cpu")
    n = dirs.shape[0]
    blocked = (dirs.reshape(height // 16, 16, width // 16, 16, 3)
               .permute(0, 2, 1, 3, 4).reshape(n, 3))
    td = blocked.reshape(n // 256, 256, 3)
    centroid = td.sum(dim=1)
    centroid = centroid / torch.clamp(
        torch.linalg.norm(centroid, dim=-1, keepdim=True), min=1e-30)
    cosmin = (td[:, :, 0] * centroid[:, None, 0]
              + td[:, :, 1] * centroid[:, None, 1]
              + td[:, :, 2] * centroid[:, None, 2]).amin(dim=1)
    half_ang = torch.arccos(torch.clamp(cosmin, -1.0, 1.0))
    return blocked, centroid, half_ang


def _eager_shortlist(centroid, half_ang, half_center, half_radius, center,
                     far_mask, kmax):
    """(counts, ids, dmin, gmask) of the cache's eager cull and sort."""
    to_c = half_center - center
    dist = torch.linalg.norm(to_c, dim=-1)
    inside = dist <= half_radius
    inv_d = 1.0 / torch.clamp(dist, min=1e-30)
    cos_a = (to_c[None, :, :, 0] * centroid[:, None, None, 0]
             + to_c[None, :, :, 1] * centroid[:, None, None, 1]
             + to_c[None, :, :, 2] * centroid[:, None, None, 2]) * inv_d
    alpha = torch.arccos(torch.clamp(cos_a, -1.0, 1.0))
    beta = torch.arcsin(torch.clamp(half_radius * inv_d, 0.0, 1.0))
    gmask = (inside | (alpha <= half_ang[:, None, None] + beta)).any(dim=-1)
    gmask = gmask & far_mask[None, :]
    counts = torch.clamp(gmask.sum(dim=-1), max=kmax).to(torch.int32)
    dmin_all = torch.clamp((dist - half_radius).amin(dim=-1), min=0.0)
    ids, dmin = P._shortlist_sorted(gmask, dmin_all[None, :].expand_as(gmask),
                                    kmax)
    return counts, ids, dmin, gmask


def _spheres(rng, c, h, dist, radius):
    """(half_center (C, H, 3), half_radius (C, H)) about the origin: centres
    at distances uniform in `dist` in uniform directions, radii uniform in
    `radius`."""
    d = rng.normal(size=(c, h, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = rng.uniform(*dist, size=(c, h, 1))
    rad = rng.uniform(*radius, size=(c, h))
    return (torch.tensor(d * r, dtype=torch.float32),
            torch.tensor(rad, dtype=torch.float32))


def _case(name):
    """run_cache_shortlist's keywords for one named case (8 tiles of a
    64-wide cache, its centre at the origin)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    _, centroid, half_ang = P._cache_tile_cones(WIDTH, "cpu")
    c, h, kmax = 300, 2, 128
    far = None
    dist, radius = (5.0, 50.0), (0.5, 3.0)
    if name == "few-clusters":  # C < KP: id 0 in the columns past C
        c, kmax = 50, 50
    elif name == "empty-tile":  # small clusters about (30, 0, 0) only
        dist, radius = (0.0, 2.0), (0.1, 0.5)
    elif name == "over-kp":  # wide spheres: tiles meet more than 128
        radius = (10.0, 25.0)
    elif name == "far-mask":
        far = rng.uniform(size=c) < 0.5
    elif name == "inside":  # the centre inside some sub-spheres
        dist, radius = (1.0, 20.0), (0.5, 6.0)
    elif name == "sub-spheres-8":
        c, h = 40, 8
    half_center, half_radius = _spheres(rng, c, h, dist, radius)
    if name == "empty-tile":
        half_center[..., 0] += 30.0
    elif name == "ties":  # every third cluster a copy of one before it
        half_center[2::3] = half_center[0::3][:c // 3]
        half_radius[2::3] = half_radius[0::3][:c // 3]
    return dict(centroid=centroid, half_ang=half_ang,
                half_center=half_center, half_radius=half_radius,
                center=torch.zeros(3),
                far_mask=torch.tensor(np.ones(c, bool) if far is None
                                      else far),
                kmax=kmax)


CASES = ["few-clusters", "empty-tile", "over-kp", "ties", "far-mask",
         "inside", "sub-spheres-8"]


@pytest.mark.parametrize("name", CASES)
def test_twin_equals_the_eager_chain(name):
    """cache_shortlist_reference gives the eager chain's counts, ids and
    dmin bit for bit, and each case holds what it is named for."""
    kw = _case(name)
    counts, ids, dmin = P.cache_shortlist_reference(**kw)
    want_c, want_i, want_d, gmask = _eager_shortlist(**kw)
    assert torch.equal(counts, want_c)
    assert torch.equal(ids, want_i)
    assert torch.equal(dmin.view(torch.int32), want_d.view(torch.int32))
    kp = P._ceil_to(kw["kmax"], 128)
    c = kw["far_mask"].shape[0]
    assert ids.shape == dmin.shape == (kw["centroid"].shape[0], kp)
    assert counts.dtype == ids.dtype == torch.int32
    survivors = gmask.sum(dim=-1)
    if name == "few-clusters":
        assert c < kp
        assert (ids[:, c:] == 0).all() and (dmin[:, c:] == 3e38).all()
    elif name == "empty-tile":
        empty = survivors == 0
        assert empty.any() and not empty.all()
        assert (counts[empty] == 0).all()
        assert torch.equal(ids[empty], torch.arange(kp, dtype=torch.int32)
                           .expand(int(empty.sum()), kp))
    elif name == "over-kp":
        assert (survivors > kp).any()
        assert (counts[survivors > kp] == kw["kmax"]).all()
        assert (dmin[survivors > kp] < 3e38).all()
    elif name == "ties":
        n = int(counts.max())
        g = int(counts.argmax())
        tied = dmin[g, 1:n] == dmin[g, :n - 1]
        assert tied.any()
        assert (ids[g, 1:n][tied] > ids[g, :n - 1][tied]).all()
    elif name == "far-mask":
        met = _eager_shortlist(**dict(kw, far_mask=torch.ones_like(
            kw["far_mask"])))[3]
        assert (met & ~kw["far_mask"][None, :]).any()
        assert not (gmask & ~kw["far_mask"][None, :]).any()
    elif name == "inside":
        to_c = kw["half_center"] - kw["center"]
        inside = torch.linalg.norm(to_c, dim=-1) <= kw["half_radius"]
        assert inside.any()
        assert gmask[:, inside.any(dim=-1)].all()
    elif name == "sub-spheres-8":
        assert kw["half_center"].shape[1] == 8
    for g in range(ids.shape[0]):  # survivors nearest first, then by id
        n = int(min(survivors[g], kp))
        key = dmin[g, :n].double() * 2**32 + ids[g, :n].double()
        assert (key[1:] > key[:-1]).all()
        rest = ids[g, n:][ids[g, n:] > 0]
        assert (rest[1:] > rest[:-1]).all()
        assert (dmin[g, n:] == 3e38).all()


@pytest.mark.parametrize("split", ["frame", "all"])
def test_cache_inputs_equal_the_eager_chain(split):
    """_cache_trace_inputs on the CPU, at a small scene's frame cache (8
    sub-spheres a cluster) and at every cluster: the tile cones and the
    shortlist equal the eager chain's, and the rays start at the centre."""
    scene = testing.make_big_scene(n_boxes=200, seed=11)
    omms = ommatidia_to_array(testing.make_sphere_eye(64, 4.0))
    splan = P.scene_plan(scene, "cpu")
    _, center, d = P._farfield_split(splan, omms, np.array(
        [0.0, 2.0, 0.0], np.float32), np.eye(3), 0.25)
    if split == "frame":
        a = P._frame_cache_args(splan, center, d)
        mask, kmax, center_t = a["far_mask"], a["kmax"], a["center"]
    else:
        mask = torch.ones(splan.num_clusters, dtype=torch.bool)
        kmax, center_t = 32, torch.tensor(np.asarray(center, np.float32))
    blocked, counts, ids, dmin, rays = P._cache_trace_inputs(
        splan.half_center, splan.half_radius, center_t, mask, WIDTH, kmax,
        tmin=1.5)
    want_b, centroid, half_ang = _eager_tile_cones(WIDTH)
    want = _eager_shortlist(centroid, half_ang, splan.half_center,
                            splan.half_radius, center_t, mask, kmax)
    assert torch.equal(blocked, want_b)
    assert torch.equal(counts, want[0]) and torch.equal(ids, want[1])
    assert torch.equal(dmin, want[2])
    assert (counts > 0).any() and splan.half_center.shape[1] == 8
    assert torch.equal(rays, P.pack_rays(
        want_b, center_t[None, :].expand(want_b.shape[0], 3),
        torch.full((want_b.shape[0],), 1.5)))


def test_wrapper_takes_the_twin_on_the_cpu():
    """run_cache_shortlist on CPU tensors is the twin and launches
    nothing."""
    kw = _case("over-kp")
    before = P.cache_cull_launches
    got = P.run_cache_shortlist(**kw)
    assert P.cache_cull_launches == before
    for a, b in zip(got, P.cache_shortlist_reference(**kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", [
    "float64-centroid", "int-far-mask", "half-ang-length", "sub-spheres",
    "centre-shape", "meta-device", "mixed-devices", "kmax-0", "kmax-wide"])
def test_wrapper_refuses_bad_inputs(bad):
    """A wrong dtype, shape or device, or a kmax outside 1 to the kernel's
    widest shortlist, raises before any work."""
    kw = _case("ties")
    if bad == "float64-centroid":
        kw["centroid"] = kw["centroid"].double()
    elif bad == "int-far-mask":
        kw["far_mask"] = kw["far_mask"].to(torch.int32)
    elif bad == "half-ang-length":
        kw["half_ang"] = kw["half_ang"][:-1]
    elif bad == "sub-spheres":
        kw["half_radius"] = kw["half_radius"][:, :1]
    elif bad == "centre-shape":
        kw["center"] = kw["center"][None, :]
    elif bad == "meta-device":
        kw = {k: v.to("meta") if torch.is_tensor(v) else v
              for k, v in kw.items()}
    elif bad == "mixed-devices":
        kw["center"] = kw["center"].to("meta")
    elif bad == "kmax-0":
        kw["kmax"] = 0
    else:
        kw["kmax"] = P.CACHE_CULL_MAX_KP + 1
    err = {"float64-centroid": TypeError, "int-far-mask": TypeError,
           "mixed-devices": TypeError}.get(bad, ValueError)
    with pytest.raises(err):
        P.run_cache_shortlist(**kw)
