"""The port's CUDA kernels on a card, against their torch twins.

JAX-free, so the file runs where JAX is absent (the card's machine):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Inputs come from the port's own pipeline.  Thresholds as in
tests/test_torch_k1.py: slot ids (K1, both forms) equal on >= 99.9 % of
live rays, t within rtol 1e-5 where they agree (the kernel fuses products
into FMAs, the twin does not); frame means within 2e-4.  K2 and K3 sum
their products in the twins' order without FMAs, so K2's rows and K3's
decisions must equal the twins' on every ray, bit for bit (K2 also at the
camera image's shapes).  The real-camera images and the oracle on the card against the
CPU: channels within 1 but at near-ties (the two closest hits within 1e-6
relative in t), oracle radiance within 2e-4.  The probes (K4, K5):
copy_only and dma_only bit-equal, the dot modes equal on >= 99.9 % of live rays within rtol 1e-5.
The dot bench (K6): within 1e-5 of the sum of |terms| in both precisions.
The planning refine (csrc/refine_mask.cu) writes every product, sum and
division as its twin (_refine_mask) rounds it: its row counts and pack
keys equal the twin's on the card bit for bit, and so do the plans built
through it, at the pose sweep cell's scene and poses.  The unlit shading
(csrc/shade_means.cu) rounds every sample's colour as its twin
(shade_means_reference) does, so only the mean's order of summation
differs: means within 1e-4, and 1e-6 on average.  Ray generation
(csrc/ray_features.cu) rounds every product and sum as its twin
(ray_features_reference) does: its rays and origins equal the twin's bit
for bit, and so do the frames made from them.  The far-field cache's cull
and shortlist (csrc/cache_cull.cu) rounds its test as its twin
(cache_shortlist_reference) does: counts, ids and dmin equal the twin's
bit for bit at the meadow cell's sweep poses, the steady cells' pose,
synthetic clusters that all survive, and a small scene, and so do the
caches built through it.
"""

import functools

import numpy as np
import pytest
import torch

from compound_ray_tpu_torch import testing
from compound_ray_tpu_torch.eye import pipeline as P
from compound_ray_tpu_torch.scene.eye_io import ommatidia_to_array
from compound_ray_tpu_torch.tools import microbench_k as MB
from compound_ray_tpu_torch.tools import probe_step as PS
from compound_ray_tpu_torch.trace import cluster_tracer as CT
from compound_ray_tpu_torch.trace import mm_tracer as TM
from compound_ray_tpu_torch.trace.lighting import default_lights
from compound_ray_tpu_torch.trace.shade import miss_id

SLOT_AGREE = 0.999
T_RTOL = 1e-5
ATOL = 2e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the twins are plain f32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
@pytest.mark.parametrize("accept_deg,samples", [(4.0, 640), (20.0, 640),
                                                (6.0, 64)])
def test_k1_matches_twin(cuda_device, accept_deg, samples):
    scene = testing.make_big_scene(n_boxes=60, seed=5)
    omms = ommatidia_to_array(testing.make_sphere_eye(16, accept_deg))
    f = testing.frame_pack(scene, omms, samples, (0.0, 2.0, 0.0), cuda_device)
    ep = f.eplan
    rays, _ = P.run_ray_features(f.omms_p, f.pos, f.ls, f.splay, f.spin,
                                 samples=samples, ng=ep.ng, g=ep.g,
                                 nrb=ep.nrb, rb_size=ep.rb_size)
    kw = dict(ng=ep.ng, nrb=ep.nrb, rb_size=ep.rb_size, rmax=f.rmax)
    before = TM.launches
    got = TM.run_packed_tracer(f.row_counts, f.packed_mm, rays, **kw)
    torch.cuda.synchronize()
    assert TM.launches == before + 1
    ref = TM.packed_tracer_reference(f.row_counts, f.packed_mm, rays, **kw)
    agree, _, max_rel = testing.hit_agreement(ref, got, f.row_counts,
                                              ep.rg_pad)
    assert agree >= SLOT_AGREE
    assert (torch.isfinite(ref[0]) & (ref[3] == got[3])).any()
    assert max_rel <= T_RTOL
    assert torch.equal(got[4:], torch.zeros_like(got[4:]))


def _affine_k1_case(device, accept_deg, samples):
    """An affine frame_pack frame (one ommatidium per group) and its
    8-feature rays: (row_counts, packed_mm, rays, kw, rg_pad)."""
    scene = testing.make_big_scene(n_boxes=60, seed=5)
    omms = ommatidia_to_array(testing.make_sphere_eye(16, accept_deg))
    f = testing.frame_pack(scene, omms, samples, (0.0, 2.0, 0.0), device,
                           affine=True)
    ep = f.eplan
    assert ep.g == 1
    rays, _ = P.run_ray_features(f.omms_p, f.pos, f.ls, f.splay, f.spin,
                                 samples=samples, ng=ep.ng, g=ep.g,
                                 nrb=ep.nrb, rb_size=ep.rb_size, affine=True)
    assert rays.shape[0] == TM.RAY_FEATS_AFFINE
    kw = dict(ng=ep.ng, nrb=ep.nrb, rb_size=ep.rb_size, rmax=f.rmax,
              ray_feats=TM.RAY_FEATS_AFFINE)
    return f.row_counts, f.packed_mm, rays, kw, ep.rg_pad


@pytest.mark.cuda
@pytest.mark.parametrize("accept_deg,samples", [(4.0, 640), (20.0, 640),
                                                (6.0, 128)])
def test_k1_affine_matches_twin(cuda_device, accept_deg, samples):
    """K1's 8-feature form (cr_packed_tracer_affine) on an affine pack
    against the twin at ray_feats=8, with the 16-feature thresholds; it
    counts as an affine launch, not a 16-feature one."""
    rc, pm, rays, kw, rg_pad = _affine_k1_case(cuda_device, accept_deg,
                                               samples)
    before, before_a = TM.launches, TM.affine_launches
    got = TM.run_packed_tracer(rc, pm, rays, **kw)
    torch.cuda.synchronize()
    assert (TM.launches, TM.affine_launches) == (before, before_a + 1)
    ref = TM.packed_tracer_reference(rc, pm, rays, **kw)
    agree, _, max_rel = testing.hit_agreement(ref, got, rc, rg_pad)
    assert agree >= SLOT_AGREE
    assert (torch.isfinite(ref[0]) & (ref[3] == got[3])).any()
    assert max_rel <= T_RTOL
    assert torch.equal(got[4:], torch.zeros_like(got[4:]))


@pytest.mark.cuda
@pytest.mark.parametrize("rg", [1, 100, 255, 300, 511])
def test_k1_affine_ragged_groups_match_twin(cuda_device, rg):
    """cr_packed_tracer_affine at groups of rays that fill no whole number
    of blocks of 256 rays (called directly: the wrapper pads groups to
    256): each group's first rg rays of an affine frame at 640 rays per
    group, traced alone, give the kernel's own output for them bit for bit
    and the twin's within the thresholds, and nothing past the output is
    written."""
    import ctypes

    from compound_ray_tpu_torch.trace import _build

    rc, pm, rays, kw, rg_pad = _affine_k1_case(cuda_device, 4.0, 640)
    full = TM.run_packed_tracer(rc, pm, rays, **kw)
    ref = TM.packed_tracer_reference(rc, pm, rays, **kw)
    ng = kw["ng"]
    cut = rays.reshape(8, ng, rg_pad)[:, :, :rg].contiguous()
    out = torch.full((8 * ng * rg + 64,), 7.0, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    err = _build.packed_tracer_lib().cr_packed_tracer_affine(
        ctypes.c_void_p(rc.data_ptr()), ctypes.c_void_p(pm.data_ptr()),
        ctypes.c_void_p(cut.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ng, kw["rmax"], rg, ng * rg, ctypes.c_void_p(stream))
    torch.cuda.synchronize()
    assert err == 0
    got = out[:8 * ng * rg].reshape(8, -1)
    assert torch.equal(got, full.reshape(8, ng, rg_pad)[:, :, :rg]
                       .reshape(8, -1))
    agree, _, max_rel = testing.hit_agreement(
        ref.reshape(8, ng, rg_pad)[:, :, :rg].reshape(8, -1), got, rc, rg)
    assert agree >= SLOT_AGREE and max_rel <= T_RTOL
    assert (out[8 * ng * rg:] == 7.0).all()


@pytest.mark.cuda
def test_affine_frame_on_card_matches_cpu(cuda_device):
    """The same affine frame (same numpy angles) on the card (K1's
    8-feature form) and on the CPU (its twin)."""
    omms = ommatidia_to_array(testing.make_sphere_eye(24, 5.0))
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        scene = testing.make_big_scene(n_boxes=60, seed=5)
        out.append(testing.frame_means(scene, testing.frame_pack(
            scene, omms, 256, (0.0, 2.0, 0.0), dev, affine=True)))
    np.testing.assert_allclose(out[0], out[1], atol=ATOL)


def _adversarial_k1_case(device, rg=256):
    """Four groups of rg rays [d = +z, o in [0, 1)^2 at binary fractions]
    against payloads with exact products: group 0 ties in t across lanes
    and rows (one triangle at lanes 3 and 100 of row 0 and lane 3 of row
    1, another at lane 50, all at z = 1; a nearer one at lane 120 of row 1
    over x < 1/2; a farther one at lane 0), group 1 hits at t = 0 with
    half its rays on the edge u + v = 1 exactly, group 2 has one row of
    padding columns only, group 3 no rows.  The other lanes are padding."""
    from compound_ray_tpu_torch.trace.plucker import triangle_constants

    ng, rmax = 4, 2
    pm = np.zeros((ng, rmax, 16, 512), np.float32)

    def put(g, j, lane, v0, e1, e2, slot):
        tri = triangle_constants(*(np.asarray([x], np.float32)
                                   for x in (v0, e1, e2)))
        col = np.zeros((4, 16), np.float32)
        col[0, 0:6] = tri["edge6"][0, 1]
        col[0, 10] = slot
        col[1, 0:6] = tri["edge6"][0, 2]
        col[2, 0:3] = tri["normal"][0]
        col[3, 6:9] = tri["normal"][0]
        col[3, 9] = tri["c0"][0]
        for b in range(4):
            pm[g, j, :, 128 * b + lane] = col[b]

    big = ((-1.0, -1.0, 1.0), (4.0, 0.0, 0.0), (0.0, 4.0, 0.0))
    for j, lane, slot in ((0, 3, 3.0), (0, 100, 100.0), (1, 3, 1003.0)):
        put(0, j, lane, *big, slot)
    put(0, 0, 50, (-2.0, -2.0, 1.0), (8.0, 0.0, 0.0), (0.0, 8.0, 0.0), 50.0)
    put(0, 0, 0, (-1.0, -1.0, 2.0), (4.0, 0.0, 0.0), (0.0, 4.0, 0.0), 0.0)
    put(0, 1, 120, (-1.0, -1.0, 0.5), (1.5, 0.0, 0.0), (0.0, 4.0, 0.0),
        1120.0)
    put(1, 0, 7, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), 7.0)
    rc = np.array([2, 1, 1, 0], np.int32)
    i = np.arange(rg)
    x = (i % 16) / 16.0 + 1.0 / 64.0
    y = (i // 16 % 16) / 16.0 + 1.0 / 64.0
    o = np.zeros((ng, rg, 3), np.float32)
    o[:, :, 0], o[:, :, 1] = x, y
    edge = i % 2 == 0  # group 1: every other ray on x + y = 1, the rest
    o[1, edge, 0] = (i[edge] % 128) / 128.0  # inside, at half the scale
    o[1, edge, 1] = 1.0 - o[1, edge, 0]
    o[1, ~edge, :2] *= 0.5
    d = np.zeros_like(o)
    d[..., 2] = 1.0
    rays = TM.pack_rays_mm(torch.as_tensor(d.reshape(-1, 3)),
                           torch.as_tensor(o.reshape(-1, 3)),
                           torch.zeros(ng * rg))
    return (torch.as_tensor(rc, device=device),
            torch.as_tensor(pm, device=device), rays.to(device),
            dict(ng=ng, nrb=1, rb_size=rg, rmax=rmax))


@pytest.mark.cuda
def test_k1_adversarial_payload_equals_twin(cuda_device):
    """Ties across lanes and rows, t = 0, u + v = 1 exactly and padding
    columns, all with exact products: winners, t, u and v equal the
    twin's bit for bit, and the tie order is the TPU's."""
    rc, pm, rays, kw = _adversarial_k1_case(cuda_device)
    got = TM.run_packed_tracer(rc, pm, rays, **kw)
    ref = TM.packed_tracer_reference(rc, pm, rays, **kw)
    assert torch.equal(got, ref)
    rg = kw["rb_size"]
    slots = got[3].reshape(4, rg)
    assert set(slots[0].unique().tolist()) == {3.0, 1120.0}
    assert (slots[1] == 7.0).all() and (got[0].reshape(4, rg)[1] == 0).all()
    u, v = got[1].reshape(4, rg)[1], got[2].reshape(4, rg)[1]
    assert ((u + v)[0::2] == 1.0).all()
    assert (slots[2:] == -1.0).all() and torch.isinf(got[0].reshape(
        4, rg)[2:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("rg", [1, 100, 255, 300, 511])
def test_k1_ragged_groups_match_twin(cuda_device, rg):
    """K1's C entry at groups of rays that fill no whole number of blocks
    of 256 rays (the wrapper pads groups to 256, so this calls the library
    directly): each group's first rg rays of the adversarial case at 512
    rays per group, traced alone, give the twin's output for them, and
    nothing past the output is written."""
    import ctypes

    from compound_ray_tpu_torch.trace import _build

    rc, pm, rays, kw = _adversarial_k1_case(cuda_device, rg=512)
    ref = TM.packed_tracer_reference(rc, pm, rays, **kw)
    ng = kw["ng"]
    cut = rays.reshape(16, ng, 512)[:, :, :rg].contiguous()
    out = torch.full((8 * ng * rg + 64,), 7.0, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    err = _build.packed_tracer_lib().cr_packed_tracer(
        ctypes.c_void_p(rc.data_ptr()), ctypes.c_void_p(pm.data_ptr()),
        ctypes.c_void_p(cut.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ng, kw["rmax"], rg, ng * rg, ctypes.c_void_p(stream))
    torch.cuda.synchronize()
    assert err == 0
    want = ref.reshape(8, ng, 512)[:, :, :rg].reshape(8, -1)
    assert torch.equal(out[:8 * ng * rg].reshape(8, -1), want)
    assert (out[8 * ng * rg:] == 7.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["make_box_scene", "make_mixed_flat_scene",
                                  "make_two_texture_scene"])
def test_frame_on_card_matches_cpu(cuda_device, name):
    """The same frame (same numpy angles) on the card (K1) and on the CPU
    (the twin)."""
    pos = (0.0, 1.5, 3.0) if name == "make_box_scene" else (0.0, 5.0, 0.0)
    omms = ommatidia_to_array(testing.make_sphere_eye(24, 5.0))
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        scene = getattr(testing, name)()
        out.append(testing.frame_means(
            scene, testing.frame_pack(scene, omms, 96, pos, dev)))
    np.testing.assert_allclose(out[0], out[1], atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("size", ["small", "medium"])
def test_k2_matches_twin(cuda_device, size, early_exit):
    """K2 on a far-field cache's own inputs, every cluster in the cache:
    small = the 200-box scene at width 64 (8 tiles, KP 128); medium = the
    2000-box bench scene at width 256 (128 tiles, KP 256)."""
    if size == "small":
        scene, width, pos = testing.make_big_scene(200, seed=11), 64, (
            0.0, 2.0, 0.0)
    else:
        scene, width = testing.make_big_scene(2000, seed=0), 256
        c = scene.aabb_center()
        pos = (float(c[0]), float(c[1]) + 1.0, float(c[2]))
    omms = ommatidia_to_array(testing.make_sphere_eye(64, 4.0))
    c = testing.cache_trace_inputs(scene, omms, pos, cuda_device, width,
                                   split="all")
    args = (c.counts, c.ids, c.dmin, c.payload, c.rays)
    before = CT.launches
    got = CT.run_tracer_kernel(*args, early_exit=early_exit, **c.kw)
    torch.cuda.synchronize()
    assert CT.launches == before + 1
    ref = CT.cluster_tracer_reference(*args, early_exit=early_exit, **c.kw)
    assert torch.isfinite(ref[:, 0]).float().mean() > 0.2
    assert torch.equal(got, ref)
    assert torch.equal(got[:, 5:], torch.zeros_like(got[:, 5:]))


def _k2_edge_case(device):
    """The 64-wide cache inputs of the 200-box scene (8 tiles of 256 rays,
    32 clusters, KP 128) with their shortlists rewritten: tile 0 walks
    nothing, tile 1 one cluster, tile 2 all KP entries (its shortlist
    repeated), tile 3 starts with an added cluster that holds one huge
    triangle in front of all its rays and a dmin[1] beyond it, so both of
    its batches leave before entry 1 while that entry's copy is in flight;
    the other tiles keep their own shortlists."""
    from compound_ray_tpu_torch.trace.plucker import triangle_constants

    scene = testing.make_big_scene(200, seed=11)
    omms = ommatidia_to_array(testing.make_sphere_eye(64, 4.0))
    c = testing.cache_trace_inputs(scene, omms, (0.0, 2.0, 0.0), "cpu", 64,
                                   split="all")
    counts, ids, dmin = c.counts.clone(), c.ids.clone(), c.dmin.clone()
    kp, rg = ids.shape[1], c.kw["rb_size"]
    assert kp == 128 and c.kw["ng"] == 8 and int(counts.min()) >= 4
    counts[0] = 0
    counts[1] = 1
    n2 = int(counts[2])
    reps = -(-kp // n2)
    ids[2] = ids[2, :n2].repeat(reps)[:kp]
    dmin[2] = dmin[2, :n2].repeat_interleave(1).repeat(reps)[:kp].sort()[0]
    counts[2] = kp
    rays3 = c.rays[3 * rg:4 * rg]
    mean_d = rays3[:, 0:3].mean(0)
    mean_d = mean_d / mean_d.norm()
    o = rays3[0, 6:9]
    a = torch.linalg.cross(mean_d, torch.tensor([0.3, 0.5, 0.8]))
    a = a / a.norm()
    b = torch.linalg.cross(mean_d, a)
    v0 = o + 0.5 * mean_d - 100.0 * a - 100.0 * b
    tri = triangle_constants(*(x.numpy()[None].astype(np.float32)
                               for x in (v0, 300.0 * a, 300.0 * b)))
    wall = torch.zeros((1, 16, 128))
    wall[0, 0:6, 5] = torch.as_tensor(tri["edge6"][0, 1])
    wall[0, 6:12, 5] = torch.as_tensor(tri["edge6"][0, 2])
    wall[0, 12:15, 5] = torch.as_tensor(tri["normal"][0])
    wall[0, 15, 5] = float(tri["c0"][0])
    payload = torch.cat([c.payload, wall])
    ids[3, 1:] = ids[3, :-1].clone()
    dmin[3, 1:] = dmin[3, :-1].clone().clamp(min=10.0)
    ids[3, 0] = payload.shape[0] - 1
    dmin[3, 0] = 0.0
    counts[3] = counts[3] + 1
    args = tuple(x.to(device).contiguous()
                 for x in (counts, ids, dmin, payload, c.rays))
    return args, dict(c.kw)


@pytest.mark.cuda
@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("kmax", [128, 32, 5, 1])
def test_k2_edge_shortlists_equal_twin(cuda_device, kmax, early_exit):
    """Shortlists of 0, 1, KP and mixed lengths, kmax at and under KP, and
    a tile whose batches leave at entry 1 with that entry's copy in flight:
    every row equals the twin's bit for bit with the early exit on and off,
    and the early leavers hold the wall's lane."""
    args, kw = _k2_edge_case(cuda_device)
    kw["kmax"] = kmax
    got = CT.run_tracer_kernel(*args, early_exit=early_exit, **kw)
    torch.cuda.synchronize()
    ref, walked = CT._cluster_tracer_twin(*args, early_exit=early_exit, **kw,
                                          count_walked=True)
    assert torch.equal(got, ref)
    rg = kw["rb_size"]
    assert torch.isinf(got[:rg, 0]).all() and (got[:rg, 3] == -1).all()
    wall = args[3].shape[0] - 1
    assert (got[3 * rg:4 * rg, 3] == wall).all()
    assert (got[3 * rg:4 * rg, 4] == 5).all()
    want3 = 1 if early_exit else min(int(args[0][3]), kmax)
    assert walked[3].tolist() == [want3] * (rg // CT.BATCH_RAYS)
    assert walked[2].max().item() <= kmax and walked[0].sum().item() == 0
    if not early_exit:
        assert walked[2].tolist() == [kmax] * (rg // CT.BATCH_RAYS)
    # launched again on the same inputs: no state survives a launch
    assert torch.equal(CT.run_tracer_kernel(*args, early_exit=early_exit,
                                            **kw), got)


@pytest.mark.cuda
def test_k2_wrapper_rejects_a_misaligned_payload(cuda_device):
    args, kw = _k2_edge_case(cuda_device)
    flat = torch.empty(args[3].numel() + 1, device=cuda_device)
    off = flat[1:].view_as(args[3]).copy_(args[3])
    assert off.data_ptr() % 16 and off.is_contiguous()
    with pytest.raises(ValueError):
        CT.run_tracer_kernel(args[0], args[1], args[2], off, args[4], **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("sky", [False, True], ids=["dense", "sky"])
def test_cache_frame_on_card_matches_cpu(cuda_device, sky):
    """A frame with the far-field cache on (64 wide), dense or with the sky
    split, on the card (K1, K2) and on the CPU (the twins), from the same
    numpy angles."""
    omms = ommatidia_to_array(testing.make_sphere_eye(64, 4.0))
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        scene = testing.make_big_scene(200, seed=11)
        out.append(testing.frame_means(scene, testing.frame_pack(
            scene, omms, 128, (0.0, 2.0, 0.0), dev, cache_width=64,
            sky=sky)))
    np.testing.assert_allclose(out[0], out[1], atol=ATOL)


@pytest.mark.cuda
def test_raw_samples_match_twin(cuda_device):
    """Raw samples (pipeline.render_samples: the dense pack, no far field)
    through K1 and through its twin on the card, same generator seed; K1
    launches once per frame."""
    scene = testing.make_big_scene(n_boxes=60, seed=5)
    omms = ommatidia_to_array(testing.make_sphere_eye(32, 4.0))

    def frame(tracer):
        gen = torch.Generator(device=cuda_device).manual_seed(9)
        return P.render_samples(
            scene, scene.device_triangles(cuda_device), omms,
            np.asarray([0.0, 2.0, 0.0], np.float32),
            np.eye(3, dtype=np.float32), gen, 96, 0, tracer=tracer)

    before = TM.launches
    got = frame(None)
    torch.cuda.synchronize()
    assert TM.launches == before + 1
    ref = frame(TM.packed_tracer_reference)
    assert got.shape == ref.shape == (96, 32, 3)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["spherical_orientationwise",
                                  "spherical_split_orientationwise"])
def test_voronoi_projection_on_card_matches_cpu(cuda_device, name):
    """A Voronoi projection of the same means at 160 x 80, 300 ommatidia, on
    the card and on the CPU: index maps equal but at near-ties (the two
    winners' angles within 1e-6 rad), colours within 1."""
    from compound_ray_tpu_torch.projection import project as PR

    w, h = 160, 80
    omms = ommatidia_to_array(testing.make_sphere_eye(300))
    means = np.random.default_rng(4).uniform(size=(300, 3)).astype(
        np.float32)
    frames, maps = [], []
    for dev in (cuda_device, torch.device("cpu")):
        pos, dirs = (torch.tensor(x, device=dev)
                     for x in (omms[:, 0:3], omms[:, 3:6]))
        frames.append(PR.project_frame(name, torch.tensor(means, device=dev),
                                       None, pos, dirs, w, h).cpu().numpy())
        maps.append(PR.voronoi_index_map(
            dirs, w, h, split="split" in name,
            positions_x=pos[:, 0]).cpu().numpy())
    share, gap = testing.voronoi_agreement(maps[0], maps[1], omms[:, 3:6],
                                           w, h)
    assert share >= 0.999 and gap < 1e-6
    same = maps[0] == maps[1]
    assert np.abs(frames[0][same].astype(int)
                  - frames[1][same].astype(int)).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("feats", [16, 8])
@pytest.mark.parametrize("size", ["small", "medium"])
def test_k3_matches_twin(cuda_device, size, feats):
    """K3 on a pose pack laid out as an occluder table (two groups with
    no rows): small = the 60-box scene, 16 ommatidia, 640 samples; medium =
    the 2000-box bench scene at its bench pose, 256 ommatidia, 640
    samples."""
    if size == "small":
        scene, n_omm = testing.make_big_scene(60, seed=5), 16
        pos = (0.0, 2.0, 0.0)
    else:
        scene, n_omm = testing.make_big_scene(2000, seed=0), 256
        c = scene.aabb_center()
        pos = (float(c[0]), float(c[1]) + 1.0, float(c[2]))
    omms = ommatidia_to_array(testing.make_sphere_eye(n_omm, 4.0))
    f = testing.frame_pack(scene, omms, 640, pos, cuda_device, seed=9)
    r2v, flag, rows, rays, rc, kw = testing.pack_occlusion_table(
        f, feats=feats, skip=(0, 3))
    before = TM.occlusion_launches
    got = TM.run_rows_occlusion(r2v, flag, rows, rays, **kw)
    torch.cuda.synchronize()
    assert TM.occlusion_launches == before + 1
    ref = TM.rows_occlusion_reference(r2v, flag, rows, rays, **kw)
    assert torch.equal(got, ref)
    live = torch.repeat_interleave(torch.as_tensor(rc > 0, device=got.device),
                                   kw["nrb"] * kw["rb_size"])
    assert got[0, live].any() and not got[0, live].all()
    assert not got[0, ~live].any()


@pytest.mark.cuda
def test_k3_matches_twin_on_a_lit_frame(cuda_device):
    """K3 on the shadow rays and table of a lit frame (the reverse-affine
    F = 8 form), the canopy scene with its default lights: the frame reads
    the 4 live features, and its decisions equal the twin's at L = 4 and
    at L = F = 8."""
    scene = testing.make_canopy_scene()
    omms = ommatidia_to_array(testing.canopy_eye(2.0))
    f = testing.frame_pack(scene, omms, 256, (0.0, 0.0, 0.0), cuda_device)
    r2v, flag, rows, rays, kw = testing.lit_occlusion_inputs(
        scene, f, default_lights(scene.aabb_min, scene.aabb_max))
    assert kw["live_feats"] == P.SHADOW_LIVE_FEATS == 4
    assert rows.shape[1] == P.SHADOW_FEATS == 8
    got = TM.run_rows_occlusion(r2v, flag, rows, rays, **kw)
    ref = TM.rows_occlusion_reference(r2v, flag, rows, rays, **kw)
    assert torch.equal(got, ref) and got.any() and not got.all()
    kw8 = dict(kw, live_feats=8)
    assert torch.equal(TM.run_rows_occlusion(r2v, flag, rows, rays, **kw8),
                       got)
    assert torch.equal(TM.rows_occlusion_reference(r2v, flag, rows, rays,
                                                   **kw8), ref)


def _random_occlusion_table(device, nvg, rg, feats, live, seed):
    """A K3 table of random rows (0-3 per virtual group, one group with
    none, then 3 padding rows) whose features live..F-1 are zero in rows
    and rays, as in the shadow plan's table."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 4, nvg)
    counts[1] = 0
    counts[0] = 3
    tb = int(counts.sum()) + 3
    rows = np.zeros((tb, feats, 512), np.float32)
    rows[:, :live] = rng.standard_normal((tb, live, 512))
    # tnum's feature 3 against the rays' 1: most slots fail tt <= d
    rows[:, 3, 384:512] = rng.choice([-4.0, 4.0], (tb, 128))
    rows[-3:] = 0.0
    rays = np.zeros((feats, nvg * rg), np.float32)
    rays[:live] = rng.standard_normal((live, nvg * rg))
    rays[3] = 1.0
    r2v = np.concatenate([np.repeat(np.arange(nvg), counts),
                          np.full(3, nvg - 1)]).astype(np.int32)
    flag = np.concatenate([np.concatenate([[2] + [1] * (c - 1) for c in
                                           counts if c]), np.zeros(3)])
    return (torch.as_tensor(r2v, device=device),
            torch.as_tensor(flag.astype(np.int32), device=device),
            torch.as_tensor(rows, device=device),
            torch.as_tensor(rays, device=device), counts)


@pytest.mark.cuda
@pytest.mark.parametrize("feats,live", [(8, 4), (8, 8), (16, 4), (16, 16)])
@pytest.mark.parametrize("nrb", [1, 3, 5])
def test_k3_ragged_groups_match_twin(cuda_device, feats, live, nrb):
    """Groups of 128, 384 and 640 rays (one, three and five blocks of 128
    threads, several blocks to a group): every decision equals the twin's,
    zero-row groups come out clear, and L = 4 reads of a table whose
    features 4..F-1 are zero decide as L = F does."""
    nvg, rb = 6, 128
    r2v, flag, rows, rays, counts = _random_occlusion_table(
        cuda_device, nvg, nrb * rb, feats, live, seed=feats + nrb)
    kw = dict(nrb=nrb, rb_size=rb, live_feats=live)
    before = TM.occlusion_launches
    got = TM.run_rows_occlusion(r2v, flag, rows, rays, **kw)
    torch.cuda.synchronize()
    assert TM.occlusion_launches == before + 1
    ref = TM.rows_occlusion_reference(r2v, flag, rows, rays, **kw)
    assert torch.equal(got, ref)
    full = TM.rows_occlusion_reference(r2v, flag, rows, rays, nrb=nrb,
                                       rb_size=rb)
    assert torch.equal(full, ref)
    live_rays = torch.repeat_interleave(
        torch.as_tensor(counts > 0, device=got.device), nrb * rb)
    assert got[0, live_rays].any() and not got[0, live_rays].all()
    assert not got[0, ~live_rays].any()


@pytest.mark.cuda
@pytest.mark.parametrize("rg", [1, 100, 200])
def test_k3_ragged_rays_match_twin(cuda_device, rg):
    """K3's C entry at groups of rays that fill no whole block of 128
    threads (the wrapper takes groups of whole 128-ray blocks, so this calls
    the library directly): each group's first rg rays of a random table at
    256 rays per group, traced alone at L = 4, give the twin's decisions for
    them, and nothing past the output is written."""
    import ctypes

    from compound_ray_tpu_torch.trace import _build

    nvg = 6
    r2v, flag, rows, rays, _ = _random_occlusion_table(
        cuda_device, nvg, 256, 8, 4, seed=rg)
    ref = TM.rows_occlusion_reference(r2v, flag, rows, rays, nrb=2,
                                      rb_size=128, live_feats=4)
    cut = rays.reshape(8, nvg, 256)[:, :, :rg].contiguous()
    start, count = TM._row_ranges(r2v, flag, nvg)
    out = torch.full((nvg * rg + 64,), 7.0, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    err = _build.rows_occlusion_lib().cr_rows_occlusion(
        ctypes.c_void_p(start.data_ptr()), ctypes.c_void_p(count.data_ptr()),
        ctypes.c_void_p(rows.data_ptr()), ctypes.c_void_p(cut.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), nvg, 8, 4, rg, nvg * rg,
        ctypes.c_void_p(stream))
    torch.cuda.synchronize()
    assert err == 0
    want = ref.reshape(nvg, 256)[:, :rg].reshape(-1)
    assert torch.equal(out[:nvg * rg], want)
    assert (out[nvg * rg:] == 7.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["canopy", "mr_normal"])
def test_lit_frame_on_card_matches_cpu(cuda_device, name):
    """The same lit frame (same numpy angles, so the same probe) on the card
    (K1, K3) and on the CPU (the twins)."""
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        if name == "canopy":
            scene = testing.make_canopy_scene()
            omms = ommatidia_to_array(testing.canopy_eye(2.0))
            pos = (0.0, 0.0, 0.0)
        else:
            scene = testing.make_mr_normal_scene()
            omms = ommatidia_to_array(testing.make_sphere_eye(24, 5.0))
            pos = (0.0, 5.0, 0.0)
        f = testing.frame_pack(scene, omms, 128, pos, dev, seed=4)
        out.append(testing.lit_frame_means(
            scene, f, default_lights(scene.aabb_min, scene.aabb_max)))
    assert out[0].max() > 0.7
    np.testing.assert_allclose(out[0], out[1], atol=ATOL)


# the real cameras' pose and parameters (tests/test_fast_image.py): 60
# degrees of y field of view for the pinhole at its aspect
CAM_POS = (0.0, 3.0, 40.0)
CAM_LS = np.diag([1.0, 1.0, -1.0])
CAM_KINDS = {"pinhole": None, "panoramic": [0.0],
             "orthographic": [30.0, 20.0]}


def _cam_param(kind, width, height):
    if kind == "pinhole":
        y = float(np.tan(np.radians(30.0)))
        return [y * width / height, y, 1.0]
    return CAM_KINDS[kind]


def _hold_images(card, cpu, ties):
    """Card and CPU images: equal within 1 per channel but at near-ties."""
    diff = np.abs(card.astype(int) - cpu.astype(int)).max(axis=-1)
    assert card.shape == cpu.shape
    assert not ((diff > 1) & ~ties).any()


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(40, 24), (256, 256)],
                         ids=["40x24", "256x256"])
def test_k2_matches_twin_at_image_shapes(cuda_device, size):
    """K2 on the pinhole image's own inputs on the bench scene (256
    clusters, so KP = kmax = 256, tiles of 256 rays, early exit on): every
    row equals the twin's bit for bit."""
    scene = testing.make_big_scene(2000, seed=0)
    w, h = size
    c = testing.camera_trace_inputs(scene, "pinhole", CAM_POS, CAM_LS,
                                    _cam_param("pinhole", w, h), w, h,
                                    cuda_device)
    assert c.kw["kmax"] == c.ids.shape[1] == 256
    args = (c.counts, c.ids, c.dmin, c.payload, c.rays)
    before = CT.launches
    got = CT.run_tracer_kernel(*args, early_exit=True, **c.kw)
    torch.cuda.synchronize()
    assert CT.launches == before + 1
    ref = CT.cluster_tracer_reference(*args, early_exit=True, **c.kw)
    assert torch.isfinite(ref[:, 0]).float().mean() > 0.3
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(CAM_KINDS))
def test_camera_image_on_card_matches_cpu(cuda_device, kind):
    """The tile-culled image (K2 on the card, its twin on the CPU) and the
    oracle image of the 80-box scene at 64 x 48, on both devices."""
    from compound_ray_tpu_torch.cameras.fast_image import (
        render_camera_image_fast,
    )
    from compound_ray_tpu_torch.cameras.raygen import render_camera_image

    w, h = 64, 48
    param = _cam_param(kind, w, h)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        scene = testing.make_big_scene(80, seed=9)
        sd = scene.device_triangles(dev)
        args = (kind, np.asarray(CAM_POS, np.float32),
                np.asarray(CAM_LS, np.float32), np.asarray(param, np.float32),
                w, h, 3)
        out.append((render_camera_image_fast(scene, sd, *args).cpu().numpy(),
                    render_camera_image(sd, *args).cpu().numpy()))
    ties = testing.camera_near_ties(testing.make_big_scene(80, seed=9), kind,
                                    CAM_POS, CAM_LS, param, w, h, "cpu")
    for a, b in zip(*out):
        _hold_images(a, b, ties)


@pytest.mark.cuda
def test_oracle_on_card_matches_cpu(cuda_device):
    """The oracle's lit frame (render_compound_samples, shadow rays over the
    whole soup) on the card and on the CPU from the same angles."""
    from compound_ray_tpu_torch.eye.render import render_compound_samples

    scene = testing.make_mr_normal_scene()
    omms = ommatidia_to_array(testing.make_sphere_eye(24, 5.0))
    rng = np.random.default_rng(2)
    splay = (rng.standard_normal((16, 24)) * 0.03).astype(np.float32)
    spin = (rng.uniform(size=(16, 24)) * np.pi).astype(np.float32)
    lights = default_lights(scene.aabb_min, scene.aabb_max)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        out.append(render_compound_samples(
            scene.device_triangles(dev), omms, (0.0, 5.0, 0.0), np.eye(3),
            None, 16, 2, True, lights,
            angles=(torch.tensor(splay, device=dev),
                    torch.tensor(spin, device=dev))).cpu().numpy())
    assert out[0].max() > 0.1
    np.testing.assert_allclose(out[0], out[1], atol=ATOL)


# row counts per group of the probes' card cases: two rows in most groups and
# none in group 1; and rmax 3 with 0 to 3 rows and one count above rmax, which
# the kernel clamps
PROBE_CASES = {"two_rows": (2, (2, 0, 2, 2, 1, 2, 2, 2)),
               "ragged": (3, (3, 0, 2, 1, 5, 0, 3, 1))}


def _probe_inputs(device, case="two_rows", rb_size=1024):
    """make_inputs with the row counts of PROBE_CASES[case]."""
    rmax, counts = PROBE_CASES[case]
    rc, pmm, rays = PS.make_inputs(len(counts), rb_size, rmax, seed=3)
    rc[:] = counts
    return tuple(torch.as_tensor(x, device=device) for x in (rc, pmm, rays))


def _hold_probe(ref, got, rc, rb_size, mode):
    live = torch.repeat_interleave(rc > 0, rb_size)
    assert torch.isinf(got[0, ~live]).all() and (got[0, ~live] > 0).all()
    if mode in ("copy_only", "dma_only"):
        assert torch.equal(got[0, live], ref[0, live])
    else:
        agree, _, max_rel = testing.probe_agreement(ref, got, rc, rb_size)
        assert agree >= SLOT_AGREE and max_rel <= T_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", PROBE_CASES)
@pytest.mark.parametrize("rs", PS.CHAIN_WIDTHS)
@pytest.mark.parametrize("mode", PS.MODES)
def test_k4_probe_matches_twin(cuda_device, mode, rs, case):
    rc, pmm, rays = _probe_inputs(cuda_device, case)
    ng, rb, rmax = pmm.shape[0], rays.shape[1] // pmm.shape[0], pmm.shape[1]
    before = PS.probe_launches
    got = PS.run_probe(rc, pmm, rays, ng, rb, rmax, mode, rs)
    torch.cuda.synchronize()
    assert PS.probe_launches == before + 1
    ref = PS.probe_reference(rc, pmm, rays, ng, rb, rmax, mode)
    _hold_probe(ref, got, rc, rb, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PROBE_CASES)
@pytest.mark.parametrize("mode", PS.MODES)
def test_k5_probe3d_matches_twin(cuda_device, mode, case):
    """The 3-D layout; its dot_only is the full dot_cand, as on the TPU."""
    rc, pmm, rays = _probe_inputs(cuda_device, case)
    ng, rb, rmax = pmm.shape[0], rays.shape[1] // pmm.shape[0], pmm.shape[1]
    rays3d = rays.reshape(16, ng, rb).permute(1, 0, 2).contiguous()
    before = PS.probe3d_launches
    got = PS.run_probe3d(rc, pmm, rays3d, ng, rb, rmax, mode)
    torch.cuda.synchronize()
    assert PS.probe3d_launches == before + 1
    ref = PS.probe_reference(rc, pmm, rays3d, ng, rb, rmax, mode, "3d")
    _hold_probe(ref, got, rc, rb, mode)
    if mode == "dot_only":
        assert torch.equal(got, PS.run_probe3d(rc, pmm, rays3d, ng, rb, rmax,
                                               "dot_cand"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", PROBE_CASES)
@pytest.mark.parametrize("mode", ["dot_only", "dot_cand"])
def test_probe_value_does_not_depend_on_rs(cuda_device, mode, case):
    """A ray's value is the same at 256, 512 and 1024 rays per block and in
    both layouts, bit for bit: each product is one fmaf chain in feature
    order, whatever the block's tiling."""
    rc, pmm, rays = _probe_inputs(cuda_device, case)
    ng, rb, rmax = pmm.shape[0], rays.shape[1] // pmm.shape[0], pmm.shape[1]
    outs = [PS.run_probe(rc, pmm, rays, ng, rb, rmax, mode, rs)
            for rs in PS.CHAIN_WIDTHS]
    assert torch.isfinite(outs[0]).any()
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    if mode == "dot_cand":
        rays3d = rays.reshape(16, ng, rb).permute(1, 0, 2).contiguous()
        assert torch.equal(PS.run_probe3d(rc, pmm, rays3d, ng, rb, rmax,
                                          mode), outs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 2048])
@pytest.mark.parametrize("k,prec", [(16, "highest"), (16, "default"),
                                    (96, "highest"), (256, "default")])
def test_k6_dot_bench_matches_twin(cuda_device, k, prec, n):
    ft, mm = MB.bench_inputs(k, n, cuda_device)
    before = MB.dot_bench_launches
    got = MB.run_dot_bench(ft, mm, prec, 40)
    torch.cuda.synchronize()
    assert MB.dot_bench_launches == before + 1
    ref = MB.dot_bench_reference(ft, mm, prec, 40)
    scale = testing.dot_bench_scale(ft, mm, prec, 40)
    assert ((got.double() - ref.double()).abs() / scale).max() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 2, 7, 40])
@pytest.mark.parametrize("n", MB.NS)
@pytest.mark.parametrize("k", sorted({k for k, p in MB.SWEEP
                                      if p == "default"}))
def test_k6_default_every_swept_shape(cuda_device, k, n, steps):
    """The wgmma form at every (K, N) the microbench sweeps (K 256, N 2048 is the
    largest shared-memory case), at step counts of 1, under and not a
    multiple of the 4 steps its loop unrolls, and 40."""
    ft, mm = MB.bench_inputs(k, n, cuda_device)
    got = MB.run_dot_bench(ft, mm, "default", steps)
    torch.cuda.synchronize()
    ref = MB.dot_bench_reference(ft, mm, "default", steps)
    scale = testing.dot_bench_scale(ft, mm, "default", steps)
    assert ((got.double() - ref.double()).abs() / scale).max() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(32, 128), (80, 1024), (240, 2112),
                                 (16, 2080)])
def test_k6_default_other_shapes(cuda_device, k, n):
    """K and N outside the sweep: every multiple of 16 and of 32 the
    contract takes, on both tile widths (2112 = 33 x 64 takes the wide
    tile, 2080 the narrow one)."""
    rng = np.random.default_rng(k + n)
    ft = torch.as_tensor(rng.standard_normal((k, MB.RS)).astype(np.float32),
                         device=cuda_device)
    mm = torch.as_tensor(
        rng.standard_normal((MB.NROWS, k, n)).astype(np.float32),
        device=cuda_device)
    got = MB.run_dot_bench(ft, mm, "default", 9)
    ref = MB.dot_bench_reference(ft, mm, "default", 9)
    scale = testing.dot_bench_scale(ft, mm, "default", 9)
    assert ((got.double() - ref.double()).abs() / scale).max() <= 1e-5


@pytest.mark.cuda
def test_blend_scene_frame_card_vs_cpu(cuda_device, tmp_path):
    """A written .blend loaded by EyeRenderer on the card and on the CPU:
    the same scene, and its compound eye's frame at the eye's pose, from
    the same numpy angles, through K1 on the card and its twin on the CPU
    within ATOL."""
    from compound_ray_tpu_torch import EyeRenderer

    path = testing.write_big_scene_blend(
        str(tmp_path), n_boxes=60, seed=5, n_omm=64, accept_deg=4.0,
        camera_pos=(0.0, 3.0, 40.0))
    means, scenes = [], []
    for dev in (cuda_device, torch.device("cpu")):
        r = EyeRenderer(verbose=False, device=dev)
        r.load_gltf_scene(path)
        r.goto_camera_by_name("insect-eye-spherical-projector")
        cam = r.current_camera()
        f = testing.frame_pack(r.scene, cam.ommatidia, 64, cam.position, dev)
        assert (f.row_counts > 0).any()
        means.append(testing.frame_means(r.scene, f))
        scenes.append(r.scene)
    np.testing.assert_array_equal(scenes[0].v0, scenes[1].v0)
    assert np.isfinite(means[0]).all()
    np.testing.assert_allclose(means[0], means[1], atol=ATOL)


REFINE_POSES = 16


@functools.lru_cache(maxsize=1)
def _natural_sweep():
    """The natural-1000 cell's scene, its eye, its render settings, and
    (position, local space) at the configuration's pose and at
    REFINE_POSES seeded poses of the pose sweep's region
    (testing.natural_sweep)."""
    scene, omms, render_config, _, poses = testing.natural_sweep(
        REFINE_POSES, 17)
    return scene, omms, render_config, [testing.pose_arrays(p)
                                        for p in poses]


@pytest.mark.cuda
@pytest.mark.parametrize("with_dmax", [False, True], ids=["plain", "dmax"])
@pytest.mark.parametrize("samples", [100, 128], ids=["g2", "g1"])
@pytest.mark.parametrize("refine_mode", ["exact", "sphere"])
def test_refine_kernel_equals_twin_on_the_sweep(cuda_device, refine_mode,
                                                samples, with_dmax):
    """run_refine's kernel against refine_reference on the card, chunk by
    chunk as the pack calls it, at the natural-1000 cell's pose and 16
    sweep poses: row counts equal and keys bit for bit, one launch per
    chunk.  dmax is a seeded apex-distance bound per ommatidium."""
    scene, omms, _, poses = _natural_sweep()
    splan = P.scene_plan(scene, cuda_device)
    eplan = P.eye_plan(omms, samples)
    g = eplan.g
    assert g == (2 if samples == 100 else 1)
    omms_p = eplan.device_arrays(omms, cuda_device)[0]
    tri = splan.slot_tri_cl if refine_mode == "exact" else None
    rng = np.random.default_rng(samples)
    refined = chunks = 0
    before = P.refine_launches
    for pos_np, ls_np in poses:
        pos = torch.as_tensor(pos_np, device=cuda_device)
        ls = torch.as_tensor(ls_np, device=cuda_device)
        gmask, counts, dmin = P._cull_groups(
            omms_p, pos, ls, splan.half_center, splan.half_radius, 4.0, g)
        kcand = min(splan.num_clusters,
                    P._ceil_to(max(int(counts.max()), 1), 8))
        ids = P._shortlist_sorted(gmask, dmin, kcand)[0][:, :kcand]
        cl = torch.clamp(counts, max=kcand)
        dmax = (torch.tensor(rng.uniform(1.0, 30.0, omms_p.shape[0]),
                             dtype=torch.float32, device=cuda_device)
                if with_dmax else None)
        for g0, g1 in P._refine_chunks(ids.shape[0], g, kcand):
            args = (omms_p[g0 * g:g1 * g], pos, ls, ids[g0:g1], cl[g0:g1],
                    splan.slot_center_cl, splan.slot_radius_cl, g, 4.0, tri)
            dm = None if dmax is None else dmax[g0 * g:g1 * g]
            rows, key = P.run_refine(*args, dmax=dm)
            torch.cuda.synchronize()
            want_rows, want_key = P.refine_reference(*args, dmax=dm)
            assert torch.equal(rows, want_rows)
            assert torch.equal(key, want_key)
            refined += int(torch.isfinite(key).sum())
            chunks += 1
    assert P.refine_launches == before + chunks
    assert refined > 0


@pytest.mark.cuda
def test_plans_through_the_refine_kernel_equal_the_twin_path(cuda_device,
                                                            monkeypatch):
    """_plan_frame at the natural-1000 cell's 100 samples and render
    settings, at the configuration's pose and 16 sweep poses, with a fresh
    pack store and the same width hints on both sides: the plan through
    the kernel (one pass that measures its widths and packs) and the plan
    through the twin (run_refine replaced by refine_reference) give equal
    widths and torch.equal (row_counts, packed_mm); the twin path launches
    no kernel."""
    from compound_ray_tpu_torch import config
    from compound_ray_tpu_torch.trace.shade import miss_id

    scene, omms, render_config, poses = _natural_sweep()
    monkeypatch.setattr(config, "_global_config",
                        config.RenderConfig(**render_config))
    splan = P.scene_plan(scene, cuda_device)
    eplan = P.eye_plan(omms, 100)
    scene_dev = scene.device_triangles(cuda_device)
    background = miss_id(scene.background_shader)

    def plan(pos, ls, hints):
        splan.packed_store.clear()
        eplan.kmax_hint, eplan.rmax_hint = hints
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        kw, _ = P._plan_frame(scene, scene_dev, omms, pos, ls, gen, 100,
                              background)
        torch.cuda.synchronize()
        return kw["row_counts"], kw["packed_mm"], kw["rmax"]

    twin_run = P.refine_reference
    for pos, ls in poses:
        hints = (eplan.kmax_hint, eplan.rmax_hint)
        before = P.refine_launches
        rc_k, pm_k, rmax_k = plan(pos, ls, hints)
        assert P.refine_launches > before
        after = (eplan.kmax_hint, eplan.rmax_hint)
        with monkeypatch.context() as m:
            m.setattr(P, "run_refine", twin_run)
            before = P.refine_launches
            rc_t, pm_t, rmax_t = plan(pos, ls, hints)
            assert P.refine_launches == before
        assert (eplan.kmax_hint, eplan.rmax_hint) == after
        assert rmax_k == rmax_t
        assert torch.equal(rc_k, rc_t)
        assert torch.equal(pm_k, pm_t)


def _wrap_texture_scene():
    """Two textures with nearest and linear filtering under clamp and
    mirror addressing."""
    scene = testing.make_two_texture_scene()
    scene.tex_wrap_s = np.array([1, 2], np.int32)
    scene.tex_wrap_t = np.array([2, 1], np.int32)
    scene.tex_filter = np.array([0, 1], np.int32)
    scene._device_cache = None
    return scene


def _big_field():
    return testing.make_big_scene(200, seed=11)


# name -> (scene, (ommatidia, degrees), samples, pose, frame_pack keywords,
# frames of a stacked burst)
SHADE_CASES = {
    "textured-flat": (testing.make_mixed_flat_scene, (48, 6.0), 96,
                      (0.0, 5.0, 0.0), {}, 1),
    "tex-only-wraps": (_wrap_texture_scene, (48, 8.0), 64, (0.0, 5.0, 0.0),
                       {}, 1),
    "tex-only-g1-320": (testing.make_two_texture_scene, (64, 8.0), 320,
                        (0.0, 5.0, 0.0), {}, 1),
    "flat-white-g8": (lambda: testing.make_box_scene("white", colored=False),
                      (64, 6.0), 16, (0.0, 2.0, 3.0), {}, 1),
    "vertex-default-bg": (
        lambda: testing.make_box_scene("default_background"), (64, 6.0), 64,
        (0.0, 2.0, 3.0), {}, 1),
    "vertex-simple-sky": (testing.make_box_scene, (64, 6.0), 3200,
                          (0.0, 2.0, 3.0), {}, 1),
    "burst-4": (testing.make_mixed_flat_scene, (48, 6.0), 100,
                (0.0, 5.0, 0.0), {}, 4),
    "cache": (_big_field, (64, 4.0), 128, (0.0, 2.0, 0.0),
              {"cache_width": 64}, 1),
    "cache-textured": (lambda: testing.add_textured_quads(_big_field()),
                       (64, 4.0), 128, (0.0, 2.0, 0.0), {"cache_width": 64},
                       1),
    "cache-sky": (_big_field, (64, 4.0), 128, (0.0, 2.0, 0.0),
                  {"cache_width": 64, "sky": True}, 1),
}
SHADE_MAX_ABS = 1e-4
SHADE_MEAN_ABS = 1e-6


def _shade_case(name, device):
    make, (n, deg), samples, pos, extra, frames = SHADE_CASES[name]
    scene = make()
    omms = ommatidia_to_array(testing.make_sphere_eye(n, deg))
    f = testing.frame_pack(scene, omms, samples, pos, device, seed=3,
                           **extra)
    return scene, f, frames


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHADE_CASES))
def test_shade_kernel_matches_twin(cuda_device, name):
    """csrc/shade_means.cu against shade_means_reference on the same K1
    rows and rays, one launch each: every sample's colour is the twin's,
    so the means differ only by the order of summation."""
    scene, f, frames = _shade_case(name, cuda_device)
    out, rays, _, kw = testing.shade_inputs(scene, f, frames=frames)
    before = P.shade_launches
    got = P.run_shade_means(out, rays, **kw)
    torch.cuda.synchronize()
    assert P.shade_launches == before + 1
    want = P.shade_means_reference(out, rays, **kw)
    assert got.shape == want.shape == (f.omms_p.shape[0], frames, 3)
    err = (got - want).abs()
    assert err.max().item() <= SHADE_MAX_ABS, err.max().item()
    assert err.mean().item() <= SHADE_MEAN_ABS, err.mean().item()
    if name == "tex-only-g1-320":
        assert (kw["g"], kw["rg_pad"]) == (1, 512)
    if name == "flat-white-g8":
        assert kw["g"] == 8


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cache-sky", "textured-flat"])
def test_frames_shade_once_through_the_kernel(cuda_device, name):
    """A frame core on the card shades through the kernel, one launch a
    frame, the sky split's scatter applied after it; the same frame
    through the twin (shader=shade_means_reference) launches none and
    agrees; lit frames and raw samples never launch the kernel."""
    scene, f, _ = _shade_case(name, cuda_device)
    ep = f.eplan
    args = dict(packed_mm=f.packed_mm, row_counts=f.row_counts,
                attr_table=f.splan.attr_table,
                scene_dev=scene.device_triangles(cuda_device),
                quad_table=f.splan.quad_table, omms_p=f.omms_p,
                position=f.pos, local_space=f.ls, splay=f.splay,
                spin=f.spin, samples=f.samples,
                background=miss_id(scene.background_shader),
                ng=f.ng, g=ep.g, nrb=ep.nrb, rb_size=ep.rb_size,
                rmax=f.rmax, textured=f.splan.textured,
                tex_only=f.splan.tex_only, cache=f.cache,
                cache_shape=f.cache_shape, far_sphere=f.far_sphere,
                sky_means=f.sky_means, sky_scatter=f.sky_scatter)
    before = P.shade_launches
    got = P._trace_shade_angles(**args)
    torch.cuda.synchronize()
    assert P.shade_launches == before + 1
    want = P._trace_shade_angles(shader=P.shade_means_reference, **args)
    raw = P._trace_shade_angles(want_samples=True, **args)
    torch.cuda.synchronize()
    assert P.shade_launches == before + 1
    assert got.shape == want.shape == (
        (f.sky_means.shape[0] if f.sky_means is not None
         else f.omms_p.shape[0]), 3)
    err = (got - want).abs()
    assert err.max().item() <= SHADE_MAX_ABS
    assert err.mean().item() <= SHADE_MEAN_ABS
    assert raw.shape == (f.omms_p.shape[0], f.samples, 3)
    if name == "textured-flat":
        testing.lit_frame_means(
            scene, f, default_lights(scene.aabb_min, scene.aabb_max))
        torch.cuda.synchronize()
        assert P.shade_launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("name", list(testing.RAYGEN_CASES))
def test_raygen_kernel_matches_twin(cuda_device, name, affine):
    """csrc/ray_features.cu against ray_features_reference on the same
    angles, one launch: the rays (16 or 8 features, padding included) and
    the origins rows bit for bit, and the origins equal
    _omm_world_origins'."""
    kw = testing.raygen_inputs(name, cuda_device)
    before = P.raygen_launches
    rays, ((ox, oy, oz), tmin) = P.run_ray_features(**kw, affine=affine)
    torch.cuda.synchronize()
    assert P.raygen_launches == before + 1
    want, _ = P.ray_features_reference(**kw, affine=affine)
    assert rays.shape == want.shape == (
        TM.RAY_FEATS_AFFINE if affine else TM.RAY_FEATS,
        kw["ng"] * kw["nrb"] * kw["rb_size"])
    assert torch.equal(rays, want), int((rays != want).sum())
    (wx, wy, wz), wt, _, _ = P._omm_world_origins(
        kw["omms_p"], kw["position"], kw["local_space"])
    for got, ref in ((ox, wx), (oy, wy), (oz, wz), (tmin, wt)):
        assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cache", "textured-flat"])
def test_frames_generate_their_rays_once(cuda_device, name):
    """A frame core on the card generates its rays in one launch (a lit
    frame's first at a pose one more, for its shadow probe), and its
    means, raw samples and lit means equal those of the same frames made
    from the eager twin's rays, bit for bit."""
    scene, f, _ = _shade_case(name, cuda_device)
    ep = f.eplan
    args = dict(packed_mm=f.packed_mm, row_counts=f.row_counts,
                attr_table=f.splan.attr_table,
                scene_dev=scene.device_triangles(cuda_device),
                quad_table=f.splan.quad_table, omms_p=f.omms_p,
                position=f.pos, local_space=f.ls, splay=f.splay,
                spin=f.spin, samples=f.samples,
                background=miss_id(scene.background_shader),
                ng=f.ng, g=ep.g, nrb=ep.nrb, rb_size=ep.rb_size,
                rmax=f.rmax, textured=f.splan.textured,
                tex_only=f.splan.tex_only, cache=f.cache,
                cache_shape=f.cache_shape, far_sphere=f.far_sphere)
    lit = name == "textured-flat"
    lights = default_lights(scene.aabb_min, scene.aabb_max)

    def frames():
        out = [P._trace_shade_angles(**args),
               P._trace_shade_angles(want_samples=True, **args)]
        if lit:
            out.append(testing.lit_frame_means(scene, f, lights))
        torch.cuda.synchronize()
        return out

    before = P.raygen_launches
    got = frames()
    assert P.raygen_launches == before + 2 + 2 * lit
    run = P.run_ray_features
    P.run_ray_features = P.ray_features_reference
    try:
        want = frames()
    finally:
        P.run_ray_features = run
    assert P.raygen_launches == before + 2 + 2 * lit
    assert f.cache is not None or name != "cache"
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a.cpu() if torch.is_tensor(a)
                                         else a),
                              np.asarray(b.cpu() if torch.is_tensor(b)
                                         else b))


# ---------------------- the far-field cache's cull (csrc/cache_cull.cu)
CULL_POSES = 8  # meadow window poses besides the configuration's
CULL_SEED = 2**31 + 29


def _bench_cell(config: str, traffic: str = None):
    """A benchmark configuration's parsed file, its scene arrays, its
    scene (the port's FlatScene of the benchmark's own generator), its (N,
    8) ommatidia, the traffic's parsed file (or None) and the
    configuration's pose followed, with `traffic`, by CULL_POSES window
    poses of that traffic at CULL_SEED."""
    import json
    import os

    from benchmark import scene as bench_scene
    from benchmark import traffic as bench_traffic
    from benchmark.system import flat_scene

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "benchmark")
    with open(os.path.join(root, "configs", config + ".json")) as f:
        cfg = json.load(f)
    arrays = bench_scene.build_scene(cfg)
    omms = bench_scene.build_eye(cfg)
    poses = [tuple(float(v) for v in cfg["pose"]["position"]
                   + cfg["pose"]["rotation"])]
    spec = None
    if traffic is not None:
        with open(os.path.join(root, "traffic", traffic + ".json")) as f:
            spec = json.load(f)
        poses += bench_traffic.pose_streams(cfg, spec, arrays, omms,
                                            CULL_SEED)[1][:CULL_POSES]
    return cfg, arrays, flat_scene(arrays, config), omms, spec, poses


@functools.lru_cache(maxsize=1)
def _meadow_cell():
    return _bench_cell("meadow-1000", "posesweep-s1000")


def _hold_shortlist(kw):
    """run_cache_shortlist on kw, one launch, against the twin bit for bit;
    returns the twin's counts."""
    before = P.cache_cull_launches
    got = P.run_cache_shortlist(**kw)
    torch.cuda.synchronize()
    assert P.cache_cull_launches == before + 1
    want = P.cache_shortlist_reference(**kw)
    for name, a, b in zip(("counts", "ids", "dmin"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (
            name, int((a != b).sum()))
    return want[0]


@pytest.mark.cuda
def test_cache_cull_kernel_equals_twin_on_the_meadow_sweep(cuda_device):
    """csrc/cache_cull.cu against cache_shortlist_reference on the meadow
    cell's cache inputs (8,192 tiles of 256 rays, ~7,150 clusters past D)
    at its configuration's pose and CULL_POSES poses of its sweep: counts,
    ids and dmin bit for bit at the frame's kmax (256) and at kmax 1024
    (KP 1024: four tiles a block), and some pose has a tile over 256."""
    _, _, scene, omms, _, poses = _meadow_cell()
    assert len(poses) == 1 + CULL_POSES
    over = 0
    for pose in poses:
        kw = testing.cache_cull_inputs(scene, omms, pose, cuda_device)
        assert kw["kmax"] == 256 and kw["centroid"].shape[0] == 8192
        _hold_shortlist(kw)
        wide = _hold_shortlist(dict(kw, kmax=1024))
        over += int((wide > kw["kmax"]).sum())
    assert over > 0


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["natural-1000", "natural-acute-10k"])
def test_cache_cull_kernel_equals_twin_at_steady_poses(cuda_device, config):
    """The kernel against the twin at the steady cache cells' pose, the
    cache their set-up builds: bit for bit."""
    _, _, scene, omms, _, (pose,) = _bench_cell(config)
    kw = testing.cache_cull_inputs(scene, omms, pose, cuda_device)
    counts = _hold_shortlist(kw)
    assert (counts > 0).any() and kw["far_mask"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kmax", [256, 1000, 4096])
@pytest.mark.parametrize("subs", [2, 8])
def test_cache_cull_kernel_equals_twin_when_every_cluster_survives(
        cuda_device, subs, kmax):
    """Synthetic clusters about a 512-wide cache's centre (512 tiles), every
    one met by some tile and most by every tile (over half hold the centre
    inside; a third are copies: ties in the key, ordered by id): bit for
    bit at KP 256, 1024 and 4096 (eight, four and one tile a block), every
    tile over KP, so every buffer trims."""
    _, centroid, half_ang = P._cache_tile_cones(512, cuda_device)
    kw = dict(centroid=centroid, half_ang=half_ang, kmax=kmax,
              **_synthetic_clusters(subs, cuda_device))
    counts = _hold_shortlist(kw)
    c = kw["far_mask"].shape[0]
    full_counts, full_ids, _ = P.cache_shortlist_reference(**dict(kw,
                                                                  kmax=c))
    assert (full_counts > P._ceil_to(kmax, 128)).all()
    assert (counts == kmax).all()
    live = torch.arange(full_ids.shape[1], device=cuda_device)[None, :] < (
        full_counts[:, None])
    seen = torch.zeros(c, dtype=torch.bool, device=cuda_device)
    seen[full_ids[live].long()] = True
    assert seen.all()


def _synthetic_clusters(subs: int, device, c: int = 6000) -> dict:
    """run_cache_shortlist's cluster keywords for c seeded clusters of
    `subs` sub-spheres about the origin, the cache's centre, every one in
    far_mask: centres 1-40 units out in uniform directions, radii 5-40,
    every third cluster a copy of one before it."""
    rng = np.random.default_rng(subs)
    d = rng.normal(size=(c, subs, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    centres = d * rng.uniform(1.0, 40.0, size=(c, subs, 1))
    radii = rng.uniform(5.0, 40.0, size=(c, subs))
    centres[2::3] = centres[0::3][:c // 3]
    radii[2::3] = radii[0::3][:c // 3]
    return dict(half_center=torch.tensor(centres, dtype=torch.float32,
                                         device=device),
                half_radius=torch.tensor(radii, dtype=torch.float32,
                                         device=device),
                center=torch.zeros(3, device=device),
                far_mask=torch.ones(c, dtype=torch.bool, device=device))


@pytest.mark.cuda
def test_cache_cull_kernel_equals_twin_on_a_small_scene(cuda_device):
    """A 200-box scene's 32 clusters (8 sub-spheres each; KP 128 > C, so id
    0 in the columns past them) at the sweep test pose: bit for bit."""
    scene = testing.make_big_scene(n_boxes=200, seed=11)
    omms = ommatidia_to_array(testing.make_sphere_eye(64, 4.0))
    kw = testing.cache_cull_inputs(scene, omms, (0.0, 2.0, 0.0, 0.0, 0.0,
                                                 0.0), cuda_device)
    assert kw["half_center"].shape[:2] == (32, 8) and kw["kmax"] == 32
    counts = _hold_shortlist(kw)
    assert (counts > 0).any()


@pytest.mark.cuda
def test_meadow_sweep_launches_the_cull_once_a_cache(cuda_device,
                                                     monkeypatch):
    """The meadow cell's frames through the benchmark's own system on the
    card: each new pose builds one cache and launches the cull once
    (pipeline.cache_cull_launches == pipeline.cache_builds), and the cache
    of a pose rebuilt through the twin is bit-equal to the kernel's."""
    from benchmark.system import System

    cfg, arrays, _, omms, traffic, poses = _meadow_cell()
    system = System(cfg, traffic, arrays, omms, CULL_SEED, cuda_device)
    try:
        splan = P.scene_plan(system.renderer.scene, cuda_device)
        builds, culls = P.cache_builds, P.cache_cull_launches
        for pose in poses[:4]:
            system.view(pose)
        torch.cuda.synchronize()
        assert P.cache_builds - builds == 4
        assert P.cache_cull_launches - culls == P.cache_builds - builds
        (got,) = [v[1] for v in splan.cache_store.values()][-1:]
        splan.cache_store.clear()
        monkeypatch.setattr(P, "run_cache_shortlist",
                            P.cache_shortlist_reference)
        culls = P.cache_cull_launches
        system.view(poses[3])
        torch.cuda.synchronize()
        assert P.cache_cull_launches == culls
        (want,) = [v[1] for v in splan.cache_store.values()]
        assert torch.equal(got, want)
    finally:
        system.close()
