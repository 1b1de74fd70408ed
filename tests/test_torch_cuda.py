"""The port's CUDA kernels on a card, against their torch twins.

JAX-free, so the file runs where JAX is absent (the card's machine):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Inputs come from the port's own pipeline.  Thresholds as in
tests/test_torch_k1.py: slot ids (K1) equal on >= 99.9 % of live rays, t
within rtol 1e-5 where they agree (the kernel fuses products into FMAs, the
twin does not); frame means within 2e-4.  K2 and K3 sum their products in
the twins' order without FMAs, so K2's rows and K3's decisions must equal
the twins' on every ray, bit for bit (K2 also at the camera image's
shapes).  The real-camera images and the oracle on the card against the
CPU: channels within 1 but at near-ties (the two closest hits within 1e-6
relative in t), oracle radiance within 2e-4.  The probes (K4, K5):
copy_only and dma_only bit-equal, the dot modes equal on >= 99.9 % of live rays within rtol 1e-5.
The dot bench (K6): within 1e-5 of the sum of |terms| in both precisions.
"""

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
    rays, _ = P._gen_ray_features(f.omms_p, f.pos, f.ls, f.splay, f.spin,
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
                                   all_far=True)
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
                                   all_far=True)
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
