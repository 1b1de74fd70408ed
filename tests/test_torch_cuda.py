"""The port's CUDA kernels on a card, against their torch twins.

JAX-free, so the file runs where JAX is absent (the card's machine):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Inputs come from the port's own pipeline.  Thresholds as in
tests/test_torch_k1.py: slot ids (K1) or cluster and lane (K2) equal on
>= 99.9 % of live rays, t within rtol 1e-5 where they agree (the kernels
fuse products into FMAs, the twins do not); frame means within 2e-4.  K3
sums its products in the twin's order without FMAs, so its decisions must
equal the twin's on every ray.  The probes (K4, K5): copy_only and dma_only
bit-equal, the dot modes equal on >= 99.9 % of live rays within rtol 1e-5.
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
    agree, _, max_rel = testing.cluster_hit_agreement(ref, got, c.counts,
                                                      c.kw["rb_size"])
    assert agree >= SLOT_AGREE
    assert torch.isfinite(ref[:, 0]).float().mean() > 0.2
    assert max_rel <= T_RTOL
    assert torch.equal(got[:, 5:], torch.zeros_like(got[:, 5:]))


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
    F = 8 form), the canopy scene with its default lights."""
    scene = testing.make_canopy_scene()
    omms = ommatidia_to_array(testing.canopy_eye(2.0))
    f = testing.frame_pack(scene, omms, 256, (0.0, 0.0, 0.0), cuda_device)
    r2v, flag, rows, rays, kw = testing.lit_occlusion_inputs(
        scene, f, default_lights(scene.aabb_min, scene.aabb_max))
    got = TM.run_rows_occlusion(r2v, flag, rows, rays, **kw)
    ref = TM.rows_occlusion_reference(r2v, flag, rows, rays, **kw)
    assert torch.equal(got, ref) and got.any() and not got.all()


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


def _probe_inputs(device, ng=8, rb_size=1024, rmax=2):
    """make_inputs with two rows in some groups and none in group 1."""
    rc, pmm, rays = PS.make_inputs(ng, rb_size, rmax, seed=3)
    rc[:] = 2
    rc[1], rc[4] = 0, 1
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
@pytest.mark.parametrize("rs", PS.CHAIN_WIDTHS)
@pytest.mark.parametrize("mode", PS.MODES)
def test_k4_probe_matches_twin(cuda_device, mode, rs):
    rc, pmm, rays = _probe_inputs(cuda_device)
    ng, rb, rmax = pmm.shape[0], rays.shape[1] // pmm.shape[0], pmm.shape[1]
    before = PS.probe_launches
    got = PS.run_probe(rc, pmm, rays, ng, rb, rmax, mode, rs)
    torch.cuda.synchronize()
    assert PS.probe_launches == before + 1
    ref = PS.probe_reference(rc, pmm, rays, ng, rb, rmax, mode)
    _hold_probe(ref, got, rc, rb, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", PS.MODES)
def test_k5_probe3d_matches_twin(cuda_device, mode):
    """The 3-D layout; its dot_only is the full dot_cand, as on the TPU."""
    rc, pmm, rays = _probe_inputs(cuda_device)
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
