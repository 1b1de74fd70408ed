"""K1, the packed closest-hit tracer: the port's torch twin against the JAX
kernel (interpret mode on CPU), and the CUDA kernel against the twin on a
card.

Thresholds: slot ids equal on >= 99.9 % of live rays, and t within rtol
1e-5 where the slots agree.  The two sides sum the 16-feature products in
different orders, so a near-tie between two slots may resolve either way
and t may differ in its last bits.  Live rays are those of groups with
row_counts > 0: groups without payload rows are masked by every caller.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from compound_ray_tpu import config as jcfg  # noqa: E402
from compound_ray_tpu import testing as jtesting  # noqa: E402
from compound_ray_tpu.eye import pipeline as JP  # noqa: E402
from compound_ray_tpu.scene.eye_io import ommatidia_to_array  # noqa: E402
from compound_ray_tpu.trace.mm_tracer import run_packed_tracer as jax_k1  # noqa: E402
from compound_ray_tpu_torch import interop  # noqa: E402
from compound_ray_tpu_torch.trace import mm_tracer as TM  # noqa: E402

SAMPLES = 640
SLOT_AGREE = 0.999
T_RTOL = 1e-5


@pytest.fixture
def jax_unlit():
    old = jcfg.get_config()
    jcfg.set_config(dataclasses.replace(
        old, farfield="off", sky_split=False, affine_rays=False))
    yield
    jcfg.set_config(old)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the K1 CUDA kernel runs only there")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the twin is plain f32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _jax_case(accept_deg, pos=(0.0, 2.0, 0.0), samples=SAMPLES, seed=0):
    """A JAX-built pose pack and ray features on make_big_scene(60)."""
    scene = jtesting.make_big_scene(n_boxes=60, seed=5)
    splan = JP.scene_plan(scene)
    omms = ommatidia_to_array(jtesting.make_sphere_eye(16, accept_deg))
    eplan = JP.eye_plan(omms, samples)
    omms_p = jnp.asarray(omms[eplan.perm])
    p = jnp.asarray(np.asarray(pos, np.float32))
    ls = jnp.eye(3, dtype=jnp.float32)
    kcand, rmax = JP._plan_widths(splan, eplan, omms_p, p, ls,
                                  (eplan.sig, samples, b"k1"))
    rc, pmm, _, _ = JP._pack_fused(
        splan.mm_flat, splan.slot_center_cl, splan.slot_radius_cl,
        splan.half_center, splan.half_radius, omms_p, p, ls, g=eplan.g,
        kcand=kcand, rmax=rmax, cull_sigmas=4.0, tri_cl=splan.slot_tri_cl)
    rng = np.random.default_rng(seed)
    sd = omms[eplan.perm][:, 6] / JP.FWHM_SD_RATIO
    shape = (omms_p.shape[0], samples)
    splay = (rng.standard_normal(shape) * sd[:, None]).astype(np.float32)
    spin = (rng.uniform(size=shape) * np.pi).astype(np.float32)
    rays, _, _ = JP._gen_ray_features(
        omms_p, p, ls, jnp.asarray(splay), jnp.asarray(spin),
        samples=samples, ng=eplan.ng, g=eplan.g, nrb=eplan.nrb,
        rb_size=eplan.rb_size)
    shape_kw = dict(ng=eplan.ng, nrb=eplan.nrb, rb_size=eplan.rb_size,
                    rmax=rmax)
    return np.asarray(rc), np.asarray(pmm), np.asarray(rays), shape_kw


def _agreement(ref, got, row_counts, rg):
    live = np.repeat(np.asarray(row_counts) > 0, rg)
    assert live.any()
    agree = ref[3][live] == got[3][live]
    both = agree & np.isfinite(ref[0][live])
    t_ref, t_got = ref[0][live][both], got[0][live][both]
    return agree.mean(), t_ref, t_got, np.isfinite(ref[0][live]).mean()


def _twin(rc, pmm, rays, kw, device="cpu"):
    rc_t, pm_t = interop.packed_from_arrays(rc, pmm, device)
    rays_t = torch.tensor(rays, device=device)
    return TM.packed_tracer_reference(rc_t, pm_t, rays_t, **kw)


@pytest.mark.parametrize("accept_deg", [4.0, 20.0])
def test_twin_matches_jax_kernel(jax_unlit, accept_deg):
    rc, pmm, rays, kw = _jax_case(accept_deg)
    ref = np.asarray(jax_k1(jnp.asarray(rc), jnp.asarray(pmm),
                            jnp.asarray(rays), emit="bary",
                            precision="highest", **kw))
    got = _twin(rc, pmm, rays, kw).numpy()
    frac, t_ref, t_got, hits = _agreement(ref, got, rc, kw["nrb"] * kw["rb_size"])
    assert hits > 0.1, "the case must produce real hits"
    assert frac >= SLOT_AGREE, frac
    np.testing.assert_allclose(t_got, t_ref, rtol=T_RTOL)
    # misses: t = +inf, u = v = 0, slot = -1 (the kernel's init values)
    miss = ~np.isfinite(got[0])
    assert (got[3][miss] == -1).all() and (got[1][miss] == 0).all()
    np.testing.assert_array_equal(got[4:], 0.0)


def test_twin_winner_order_on_ties(jax_unlit):
    """Duplicate slots tie exactly: the lowest lane, then the first row,
    must win, as in the TPU kernel's per-lane strict < and first-lane
    argmin.  Slot ids are rewritten so every copy is distinguishable."""
    rc, pmm, rays, kw = _jax_case(20.0)
    assert kw["rmax"] >= 2
    g = int(np.argmax(rc))
    pmm = pmm.copy()
    # row 1 := row 0, lane 100 := lane 3 in every column block, and slot
    # ids 1000 * (row + 1) + lane (feature 10 meets a zero ray feature)
    pmm[g, 1] = pmm[g, 0]
    for row in (0, 1):
        for b in range(4):
            pmm[g, row, :, 128 * b + 100] = pmm[g, row, :, 128 * b + 3]
        pmm[g, row, 10, 0:128] = 1000.0 * (row + 1) + np.arange(128)
    rc = rc.copy()
    rc[g] = 2
    ref = np.asarray(jax_k1(jnp.asarray(rc), jnp.asarray(pmm),
                            jnp.asarray(rays), emit="bary",
                            precision="highest", **kw))
    got = _twin(rc, pmm, rays, kw).numpy()
    rg = kw["nrb"] * kw["rb_size"]
    sl = slice(g * rg, (g + 1) * rg)
    np.testing.assert_array_equal(got[3][sl], ref[3][sl])
    winners = got[3][sl][np.isfinite(got[0][sl])]
    assert winners.size and (winners < 2000).all(), "row 0 must win ties"
    assert not (winners == 1100).any(), "lane 3 must beat its copy at 100"


def test_wrapper_takes_the_twin_on_cpu_and_counts_no_launch(jax_unlit):
    rc, pmm, rays, kw = _jax_case(4.0)
    rc_t, pm_t = interop.packed_from_arrays(rc, pmm, "cpu")
    before = TM.launches
    out = TM.run_packed_tracer(rc_t, pm_t, torch.tensor(rays), **kw)
    assert TM.launches == before
    assert torch.equal(out, _twin(rc, pmm, rays, kw))


def test_wrapper_rejects_bad_inputs():
    rc = torch.ones(2, dtype=torch.int32)
    pmm = torch.zeros((2, 1, 16, 512))
    rays = torch.zeros((16, 2 * 256))
    kw = dict(ng=2, nrb=1, rb_size=256, rmax=1)
    with pytest.raises(TypeError):
        TM.run_packed_tracer(rc.long(), pmm, rays, **kw)
    with pytest.raises(ValueError):
        TM.run_packed_tracer(rc, pmm[:, :, :8], rays, **kw)
    with pytest.raises(ValueError):
        TM.run_packed_tracer(rc, pmm, rays[:, :256], **kw)
    with pytest.raises(ValueError):
        TM.run_packed_tracer(rc, pmm, rays.t().contiguous().t(), **kw)
    with pytest.raises(ValueError):
        TM.run_packed_tracer(rc, pmm, rays, ng=2, nrb=1, rb_size=200, rmax=1)
    with pytest.raises(ValueError):
        TM.run_packed_tracer(rc.to("meta"), pmm.to("meta"), rays.to("meta"),
                             **kw)


def test_padding_columns_never_hit():
    """All-zero payload columns (den = 0) mask themselves: a payload of
    padding only gives misses for every ray."""
    g, rg = 2, 256
    rng = np.random.default_rng(3)
    d = rng.standard_normal((g * rg, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = rng.standard_normal((g * rg, 3)).astype(np.float32)
    rays = TM.pack_rays_mm(torch.tensor(d), torch.tensor(o),
                           torch.zeros(g * rg))
    out = TM.packed_tracer_reference(
        torch.full((g,), 2, dtype=torch.int32), torch.zeros((g, 2, 16, 512)),
        rays, ng=g, nrb=1, rb_size=rg, rmax=2)
    assert torch.isinf(out[0]).all() and (out[3] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("accept_deg", [4.0, 20.0])
def test_cuda_kernel_matches_twin(jax_unlit, cuda_device, accept_deg):
    rc, pmm, rays, kw = _jax_case(accept_deg)
    rc_t, pm_t = interop.packed_from_arrays(rc, pmm, cuda_device)
    before = TM.launches
    got = TM.run_packed_tracer(rc_t, pm_t, torch.tensor(rays,
                                                        device=cuda_device),
                               **kw)
    torch.cuda.synchronize()
    assert TM.launches == before + 1
    ref = _twin(rc, pmm, rays, kw, cuda_device)
    frac, t_ref, t_got, _ = _agreement(ref.cpu().numpy(), got.cpu().numpy(),
                                       rc, kw["nrb"] * kw["rb_size"])
    assert frac >= SLOT_AGREE, frac
    np.testing.assert_allclose(t_got, t_ref, rtol=T_RTOL)


def _exact_accepts(w1, w2, den, tnum):
    """The twin's exact candidate test on float32 tensors."""
    inv = 1.0 / den
    u, v, t = w1 * inv, w2 * inv, tnum * inv
    return (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)


def test_reject_rule_rejects_padding_and_misses():
    """The rule is not vacuous: on a real pose pack it rejects the
    padding columns and nearly every pair the exact test rejects, and no
    pair it accepts."""
    rc, pmm, rays, kw = _jax_case(20.0)
    rg = kw["nrb"] * kw["rb_size"]
    p = torch.einsum("fgr,gjfc->gjrc",
                     torch.tensor(rays).reshape(16, kw["ng"], rg),
                     torch.tensor(pmm))
    w1, w2, den, tnum = p.split(128, dim=-1)
    ok = _exact_accepts(w1, w2, den, tnum)
    rej = TM.k1_reject(w1, w2, den, tnum)
    assert ok.any() and not (ok & rej).any()
    pad = (den == 0) & (w1 == 0) & (w2 == 0) & (tnum == 0)
    assert pad.any() and rej[pad].all()
    assert rej[~ok].float().mean() > 0.95
