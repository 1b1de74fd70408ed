"""K4 and K5, the knock-out probes of K1's row step: the port's twin
(run_probe / run_probe3d on CPU tensors) against the JAX tool's Pallas
kernels, which run in interpret mode on the CPU (tools/probe_step.py:145,
:220); and the port's tool, its wrappers and EyeRenderer's device default.

Live groups only (rc > 0): the TPU kernels leave the other groups unwritten
(the CPU interpreter gives NaN there), the port writes +inf.  rtol 1e-5:
the two sides sum the 16 products in different orders, both in f32 (JAX's
CPU dot at Precision.DEFAULT is f32).
"""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from tools import probe_step as jps  # noqa: E402

from compound_ray_tpu_torch import EyeRenderer  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera  # noqa: E402
from compound_ray_tpu_torch.tools import probe_step as PS  # noqa: E402

NG, RB, RMAX = 3, 1024, 2
RC = np.array([2, 0, 1], np.int32)
LIVE = np.repeat(RC > 0, RB)


@pytest.fixture(scope="module")
def inputs():
    _, pmm, rays = PS.make_inputs(NG, RB, RMAX, seed=7)
    return RC, pmm, rays


def _port(inputs, layout="2d"):
    rc, pmm, rays = (torch.as_tensor(x) for x in inputs)
    if layout == "3d":
        rays = rays.reshape(16, NG, RB).permute(1, 0, 2).contiguous()
    return rc, pmm, rays


def _hold(jax_out, port_out):
    np.testing.assert_allclose(port_out.numpy()[0, LIVE],
                               np.asarray(jax_out)[0, LIVE], rtol=1e-5)


def test_make_inputs_draws_as_the_jax_tool():
    """The JAX tool's draw (tools/probe_step.py:228-234), bit for bit."""
    ng, rb_size, rmax = 4, 1024, 1
    rng = np.random.default_rng(0)
    pmm = np.zeros((ng, rmax, 16, 512), np.float32)
    pmm[:, :, 0:10, :] = rng.standard_normal(
        (ng, rmax, 10, 512)).astype(np.float32) * 50.0
    pmm[:, :, 10, :] = rng.integers(0, 1 << 20, (ng, rmax, 512))
    rc = np.ones((ng,), np.int32)
    rays = rng.standard_normal((16, ng * rb_size)).astype(np.float32)
    for want, got in zip((rc, pmm, rays), PS.make_inputs(ng, rb_size, rmax)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rs", PS.CHAIN_WIDTHS)
@pytest.mark.parametrize("mode", PS.MODES)
def test_probe_matches_jax(inputs, mode, rs):
    want = jps.run_probe(*inputs, NG, RB, RMAX, mode, rs)
    before = PS.probe_launches
    got = PS.run_probe(*_port(inputs), NG, RB, RMAX, mode, rs)
    assert PS.probe_launches == before  # CPU tensors never launch
    assert got.shape == (1, NG * RB) and got.dtype == torch.float32
    _hold(want, got)
    assert torch.isinf(got[0, ~torch.as_tensor(LIVE)]).all()


@pytest.mark.parametrize("mode", PS.MODES)
def test_probe3d_matches_jax(inputs, mode):
    rc, pmm, rays = inputs
    rays3d = rays.reshape(16, NG, RB).transpose(1, 0, 2).copy()
    want = jps.run_probe3d(rc, pmm, rays3d, NG, RB, RMAX, mode)
    before = PS.probe3d_launches
    got = PS.run_probe3d(*_port(inputs, "3d"), NG, RB, RMAX, mode)
    assert PS.probe3d_launches == before
    _hold(want, got)


RAGGED_NG, RAGGED_RB, RAGGED_RMAX = 5, 512, 3
# 0 to 3 rows per group, and one count above rmax for the clamp
RAGGED_RC = np.array([3, 0, 2, 1, 5], np.int32)


@pytest.mark.parametrize("layout", ["2d", "3d"])
@pytest.mark.parametrize("mode", PS.MODES)
def test_probe_ragged_rows_match_jax(mode, layout):
    """Row counts 0-3 under rmax 3 (the tool's own draw has one row
    everywhere).  The port clamps a count above rmax; the JAX kernel has no
    clamp and would read past the group's rows, so it is given the clamped
    counts."""
    ng, rb, rmax = RAGGED_NG, RAGGED_RB, RAGGED_RMAX
    _, pmm, rays = PS.make_inputs(ng, rb, rmax, seed=11)
    rays3d = rays.reshape(16, ng, rb).transpose(1, 0, 2).copy()
    clamped = np.minimum(RAGGED_RC, rmax)
    if layout == "2d":
        want = jps.run_probe(clamped, pmm, rays, ng, rb, rmax, mode, 256)
        got = PS.run_probe(torch.as_tensor(RAGGED_RC), torch.as_tensor(pmm),
                           torch.as_tensor(rays), ng, rb, rmax, mode, 256)
    else:
        want = jps.run_probe3d(clamped, pmm, rays3d, ng, rb, rmax, mode)
        got = PS.run_probe3d(torch.as_tensor(RAGGED_RC), torch.as_tensor(pmm),
                             torch.as_tensor(rays3d), ng, rb, rmax, mode)
    live = np.repeat(RAGGED_RC > 0, rb)
    np.testing.assert_allclose(got.numpy()[0, live],
                               np.asarray(want)[0, live], rtol=1e-5)
    assert torch.isinf(got[0, ~torch.as_tensor(live)]).all()
    # every row of a group counts: dropping the last row changes the answer
    if mode != "copy_only":
        fewer = np.maximum(clamped - 1, 0)
        fn = PS.run_probe if layout == "2d" else PS.run_probe3d
        less = fn(torch.as_tensor(fewer), torch.as_tensor(pmm),
                  torch.as_tensor(rays if layout == "2d" else rays3d), ng,
                  rb, rmax, mode)
        many = np.repeat(clamped > 1, rb)
        assert (less.numpy()[0, many] >= got.numpy()[0, many]).all()
        assert (less.numpy()[0, many] > got.numpy()[0, many]).any()


def test_probe3d_dot_only_is_dot_cand(inputs):
    """The JAX tool's 3-D kernel has no dot_only branch
    (tools/probe_step.py:170-191): its dot_only is the full dot_cand, and
    the port keeps that; the 2-D dot_only differs."""
    args = (*_port(inputs, "3d"), NG, RB, RMAX)
    dot3 = PS.run_probe3d(*args, "dot_only")
    assert torch.equal(dot3, PS.run_probe3d(*args, "dot_cand"))
    dot2 = PS.run_probe(*_port(inputs), NG, RB, RMAX, "dot_only")
    assert not torch.equal(dot2, dot3)


@pytest.mark.parametrize("layout", ["2d", "3d"])
def test_probe_writes_inf_in_groups_without_rows(inputs, layout):
    rc, pmm, rays = _port(inputs, layout)
    fn = PS.run_probe if layout == "2d" else PS.run_probe3d
    for mode in PS.MODES:
        out = fn(rc, pmm, rays, NG, RB, RMAX, mode)[0].reshape(NG, RB)
        assert torch.isinf(out[1]).all() and (out[1] > 0).all()
        assert torch.isfinite(out[0]).all()


def test_probe_wrappers_refuse_what_the_kernel_does_not_take(inputs):
    rc, pmm, rays = _port(inputs)
    with pytest.raises(ValueError, match="mode"):
        PS.run_probe(rc, pmm, rays, NG, RB, RMAX, "real_uvs")
    with pytest.raises(ValueError, match="rs="):
        PS.run_probe(rc, pmm, rays, NG, RB, RMAX, "dot_cand", 128)
    with pytest.raises(ValueError, match="multiple"):
        PS.run_probe(rc, pmm, rays[:, :NG * 768].contiguous(), NG, 768,
                     RMAX, "copy_only", 512)
    with pytest.raises(ValueError, match="rays"):
        PS.run_probe3d(rc, pmm, rays, NG, RB, RMAX, "copy_only")
    with pytest.raises(ValueError, match="pmm"):
        PS.run_probe(rc, pmm[:, :1].contiguous(), rays, NG, RB, RMAX,
                     "dma_only")
    with pytest.raises(TypeError, match="rc"):
        PS.run_probe(rc.long(), pmm, rays, NG, RB, RMAX, "dma_only")
    with pytest.raises(ValueError, match="contiguous"):
        PS.run_probe(rc, pmm, rays.t().contiguous().t(), NG, RB, RMAX,
                     "copy_only")


def test_probe_tool_runs_on_the_cpu(tmp_path):
    """main() with the twins at a small size: every timed key, the deltas,
    what is not ported, and a record that names the CPU and its clock."""
    out = tmp_path / "probe.json"
    rec = PS.main(["--device", "cpu", "--ng", "4", "--rb-size", "1024",
                   "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    assert rec["device"] == "cpu" and "host clock" in rec["timer"]
    assert set(rec["times_ms"]) == {
        "copy_only", "dma_only", "dot_only", "dot_cand", "dma_only_rs512",
        "dot_cand_rs512", "dma_only_rs1024", "dot_cand_rs1024",
        "copy_only_ng2", "copy_only_ng1", "copy_only_3d", "dot_cand_3d",
        "real_bary"}
    assert len(rec["deltas_ms"]) == 4 and "real_uvs" in rec["not_ported"]
    assert rec["steps"] == 4 * 1024 // 256


def test_eye_renderer_defaults_to_the_card():
    """EyeRenderer(verbose=True, *, device="cuda"), verbose first as in the
    JAX API: without a card the default raises and never falls back to the
    CPU; device="cpu" renders there."""
    if torch.cuda.is_available():
        assert EyeRenderer().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            EyeRenderer()
    with pytest.raises(TypeError):
        EyeRenderer(False, "cpu")
    r = EyeRenderer(True, device="cpu")
    assert r.verbose and r.device == torch.device("cpu")
    r.scene = ttesting.make_box_scene()
    r.scene.cameras.append(CompoundEyeCamera(
        "eye", "single_dimension_fast", ttesting.make_sphere_eye(8, 5.0)))
    r.goto_camera(len(r.scene.cameras) - 1)
    r.set_current_eye_samples_per_ommatidium(16)
    r.render_frame()
    means = r.get_camera_data()
    assert means.shape == (8, 3) and np.isfinite(means).all()
