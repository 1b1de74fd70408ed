"""K6, the skinny-K dot bench: the port's twin (run_dot_bench on CPU
tensors) against the JAX tool's Pallas kernel in interpret mode on the CPU,
and the tool's split products against float64.

The JAX kernel refuses the CPU outside interpret mode, so it runs under
force_tpu_interpret_mode().  On the CPU, JAX computes both precisions in
f32, so "highest" is held to it directly and "default" to JAX fed the
same bf16-rounded inputs (bf16 x bf16 products are exact in f32: the
one-pass contract).  Errors are measured against the sum of |terms| of each
output element, within 1e-5 (both sides sum in f32, in other orders).
The accuracy of the split products is held to float64 and to the split's
identity, not to the JAX numbers: XLA may elide the bf16 round trips
(docs/performance.md:342-349).
"""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tools import microbench_k as jmb  # noqa: E402

from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.tools import microbench_k as MB  # noqa: E402

N, STEPS = 512, 6


@pytest.mark.parametrize("prec", MB.PRECISIONS)
@pytest.mark.parametrize("k", [16, 48])
def test_dot_bench_matches_jax(k, prec):
    ft, mm = MB.bench_inputs(k, N, "cpu")
    jft, jmm = ft.numpy(), mm.numpy()
    if prec == "default":
        jft, jmm = (MB.bf16_round(x).numpy() for x in (ft, mm))
    jprec = {"highest": jax.lax.Precision.HIGHEST,
             "default": jax.lax.Precision.DEFAULT}[prec]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmb.make_bench(k, N, jprec, STEPS)(jft, jmm))
    before = MB.dot_bench_launches
    got = MB.run_dot_bench(ft, mm, prec, STEPS)
    assert MB.dot_bench_launches == before  # CPU tensors never launch
    assert got.shape == (MB.RS, MB.OUT_COLS) and got.dtype == torch.float32
    scale = ttesting.dot_bench_scale(ft, mm, prec, STEPS).numpy()
    assert (np.abs(got.numpy().astype(np.float64) - want) / scale).max() <= 1e-5


def test_default_rounds_the_operands_to_bf16():
    ft, mm = MB.bench_inputs(16, 128, "cpu")
    hi = MB.run_dot_bench(ft, mm, "highest", 4)
    lo = MB.run_dot_bench(ft, mm, "default", 4)
    want = MB.run_dot_bench(MB.bf16_round(ft), MB.bf16_round(mm), "highest",
                            4)
    torch.testing.assert_close(lo, want, rtol=0, atol=0)
    assert not torch.equal(hi, lo)


def test_split3_is_exact_and_bf16():
    rng = np.random.default_rng(2)
    x = torch.as_tensor((rng.standard_normal(4096)
                         * 10.0 ** rng.uniform(-2, 3, 4096)).astype(
                             np.float32))
    h, m, lo = MB.split3(x)
    assert torch.equal(h + m + lo, x)
    for part in (h, m, lo):
        assert torch.equal(MB.bf16_round(part), part)
    assert (lo != 0).any()


def test_accuracy_against_float64():
    """The tool's accuracy() at a small size: each form's error relative to
    the |terms| scale, against float64 computed here."""
    acc = MB.accuracy(k=16, m=64, n=256, device="cpu")
    err = {name: acc[name]["max_rel_vs_scale"] for name in acc}
    assert err["highest"] <= 1e-6
    assert 1e-4 <= err["default"] <= 1e-2  # one bf16 pass: ~2^-9
    assert err["stacked6"] <= 1e-5 < err["default"]
    assert err["stacked6"] <= err["stacked3"] < err["default"]
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((64, 16))
         * 10.0 ** rng.uniform(-2, 3, (64, 16))).astype(np.float32)
    b = (rng.standard_normal((16, 256))
         * 10.0 ** rng.uniform(-2, 3, (16, 256))).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    got = MB.stacked6(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert np.isclose((np.abs(got - ref) / scale).max(), err["stacked6"])


def test_dot_bench_wrapper_refuses_what_the_kernel_does_not_take():
    ft, mm = MB.bench_inputs(16, 512, "cpu")
    with pytest.raises(ValueError, match="precision"):
        MB.run_dot_bench(ft, mm, "bf16x3", 4)
    with pytest.raises(ValueError, match="n_steps"):
        MB.run_dot_bench(ft, mm, "highest", 0)
    with pytest.raises(ValueError, match="K="):
        MB.run_dot_bench(ft[:8].contiguous(), mm[:, :8].contiguous(),
                         "highest", 4)
    with pytest.raises(ValueError, match="N="):
        MB.run_dot_bench(ft, mm[:, :, :96].contiguous(), "highest", 4)
    with pytest.raises(ValueError, match="mm"):
        MB.run_dot_bench(ft, mm[:3].contiguous(), "highest", 4)
    with pytest.raises(TypeError, match="ft"):
        MB.run_dot_bench(ft.double(), mm, "highest", 4)


def test_microbench_tool_runs_on_the_cpu(tmp_path):
    out = tmp_path / "mb.json"
    rec = MB.main(["--device", "cpu", "--steps", "4", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    assert rec["device"] == "cpu" and "host clock" in rec["timer"]
    assert [(r["N"], r["K"], r["prec"]) for r in rec["dot_step"]] == [
        (n, k, prec) for n in MB.NS for k, prec in MB.SWEEP]
    assert set(rec["accuracy"]) == {"highest", "default", "stacked3",
                                    "stacked6"}
    assert rec["verdict"]["N"] == 2048
