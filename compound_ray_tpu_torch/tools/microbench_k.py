"""Skinny-K dot cost and stacked-K split accuracy on the card
(tools/microbench_k.py in torch).

    python -m compound_ray_tpu_torch.tools.microbench_k [--out PATH]
    python -m compound_ray_tpu_torch.tools.microbench_k --device cpu --steps 8

The packed tracers contract K = 16 (or 8) ray features against 512-2048
slot columns.  This tool asks what such a product costs per step: K6
(run_dot_bench, csrc/microbench_k.cu) loops (256, K) x (K, N) products
n_steps times, in f32 on the CUDA cores ("highest") or as one bf16 pass
on the tensor cores ("default"), for K in {16, 48, 96, 128, 256} and N in
{512, 2048}.  And it measures, off any kernel, how close stacking the
operands' bf16 hi/mid/lo splits on K brings one bf16 pass to f32:

    x = x_h + x_m + x_l   (each bf16-exact)
    A@B ~ [A_h A_h A_m A_h A_l A_m] @ [B_h; B_m; B_h; B_l; B_h; B_m]

Eager torch rounds x.to(bfloat16).float() for real, so the port's splits
are real; XLA may elide such a round trip (docs/performance.md:342-349).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import time

import numpy as np
import torch

from compound_ray_tpu_torch.tools import (
    device_record,
    time_ms,
    write_record,
)

RS = 256  # rows of the product (rays)
NROWS = 4  # distinct payload rows cycled in the loop
OUT_COLS = 128  # product columns summed into the output
PRECISIONS = ("highest", "default")
# the JAX tool's sweep (tools/microbench_k.py:167-171)
SWEEP = ((16, "highest"), (16, "default"), (48, "default"), (96, "default"),
         (96, "highest"), (128, "default"), (256, "default"))
NS = (512, 2048)
N_STEPS = 4000

# K6 launches by run_dot_bench (the kernel only, never the twin)
dot_bench_launches = 0


def _check_inputs(ft, mm, prec, n_steps):
    """Raise on anything K6 and its twin do not take; returns (K, N)."""
    for name, x in (("ft", ft), ("mm", mm)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mm.device != ft.device:
        raise ValueError(f"mm is on {mm.device}, ft on {ft.device}")
    if prec not in PRECISIONS:
        raise ValueError(f"precision {prec!r} is not one of {PRECISIONS}")
    if n_steps < 1:
        raise ValueError(f"n_steps={n_steps} must be >= 1")
    if ft.dim() != 2 or ft.shape[1] != RS:
        raise ValueError(f"ft {tuple(ft.shape)} != (K, {RS})")
    k = ft.shape[0]
    if not (16 <= k <= 256 and k % 16 == 0):
        raise ValueError(f"K={k} must be a multiple of 16 in [16, 256]")
    if mm.dim() != 3 or tuple(mm.shape[:2]) != (NROWS, k):
        raise ValueError(f"mm {tuple(mm.shape)} != ({NROWS}, {k}, N)")
    n = mm.shape[2]
    if n < OUT_COLS or n % 32:
        raise ValueError(f"N={n} must be a multiple of 32, at least "
                         f"{OUT_COLS}")
    return k, n


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even) and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full f32: refuses TF32 matmuls on CUDA."""
    if a.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("needs f32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    return a @ b


def dot_bench_reference(ft, mm, prec: str, n_steps: int) -> torch.Tensor:
    """Plain torch twin of K6: (256, 128) f32, the sum over j < n_steps of
    (ft^T mm[j % 4])[:, :128], each product in f32 and added in step order
    to an f32 accumulator.  "default" rounds both operands to bf16 first:
    bf16 x bf16 products are exact in f32, so this is the one-pass
    contract.  The four distinct products are formed once."""
    _check_inputs(ft, mm, prec, n_steps)
    if prec == "default":
        ft, mm = bf16_round(ft), bf16_round(mm)
    prods = [_f32_matmul(ft.t(), mm[r, :, :OUT_COLS]) for r in range(NROWS)]
    acc = torch.zeros((RS, OUT_COLS), dtype=torch.float32, device=ft.device)
    for j in range(n_steps):
        acc += prods[j % NROWS]
    return acc


def run_dot_bench(ft, mm, prec: str, n_steps: int) -> torch.Tensor:
    """K6: n_steps skinny-K products, the first 128 columns summed
    (tools/microbench_k.py:43, make_bench).  ft (K, 256) f32, mm (4, K, N)
    f32; returns (256, 128) f32.  Every column of every product is
    computed, as on the TPU.  CUDA tensors launch csrc/microbench_k.cu on
    the current stream (or raise); CPU tensors take dot_bench_reference."""
    global dot_bench_launches
    k, n = _check_inputs(ft, mm, prec, n_steps)
    dev = ft.device
    if dev.type == "cpu":
        return dot_bench_reference(ft, mm, prec, n_steps)
    if dev.type != "cuda":
        raise ValueError(f"run_dot_bench takes CPU or CUDA tensors, not "
                         f"{dev.type}")
    from compound_ray_tpu_torch.trace import _build

    lib = _build.microbench_k_lib()
    out = torch.empty((RS, OUT_COLS), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cr_dot_bench(
            ctypes.c_void_p(ft.data_ptr()), ctypes.c_void_p(mm.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), None, k, n, n_steps,
            PRECISIONS.index(prec), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"dot bench launch failed: CUDA error {err}")
    dot_bench_launches += 1
    return out


def bench_inputs(k: int, n: int, device):
    """(ft (K, 256), mm (4, K, N)) f32 from default_rng(0), as the JAX
    tool's time_variant draws them (tools/microbench_k.py:76-78)."""
    rng = np.random.default_rng(0)
    ft = rng.standard_normal((k, RS)).astype(np.float32)
    mm = rng.standard_normal((NROWS, k, n)).astype(np.float32)
    return torch.as_tensor(ft, device=device), torch.as_tensor(mm,
                                                               device=device)


def time_variant(k: int, n: int, prec_name: str, n_steps: int = N_STEPS,
                 reps: int = 3, device="cuda") -> dict:
    """One timed K6 variant (tools/microbench_k.py:72): mean time of reps
    back-to-back launches after a warm-up; returns its record."""
    dev = torch.empty(0, device=device).device
    ft, mm = bench_inputs(k, n, dev)
    ms = time_ms(lambda: run_dot_bench(ft, mm, prec_name, n_steps), reps,
                 dev)
    rec = {"bench": "dot_step", "K": k, "N": n, "prec": prec_name,
           "n_steps": n_steps, "ms": ms, "us_per_step": ms / n_steps * 1e3}
    print(json.dumps(rec), flush=True)
    return rec


def split3(x):
    """x = h + m + l with each part bf16-exact (f32 tensors)."""
    h = bf16_round(x)
    r = x - h
    m = bf16_round(r)
    lo = bf16_round(r - m)
    return h, m, lo


def stacked6(a, b):
    """The six >= 2^-24-relative split products stacked on K, one product
    of bf16-exact operands with f32 sums."""
    ah, am, al = split3(a)
    bh, bm, bl = split3(b)
    sa = torch.cat([ah, ah, am, ah, al, am], dim=1)
    sb = torch.cat([bh, bm, bh, bl, bh, bm], dim=0)
    return _f32_matmul(sa, sb)


def stacked3(a, b):
    """The three leading split products stacked on K."""
    ah, am, _ = split3(a)
    bh, bm, _ = split3(b)
    sa = torch.cat([ah, ah, am], dim=1)
    sb = torch.cat([bh, bm, bh], dim=0)
    return _f32_matmul(sa, sb)


def plain(a, b, prec: str):
    """a @ b at `prec`: "highest" in f32, "default" as one bf16 pass (both
    operands rounded to bf16, f32 sums)."""
    if prec == "default":
        a, b = bf16_round(a), bf16_round(b)
    return _f32_matmul(a, b)


def accuracy(k: int = 16, m: int = 512, n: int = 2048, device="cuda") -> dict:
    """Error of each product form relative to the |terms| scale against
    float64 (tools/microbench_k.py:132), on wide-range data from
    default_rng(1)."""
    dev = torch.empty(0, device=device).device
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((m, k))
         * 10.0 ** rng.uniform(-2, 3, (m, k))).astype(np.float32)
    b = (rng.standard_normal((k, n))
         * 10.0 ** rng.uniform(-2, 3, (k, n))).astype(np.float32)
    ref = np.asarray(a, np.float64) @ np.asarray(b, np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    at, bt = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
    out = {}
    for name, fn in (("highest", lambda: plain(at, bt, "highest")),
                     ("default", lambda: plain(at, bt, "default")),
                     ("stacked3", lambda: stacked3(at, bt)),
                     ("stacked6", lambda: stacked6(at, bt))):
        got = fn().cpu().numpy().astype(np.float64)
        rel = np.abs(got - ref) / np.maximum(scale, 1e-30)
        out[name] = {"max_rel_vs_scale": float(rel.max()),
                     "p99": float(np.quantile(rel, 0.99))}
        print(json.dumps({"bench": "accuracy", "mode": name, **out[name]}),
              flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=N_STEPS)
    ap.add_argument("--out", default=None,
                    help="JSON path (default build/compound_ray_tpu_torch/"
                         "microbench_k.json)")
    args = ap.parse_args(argv)
    dev = torch.empty(0, device=args.device).device  # raises without CUDA
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    rec_dev = device_record(dev)
    print(json.dumps(rec_dev), flush=True)
    acc = accuracy(device=dev)
    steps = []
    for n in NS:
        for k, prec in SWEEP:
            steps.append(time_variant(k, n, prec, args.steps, device=dev))
    at_n = max(NS)
    us = {(r["K"], r["prec"]): r["us_per_step"] for r in steps
          if r["N"] == at_n}
    base, one = us[(16, "highest")], us[(96, "default")]
    verdict = {"verdict": "stacked-K wins" if one < 0.7 * base else "no win",
               "N": at_n, "highestK16_us": base, "defaultK96_us": one,
               "stacked6_err": acc["stacked6"]["max_rel_vs_scale"],
               "highest_err": acc["highest"]["max_rel_vs_scale"]}
    print(json.dumps(verdict), flush=True)
    record = {"tool": "microbench_k", **rec_dev, "accuracy": acc,
              "dot_step": steps, "verdict": verdict,
              "measured": time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime())}
    path = write_record(record, "microbench_k", args.out)
    print(f"wrote {path}", flush=True)
    return record


if __name__ == "__main__":
    main()
