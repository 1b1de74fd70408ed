"""Dissect the packed tracer's per-step cost on the card (tools/probe_step.py
in torch): knock-out kernels K4 (run_probe) and K5 (run_probe3d) that share
K1's grid, staging and ray tiling, and the sweep of the JAX tool.

    python -m compound_ray_tpu_torch.tools.probe_step [--out PATH]
    python -m compound_ray_tpu_torch.tools.probe_step --device cpu --ng 4 --rb-size 1024

Modes (each sinks through the same per-ray min, so differences isolate):
  copy_only  no row loop: the launch, the rays' feature 0 in, one value out
  dma_only   + each payload row staged in shared memory and touched
  dot_only   + the (rs, 16) x (16, 512) products, w1 block sunk
  dot_cand   + the candidate math (divide, u/v/t, inside tests)
  real_bary  K1 itself (trace/mm_tracer.py run_packed_tracer)
so dma - copy is staging + loop + sink, dot - dma the products, cand - dot
the candidate math and bary - cand K1's winner select (less the products
K1 skips: it reads 10 features, the probes 16).  Payloads are random with
the magnitudes of the JAX tool; timings are the signal, hits are junk.

Not ported: real_uvs and its BATCH_RAYS sweep (tools/probe_step.py:280-307)
and so the cu/cv delta.  The port's K1 has no uvs emit, and its block is
fixed at 256 rays (on 128 threads, two rays each; ROADMAP.md, K1 notes).
The probes cover rs rays per block on rs / 2 threads, as K1 does at rs 256
(kRaysPerThread of csrc/probe_step.cu).
"""

from __future__ import annotations

import argparse
import ctypes
import time

import numpy as np
import torch

from compound_ray_tpu_torch.tools import (
    device_record,
    time_ms,
    write_record,
)
from compound_ray_tpu_torch.trace.attrs import KERNEL_LEAF
from compound_ray_tpu_torch.trace.mm_tracer import (
    MM_COLS,
    MM_FEATS,
    RAY_FEATS,
    run_packed_tracer,
)

MODES = ("copy_only", "dma_only", "dot_only", "dot_cand")
CHAIN_WIDTHS = (256, 512, 1024)  # rays per block (the TPU's chain width)
RS = 256
# the JAX tool's shape: ofstad-like, cnt = 1 everywhere; rb_size 3072
# divides by every chain width
NG, RB_SIZE, RMAX = 1000, 3072, 1
REPS = 10  # timed launches per entry, after one warm-up
NOT_PORTED = {
    "real_uvs": "the port's K1 has no uvs emit",
    "real_uvs_rs512": "the port's K1 block is fixed at 256 rays",
    "real_uvs_rs1024": "the port's K1 block is fixed at 256 rays",
}

# elements of the twin's (groups, rows, rays, columns) product per chunk
_TWIN_CHUNK_ELEMS = 1 << 26

# K4 launches by run_probe, K5 launches by run_probe3d (kernels only)
probe_launches = 0
probe3d_launches = 0


def make_inputs(ng: int = NG, rb_size: int = RB_SIZE, rmax: int = RMAX,
                seed: int = 0):
    """(rc (NG,) i32, pmm (NG, rmax, 16, 512) f32, rays (16, NG*rb) f32) as
    numpy, drawn in the JAX tool's order (tools/probe_step.py:228-234), so
    the same arguments give the TPU run's inputs bit for bit: feature rows
    0-9 standard normal x 50, row 10 integers below 2^20, cnt = 1."""
    rng = np.random.default_rng(seed)
    pmm = np.zeros((ng, rmax, MM_FEATS, MM_COLS), np.float32)
    pmm[:, :, 0:10, :] = rng.standard_normal(
        (ng, rmax, 10, MM_COLS)).astype(np.float32) * 50.0
    pmm[:, :, 10, :] = rng.integers(0, 1 << 20, (ng, rmax, MM_COLS))
    rc = np.ones((ng,), np.int32)
    rays = rng.standard_normal((RAY_FEATS, ng * rb_size)).astype(np.float32)
    return rc, pmm, rays


def _check_inputs(rc, pmm, rays, ng, rb_size, rmax, mode, rs, layout):
    """Raise on anything the kernel and its twin do not take."""
    dev = rays.device
    for name, x, dtype in (("rc", rc, torch.int32), ("pmm", pmm, torch.float32),
                           ("rays", rays, torch.float32)):
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if rs not in CHAIN_WIDTHS:
        raise ValueError(f"rs={rs} is not one of {CHAIN_WIDTHS}")
    if ng < 1 or rmax < 1 or rb_size < 1 or rb_size % rs:
        raise ValueError(f"ng={ng}, rmax={rmax} must be >= 1 and rb_size="
                         f"{rb_size} a positive multiple of rs={rs}")
    if tuple(rc.shape) != (ng,):
        raise ValueError(f"rc {tuple(rc.shape)} != ({ng},)")
    if tuple(pmm.shape) != (ng, rmax, MM_FEATS, MM_COLS):
        raise ValueError(f"pmm {tuple(pmm.shape)} != "
                         f"({ng}, {rmax}, {MM_FEATS}, {MM_COLS})")
    want = ((RAY_FEATS, ng * rb_size) if layout == "2d"
            else (ng, RAY_FEATS, rb_size))
    if tuple(rays.shape) != want:
        raise ValueError(f"rays {tuple(rays.shape)} != {want} ({layout})")


def probe_reference(rc, pmm, rays, ng: int, rb_size: int, rmax: int,
                    mode: str, layout: str = "2d") -> torch.Tensor:
    """Plain torch twin of K4 (layout "2d", rays (16, NG*rb)) and of K5
    (layout "3d", rays (NG, 16, rb)): (1, NG*rb) f32, per mode as in
    csrc/probe_step.cu; +inf in groups with rc <= 0.  The 3-D dot_only is
    the full dot_cand, as in the JAX tool (tools/probe_step.py:170-191).
    The products are an einsum in f32, chunked over groups; on CUDA the
    twin refuses to run with TF32 matmuls on."""
    _check_inputs(rc, pmm, rays, ng, rb_size, rmax, mode, RS, layout)
    dev = rays.device
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("probe_reference needs f32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    if layout == "3d" and mode == "dot_only":
        mode = "dot_cand"
    feats = (rays.reshape(RAY_FEATS, ng, rb_size) if layout == "2d"
             else rays.permute(1, 0, 2))  # (16, NG, rb)
    cnt = rc.clamp(0, rmax)
    live = (cnt > 0)[:, None]  # (NG, 1)
    inf = torch.tensor(torch.inf, device=dev)
    if mode == "copy_only":
        return torch.where(live, feats[0], inf).reshape(1, -1)
    row_ok = torch.arange(rmax, device=dev)[None, :] < cnt[:, None]  # (NG, rmax)
    if mode == "dma_only":
        touch = torch.where(row_ok[:, :, None], pmm[:, :, 0, :KERNEL_LEAF],
                            inf).amin(dim=(1, 2))  # (NG,)
        out = torch.where(live, touch[:, None].expand(ng, rb_size), inf)
        return out.reshape(1, -1)
    cols = KERNEL_LEAF if mode == "dot_only" else MM_COLS
    out = torch.full((ng, rb_size), torch.inf, dtype=torch.float32,
                     device=dev)
    chunk = max(1, _TWIN_CHUNK_ELEMS // (rmax * rb_size * cols))
    for g0 in range(0, ng, chunk):
        g1 = min(ng, g0 + chunk)
        p = torch.einsum("kgr,gjkc->gjrc", feats[:, g0:g1],
                         pmm[g0:g1, :, :, :cols])  # (G, rmax, rb, cols)
        if mode == "dot_only":
            x = p
        else:
            w1, w2, den, tnum = p.split(KERNEL_LEAF, dim=-1)
            inv = 1.0 / den
            u = w1 * inv
            v = w2 * inv
            t = tnum * inv
            ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)
            x = torch.where(ok, t, inf)
        x = torch.where(row_ok[g0:g1, :, None, None], x, inf)
        out[g0:g1] = x.amin(dim=(1, 3))
    return torch.where(live, out, inf).reshape(1, -1)


def _launch(rc, pmm, rays, ng, rb_size, rmax, mode, rs, feat_stride,
            group_stride) -> torch.Tensor:
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(f"the probes take CPU or CUDA tensors, not {dev.type}")
    from compound_ray_tpu_torch.trace import _build

    lib = _build.probe_step_lib()
    out = torch.empty((1, ng * rb_size), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cr_probe_step(
            ctypes.c_void_p(rc.data_ptr()), ctypes.c_void_p(pmm.data_ptr()),
            ctypes.c_void_p(rays.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            None, ng, rmax, rb_size, rs, MODES.index(mode), feat_stride,
            group_stride, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"probe launch failed: CUDA error {err}")
    return out


def run_probe(rc, pmm, rays, ng: int, rb_size: int, rmax: int, mode: str,
              rs: int = RS) -> torch.Tensor:
    """K4: the knock-out probe `mode` of K1's row step
    (tools/probe_step.py:125).  rc (NG,) i32, pmm (NG, rmax, 16, 512) f32,
    rays (16, NG*rb) f32; returns (1, NG*rb) f32, +inf in groups with
    rc <= 0 (the TPU kernel leaves them unwritten).  rs rays per block
    (256, 512 or 1024) do not change the output, bit for bit.  CUDA tensors
    launch csrc/probe_step.cu on the current stream (or raise); CPU tensors
    take probe_reference."""
    global probe_launches
    _check_inputs(rc, pmm, rays, ng, rb_size, rmax, mode, rs, "2d")
    if rays.device.type == "cpu":
        return probe_reference(rc, pmm, rays, ng, rb_size, rmax, mode)
    out = _launch(rc, pmm, rays, ng, rb_size, rmax, mode, rs,
                  ng * rb_size, rb_size)
    probe_launches += 1
    return out


def run_probe3d(rc, pmm, rays3d, ng: int, rb_size: int, rmax: int,
                mode: str) -> torch.Tensor:
    """K5: run_probe with rays in (NG, 16, rb) layout, 256 rays per
    block (tools/probe_step.py:151).  Its dot_only runs the full dot_cand
    body, as the JAX tool's 3-D kernel does (tools/probe_step.py:170-191).
    CUDA tensors launch csrc/probe_step.cu (or raise); CPU tensors take
    probe_reference."""
    global probe3d_launches
    _check_inputs(rc, pmm, rays3d, ng, rb_size, rmax, mode, RS, "3d")
    if rays3d.device.type == "cpu":
        return probe_reference(rc, pmm, rays3d, ng, rb_size, rmax, mode, "3d")
    kmode = "dot_cand" if mode == "dot_only" else mode
    out = _launch(rc, pmm, rays3d, ng, rb_size, rmax, kmode, RS, rb_size,
                  RAY_FEATS * rb_size)
    probe3d_launches += 1
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ng", type=int, default=NG,
                    help="groups (a multiple of 4)")
    ap.add_argument("--rb-size", type=int, default=RB_SIZE,
                    help="rays per group (a multiple of 1024)")
    ap.add_argument("--out", default=None,
                    help="JSON path (default build/compound_ray_tpu_torch/"
                         "probe_step.json)")
    args = ap.parse_args(argv)
    dev = torch.empty(0, device=args.device).device  # raises without CUDA
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    ng, rb_size, rmax = args.ng, args.rb_size, RMAX
    if ng % 4 or rb_size % 1024:
        raise ValueError("--ng must be a multiple of 4 and --rb-size of 1024")
    rc, pmm, rays = (torch.as_tensor(x, device=dev)
                     for x in make_inputs(ng, rb_size, rmax))

    times = {}

    def timed(key, fn):
        times[key] = time_ms(fn, REPS, dev)
        print(f"probe {key:18s}: {times[key]:9.4f} ms", flush=True)

    for mode in MODES:
        timed(mode, lambda m=mode: run_probe(rc, pmm, rays, ng, rb_size,
                                             rmax, m))
    # chain-width sweep: a per-block floor shrinks with wider blocks
    for rs in (512, 1024):
        for mode in ("dma_only", "dot_cand"):
            timed(f"{mode}_rs{rs}", lambda m=mode, r=rs: run_probe(
                rc, pmm, rays, ng, rb_size, rmax, m, r))
    # grid-size scaling at constant total rays: fewer, longer groups
    for ngx, rbx in ((ng // 2, rb_size * 2), (ng // 4, rb_size * 4)):
        rcx = torch.ones((ngx,), dtype=torch.int32, device=dev)
        timed(f"copy_only_ng{ngx}", lambda n=ngx, rb=rbx, c=rcx: run_probe(
            c, pmm[:n], rays, n, rb, rmax, "copy_only"))
    # contiguous (NG, 16, rb) rays
    rays3d = rays.reshape(RAY_FEATS, ng, rb_size).permute(1, 0, 2).contiguous()
    for mode in ("copy_only", "dot_cand"):
        timed(f"{mode}_3d", lambda m=mode: run_probe3d(
            rc, pmm, rays3d, ng, rb_size, rmax, m))
    timed("real_bary", lambda: run_packed_tracer(
        rc, pmm, rays, ng=ng, nrb=1, rb_size=rb_size, rmax=rmax))
    for key, why in NOT_PORTED.items():
        print(f"probe {key:18s}: not ported ({why})", flush=True)

    steps = ng * (rb_size // RS)
    print(f"\n{steps} block-steps at rs={RS}; us/step:", flush=True)
    for k, v in times.items():
        print(f"  {k:18s} {v / steps * 1000.0:8.4f}", flush=True)
    deltas = {
        "staging+loop+sink (dma-copy)": times["dma_only"] - times["copy_only"],
        "products (dot-dma)": times["dot_only"] - times["dma_only"],
        "cand math (cand-dot)": times["dot_cand"] - times["dot_only"],
        "winner sel (bary-cand)": times["real_bary"] - times["dot_cand"],
    }
    for k, v in deltas.items():
        print(f"  {k:30s} {v:9.4f} ms", flush=True)
    record = {"tool": "probe_step", **device_record(dev),
              "shape": {"ng": ng, "rb_size": rb_size, "rmax": rmax,
                        "rays": ng * rb_size, "reps": REPS},
              "times_ms": times, "deltas_ms": deltas, "steps": steps,
              "not_ported": NOT_PORTED,
              "measured": time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime())}
    path = write_record(record, "probe_step", args.out)
    print(f"wrote {path}", flush=True)
    return record


if __name__ == "__main__":
    main()
