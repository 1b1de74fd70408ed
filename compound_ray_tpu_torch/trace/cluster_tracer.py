"""Cluster-shortlist closest-hit tracer K2 (compound_ray_tpu/trace/
pallas_tracer.py in torch).

A group of rays (a 256-direction tile of the far-field cache) walks its own
front-to-back shortlist of 128-triangle clusters: `counts[g]` entries of
`ids[g]`, with `dmin[g]` the lower distance bound of each.  A cluster's
payload is (16, 128): component-major rows over its 128 triangle lanes,

    0- 5  edge Plücker 6-vector of the edge opposite v1   (w1 -> u)
    6-11  edge Plücker 6-vector of the edge opposite v2   (w2 -> v)
   12-14  n = e1 x e2                                      (den = d . n)
   15     c0 = v0 . n                                      (t numerator)

A ray is the (16,) row [d, m = o x d, o, tmin, 0 x 6].  Per lane
u = w1/den, v = w2/den, t = (c0 - o.n)/den, and the lane hits iff u >= 0,
v >= 0, u + v <= 1 and t >= tmin.  All-zero padding lanes give den = 0, so
u, v and t are inf or NaN and every comparison fails under IEEE arithmetic.

The early-exit form stops a 128-ray batch before cluster j once no ray of
the batch has a current best t above dmin[g, j]: the shortlist is sorted
nearest first, so no later cluster can hold a closer hit.

Two implementations of one contract:
  * run_tracer_kernel — the wrapper of the CUDA kernel
    (csrc/cluster_tracer.cu) for CUDA tensors; CPU tensors take the twin.
  * cluster_tracer_reference — the plain torch twin.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from compound_ray_tpu_torch.spans import span
from compound_ray_tpu_torch.trace.attrs import KERNEL_LEAF, OUT_COMPS

PAYLOAD_COMPS = 16  # w1 edge6, w2 edge6, normal, c0
RAY_COMPS = 16  # dx dy dz mx my mz ox oy oz tmin pad[6]
# rays per early-exit decision (compound_ray_tpu/trace/pallas_tracer.py:183);
# rb_size must be a multiple
BATCH_RAYS = 128

# elements of the twin's (groups, rays, 128) temporaries per group chunk:
# bounds its memory to a few hundred MB at the full-size cache
_TWIN_CHUNK_ELEMS = 1 << 24

# K2 launches by run_tracer_kernel (the kernel only, never the twin)
launches = 0


def build_kernel_payload(cluster_set) -> np.ndarray:
    """(C, 16, 128) float32 intersection payload from a cluster set of leaf
    128 (compound_ray_tpu/trace/pallas_tracer.py:70).  Geometry only: the
    winner's attributes live in the attribute table."""
    from compound_ray_tpu_torch.trace.plucker import triangle_constants

    c, l = cluster_set.tri_id.shape
    assert l == KERNEL_LEAF
    tri = triangle_constants(cluster_set.v0, cluster_set.e1, cluster_set.e2)
    edge6 = np.asarray(tri["edge6"], np.float32)  # (C*L, 3, 6)
    normal = np.asarray(tri["normal"], np.float32)  # (C*L, 3)
    c0 = np.asarray(tri["c0"], np.float32)[:, None]  # (C*L, 1)
    payload = np.concatenate([edge6[:, 1], edge6[:, 2], normal, c0], axis=1)
    assert payload.shape[1] == PAYLOAD_COMPS
    return np.ascontiguousarray(
        payload.reshape(c, l, PAYLOAD_COMPS).transpose(0, 2, 1))


def pack_rays(dirs, origins, tmin) -> torch.Tensor:
    """(R, 16) ray rows [d, m = o x d, o, tmin, 0 x 6] from (R, 3)
    directions and origins and (R,) tmin
    (compound_ray_tpu/trace/pallas_tracer.py:143)."""
    m = torch.linalg.cross(origins, dirs, dim=-1)
    r = dirs.shape[0]
    return torch.cat(
        [dirs, m, origins, tmin.reshape(r, 1),
         torch.zeros((r, RAY_COMPS - 10), dtype=dirs.dtype,
                     device=dirs.device)], dim=-1).contiguous()


def _check_inputs(counts, ids, dmin, payload, rays, ng, nrb, rb_size, kmax):
    """Raise on anything the kernel and its twin do not take."""
    dev = rays.device
    for name, x, dtype in (("counts", counts, torch.int32),
                           ("ids", ids, torch.int32),
                           ("dmin", dmin, torch.float32),
                           ("payload", payload, torch.float32),
                           ("rays", rays, torch.float32)):
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rb_size <= 0 or rb_size % BATCH_RAYS:
        raise ValueError(
            f"rb_size={rb_size} must be a positive multiple of {BATCH_RAYS}")
    if tuple(counts.shape) != (ng,):
        raise ValueError(f"counts {tuple(counts.shape)} != ({ng},)")
    if ids.dim() != 2 or ids.shape[0] != ng or ids.shape[1] < 1:
        raise ValueError(f"ids {tuple(ids.shape)} != ({ng}, KP)")
    if tuple(dmin.shape) != tuple(ids.shape):
        raise ValueError(f"dmin {tuple(dmin.shape)} != ids "
                         f"{tuple(ids.shape)}")
    if not 1 <= kmax <= ids.shape[1]:
        raise ValueError(f"kmax={kmax} must lie in [1, KP={ids.shape[1]}]")
    if (payload.dim() != 3 or payload.shape[0] < 1
            or tuple(payload.shape[1:]) != (PAYLOAD_COMPS, KERNEL_LEAF)):
        raise ValueError(f"payload {tuple(payload.shape)} != "
                         f"(C, {PAYLOAD_COMPS}, {KERNEL_LEAF})")
    if tuple(rays.shape) != (ng * nrb * rb_size, RAY_COMPS):
        raise ValueError(f"rays {tuple(rays.shape)} != "
                         f"({ng * nrb * rb_size}, {RAY_COMPS})")


def k2_keep_first(w1, den):
    """The first two conditions of k2_reject's keep test, on den and w1
    alone: d > 0 and a >= -m.  K2 computes w2 for a lane only where they
    hold for one of a thread's rays."""
    s = torch.where(den >= 0.0, 1.0, -1.0).to(den.dtype)
    d = den * s
    return (d > 0.0) & (w1 * s >= -(d * 2.0 ** -20))


def k2_reject(w1, w2, den):
    """K2's divide-free reject test on the barycentric conditions
    (csrc/cluster_tracer.cu mirrors it): True only where the exact test
    (inv = 1 / den, u = w1 inv, v = w2 inv; u >= 0, v >= 0, u + v <= 1)
    rejects the pair, so the kernel divides, and tests t >= tmin, only on
    the pairs this leaves.  With s the sign of den (+1 at +-0), a = w1 s,
    b = w2 s, d = den s and the margin m = d 2^-20, a pair is kept iff
    d > 0, a >= -m (the first two: k2_keep_first), b >= -m and
    a + b <= d + m, so all-zero padding lanes (den = 0) and NaNs are
    rejected.  tmin is not part of it: t >= tmin stays in the exact test
    after the divide.  The proof is in the kernel's header note.  Not on
    cluster_tracer_reference's path: the twin runs the exact test alone."""
    s = torch.where(den >= 0.0, 1.0, -1.0).to(den.dtype)
    a, b, d = w1 * s, w2 * s, den * s
    m = d * 2.0 ** -20
    return ~(k2_keep_first(w1, den) & (b >= -m) & (a + b <= d + m))


def cluster_tracer_reference(counts, ids, dmin, payload, rays, ng: int,
                             nrb: int, rb_size: int, kmax: int,
                             early_exit: bool = False) -> torch.Tensor:
    """Plain torch twin of the K2 kernel: (R, 8) rows
    [t, u, v, cluster id, lane, 0, 0, 0]; a miss is t = +inf, u = v = 0,
    cluster = -1, lane = 0.

    Winner order of the TPU kernel (compound_ray_tpu/trace/
    pallas_tracer.py:254-344): each lane keeps its first cluster at the
    lane's minimum t (strict <), then the lowest lane at the minimum over
    lanes wins.  The early exit is decided per 128-ray batch before each
    cluster j from the batch's worst current best t, with a cumulative
    "still active" mask standing in for the kernel's while loop.  A group
    walks min(counts[g], kmax) clusters; counts <= 0 gives misses (the TPU
    leaves those groups unwritten; callers mask them either way).  Cluster
    ids are clamped into the payload, as the kernel clamps them."""
    return _cluster_tracer_twin(counts, ids, dmin, payload, rays, ng, nrb,
                                rb_size, kmax, early_exit)[0]


def _cluster_tracer_twin(counts, ids, dmin, payload, rays, ng: int, nrb: int,
                         rb_size: int, kmax: int, early_exit: bool = False,
                         count_walked: bool = False):
    """(cluster_tracer_reference's (R, 8) result, walked), walked None
    unless count_walked, else the (NG, rg / 128) int64 count of the
    clusters each 128-ray batch walks on these inputs, as the kernel's
    block walks them: min(counts[g], kmax) without the early exit, with it
    the shortlist entries up to the first one that no ray's best t
    exceeds."""
    _check_inputs(counts, ids, dmin, payload, rays, ng, nrb, rb_size, kmax)
    dev = rays.device
    rg = nrb * rb_size
    nb = rg // BATCH_RAYS
    kp = ids.shape[1]
    out = torch.zeros((ng * rg, OUT_COMPS), dtype=torch.float32, device=dev)
    out[:, 0] = torch.inf
    out[:, 3] = -1.0
    cnt_all = counts.clamp(0, kmax)
    ids_c = ids.clamp(0, payload.shape[0] - 1)
    lane_ix = torch.arange(KERNEL_LEAF, device=dev)
    walked = (torch.zeros((ng, nb), dtype=torch.int64, device=dev)
              if count_walked else None)
    chunk = max(1, _TWIN_CHUNK_ELEMS // (rg * KERNEL_LEAF))
    for g0 in range(0, ng, chunk):
        g1 = min(ng, g0 + chunk)
        gn = g1 - g0
        cnt = cnt_all[g0:g1]
        steps = int(cnt.max().item())
        if steps == 0:
            continue
        ray = rays[g0 * rg:g1 * rg].reshape(gn, rg, RAY_COMPS)

        def rc(c):
            return ray[:, :, c:c + 1]  # (G, rg, 1)

        dx, dy, dz = rc(0), rc(1), rc(2)
        mx, my, mz = rc(3), rc(4), rc(5)
        ox, oy, oz = rc(6), rc(7), rc(8)
        tmin = rc(9)
        shape = (gn, rg, KERNEL_LEAF)
        bt = torch.full(shape, torch.inf, device=dev)
        bu = torch.zeros(shape, device=dev)
        bv = torch.zeros(shape, device=dev)
        bj = torch.full(shape, -1.0, device=dev)
        active = torch.ones((gn, nb), dtype=torch.bool, device=dev)
        for j in range(steps):
            live = j < cnt  # (G,)
            if early_exit:
                worst = bt.amin(dim=-1).reshape(gn, nb, BATCH_RAYS).amax(-1)
                d_j = dmin[g0:g1, min(j, kp - 1)]
                active = active & live[:, None] & (worst > d_j[:, None])
            else:
                active = live[:, None].expand(gn, nb)
            if not bool(active.any()):
                break
            if count_walked:
                walked[g0:g1] += active
            cid = ids_c[g0:g1, j]
            tri = payload[cid]  # (G, 16, 128)

            def tc(c):
                return tri[:, c:c + 1, :]  # (G, 1, 128)

            w1 = (dx * tc(0) + dy * tc(1) + dz * tc(2) + mx * tc(3)
                  + my * tc(4) + mz * tc(5))
            w2 = (dx * tc(6) + dy * tc(7) + dz * tc(8) + mx * tc(9)
                  + my * tc(10) + mz * tc(11))
            nx, ny, nz = tc(12), tc(13), tc(14)
            den = dx * nx + dy * ny + dz * nz
            onum = ox * nx + oy * ny + oz * nz
            inv = 1.0 / den
            u = w1 * inv
            v = w2 * inv
            t = (tc(15) - onum) * inv
            act = active[:, :, None].expand(gn, nb, BATCH_RAYS).reshape(
                gn, rg, 1)
            ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= tmin)
                  & (t < bt) & act)
            bt = torch.where(ok, t, bt)
            bu = torch.where(ok, u, bu)
            bv = torch.where(ok, v, bv)
            bj = torch.where(ok, cid.to(torch.float32)[:, None, None], bj)
        # cross-lane winner per ray: the first lane at the minimum.  A ray
        # whose lanes all missed picks lane 0 of the initial state, which is
        # the miss row (groups that walk no cluster stay there too)
        tbest = bt.amin(dim=-1, keepdim=True)  # (G, rg, 1)
        first = torch.where(bt == tbest, lane_ix, KERNEL_LEAF).amin(
            dim=-1, keepdim=True)  # (G, rg, 1)
        rows = out[g0 * rg:g1 * rg].view(gn, rg, OUT_COMPS)
        rows[:, :, 0] = tbest[..., 0]
        rows[:, :, 1] = bu.gather(-1, first)[..., 0]
        rows[:, :, 2] = bv.gather(-1, first)[..., 0]
        rows[:, :, 3] = bj.gather(-1, first)[..., 0]
        rows[:, :, 4] = first[..., 0].to(torch.float32)
    return out, walked


def run_tracer_kernel(counts, ids, dmin, payload, rays, ng: int, nrb: int,
                      rb_size: int, kmax: int,
                      early_exit: bool = False) -> torch.Tensor:
    """K2: closest hit of every ray over its group's cluster shortlist
    (compound_ray_tpu/trace/pallas_tracer.py:361).

    counts (NG,) int32; ids (NG, KP) int32 and dmin (NG, KP) f32, the
    shortlist nearest first; payload (C, 16, 128) f32 (build_kernel_payload);
    rays (NG*nrb*rb_size, 16) f32 (pack_rays).  Returns (R, 8) f32 rows
    [t, u, v, cluster id, lane, 0, 0, 0], t = +inf on a miss.  CUDA tensors
    launch the kernel of csrc/cluster_tracer.cu on the current stream (or
    raise); CPU tensors take cluster_tracer_reference."""
    global launches
    dev = rays.device
    if dev.type == "cpu":
        return cluster_tracer_reference(counts, ids, dmin, payload, rays, ng,
                                        nrb, rb_size, kmax, early_exit)
    _check_inputs(counts, ids, dmin, payload, rays, ng, nrb, rb_size, kmax)
    if dev.type != "cuda":
        raise ValueError(f"run_tracer_kernel takes CPU or CUDA tensors, "
                         f"not {dev.type}")
    if rays.data_ptr() % 16 or payload.data_ptr() % 16:
        raise ValueError("rays and payload must start on a 16-byte boundary "
                         "(the kernel reads each ray as float4s and copies "
                         "each cluster's payload in bulk)")
    from compound_ray_tpu_torch.trace import _build

    lib = _build.cluster_tracer_lib()
    out = torch.empty((rays.shape[0], OUT_COMPS), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with span("cr.k2"):
            err = lib.cr_cluster_tracer(
                ctypes.c_void_p(counts.data_ptr()),
                ctypes.c_void_p(ids.data_ptr()),
                ctypes.c_void_p(dmin.data_ptr()),
                ctypes.c_void_p(payload.data_ptr()),
                ctypes.c_void_p(rays.data_ptr()),
                ctypes.c_void_p(out.data_ptr()),
                ng, ids.shape[1], kmax, payload.shape[0], nrb * rb_size,
                int(bool(early_exit)), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"cluster tracer launch failed: CUDA error {err}")
    launches += 1
    return out
