"""Packed tracers K1 (closest hit) and K3 (any-hit occlusion)
(compound_ray_tpu/trace/mm_tracer.py in torch).

A group of rays (one ommatidium, or a few when samples are few) is traced
against its own packed payload: `row_counts[g]` rows of 128 triangle SLOTS,
each slot four 16-feature columns (only features 0-9 are live):

    w1   [edge1_cross(3), edge1_diff(3), 0, 0, 0, 0]   (side product -> u)
    w2   [edge2_cross(3), edge2_diff(3), 0, 0, 0, 0]   (side product -> v)
    den  [n(3),           0, 0, 0,       0, 0, 0, 0]   (d . n)
    tnum [0, 0, 0,        0, 0, 0,       n(3),  c0]    (c0 - o . n)

A ray is the feature vector F = [d(3), m(3), -o'(3), 1, 0 x 6] with
m = o x d and o' = o + tmin d, so F against a column gives w1, w2, den and
the t numerator; u = w1/den, v = w2/den, t = tnum/den and the slot hits iff
u >= 0, v >= 0, u + v <= 1 and t >= 0 (both-sided, like the reference's
OptiX default).  Padding columns are all zero: den = 0 makes u, v, t NaN or
inf and every comparison false, so padding masks itself under IEEE
arithmetic.  Row 10 of the w1 block carries the slot's global id.

With affine primary rays (config.affine_rays, one ommatidium per group)
each group's shared origin and tmin are folded into its payload
(transform_payload_affine) and a ray is [d, 1, 0 x 4] (pack_rays_affine):
K1's 8-feature form (ray_feats=8), whose products read features 0-3 only
(AFFINE_LIVE), since rows 4-7 of both are zero by construction.

Two implementations of one contract:
  * run_packed_tracer — the wrapper of the CUDA kernel
    (csrc/packed_tracer.cu) for CUDA tensors; CPU tensors take the twin.
  * packed_tracer_reference — the plain torch twin (einsum, or for the
    affine form the 4-term products summed in the kernel's order, + the
    same candidate algebra and winner order).

K3 traces the lit frame's shadow rays against the shadow plan's ragged
occluder table (eye/pipeline.py _shadow_plan): rows of transform_payload_
affine'd columns, their feature rows 0-7 only, sorted by virtual group
(light * NG + group).  A shadow ray is [D, 1, 0 x 4] with its origin at
the light, so the products give w1, w2, den and tnum directly and the test
needs no division (sign-folded, see run_rows_occlusion); rows and rays are
zero in features 4-7, so the lit frame asks K3 for live_feats=4.  Again two
implementations: run_rows_occlusion (csrc/rows_occlusion.cu on CUDA
tensors) and rows_occlusion_reference (the torch twin).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from compound_ray_tpu_torch.spans import span
from compound_ray_tpu_torch.trace.attrs import KERNEL_LEAF, OUT_COMPS

MM_FEATS = 16  # feature rows per column (0-9 live, 10 = slot id on w1)
MM_BLOCKS = 4  # w1 | w2 | den | tnum
MM_COLS = MM_BLOCKS * KERNEL_LEAF  # 512 columns per payload row
RAY_FEATS = 16  # [d, m, -o, 1, 0 x 6]
RAY_FEATS_AFFINE = 8  # [d, 1, 0 x 4] (pack_rays_affine)
AFFINE_LIVE = 4  # the affine form's live features (rows 4-7 are zero)
# rays per ray block are padded to a multiple of this (eye_plan rb_size);
# the JAX package's TPU-tuned BATCH_RAYS default, kept so shapes match
BATCH_RAYS = 256

# elements of the twin's (groups, rows, rays, 512) product per chunk: bounds
# its temporaries to a few hundred MB at the full-size frame
_TWIN_CHUNK_ELEMS = 1 << 26

# elements of the K3 twin's (groups, rays, 512) product per chunk: its few
# live temporaries of that size stay near 2 GB at the full-size frame
_OCC_TWIN_CHUNK_ELEMS = 1 << 27
# rays of a K3 warp (one per thread), for the twin's warp-issued count
_WARP = 32

# K1 launches by run_packed_tracer (the kernel only, never the twin): the
# 16-feature form, and the 8-feature affine form apart
launches = 0
affine_launches = 0
# K3 launches by run_rows_occlusion (the kernel only, never the twin)
occlusion_launches = 0


def build_mm_features(cluster_set, uv=None, texid=None, rgb=None) -> np.ndarray:
    """(C*128 + 128, 4, 16) per-slot feature columns
    (compound_ray_tpu/trace/mm_tracer.py:314).

    Row index = global slot id (cluster * 128 + lane); the trailing 128
    all-zero rows are the compaction PAD target (den = 0 -> never hits).
    feats[s, b] is column block b's 16-feature vector for slot s; w1's
    feature 10 carries float(s).  Rows 11-15 (texture-coordinate affine
    constants, texture id, flat colour) are filled as the JAX package fills
    them, so the tables agree; this port's kernel never reads them."""
    from compound_ray_tpu_torch.trace.plucker import triangle_constants

    c, l = cluster_set.tri_id.shape
    assert l == KERNEL_LEAF
    tri = triangle_constants(cluster_set.v0, cluster_set.e1, cluster_set.e2)
    edge6 = np.asarray(tri["edge6"], np.float32)  # (S, 3, 6)
    normal = np.asarray(tri["normal"], np.float32)  # (S, 3)
    c0 = np.asarray(tri["c0"], np.float32)  # (S,)
    s = c * l

    feats = np.zeros((s + KERNEL_LEAF, MM_BLOCKS, MM_FEATS), np.float32)
    feats[:s, 0, 0:6] = edge6[:, 1]  # w1 (edge opposite v1 -> u)
    feats[:s, 0, 10] = np.arange(s, dtype=np.float32)  # slot id
    feats[:s, 1, 0:6] = edge6[:, 2]  # w2 (edge opposite v2 -> v)
    feats[:s, 2, 0:3] = normal  # den = d . n
    feats[:s, 3, 6:9] = normal  # tnum = c0 - o . n  (ray carries -o)
    feats[:s, 3, 9] = c0
    if uv is not None:
        tid = cluster_set.tri_id.reshape(-1)
        safe = np.maximum(tid, 0)
        uv0 = np.asarray(uv[0], np.float32)[safe]
        uv1 = np.asarray(uv[1], np.float32)[safe]
        uv2 = np.asarray(uv[2], np.float32)[safe]
        feats[:s, 0, 11] = uv0[:, 0]
        feats[:s, 0, 12] = uv0[:, 1]
        feats[:s, 0, 13] = uv1[:, 0] - uv0[:, 0]
        feats[:s, 0, 14] = uv1[:, 1] - uv0[:, 1]
        feats[:s, 0, 15] = uv2[:, 0] - uv0[:, 0]
        feats[:s, 1, 10] = uv2[:, 1] - uv0[:, 1]
        feats[:s, 1, 11] = np.asarray(texid, np.float32)
    if rgb is not None:
        feats[:s, 1, 12] = np.asarray(rgb, np.float32)[:, 0]
        feats[:s, 1, 13] = np.asarray(rgb, np.float32)[:, 1]
        feats[:s, 1, 14] = np.asarray(rgb, np.float32)[:, 2]
    return feats


def slot_spheres(cluster_set):
    """Per-slot triangle bounding spheres for the cone refine
    (compound_ray_tpu/trace/mm_tracer.py:440).

    Returns (center (S, 3) f32, radius (S,) f32, valid (S,) bool); padding
    slots get radius -1 so `dist <= radius` and the angular test both fail
    even before the validity mask."""
    v0 = cluster_set.v0
    p1 = v0 + cluster_set.e1
    p2 = v0 + cluster_set.e2
    c = ((v0 + p1 + p2) / 3.0).astype(np.float32)
    r = np.maximum.reduce([
        np.linalg.norm(v0 - c, axis=1),
        np.linalg.norm(p1 - c, axis=1),
        np.linalg.norm(p2 - c, axis=1),
    ]).astype(np.float32)
    valid = cluster_set.tri_id.reshape(-1) >= 0
    r = np.where(valid, r, -1.0).astype(np.float32)
    return c, r, valid


def pack_rays_mm(dirs, origins, tmin):
    """(16, R) planar ray features from (R, 3) dirs/origins and (R,) tmin
    (compound_ray_tpu/trace/mm_tracer.py:460).  tmin is folded into the
    origin, o' = o + tmin d, so the inside test is simply t' >= 0; the
    Plücker moment is tmin-invariant."""
    o2 = origins + tmin[:, None] * dirs
    m = torch.linalg.cross(origins, dirs, dim=-1)
    r = dirs.shape[0]
    feats = torch.cat(
        [dirs, m, -o2, torch.ones((r, 1), dtype=dirs.dtype, device=dirs.device),
         torch.zeros((r, RAY_FEATS - 10), dtype=dirs.dtype, device=dirs.device)],
        dim=-1)
    return feats.t().contiguous()


def pack_rays_affine(dirs):
    """(8, R) planar affine ray features [d, 1, 0 x 4] from (R, 3) unit
    dirs (compound_ray_tpu/trace/mm_tracer.py:428): pack_rays_mm's
    counterpart for payloads that transform_payload_affine has folded the
    origin and tmin into."""
    r = dirs.shape[0]
    feats = torch.cat(
        [dirs, torch.ones((r, 1), dtype=dirs.dtype, device=dirs.device),
         torch.zeros((r, RAY_FEATS_AFFINE - 4), dtype=dirs.dtype,
                     device=dirs.device)], dim=-1)
    return feats.t().contiguous()


def _check_inputs(row_counts, packed_mm, rays, ng, nrb, rb_size, rmax,
                  ray_feats=RAY_FEATS):
    """Raise on anything the kernel and its twin do not take."""
    if ray_feats not in (RAY_FEATS, RAY_FEATS_AFFINE):
        raise ValueError(f"ray_feats={ray_feats}: K1 takes {RAY_FEATS} or "
                         f"{RAY_FEATS_AFFINE} (affine) ray features")
    dev = rays.device
    for name, x, dtype in (("row_counts", row_counts, torch.int32),
                           ("packed_mm", packed_mm, torch.float32),
                           ("rays", rays, torch.float32)):
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rb_size % BATCH_RAYS:
        raise ValueError(
            f"rb_size={rb_size} must be a multiple of {BATCH_RAYS}")
    if tuple(row_counts.shape) != (ng,):
        raise ValueError(f"row_counts {tuple(row_counts.shape)} != ({ng},)")
    if tuple(packed_mm.shape) != (ng, rmax, MM_FEATS, MM_COLS):
        raise ValueError(f"packed_mm {tuple(packed_mm.shape)} != "
                         f"({ng}, {rmax}, {MM_FEATS}, {MM_COLS})")
    # the payload's affine-ness is known only from the flag the callers
    # pass, so the rays' feature count must agree with it
    # (compound_ray_tpu/trace/mm_tracer.py:1033)
    if tuple(rays.shape) != (ray_feats, ng * nrb * rb_size):
        raise ValueError(f"rays {tuple(rays.shape)} != "
                         f"({ray_feats}, {ng * nrb * rb_size}) for "
                         f"ray_feats={ray_feats}")


def _products(feats, pm, ray_feats: int):
    """(G, rmax, rg, 512) products of rays (F, G, rg) with payload blocks
    (G, rmax, 16, 512): an f32 einsum over the 16 features, or for the
    affine form the AFFINE_LIVE-term sum in feature order, as the kernel
    sums it (one rounded multiply and add per term, where the kernel
    fuses them)."""
    if ray_feats == RAY_FEATS:
        return torch.einsum("fgr,gjfc->gjrc", feats, pm)
    p = feats[0][:, None, :, None] * pm[:, :, None, 0, :]
    for k in range(1, AFFINE_LIVE):
        p = p + feats[k][:, None, :, None] * pm[:, :, None, k, :]
    return p


def packed_tracer_reference(row_counts, packed_mm, rays, ng: int, nrb: int,
                            rb_size: int, rmax: int,
                            ray_feats: int = RAY_FEATS) -> torch.Tensor:
    """Plain torch twin of the K1 kernel: (8, R) planar [t, u, v, slot, 0 x 4],
    t = +inf, u = v = 0 and slot = -1 on a miss.  ray_feats=8 takes affine
    rays against a transform_payload_affine'd payload (_products).

    Winner order of the TPU kernel (compound_ray_tpu/trace/mm_tracer.py:
    602-616, 650): each lane keeps its first row at the lane's minimum t,
    then the lowest lane at the minimum over lanes wins.  Groups with
    row_counts == 0 come out as misses (the TPU leaves them unwritten;
    callers mask them either way).  Explicit f32: on CUDA the einsum must
    not run in TF32, so the twin refuses to run with TF32 matmuls on."""
    _check_inputs(row_counts, packed_mm, rays, ng, nrb, rb_size, rmax,
                  ray_feats)
    dev = rays.device
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "packed_tracer_reference needs f32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    rg = nrb * rb_size
    out = torch.zeros((OUT_COMPS, ng * rg), dtype=torch.float32, device=dev)
    if rmax == 0:
        out[0] = torch.inf
        out[3] = -1.0
        return out
    feats = rays.reshape(ray_feats, ng, rg)
    inf = torch.tensor(torch.inf, device=dev)
    row_ix = torch.arange(rmax, device=dev)
    lane_ix = torch.arange(KERNEL_LEAF, device=dev)
    chunk = max(1, _TWIN_CHUNK_ELEMS // (rmax * rg * MM_COLS))
    for g0 in range(0, ng, chunk):
        g1 = min(ng, g0 + chunk)
        gn = g1 - g0
        pm = packed_mm[g0:g1]  # (G, rmax, 16, 512)
        p = _products(feats[:, g0:g1], pm, ray_feats)
        w1, w2, den, tnum = p.split(KERNEL_LEAF, dim=-1)  # (G, rmax, rg, 128)
        inv = 1.0 / den
        u = w1 * inv
        v = w2 * inv
        t = tnum * inv
        ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)
        cnt = row_counts[g0:g1].clamp(0, rmax)
        ok &= (row_ix[None, :] < cnt[:, None])[:, :, None, None]
        tc = torch.where(ok, t, inf)
        best = tc.amin(dim=1)  # (G, rg, 128) per-lane minimum over rows
        first_row = torch.where(tc == best[:, None], row_ix[:, None, None],
                                rmax).amin(dim=1)  # (G, rg, 128)
        tmin = best.amin(dim=-1)  # (G, rg)
        lane = torch.where(best == tmin[..., None], lane_ix,
                           KERNEL_LEAF).amin(dim=-1)  # (G, rg)
        row = first_row.gather(-1, lane[..., None])[..., 0]
        hit = torch.isfinite(tmin)
        gi = torch.arange(gn, device=dev)[:, None]
        ri = torch.arange(rg, device=dev)[None, :]
        row = torch.where(hit, row, 0)
        lane = torch.where(hit, lane, 0)
        sl = slice(g0 * rg, g1 * rg)
        out[0, sl] = torch.where(hit, tmin, inf).reshape(-1)
        out[1, sl] = torch.where(hit, u[gi, row, ri, lane], 0.0).reshape(-1)
        out[2, sl] = torch.where(hit, v[gi, row, ri, lane], 0.0).reshape(-1)
        out[3, sl] = torch.where(hit, pm[gi, row, 10, lane], -1.0).reshape(-1)
    return out


def k1_keep_first(w1, den):
    """The first two conditions of k1_reject's keep test, on den and w1
    alone: d > 0 and a >= -m.  K1 computes w2 and tnum for a slot only
    where they hold for one of a thread's rays."""
    s = torch.where(den >= 0.0, 1.0, -1.0).to(den.dtype)
    d = den * s
    return (d > 0.0) & (w1 * s >= -(d * 2.0 ** -20))


def k1_reject(w1, w2, den, tnum):
    """K1's divide-free reject test (csrc/packed_tracer.cu mirrors it):
    True only where the exact test (inv = 1 / den, u = w1 inv, v = w2 inv,
    t = tnum inv; u >= 0, v >= 0, u + v <= 1, t >= 0) rejects the pair, so
    the kernel runs the exact test only on the pairs this leaves.  With s
    the sign of den (+1 at +-0), a = w1 s, b = w2 s, tt = tnum s, d = den s
    and the margin m = d 2^-20, a pair is kept iff d > 0, a >= -m (the
    first two: k1_keep_first), b >= -m, tt >= -m and a + b <= d + m, so
    all-zero padding columns and NaNs are rejected.  A bare sign test would
    not be sound, since a tiny negative w1 inv rounds to -0, which passes
    u >= 0; the margin keeps every rejected product away from that
    underflow (the proof is in the kernel's header note).  Not on
    packed_tracer_reference's path: the twin runs the exact test alone."""
    s = torch.where(den >= 0.0, 1.0, -1.0).to(den.dtype)
    a, b, tt, d = w1 * s, w2 * s, tnum * s, den * s
    m = d * 2.0 ** -20
    return ~(k1_keep_first(w1, den) & (b >= -m) & (tt >= -m)
             & (a + b <= d + m))


def run_packed_tracer(row_counts, packed_mm, rays, ng: int, nrb: int,
                      rb_size: int, rmax: int,
                      ray_feats: int = RAY_FEATS) -> torch.Tensor:
    """K1: closest hit of every ray against its group's packed payload
    (compound_ray_tpu/trace/mm_tracer.py:983, emit "bary").

    row_counts (NG,) int32; packed_mm (NG, rmax, 16, 512) f32 in the
    build_mm_features layout; rays (16, NG*nrb*rb_size) f32 planar
    [d, m, -o', 1, 0 x 6], or with ray_feats=8 (8, R) affine rays
    [d, 1, 0 x 4] against a transform_payload_affine'd payload.  Returns
    (8, R) f32 planar [t, u, v, slot, 0 x 4] with t = +inf on a miss.  CUDA
    tensors launch the kernel of csrc/packed_tracer.cu of that form on the
    current stream (or raise); CPU tensors take packed_tracer_reference."""
    global launches, affine_launches
    dev = rays.device
    if dev.type == "cpu":
        return packed_tracer_reference(row_counts, packed_mm, rays, ng, nrb,
                                       rb_size, rmax, ray_feats)
    _check_inputs(row_counts, packed_mm, rays, ng, nrb, rb_size, rmax,
                  ray_feats)
    if dev.type != "cuda":
        raise ValueError(f"run_packed_tracer takes CPU or CUDA tensors, "
                         f"not {dev.type}")
    from compound_ray_tpu_torch.trace import _build

    lib = _build.packed_tracer_lib()
    entry = (lib.cr_packed_tracer if ray_feats == RAY_FEATS
             else lib.cr_packed_tracer_affine)
    r = rays.shape[1]
    out = torch.empty((OUT_COMPS, r), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with span("cr.k1"):
            err = entry(
                ctypes.c_void_p(row_counts.data_ptr()),
                ctypes.c_void_p(packed_mm.data_ptr()),
                ctypes.c_void_p(rays.data_ptr()),
                ctypes.c_void_p(out.data_ptr()),
                ng, rmax, nrb * rb_size, r, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"packed tracer launch failed: CUDA error {err}")
    if ray_feats == RAY_FEATS:
        launches += 1
    else:
        affine_launches += 1
    return out


def transform_payload_affine(packed_mm, o_g, tmin_g):
    """Fold a per-group ray origin o_g (NG, 3) and tmin tmin_g (NG,) into a
    (NG, rmax, 16, 512) payload (compound_ray_tpu/trace/mm_tracer.py:371),
    so rays [d, 1, 0 x 4] against the result give the products that
    [d, m, -o', 1, 0 x 6] give against the original.  Per column:
    Q_d = P[0:3] + P[3:6] x o - tmin P[6:9] (rows 0-2),
    Q_c = P[9] - o . P[6:9] (row 3), rows 4-7 zero, rows 8-15 unchanged.
    The den block keeps Q_d = n exactly, so all-zero padding columns stay
    all zero.  Affine primary rays apply it with each group's ommatidial
    origin and tmin (eye/pipeline.py _pack_fused), the shadow plan with
    the light as the origin and tmin 0."""
    p_d = packed_mm[:, :, 0:3, :]
    p_m = packed_mm[:, :, 3:6, :]
    p_o = packed_mm[:, :, 6:9, :]
    p_1 = packed_mm[:, :, 9, :]
    o = o_g[:, None, :, None]  # (NG, 1, 3, 1)
    tm = tmin_g[:, None, None, None]
    cross = torch.cat([
        p_m[:, :, 1:2] * o[:, :, 2:3] - p_m[:, :, 2:3] * o[:, :, 1:2],
        p_m[:, :, 2:3] * o[:, :, 0:1] - p_m[:, :, 0:1] * o[:, :, 2:3],
        p_m[:, :, 0:1] * o[:, :, 1:2] - p_m[:, :, 1:2] * o[:, :, 0:1],
    ], dim=2)
    q_d = p_d + cross - tm * p_o
    q_c = p_1 - torch.sum(o * p_o, dim=2)
    return torch.cat([q_d, q_c[:, :, None, :],
                      torch.zeros_like(packed_mm[:, :, 0:4, :]),
                      packed_mm[:, :, 8:16, :]], dim=2)


def _check_occlusion_inputs(r2v, flag, flat_rows, rays, nrb, rb_size,
                            live_feats=None):
    """Raise on anything K3 and its twin do not take; returns (F, L, NVG)
    with L the live features, F unless `live_feats` says fewer."""
    dev = rays.device
    for name, x, dtype in (("r2v", r2v, torch.int32),
                           ("flag", flag, torch.int32),
                           ("flat_rows", flat_rows, torch.float32),
                           ("rays", rays, torch.float32)):
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rb_size <= 0 or rb_size % KERNEL_LEAF:
        raise ValueError(
            f"rb_size={rb_size} must be a positive multiple of {KERNEL_LEAF}")
    if nrb < 1:
        raise ValueError(f"nrb={nrb} must be >= 1")
    if flat_rows.dim() != 3 or flat_rows.shape[2] != MM_COLS:
        raise ValueError(f"flat_rows {tuple(flat_rows.shape)} is not "
                         f"(TB, F, {MM_COLS}): one occluder row per block")
    feats = flat_rows.shape[1]
    if feats not in (8, 16):
        raise ValueError(f"F={feats} feature rows: K3 takes 8 or 16")
    tb = flat_rows.shape[0]
    if tuple(r2v.shape) != (tb,) or tuple(flag.shape) != (tb,):
        raise ValueError(f"r2v {tuple(r2v.shape)} and flag "
                         f"{tuple(flag.shape)} must both be ({tb},)")
    rg = nrb * rb_size
    if rays.dim() != 2 or rays.shape[0] != feats or rays.shape[1] % rg:
        raise ValueError(f"rays {tuple(rays.shape)} != ({feats}, NVG * "
                         f"{rg})")
    live = feats if live_feats is None else live_feats
    if live not in (4, 8, 16) or live > feats:
        raise ValueError(f"live_feats={live_feats}: K3 reads 4, 8 or 16 "
                         f"features, at most the table's F={feats}")
    return feats, live, rays.shape[1] // rg


def _row_ranges(r2v, flag, nvg: int):
    """(first row (NVG,) int32, live rows (NVG,) int32) of each virtual
    group, on the device with no host sync: a weighted count of the live
    rows (flag > 0) per r2v, then an exclusive prefix sum.  Valid because
    the table lists each group's live rows contiguously, groups in
    ascending order, and padding rows (flag 0) only at its end."""
    count = torch.zeros(nvg, dtype=torch.int32, device=r2v.device)
    count.index_add_(0, r2v.long(), (flag > 0).to(torch.int32))
    start = (torch.cumsum(count, 0) - count).to(torch.int32)
    return start, count


def rows_occlusion_reference(r2v, flag, flat_rows, rays, nrb: int,
                             rb_size: int,
                             live_feats: int | None = None) -> torch.Tensor:
    """Plain torch twin of K3: (1, R) f32, 1.0 where some occluder row of
    the ray's virtual group passes the any-hit test, else 0.0 (zero-row
    groups included).

    Virtual group v owns rays [v * nrb * rb_size, (v + 1) * nrb * rb_size).
    For each row j of each group the products over the first `live_feats`
    features (default F) are summed in feature order, one rounded multiply
    and one rounded add per term, exactly as the kernel sums them (no fused
    multiply-add), so kernel and twin decide every ray alike.  Loops over
    the row index, chunked over groups so the (groups, rays, 512)
    temporaries stay near 2 GB."""
    return _rows_occlusion_twin(r2v, flag, flat_rows, rays, nrb, rb_size,
                                live_feats)[0]


def _rows_occlusion_twin(r2v, flag, flat_rows, rays, nrb: int, rb_size: int,
                         live_feats: int | None = None,
                         count_tests: bool = False):
    """(rows_occlusion_reference's (1, R) result, counts), counts None
    unless count_tests, else a dict of what K3 does on these inputs:

    pair_tests: the (ray, slot) tests, each ray's rows in order, each up to
    its first occluding slot and none after it, as the kernel's per-ray
    early exit tests them.  products: the L-term products those tests
    compute, as the kernel stages them: den and w1 for every test, w2 where
    a >= 0 and d > 0, tnum where b >= 0 and a + b <= d as well.
    warp_issued: for each warp of K3 (32 consecutive rays of a group, one
    per thread) and each row, the largest test count among its rays still
    open, times 32, since a warp steps over a row's slots until its last
    open ray is occluded or the row ends.  pair_tests / warp_issued is the
    lane efficiency."""
    feats, live, nvg = _check_occlusion_inputs(r2v, flag, flat_rows, rays,
                                               nrb, rb_size, live_feats)
    dev = rays.device
    rg = nrb * rb_size
    out = torch.zeros((1, rays.shape[1]), dtype=torch.float32, device=dev)
    start, count = _row_ranges(r2v, flag, nvg)
    count_np = count.cpu().numpy()
    rays_g = rays.reshape(feats, nvg, rg)
    chunk = max(1, _OCC_TWIN_CHUNK_ELEMS // (rg * MM_COLS))
    leaf = KERNEL_LEAF
    tests = torch.zeros((), dtype=torch.long, device=dev)
    products = torch.zeros((), dtype=torch.long, device=dev)
    issued = torch.zeros((), dtype=torch.long, device=dev)
    slot_ix = torch.arange(leaf, device=dev)
    for v0 in range(0, nvg, chunk):
        v1 = min(nvg, v0 + chunk)
        cnt = count_np[v0:v1]
        if not cnt.any():
            continue
        occ = torch.zeros((v1 - v0, rg), dtype=torch.bool, device=dev)
        for j in range(int(cnt.max())):
            sel = torch.as_tensor(np.flatnonzero(cnt > j) + v0, device=dev)
            rows = flat_rows[(start[sel] + j).long()]  # (G, F, 512)
            ray = rays_g[:, sel]  # (F, G, rg)
            p = ray[0, :, :, None] * rows[:, None, 0, :]
            for k in range(1, live):
                p = p + ray[k, :, :, None] * rows[:, None, k, :]
            w1, w2, den, tnum = p.split(leaf, dim=-1)
            s = torch.where(den >= 0.0, 1.0, -1.0)
            a = w1 * s
            b = w2 * s
            d = den * s
            tt = tnum * s
            stage2 = (a >= 0.0) & (d > 0.0)
            stage3 = stage2 & (b >= 0.0) & (a + b <= d)
            ok = stage3 & (tt >= 0.0) & (tt <= d)  # (G, rg, leaf)
            hit = ok.any(dim=-1)  # (G, rg)
            if count_tests:
                first = torch.where(hit, ok.int().argmax(dim=-1) + 1, leaf)
                first = first * ~occ[sel - v0]  # (G, rg), 0 once occluded
                tests += first.sum()
                tested = slot_ix < first[..., None]
                products += (2 * tested.sum() + (stage2 & tested).sum()
                             + (stage3 & tested).sum())
                issued += first.reshape(len(sel), rg // _WARP, _WARP).amax(
                    dim=-1).sum() * _WARP
            occ[sel - v0] |= hit
        out[0, v0 * rg:v1 * rg] = occ.to(torch.float32).reshape(-1)
    if not count_tests:
        return out, None
    return out, dict(pair_tests=int(tests.item()),
                     products=int(products.item()),
                     warp_issued=int(issued.item()))


def run_rows_occlusion(r2v, flag, flat_rows, rays, nrb: int, rb_size: int,
                       live_feats: int | None = None) -> torch.Tensor:
    """K3: any-hit of shadow rays in t in [0, 1] of their own
    parameterisation against their virtual group's occluder rows
    (compound_ray_tpu/trace/mm_tracer.py:897).

    r2v (TB,) int32 row -> virtual group (light * NG + group); flag (TB,)
    int32, 2 first row of a group, 1 live, 0 padding; flat_rows (TB, F,
    512) f32 with F = 8 (the shadow plan's reverse-affine rows) or 16; rays
    (F, NVG * nrb * rb_size) f32 planar; live_feats L (4, 8 or 16, at
    most F; default F): the products read features 0..L-1 only, which
    decides every ray as the F-term sum does when features L..F-1 are zero
    in rows or rays (csrc/rows_occlusion.cu says why).  Returns (1, R) f32:
    1.0 occluded, 0.0 clear; zero-row groups are written 0.0.  CUDA tensors
    launch csrc/rows_occlusion.cu on the current stream (or raise); CPU
    tensors take rows_occlusion_reference."""
    global occlusion_launches
    dev = rays.device
    if dev.type == "cpu":
        return rows_occlusion_reference(r2v, flag, flat_rows, rays, nrb,
                                        rb_size, live_feats)
    feats, live, nvg = _check_occlusion_inputs(r2v, flag, flat_rows, rays,
                                               nrb, rb_size, live_feats)
    if dev.type != "cuda":
        raise ValueError(f"run_rows_occlusion takes CPU or CUDA tensors, "
                         f"not {dev.type}")
    from compound_ray_tpu_torch.trace import _build

    lib = _build.rows_occlusion_lib()
    start, count = _row_ranges(r2v, flag, nvg)
    r = rays.shape[1]
    out = torch.empty((1, r), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with span("cr.k3"):
            err = lib.cr_rows_occlusion(
                ctypes.c_void_p(start.data_ptr()),
                ctypes.c_void_p(count.data_ptr()),
                ctypes.c_void_p(flat_rows.data_ptr()),
                ctypes.c_void_p(rays.data_ptr()),
                ctypes.c_void_p(out.data_ptr()),
                nvg, feats, live, nrb * rb_size, r, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"rows occlusion launch failed: CUDA error {err}")
    occlusion_launches += 1
    return out
