"""Brute-force closest hit over the whole triangle soup
(compound_ray_tpu/trace/intersect.py in torch).

The exact path: every ray is tested against every triangle with
Möller-Trumbore, both-sided (OptiX's default with OPTIX_RAY_FLAG_NONE).
Rays go in chunks and triangles stream through each ray chunk in chunks,
with a running closest-hit reduction, so memory is O(ray_chunk x
tri_chunk) whatever the scene.  It is the oracle the accelerated paths are
held to, the real-camera image's path below min_triangles_for_culling, the
lit camera image's, and every frame's under backend="naive".

Every dot and cross product is written out as f32 multiplies and adds,
never a matmul or einsum, so TF32 cannot enter on a card, and card and CPU
round alike.  The winner does not depend on the chunk sizes: each triangle
chunk keeps its first minimum (torch.argmin, as jnp.argmin) and a later
chunk replaces the running best only when strictly closer.
"""

from __future__ import annotations

from typing import Dict

import torch

# (ray chunk x triangle chunk) elements of each temporary of a chunk pair
# on a card: a chunk pair keeps ~25 of them alive (~1.7 GB at 2**24), where
# the default 512-ray chunk makes ~60 eager launches of 4 MB each per pair
CUDA_CHUNK_ELEMS = 1 << 24


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def oracle_ray_chunk(device, tri_chunk: int = 2048) -> int:
    """The ray chunk the port's callers pass intersect_rays: the default 512
    on the CPU, on a card the most rays whose chunk pairs stay within
    CUDA_CHUNK_ELEMS.  The result does not depend on it."""
    if torch.device(device).type != "cuda":
        return 512
    return max(512, CUDA_CHUNK_ELEMS // tri_chunk)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis of (..., 3) tensors: three f32 products and
    two adds."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis of (..., 3) tensors, in jnp.cross's terms."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def moller_trumbore(o: torch.Tensor, d: torch.Tensor, v0: torch.Tensor,
                    e1: torch.Tensor, e2: torch.Tensor):
    """All pairs of rays (R, 3) and triangles (T, 3): (t, u, v, valid),
    each (R, T) (compound_ray_tpu/trace/intersect.py:32).  t is in units of
    |d|: directions are deliberately not normalised, and tmin and tmax
    share those units."""
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    ax, ay, az = e1[:, 0], e1[:, 1], e1[:, 2]
    bx, by, bz = e2[:, 0], e2[:, 1], e2[:, 2]
    # pvec = d x e2
    px = dy * bz - dz * by
    py = dz * bx - dx * bz
    pz = dx * by - dy * bx
    det = ax * px + ay * py + az * pz
    inv_det = torch.where(det == 0.0, 0.0, 1.0 / det)
    tx = ox - v0[:, 0]
    ty = oy - v0[:, 1]
    tz = oz - v0[:, 2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    # qvec = tvec x e1
    qx = ty * az - tz * ay
    qy = tz * ax - tx * az
    qz = tx * ay - ty * ax
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (bx * qx + by * qy + bz * qz) * inv_det
    valid = (det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, valid


def _per_ray(x, r: int, device) -> torch.Tensor:
    """A scalar or (R,) bound as an (R,) f32 tensor (a Python number is
    filled on the device, with no copy from the host)."""
    if isinstance(x, (int, float)):
        return torch.full((r,), float(x), device=device)
    return torch.as_tensor(x, dtype=torch.float32, device=device).expand(r)


def intersect_rays(origins: torch.Tensor, dirs: torch.Tensor,
                   v0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor,
                   tmin, tmax, ray_chunk: int = 512,
                   tri_chunk: int = 2048) -> Dict[str, torch.Tensor]:
    """Closest hit of rays (R, 3) (directions unnormalised) over triangles
    (T, 3) in [tmin, tmax] (scalars or (R,))
    (compound_ray_tpu/trace/intersect.py:64).  Returns (R,) tensors: t, u,
    v (the winner's barycentrics), tri_id (int32, -1 on a miss) and hit.
    Triangles are padded with zero-extent ones (det = 0: a miss) and rays
    with zeros."""
    dev = origins.device
    r, n_tri = origins.shape[0], v0.shape[0]
    tmin = _per_ray(tmin, r, dev)
    tmax = _per_ray(tmax, r, dev)
    if n_tri == 0:
        return {"t": torch.full((r,), torch.inf, device=dev),
                "u": torch.zeros(r, device=dev),
                "v": torch.zeros(r, device=dev),
                "tri_id": torch.full((r,), -1, dtype=torch.int32, device=dev),
                "hit": torch.zeros(r, dtype=torch.bool, device=dev)}
    rp, tp = _ceil_to(r, ray_chunk), _ceil_to(n_tri, tri_chunk)

    def pad(x, n):
        out = x.new_zeros((n,) + tuple(x.shape[1:]))
        out[:x.shape[0]] = x
        return out

    o_p, d_p = pad(origins, rp), pad(dirs, rp)
    tmin_p, tmax_p = pad(tmin, rp), pad(tmax, rp)
    v0_p, e1_p, e2_p = pad(v0, tp), pad(e1, tp), pad(e2, tp)
    best_t = torch.full((rp,), torch.inf, device=dev)
    best_u = torch.zeros(rp, device=dev)
    best_v = torch.zeros(rp, device=dev)
    best_id = torch.full((rp,), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(ray_chunk, device=dev)
    for r0 in range(0, rp, ray_chunk):
        rs = slice(r0, r0 + ray_chunk)
        lo, hi = tmin_p[rs, None], tmax_p[rs, None]
        bt, bu, bv, bid = best_t[rs], best_u[rs], best_v[rs], best_id[rs]
        for t0 in range(0, tp, tri_chunk):
            ts = slice(t0, t0 + tri_chunk)
            t, u, v, ok = moller_trumbore(o_p[rs], d_p[rs], v0_p[ts],
                                          e1_p[ts], e2_p[ts])
            ok &= (t >= lo) & (t <= hi)
            t = torch.where(ok, t, torch.inf)
            j = torch.argmin(t, dim=1)
            cand_t = t[rows, j]
            better = cand_t < bt
            bt = torch.where(better, cand_t, bt)
            bu = torch.where(better, u[rows, j], bu)
            bv = torch.where(better, v[rows, j], bv)
            bid = torch.where(better, j + t0, bid)
        best_t[rs], best_u[rs], best_v[rs], best_id[rs] = bt, bu, bv, bid
    tri_id = best_id[:r].to(torch.int32)
    return {"t": best_t[:r], "u": best_u[:r], "v": best_v[:r],
            "tri_id": tri_id, "hit": tri_id >= 0}


def occlusion_test(origins: torch.Tensor, dirs: torch.Tensor,
                   v0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor,
                   tmin, tmax, ray_chunk: int = 512) -> torch.Tensor:
    """Any hit in [tmin, tmax] (shadow rays; shaders.cu traceOcclusion;
    compound_ray_tpu/trace/intersect.py:161): (R,) bool."""
    return intersect_rays(origins, dirs, v0, e1, e2, tmin, tmax,
                          ray_chunk=ray_chunk)["hit"]
