"""Compound projection schemas: ommatidial data -> display frame buffer
(compound_ray_tpu/projection/project.py in torch).

The eight __raygen__compound_projection_* programs of shaders.cu:354-642
as torch ops on the device of the means they are given.  The Voronoi
variants are the reference's brute-force nearest-by-angle search over
pixels x ommatidia, a masked argmin with first-occurrence ties (the
sequential strictly-less scan).

Pixels the reference never writes (rows y > 0 of single_dimension_fast,
the pixels outside the copied block of raw_ommatidial_samples) keep stale
buffer contents there; here they are zero, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from compound_ray_tpu_torch.trace.shade import make_color

PROJECTIONS = (
    "raw_ommatidial_samples",
    "single_dimension",
    "single_dimension_fast",
    "spherical_positionwise",
    "spherical_orientationwise",
    "spherical_split_orientationwise",
    "spherical_positionwise_ids",
    "spherical_orientationwise_ids",
)


def _pixel_sphere_dirs(width: int, height: int, device) -> torch.Tensor:
    """(H, W, 3) f32 unit-sphere direction of each pixel for the spherical
    projections (shaders.cu:420-428): d = 2 (x/W, y/H) - 1, angles =
    d (-pi, pi/2) + (pi/2, 0).  Computed in f64 and rounded once, so that
    every device gets the same directions: an f32 cos or sin may differ by
    an ulp between the card and the CPU, and near a Voronoi boundary one
    ulp of the cosine moves the angle by ~1e-6 rad."""
    xs = torch.arange(width, dtype=torch.float64, device=device)
    ys = torch.arange(height, dtype=torch.float64, device=device)
    dx = 2.0 * xs / width - 1.0
    dy = 2.0 * ys / height - 1.0
    gy, gx = torch.meshgrid(dy, dx, indexing="ij")  # (H, W)
    ax = gx * (-math.pi) + math.pi / 2.0
    ay = gy * (math.pi / 2.0)
    cos_y = torch.cos(ay)
    return torch.stack([torch.cos(ax) * cos_y, torch.sin(ay),
                        torch.sin(ax) * cos_y], dim=-1).to(torch.float32)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis (3) in one fixed order of IEEE operations,
    the same on every device (a library norm may sum in another order)."""
    x, y, z = v.unbind(-1)
    return torch.sqrt(x * x + y * y + z * z)


def _angles_to(ref_vectors: torch.Tensor,
               sphere_dirs: torch.Tensor) -> torch.Tensor:
    """(H, W, N) angle between each pixel direction and each ommatidial
    vector, acos(dot / (|a| |b|)) as the reference computes it.  The dot is
    three f32 multiplies and two adds over broadcast tensors, never a
    matmul: a reduced-precision product (TF32 on the card) flips Voronoi
    winners by degrees where |cos| is near 1, and K = 3 is no GEMM's shape
    anyway.  Every step up to the arccos is one IEEE operation in a fixed
    order, so the card and the CPU get the same cosines."""
    norm_r = _norm3(ref_vectors)  # (N,)
    norm_p = _norm3(sphere_dirs)  # (H, W)
    dots = sphere_dirs[..., 0:1] * ref_vectors[:, 0]
    dots += sphere_dirs[..., 1:2] * ref_vectors[:, 1]
    dots += sphere_dirs[..., 2:3] * ref_vectors[:, 2]
    dots /= norm_r * norm_p[..., None]
    return torch.arccos_(dots.clamp_(-1.0, 1.0))


# single-chunk budget of the Voronoi map's (H, W, chunk) angle tensor in f32
# elements (compound_ray_tpu/projection/project.py:71): 2^29 = 2 GB keeps
# every realistic configuration in one chunk
_VORONOI_CHUNK_ELEMS = 1 << 29


def voronoi_index_map(ref_vectors: torch.Tensor, width: int, height: int,
                      split: bool = False,
                      positions_x: Optional[torch.Tensor] = None,
                      chunk_elems: int = _VORONOI_CHUNK_ELEMS
                      ) -> torch.Tensor:
    """(H, W) int32 index of the nearest ommatidium by angle, on the device
    of ref_vectors (N, 3) (positions or directions).

    With `split`, pixels in the left half consider only ommatidia with
    position.x < 0 and right-half pixels only position.x > 0, except
    ommatidium 0, where the reference's scan starts (shaders.cu:519-534).
    The ommatidium axis runs in chunks of chunk_elems // (W H): a running
    minimum over chunks in index order, with strict `<` across chunks,
    keeps the first-occurrence ties of one argmin."""
    device = ref_vectors.device
    sphere = _pixel_sphere_dirs(width, height, device)
    n = ref_vectors.shape[0]
    chunk = max(1, min(n, chunk_elems // max(1, width * height)))
    if split:
        xs = torch.arange(width, dtype=torch.float32, device=device) / width
        left = (xs < 0.5)[None, :, None]  # (1, W, 1)
    best_ang = torch.full((height, width), math.inf, dtype=torch.float32,
                          device=device)
    best_idx = torch.zeros((height, width), dtype=torch.int32, device=device)
    for c0 in range(0, n, chunk):
        sub = ref_vectors[c0:c0 + chunk]
        ang = _angles_to(sub, sphere)  # (H, W, chunk)
        if split:
            px = positions_x[c0:c0 + chunk][None, None, :]
            eligible = ((px > 0) & ~left) | ((px < 0) & left)
            if c0 == 0:
                eligible[..., 0] = True  # ommatidium 0 is always eligible
            ang.masked_fill_(~eligible, math.inf)
        amin, idx = torch.min(ang, dim=-1)  # the first minimum's index
        del ang
        upd = amin < best_ang
        best_idx = torch.where(upd, idx.to(torch.int32) + c0, best_idx)
        best_ang = torch.where(upd, amin, best_ang)
    return best_idx


def _encode_ids(idx_map: torch.Tensor) -> torch.Tensor:
    """Base-256 RGBA encoding of ommatidium ids (shaders.cu:585-594)."""
    i = idx_map.to(torch.int64)
    return torch.stack([(i >> s) & 0xFF for s in (24, 16, 8, 0)],
                       dim=-1).to(torch.uint8)


def decode_projection_map_id(rgba) -> int:
    """Inverse of _encode_ids (eyeRendererHelperFunctions.py:153-160)."""
    r, g, b, a = (int(x) for x in rgba)
    return (r << 24) | (g << 16) | (b << 8) | a


def project_frame(projection: str, omm_means: torch.Tensor,
                  omm_samples: Optional[torch.Tensor],
                  positions: torch.Tensor, directions: torch.Tensor,
                  width: int, height: int) -> torch.Tensor:
    """The (H, W, 4) uint8 display buffer of a compound projection, on the
    device of omm_means (N, 3), from the ommatidia's relative positions and
    directions (N, 3).  omm_samples (S, N, 3) is read by
    raw_ommatidial_samples only (compound_ray_tpu/projection/project.py:148)."""
    n = omm_means.shape[0]
    device = omm_means.device
    if projection == "raw_ommatidial_samples":
        frame = torch.zeros((height, width, 4), dtype=torch.uint8,
                            device=device)
        h_copy = min(height, omm_samples.shape[0])
        w_copy = min(width, n)
        frame[:h_copy, :w_copy] = make_color(omm_samples[:h_copy, :w_copy])
        return frame

    if projection == "single_dimension":
        xs = torch.arange(width, device=device)
        row = make_color(omm_means[(xs * n) // width])  # (W, 4)
        return row[None].expand(height, width, 4).contiguous()

    if projection == "single_dimension_fast":
        frame = torch.zeros((height, width, 4), dtype=torch.uint8,
                            device=device)
        w_copy = min(width, n)
        frame[0, :w_copy] = make_color(omm_means[:w_copy])
        return frame

    if projection in ("spherical_positionwise", "spherical_positionwise_ids"):
        idx_map = voronoi_index_map(positions, width, height)
    elif projection in ("spherical_orientationwise",
                        "spherical_orientationwise_ids"):
        idx_map = voronoi_index_map(directions, width, height)
    elif projection == "spherical_split_orientationwise":
        idx_map = voronoi_index_map(directions, width, height, split=True,
                                    positions_x=positions[:, 0])
    else:
        raise ValueError(f"unknown projection {projection!r}")

    if projection.endswith("_ids"):
        return _encode_ids(idx_map)
    return make_color(omm_means[idx_map.long()])
