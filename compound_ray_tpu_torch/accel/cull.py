"""Per-ommatidium acceptance-cone geometry (compound_ray_tpu/accel/cull.py).

Each ommatidium's Gaussian splay (sigma = acceptance/FWHM_SD_RATIO,
shaders.cu:693-696) is truncated at `cull_sigmas` standard deviations to a
hard cone; eye/pipeline.py tests those cones against cluster and triangle
bounding spheres.  This module holds the shared cone apex/axis math, and
the per-ommatidium cone-vs-cluster cull of the "xla" backend's culled sweep
(trace/dispatch.py): intersect if

    angle(axis, c - apex) <= half_angle + angular_radius(sphere)

or the apex lies inside the sphere.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from compound_ray_tpu_torch.eye.sampling import FWHM_SD_RATIO


def _to_world(v: torch.Tensor, local_space: torch.Tensor) -> torch.Tensor:
    """(N, 3) eye-local vectors -> world: v @ local_space, written out so no
    matmul precision mode (TF32) can touch the geometry."""
    return (v[:, 0:1] * local_space[0] + v[:, 1:2] * local_space[1]
            + v[:, 2:3] * local_space[2])


def eye_world_geometry(
    ommatidia: torch.Tensor,  # (N, 8)
    position: torch.Tensor,  # (3,)
    local_space: torch.Tensor,  # (3, 3) rows = the eye's world x/y/z axes
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-space cone apex (retracted ray origin) and unit axis per
    ommatidium (compound_ray_tpu/accel/cull.py:28)."""
    rel_pos = ommatidia[:, 0:3]
    axis = ommatidia[:, 3:6]
    focal = ommatidia[:, 7]
    axis_n = axis / torch.clamp(
        torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=1e-30)
    rel_origin = rel_pos - axis_n * focal[:, None]
    apex = position[None, :] + _to_world(rel_origin, local_space)
    world_axis = _to_world(axis_n, local_space)
    world_axis = world_axis / torch.clamp(
        torch.linalg.vector_norm(world_axis, dim=-1, keepdim=True), min=1e-30)
    return apex, world_axis


def cone_cull_clusters(
    ommatidia: torch.Tensor,  # (N, 8)
    position: torch.Tensor,
    local_space: torch.Tensor,
    sphere_center: torch.Tensor,  # (C, 3)
    sphere_radius: torch.Tensor,  # (C,)
    cull_sigmas: float = 4.0,
) -> Dict[str, torch.Tensor]:
    """{'mask': (N, C) bool, 'count': (N,) int32}: the clusters whose
    bounding sphere meets each ommatidium's cone, truncated at cull_sigmas
    standard deviations (compound_ray_tpu/accel/cull.py:53).  `count` is
    not clamped: a caller that shortlists into k slots sizes k from it."""
    apex, axis = eye_world_geometry(ommatidia, position, local_space)
    half_angle = torch.clamp(ommatidia[:, 6] / FWHM_SD_RATIO * cull_sigmas,
                             max=math.pi)  # (N,)
    to_c = sphere_center[None, :, :] - apex[:, None, :]  # (N, C, 3)
    dist = torch.linalg.vector_norm(to_c, dim=-1)  # (N, C)
    inside = dist <= sphere_radius[None, :]
    inv_d = 1.0 / torch.clamp(dist, min=1e-30)
    cos_a = (to_c[..., 0] * axis[:, 0:1] + to_c[..., 1] * axis[:, 1:2]
             + to_c[..., 2] * axis[:, 2:3]) * inv_d
    alpha = torch.arccos(torch.clamp(cos_a, -1.0, 1.0))
    beta = torch.arcsin(torch.clamp(sphere_radius[None, :] * inv_d, 0.0,
                                    1.0))
    mask = inside | (alpha <= half_angle[:, None] + beta)
    return {"mask": mask, "count": mask.sum(dim=-1).to(torch.int32)}


def shortlist_from_mask(mask: torch.Tensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids (N, k) int32, valid (N, k) bool) from an (N, C) hit mask, k <= C
    (compound_ray_tpu/accel/cull.py:82): the surviving cluster ids first,
    in ascending order (a stable sort), then the others; valid marks the
    first count of them."""
    order = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)
    ids = order[:, :k].to(torch.int32)
    valid = (torch.arange(k, device=mask.device)[None, :]
             < mask.sum(dim=-1)[:, None])
    return ids, valid
