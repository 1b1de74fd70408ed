"""Ommatidial cone sampling (compound_ray_tpu/eye/sampling.py in torch).

Sampling semantics of the reference (shaders.cu:684-736):
  * splay angle   ~ Normal(0, acceptance_angle / FWHM_SD_RATIO)
  * spin angle    ~ Uniform(0, pi)  (half-turn: splay may be negative)
  * direction     = rotate(rotate(axis, splay, perp), spin, axis)
    with perp = normalize(cross(+y, axis)), or +z when that cross is the
    degenerate all-zero vector (the reference tests x+y+z == 0)
  * origin        = position - normalize(axis) * focal_point_offset
  * world         = eye position + localSpace . relative
  * tmin          = focal_point_offset  (lens surface), tmax = 1e16

The frame pipeline draws (N, S) planes (sample_angles_ns) and works
component-planar; the brute-force oracle (eye/render.py) draws (S, N)
(sample_angles) and works on (R, 3) rows (ommatidial_rays).

The draws come from an explicit torch.Generator on the device of the
tensors; it gives other numbers than JAX's threefry from the same seed, so
the tests feed both packages the same angles and hold the port's draw to
the distribution instead.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from compound_ray_tpu_torch.trace.intersect import cross3, dot3

# FWHM of a Gaussian = 2*sqrt(2 ln 2) * sigma (shaders.cu:53)
FWHM_SD_RATIO = 2.35482004503094938202313865291


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean length over the last axis, keeping it."""
    return torch.sqrt(dot3(x, x))[..., None]


def to_world(v: torch.Tensor, local_space: torch.Tensor) -> torch.Tensor:
    """Rows v (M, 3) in a local space whose rows are the world x/y/z axes:
    v.x X + v.y Y + v.z Z, the product v @ local_space of
    compound_ray_tpu/eye/sampling.py:160-163 as 3-term f32 multiply-adds."""
    return (v[:, 0:1] * local_space[0] + v[:, 1:2] * local_space[1]
            + v[:, 2:3] * local_space[2])


def rodrigues(point: torch.Tensor, angle: torch.Tensor,
              axis: torch.Tensor) -> torch.Tensor:
    """Axis-angle rotation without axis normalisation, the device
    rotatePoint of shaders.cu:650-652 (compound_ray_tpu/eye/sampling.py:33).
    Shapes broadcast; angle is (...,)."""
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    return (c * point + s * cross3(axis, point)
            + (1.0 - c) * dot3(axis, point)[..., None] * axis)


def cone_offset_directions(axes: torch.Tensor, splay: torch.Tensor,
                           spin: torch.Tensor) -> torch.Tensor:
    """generateOffsetRay (shaders.cu:653-664) on (..., 3) ommatidial axes
    and (...,) angles (compound_ray_tpu/eye/sampling.py:44)."""
    up = torch.tensor([0.0, 1.0, 0.0], device=axes.device)
    perp = cross3(up.expand(axes.shape), axes)
    degenerate = perp.sum(dim=-1, keepdim=True) == 0.0
    norm = torch.clamp(_norm(perp), min=1e-30)
    perp = torch.where(degenerate,
                       torch.tensor([0.0, 0.0, 1.0], device=axes.device),
                       perp / norm)
    splayed = rodrigues(axes, splay, perp)
    return rodrigues(splayed, spin, axes)


def sample_angles(generator: torch.Generator, n_omms: int, samples: int,
                  acceptance_angles: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, N) splay and spin angles (compound_ray_tpu/eye/sampling.py:58):
    the normal draw first, then the uniform one, as sample_angles_ns.  The
    generator must live on acceptance_angles' device."""
    dev = acceptance_angles.device
    sd = acceptance_angles / FWHM_SD_RATIO
    splay = torch.randn((samples, n_omms), generator=generator,
                        device=dev) * sd[None, :]
    spin = torch.rand((samples, n_omms), generator=generator,
                      device=dev) * math.pi
    return splay, spin


def ommatidial_rays(ommatidia: torch.Tensor, position: torch.Tensor,
                    local_space: torch.Tensor, samples: int,
                    generator: torch.Generator = None, *, angles=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The frame's (S*N) world-space rays from ommatidia (N, 8) [pos(3),
    dir(3), acceptance, focal_offset], the eye's position (3,) and local
    space (3, 3) (compound_ray_tpu/eye/sampling.py:132).  Returns (origins
    (S*N, 3), dirs (S*N, 3), tmin (S*N,)); ray s * N + o is sample s of
    ommatidium o, the reference's compound-buffer layout
    (summing_kernel.cu:92).  The angles come from `generator`
    (sample_angles), or pre-drawn as angles = (splay, spin), each (S, N)."""
    n = ommatidia.shape[0]
    rel_pos = ommatidia[:, 0:3]
    axis = ommatidia[:, 3:6]
    focal = ommatidia[:, 7]
    if angles is None:
        splay, spin = sample_angles(generator, n, samples, ommatidia[:, 6])
    else:
        splay, spin = angles
    rel_dir = cone_offset_directions(
        axis[None, :, :].expand(samples, n, 3), splay, spin)  # (S, N, 3)
    axis_n = axis / torch.clamp(_norm(axis), min=1e-30)
    rel_origin = rel_pos - axis_n * focal[:, None]  # (N, 3)
    origins = position[None, :] + to_world(rel_origin, local_space)
    origins = origins[None].expand(samples, n, 3).reshape(-1, 3)
    dirs = to_world(rel_dir.reshape(-1, 3), local_space)
    tmin = focal[None, :].expand(samples, n).reshape(-1)
    return origins, dirs, tmin


def sample_angles_ns(
    generator: torch.Generator,
    sd: torch.Tensor,  # (N,) acceptance / FWHM_SD_RATIO
    samples: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, S) splay and spin angles (compound_ray_tpu/eye/sampling.py:74).
    The generator must live on sd's device."""
    n = sd.shape[0]
    splay = torch.randn((n, samples), generator=generator,
                        device=sd.device) * sd[:, None]
    spin = torch.rand((n, samples), generator=generator,
                      device=sd.device) * math.pi
    return splay, spin


def rodrigues_c(px, py, pz, angle, ax, ay, az):
    """Component-planar axis-angle rotation without axis normalisation
    (compound_ray_tpu/eye/sampling.py:95, the device rotatePoint of
    shaders.cu:650-652).  All operands broadcast."""
    c = torch.cos(angle)
    s = torch.sin(angle)
    cx = ay * pz - az * py
    cy = az * px - ax * pz
    cz = ax * py - ay * px
    d = (1.0 - c) * (ax * px + ay * py + az * pz)
    return (c * px + s * cx + d * ax,
            c * py + s * cy + d * ay,
            c * pz + s * cz + d * az)


def cone_offset_components(ax, ay, az, splay, spin):
    """generateOffsetRay (shaders.cu:653-664) in component-planar form
    (compound_ray_tpu/eye/sampling.py:113).  (ax, ay, az) broadcast against
    the (N, S) splay/spin planes; returns unnormalised direction components."""
    # perp = cross(+y, axis) = (az, 0, -ax); the reference's degeneracy test
    # is sum(perp) == 0 (shaders.cu:657)
    px, py, pz = az, torch.zeros_like(az), -ax
    degenerate = (px + py + pz) == 0.0
    norm = torch.clamp(torch.sqrt(px * px + py * py + pz * pz), min=1e-30)
    px = torch.where(degenerate, 0.0, px / norm)
    py = torch.where(degenerate, 0.0, py / norm)
    pz = torch.where(degenerate, 1.0, pz / norm)
    sx, sy, sz = rodrigues_c(ax, ay, az, splay, px, py, pz)
    return rodrigues_c(sx, sy, sz, spin, ax, ay, az)
