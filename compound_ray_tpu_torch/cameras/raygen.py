"""Real-camera ray generation and the brute-force camera image
(compound_ray_tpu/cameras/raygen.py in torch).

The three real-camera raygen programs of shaders.cu:
  __raygen__pinhole       (:198-240)
  __raygen__panoramic     (:242-289)
  __raygen__orthographic  (:291-333)

Pixel convention of the reference: for pixel (x, y) of a (W, H) launch,
d = 2 (x / W, y / H) - 1 (no half-pixel offset), and the frame buffer is
row-major with index y * W + x (row 0 is d.y == -1).  Directions are not
normalised (but for the panoramic ones): t and tmin = 0.01 are in units of
|d|.  The local-space products are 3-term f32 multiply-adds.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from compound_ray_tpu_torch.eye.sampling import to_world
from compound_ray_tpu_torch.trace.intersect import (
    intersect_rays,
    oracle_ray_chunk,
)
from compound_ray_tpu_torch.trace.shade import make_color, shade_rays


def _pixel_grid(width: int, height: int,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dy), each (H * W,) in row-major pixel order."""
    xs = torch.arange(width, dtype=torch.float32, device=device)
    ys = torch.arange(height, dtype=torch.float32, device=device)
    dx = 2.0 * xs / width - 1.0
    dy = 2.0 * ys / height - 1.0
    gy, gx = torch.meshgrid(dy, dx, indexing="ij")  # (H, W)
    return gx.reshape(-1), gy.reshape(-1)


def pinhole_rays(position, local_space, scale, width: int, height: int):
    """(origins, dirs, tmin) of __raygen__pinhole: scale is (3,)."""
    dx, dy = _pixel_grid(width, height, position.device)
    x_axis, y_axis, z_axis = local_space[0], local_space[1], local_space[2]
    dirs = (z_axis[None, :] * scale[2]
            + dx[:, None] * x_axis[None, :] * scale[0]
            + dy[:, None] * y_axis[None, :] * scale[1])
    return position.expand(dirs.shape), dirs, 0.01


def panoramic_rays(position, local_space, start_radius, width: int,
                   height: int):
    """(origins, dirs, tmin) of __raygen__panoramic: unit directions on the
    equirect grid, origins start_radius out along them."""
    dx, dy = _pixel_grid(width, height, position.device)
    ax = dx * (-math.pi) + math.pi / 2.0
    ay = dy * (math.pi / 2.0)
    cos_y = torch.cos(ay)
    local = torch.stack([torch.cos(ax) * cos_y, torch.sin(ay),
                         torch.sin(ax) * cos_y], dim=-1)
    dirs = to_world(local, local_space)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    return position[None, :] + dirs * start_radius, dirs, 0.01


def orthographic_rays(position, local_space, scale, width: int, height: int):
    """(origins, dirs, tmin) of __raygen__orthographic: scale is (2,)."""
    dx, dy = _pixel_grid(width, height, position.device)
    x_axis, y_axis, z_axis = local_space[0], local_space[1], local_space[2]
    origins = (position[None, :]
               + dx[:, None] * x_axis[None, :] * scale[0]
               + dy[:, None] * y_axis[None, :] * scale[1])
    return origins, z_axis.expand(origins.shape), 0.01


def camera_rays(kind: str, position, local_space, cam_param, width: int,
                height: int):
    """The rays of camera `kind`: cam_param is the pinhole's scale (3,), the
    panoramic [start_radius] or the orthographic scale (2,)."""
    if kind == "pinhole":
        return pinhole_rays(position, local_space, cam_param, width, height)
    if kind == "panoramic":
        return panoramic_rays(position, local_space, cam_param[0], width,
                              height)
    if kind == "orthographic":
        return orthographic_rays(position, local_space, cam_param, width,
                                 height)
    raise ValueError(f"unknown camera kind {kind!r}")


def render_camera_image(scene: Dict[str, Any], kind: str, position,
                        local_space, cam_param, width: int, height: int,
                        background: int, use_lighting: bool = False,
                        lights=None) -> torch.Tensor:
    """(H, W, 4) uint8 RGBA image of a real camera, every pixel traced
    against the whole soup (compound_ray_tpu/cameras/raygen.py:78).  The
    pose, cam_param and lights may be host arrays or tensors; the image is
    rendered on the scene's device."""
    dev = scene["v0"].device

    def on_dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    origins, dirs, tmin = camera_rays(kind, on_dev(position),
                                      on_dev(local_space), on_dev(cam_param),
                                      width, height)
    hit = intersect_rays(origins, dirs, scene["v0"], scene["e1"], scene["e2"],
                         tmin, 1e16, ray_chunk=oracle_ray_chunk(dev))
    lighting = {"lights": lights} if use_lighting else None
    rgb = shade_rays(scene, dirs, hit, background, lighting=lighting,
                     origins=origins)
    return make_color(rgb).reshape(height, width, 4)
