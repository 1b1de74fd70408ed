"""The brute-force compound-eye frame (compound_ray_tpu/eye/render.py in
torch): every (sample x ommatidium) cone ray traced against the whole
triangle soup (trace/intersect.py), shaded (trace/shade.py, lit with
brute-force shadow rays when asked) and, for the means, reduced per
ommatidium.

It is the exact path: the frame under backend="naive", and raw samples
with lighting on, which the packed pipeline does not render.  Its cost is
rays x triangles pair tests (x (1 + lights) lit), so it is the reference
the packed lit frame is held to, not a fast path.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from compound_ray_tpu_torch.eye.sampling import ommatidial_rays
from compound_ray_tpu_torch.trace.intersect import (
    intersect_rays,
    oracle_ray_chunk,
)
from compound_ray_tpu_torch.trace.shade import shade_rays


def render_compound_samples(scene: Dict[str, Any], ommatidia, position,
                            local_space, generator: torch.Generator,
                            samples: int, background: int,
                            use_lighting: bool = False, lights=None, *,
                            angles=None) -> torch.Tensor:
    """(S, N, 3) float32 linear radiance of every sample
    (compound_ray_tpu/eye/render.py:25).  scene is device_triangles' dict;
    ommatidia (N, 8), position (3,), local_space (3, 3) and lights (L, 7)
    may be host arrays or tensors and are taken to the scene's device.  The
    angles come from `generator` (on that device) or pre-drawn as angles =
    (splay, spin), each (S, N)."""
    dev = scene["v0"].device

    def on_dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    omms = on_dev(ommatidia)
    origins, dirs, tmin = ommatidial_rays(
        omms, on_dev(position), on_dev(local_space), samples, generator,
        angles=angles)
    hit = intersect_rays(origins, dirs, scene["v0"], scene["e1"], scene["e2"],
                         tmin, 1e16, ray_chunk=oracle_ray_chunk(dev))
    lighting = {"lights": lights} if use_lighting else None
    rgb = shade_rays(scene, dirs, hit, background, lighting=lighting,
                     origins=origins)
    return rgb.reshape(samples, omms.shape[0], 3)


def render_compound_means(scene: Dict[str, Any], ommatidia, position,
                          local_space, generator: torch.Generator,
                          samples: int, background: int,
                          use_lighting: bool = False, lights=None, *,
                          angles=None) -> torch.Tensor:
    """(N, 3) per-ommatidium mean radiance of render_compound_samples
    (compound_ray_tpu/eye/render.py:50): the reference's write-scaled-then-
    sum (shaders.cu:734, summing_kernel) up to float reassociation."""
    return render_compound_samples(
        scene, ommatidia, position, local_space, generator, samples,
        background, use_lighting, lights, angles=angles).mean(dim=0)
