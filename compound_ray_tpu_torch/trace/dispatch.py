"""The means frame of backend "xla" (compound_ray_tpu/trace/dispatch.py in
torch): the cone-culled sweep of trace/culled.py, or the brute-force oracle
(eye/render.py) for lit frames and for scenes under
config.min_triangles_for_culling triangles.

The shortlist width K is far from uniform over an eye (horizon-grazing
cones meet many clusters, sky-facing ones almost none), so the ommatidia
are split into power-of-two K-classes and the sweep runs once per class:
the work follows the mean surviving-cluster count, not the largest.  Class
populations are padded (_pad_count), as the JAX package pads them to reuse
its compiled programs; here that keeps the chunk shapes of one pose sweep
to a few.  The cull counts come to the host once per frame to form the
classes; an ommatidium whose cone meets no cluster goes to the first class
and sees the miss shader, as in the oracle.

The angles are drawn once for the whole eye from the frame's generator,
with the oracle's layout, and sliced per class, so neither the backend nor
the classes change the sampled noise.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from compound_ray_tpu_torch.accel.clusters import scene_clusters
from compound_ray_tpu_torch.accel.cull import (
    cone_cull_clusters,
    shortlist_from_mask,
)
from compound_ray_tpu_torch.config import get_config
from compound_ray_tpu_torch.eye.render import render_compound_means
from compound_ray_tpu_torch.eye.sampling import sample_angles
from compound_ray_tpu_torch.trace.culled import render_means_culled_angles

_K_CLASSES = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def _pad_count(n: int, chunk: int = 64) -> int:
    """A class population padded to a multiple of chunk with power-of-two
    growth up to 1024, then in steps of 1024
    (compound_ray_tpu/trace/dispatch.py:34)."""
    if n <= chunk:
        return chunk
    p = chunk
    while p < n:
        p = p * 2 if p < 1024 else p + 1024
    return p


def render_means_fast(scene_flat, scene_dev: Dict[str, Any], ommatidia,
                      position, local_space, generator: torch.Generator,
                      samples: int, background: int,
                      use_lighting: bool = False, lights=None,
                      omm_chunk: int = None,
                      sample_chunk: int = None) -> torch.Tensor:
    """(N, 3) means of one frame under backend "xla"
    (compound_ray_tpu/trace/dispatch.py:45).  scene_dev is
    device_triangles' dict on the generator's device; ommatidia (N, 8),
    position (3,), local_space (3, 3) and lights (L, 7) may be host arrays
    or tensors.  Chunks default to config.omm_chunk / sample_chunk, the
    leaf size to config.xla_leaf_size."""
    cfg = get_config()
    omm_chunk = cfg.omm_chunk if omm_chunk is None else omm_chunk
    sample_chunk = cfg.sample_chunk if sample_chunk is None else sample_chunk
    if (use_lighting
            or scene_flat.num_triangles < cfg.min_triangles_for_culling):
        return render_compound_means(scene_dev, ommatidia, position,
                                     local_space, generator, samples,
                                     background, use_lighting, lights)
    dev = scene_dev["v0"].device

    def on_dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    omms, pos, ls = on_dev(ommatidia), on_dev(position), on_dev(local_space)
    n = omms.shape[0]
    clusters = scene_clusters(scene_flat, cfg.xla_leaf_size)
    cdev = clusters.device_arrays(dev)
    cull = cone_cull_clusters(omms, pos, ls, cdev["sphere_center"],
                              cdev["sphere_radius"], cfg.cull_sigmas)
    counts = cull["count"].cpu().numpy()  # the frame's one host read
    splay, spin = sample_angles(generator, n, samples, omms[:, 6])
    out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    mask = cull["mask"]
    # ommatidia whose cones meet no cluster join the first class and shade
    # as misses (the JAX sweep starts at 1 and leaves their means 0)
    prev_k = -1
    for k_class in _K_CLASSES:
        sel = np.flatnonzero((counts > prev_k) & (counts <= k_class))
        prev_k = k_class
        if len(sel):
            n_pad = _pad_count(len(sel))
            # padding repeats the first selected ommatidium; dropped below
            sel_p = torch.as_tensor(
                np.concatenate([sel, np.full(n_pad - len(sel), sel[0])]),
                device=dev)
            ids, valid = shortlist_from_mask(
                mask[sel_p], min(k_class, clusters.num_clusters))
            means = render_means_culled_angles(
                scene_dev, cdev, omms[sel_p], pos, ls, splay[:, sel_p],
                spin[:, sel_p], ids, valid, background, omm_chunk=omm_chunk,
                sample_chunk=sample_chunk)
            out[torch.as_tensor(sel, device=dev)] = means[:len(sel)]
        if k_class >= counts.max():
            break
    return out
