"""State carried across from the JAX package: its scene tables and pose pack.

The renderer has no weights; what it carries from one frame to the next is
the scene plan (compound_ray_tpu/eye/pipeline.py:ScenePlan) and the packed
payload of a pose (_pack_fused).  These helpers take either as numpy
arrays, for instance np.asarray of the JAX package's device arrays, and
return the port's counterparts, so the port can run on exactly the tables
the JAX package built.
"""

from __future__ import annotations

import numpy as np
import torch

from compound_ray_tpu_torch.eye.pipeline import ScenePlan


def scene_plan_from_arrays(device, *, mm_flat, attr_table, slot_center_cl,
                           slot_radius_cl, slot_tri_cl, half_center,
                           half_radius, quad_table, payload,
                           sphere_center_np, sphere_radius_np, textured: bool,
                           tex_only: bool) -> ScenePlan:
    """The port's ScenePlan on `device` from a JAX ScenePlan's tables, given
    under their JAX field names."""
    return ScenePlan.from_arrays(
        device, mm_flat=mm_flat, attr_table=attr_table,
        slot_center_cl=slot_center_cl, slot_radius_cl=slot_radius_cl,
        slot_tri_cl=slot_tri_cl, half_center=half_center,
        half_radius=half_radius, quad_table=quad_table, textured=textured,
        tex_only=tex_only, payload=payload, sphere_center=sphere_center_np,
        sphere_radius=sphere_radius_np)


def packed_from_arrays(row_counts, packed_mm, device):
    """(row_counts (NG,) int32, packed_mm (NG, rmax, 16, 512) f32) tensors on
    `device` from a pose pack's arrays."""
    return (torch.tensor(np.asarray(row_counts, np.int32), device=device),
            torch.tensor(np.asarray(packed_mm, np.float32), device=device))
