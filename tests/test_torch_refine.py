"""The planning refine's wrapper (eye/pipeline.py run_refine) on CPU tensors.

On the CPU the wrapper takes its torch twin, _refine_mask, so it must give
exactly what the pack took from the twin before the kernel existed: the
rows _rows(mask.sum(-1)), the key where(mask, dist, inf) with the mask and
distances of _refine_mask, and _refine_slots its slots.  The kernel (csrc/refine_mask.cu) is held to
the twin on a card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from compound_ray_tpu_torch import testing
from compound_ray_tpu_torch.eye import pipeline as P
from compound_ray_tpu_torch.scene.eye_io import ommatidia_to_array

N_OMM = 64
SIGMAS = 4.0


def _inputs(g: int, with_dmax: bool):
    """A 64-ommatidium eye in groups of g at (0, 2, 0) of the 60-box scene:
    (omms_p, position, local_space, ids, cl_counts, splan, dmax)."""
    scene = testing.make_big_scene(n_boxes=60, seed=5)
    splan = P.scene_plan(scene, "cpu")
    omms_p = torch.as_tensor(ommatidia_to_array(
        testing.make_sphere_eye(N_OMM, 8.0)))
    pos = torch.tensor([0.0, 2.0, 0.0])
    ls = torch.eye(3)
    gmask, counts, dmin = P._cull_groups(omms_p, pos, ls, splan.half_center,
                                         splan.half_radius, SIGMAS, g)
    # a shortlist narrower than the widest group's, so cl_counts clamps
    kcand = max(1, int(counts.max()) - 3)
    ids = P._shortlist_sorted(gmask, dmin, kcand)[0][:, :kcand]
    cl_counts = torch.clamp(counts, max=kcand)
    dmax = None
    if with_dmax:
        rng = np.random.default_rng(g)
        dmax = torch.tensor(rng.uniform(0.5, 8.0, N_OMM), dtype=torch.float32)
    return omms_p, pos, ls, ids, cl_counts, splan, dmax


@pytest.mark.parametrize("with_dmax", [False, True], ids=["plain", "dmax"])
@pytest.mark.parametrize("g", [1, 2, 32])
@pytest.mark.parametrize("refine_mode", ["exact", "sphere"])
def test_run_refine_on_cpu_is_the_twin(refine_mode, g, with_dmax):
    omms_p, pos, ls, ids, cl, splan, dmax = _inputs(g, with_dmax)
    tri = splan.slot_tri_cl if refine_mode == "exact" else None
    args = (omms_p, pos, ls, ids, cl, splan.slot_center_cl,
            splan.slot_radius_cl, g, SIGMAS, tri)
    mask, dist, slots = P._refine_mask(*args, dmax=dmax)
    rows, key = P.run_refine(*args, dmax=dmax)
    assert rows.dtype == torch.int32
    assert torch.equal(rows, P._rows(mask.sum(dim=-1)))
    assert key.dtype == torch.float32 and key.shape == mask.shape
    assert torch.equal(torch.isfinite(key), mask)
    assert torch.equal(key[mask], dist[mask])
    assert torch.equal(P._refine_slots(ids), slots)
    # the case refines some slots and drops others, and dmax drops more
    assert mask.any() and not mask.all()
    if dmax is not None:
        free = P._refine_mask(*args)[0]
        assert (free & ~mask).any() and not (mask & ~free).any()
