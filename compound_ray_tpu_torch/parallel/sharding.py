"""The compound-eye frame over a mesh of ranks
(compound_ray_tpu/parallel/sharding.py on torch.distributed).

Two axes, as in the JAX package:

  * ommatidium axis ("omm"): each rank traces its slice of the eye's
    groups against the replicated scene; the only communication is the
    all-gather of the per-group rows;
  * sample axis ("sample"): each rank takes a disjoint slice of every
    ommatidium's cone samples, and the partial means, each weighted by its
    share of the samples, are summed with an all-reduce.

The deployment is one process per rank, as torchrun starts them: NCCL with
one card per rank, or gloo on the CPU and where ranks share a card.  The
caller initialises the default process group; make_eye_mesh lays the ranks
out row-major on an (omm, sample) grid and makes its subgroups.

Planning (the far-field split and cache, the widths, the pose's pack, the
sky split and the shadow plan) is global and replicated on every rank
(eye/pipeline.py _plan_frame with omm_axis); only the trace and shade are
sharded.  Angles are drawn globally: every rank draws the full (Np, S) set
from its generator, seeded alike on every rank, and keeps its block, so a
sharded frame equals the dense frame on the same angles up to the f32
order of the sample-axis sum.  The shard core (shard_core) is a plain
function of the global plan and a coordinate, free of collectives; the
public functions add the two collectives and return the whole result on
every rank, as the JAX global array is whole.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from compound_ray_tpu_torch.eye.pipeline import (
    _ceil_to,
    _frame_angles,
    _plan_frame,
    _trace_shade_angles,
    canonical_device,
    scatter_sky,
)
from compound_ray_tpu_torch.trace.mm_tracer import BATCH_RAYS


def _world_size() -> int:
    """The default process group's size, or 1 when there is none."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def pick_sample_parallel(samples: int,
                         n_devices: Optional[int] = None) -> int:
    """Sample-axis width of the (omm, sample) mesh
    (compound_ray_tpu/parallel/sharding.py:34): 2 when the rank count is
    even and the sample count divides by 2, else 1 (the omm axis only), so
    the width always divides the samples.  n_devices defaults to the world
    size of the default process group, 1 when none is initialised."""
    if n_devices is None:
        n_devices = _world_size()
    return 2 if n_devices % 2 == 0 and samples % 2 == 0 else 1


@dataclass(frozen=True)
class EyeMesh:
    """This rank's place on the (omm, sample) mesh.  sample_group holds
    the ranks of its row (its omm index, every sample index: the
    all-reduce), omm_group those of its column (its sample index, every
    omm index: the all-gather); both are None on a one-rank mesh without a
    process group."""

    shape: Dict[str, int]  # {"omm": W // sp, "sample": sp}
    coords: Tuple[int, int]  # (omm index, sample index) of this rank
    sample_group: Any
    omm_group: Any
    device: torch.device


# the subgroups of each (default group, sample width), made once: every
# rank must create every group, in one order, or the run hangs
_groups: Dict[Tuple[Any, int], Tuple[list, list]] = {}


def make_eye_mesh(n_devices: Optional[int] = None, sample_parallel: int = 1,
                  device="cuda") -> EyeMesh:
    """The (omm, sample) mesh over the default process group
    (compound_ray_tpu/parallel/sharding.py:45): W ranks as W //
    sample_parallel rows of sample_parallel, rank r at (r // sp, r % sp),
    the row-major order of JAX's devices.reshape(W // sp, sp).  n_devices
    defaults to the world size and must equal it (no sub-meshes).  Every
    rank makes every row group and then every column group with
    dist.new_group, once per default group and width.  `device` is the
    rank's device (the card by default; it raises where torch has none)."""
    world = _world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"n_devices={n_devices}: the mesh spans the whole "
                         f"default process group of {world} ranks")
    sp = int(sample_parallel)
    if sp < 1 or world % sp:
        raise ValueError(f"sample_parallel={sp} must divide the {world} "
                         f"ranks")
    device = canonical_device(device)
    shape = {"omm": world // sp, "sample": sp}
    if world == 1 and not (dist.is_available() and dist.is_initialized()):
        return EyeMesh(shape, (0, 0), None, None, device)
    key = (dist.group.WORLD, sp)
    if key not in _groups:
        rows = [dist.new_group([i * sp + j for j in range(sp)])
                for i in range(world // sp)]
        cols = [dist.new_group([i * sp + j for i in range(world // sp)])
                for j in range(sp)]
        _groups[key] = (rows, cols)
    rows, cols = _groups[key]
    rank = dist.get_rank()
    i, j = rank // sp, rank % sp
    return EyeMesh(shape, (i, j), rows[i], cols[j], device)


@dataclass
class MeshPlan:
    """_plan_for_mesh's result: the global frame plan (kw, as _plan_frame
    returns it), inv_valid and the per-shard sizes."""

    kw: Dict[str, Any]
    inv_valid: torch.Tensor
    omm_axis: int
    s_local: int  # samples per shard
    ng_local: int  # groups per shard
    rb_local: int  # a shard's ray block: g * s_local padded to BATCH_RAYS


def _plan_for_mesh(scene_flat, scene_dev, omms_np, position, local_space,
                   generator, samples: int, background: int,
                   shape: Dict[str, int], lights=None,
                   allow_cache: bool = True, angles=None) -> MeshPlan:
    """Global planning for a sharded frame
    (compound_ray_tpu/parallel/sharding.py:75-199), replicated on every
    rank: the eye plan padded to the omm axis, the pose-memoised pack, the
    far-field cache (K2 builds it on each rank), the sky split at quantum
    lcm(64, omm axis), the shard-major shadow plan when lit, and frame 0's
    global angles from `generator` (or `angles`)."""
    omm_axis, sample_axis = shape["omm"], shape["sample"]
    if samples % sample_axis:
        raise ValueError(f"samples={samples} must divide by the sample "
                         f"axis {sample_axis}")
    kw, inv_valid = _plan_frame(
        scene_flat, scene_dev, omms_np, position, local_space, generator,
        samples, background, lights=lights, omm_axis=omm_axis,
        allow_cache=allow_cache, angles=angles)
    s_local = samples // sample_axis
    return MeshPlan(kw, inv_valid, omm_axis, s_local, kw["ng"] // omm_axis,
                    _ceil_to(kw["g"] * s_local, BATCH_RAYS))


def shard_core(plan: MeshPlan, i: int, j: int, splay=None, spin=None,
               want_samples: bool = False) -> torch.Tensor:
    """Shard (i, j) of a frame, with no collective: group rows [i * NG_l,
    (i + 1) * NG_l) of the pack and the eye, sample columns [j * S_l,
    (j + 1) * S_l) of the global angles (the plan's frame 0, or splay and
    spin (Np, S)), and shard i's block of the shadow plan, through
    _trace_shade_angles with one ray block of rb_local.  Returns the
    partial means (Np_l, 3) times S_l / S (the JAX shard_fn,
    compound_ray_tpu/parallel/sharding.py:275-296), or with want_samples
    the (Np_l, S_l, 3) samples."""
    kw = plan.kw
    g, ngl, sl = kw["g"], plan.ng_local, plan.s_local
    groups = slice(i * ngl, (i + 1) * ngl)
    omms = slice(i * ngl * g, (i + 1) * ngl * g)
    cols = slice(j * sl, (j + 1) * sl)
    splay = kw["splay"] if splay is None else splay
    spin = kw["spin"] if spin is None else spin
    local = dict(
        kw, packed_mm=kw["packed_mm"][groups],
        row_counts=kw["row_counts"][groups], omms_p=kw["omms_p"][omms],
        splay=splay[omms, cols], spin=spin[omms, cols], samples=sl,
        ng=ngl, nrb=1, rb_size=plan.rb_local, sky_means=None,
        sky_scatter=None)
    if "shadow" in kw:
        counts, r2v, flag, flat_rows, sph = kw["shadow"]
        tb = r2v.shape[0] // plan.omm_axis
        rows = slice(i * tb, (i + 1) * tb)
        local["shadow"] = (counts[:, groups], r2v[rows], flag[rows],
                           flat_rows[rows], sph[groups])
    out = _trace_shade_angles(want_samples=want_samples, **local)
    if want_samples:
        return out
    return out * (sl / kw["samples"])


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _all_gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """x gathered from the n ranks of `group` and concatenated on dim."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _combine_means(plan: MeshPlan, mesh: EyeMesh,
                   partial: torch.Tensor) -> torch.Tensor:
    """Partial means (Np_l, ..., 3) of every shard -> the whole frame in
    ommatidium order: the sum over the sample axis (all-reduce), the rows
    of the omm axis (all-gather), then the sky scatter over the replicated
    sky means (compound_ray_tpu/parallel/sharding.py:359-360) and
    inv_valid."""
    means = _all_reduce(partial, mesh.sample_group)
    means = _all_gather(means, mesh.omm_group, mesh.shape["omm"], 0)
    kw = plan.kw
    if kw["sky_means"] is not None:
        means = scatter_sky(means, kw["sky_means"], kw["sky_scatter"])
    return means[plan.inv_valid]


def _check_device(mesh: EyeMesh, device) -> None:
    if canonical_device(device) != mesh.device:
        raise ValueError(f"the frame's generator is on {device}, the "
                         f"mesh's rank on {mesh.device}")


def render_means_sharded_packed(
        scene_flat, scene_dev: Dict[str, Any], ommatidia: np.ndarray,
        position, local_space, generator: torch.Generator, samples: int,
        background: int, mesh: EyeMesh, lights=None) -> torch.Tensor:
    """One frame's (N, 3) means over the mesh, lit or unlit
    (compound_ray_tpu/parallel/sharding.py:202), on every rank.  Every
    rank draws the frame's global angles from `generator`, which must be
    seeded alike on every rank, as one controller's key is one key: the
    renderer seeds it from (config.base_seed, the eye's frame).

    As in the JAX package, a lit sharded frame is not audited against its
    shadow shafts (compound_ray_tpu/parallel/sharding.py:217-223): it
    renders the same shaft approximation as the dense frame without the
    leak warning."""
    _check_device(mesh, generator.device)
    plan = _plan_for_mesh(scene_flat, scene_dev, ommatidia, position,
                          local_space, generator, samples, background,
                          mesh.shape, lights=lights)
    return _combine_means(plan, mesh, shard_core(plan, *mesh.coords))


def render_means_sharded_angles(
        scene_flat, scene_dev: Dict[str, Any], ommatidia: np.ndarray,
        position, local_space, splay: torch.Tensor, spin: torch.Tensor,
        samples: int, background: int, mesh: EyeMesh,
        lights=None) -> torch.Tensor:
    """render_means_sharded_packed on given global angles (Np, S) of the
    plan's (sky-compacted) eye rows, on the mesh's device, in place of a
    generator's draw; the lit frame's shadow plan probes them."""
    _check_device(mesh, splay.device)
    plan = _plan_for_mesh(scene_flat, scene_dev, ommatidia, position,
                          local_space, None, samples, background, mesh.shape,
                          lights=lights, angles=(splay, spin))
    return _combine_means(plan, mesh, shard_core(plan, *mesh.coords))


def render_means_sharded_packed_frames(
        scene_flat, scene_dev: Dict[str, Any], ommatidia: np.ndarray,
        position, local_space, generators, samples: int, background: int,
        mesh: EyeMesh, lights=None) -> torch.Tensor:
    """(F, N, 3) means of F consecutive frames at one pose over the mesh
    (compound_ray_tpu/parallel/sharding.py:408), frame f drawn from
    generators[f]: planned once from frame 0, then one shard core per frame
    (the JAX package scans them), and one all-reduce and one all-gather
    for the burst.  Frame f equals render_means_sharded_packed on
    generators[f] at the same plan."""
    _check_device(mesh, generators[0].device)
    plan = _plan_for_mesh(scene_flat, scene_dev, ommatidia, position,
                          local_space, generators[0], samples, background,
                          mesh.shape, lights=lights)
    i, j = mesh.coords
    partial = torch.stack(
        [shard_core(plan, i, j, splay, spin)
         for splay, spin in _frame_angles(plan.kw, generators, samples)],
        dim=1)  # (Np_l, F, 3)
    return _combine_means(plan, mesh, partial).transpose(0, 1)


def _gather_samples(plan: MeshPlan, mesh: EyeMesh,
                    raw: torch.Tensor) -> torch.Tensor:
    """A shard's (Np_l, S_l, 3) samples -> the whole (S, N, 3) buffer:
    gathered over the sample axis and then the omm axis (out_specs
    P("omm", "sample", None), compound_ray_tpu/parallel/sharding.py:534)."""
    raw = _all_gather(raw, mesh.sample_group, mesh.shape["sample"], 1)
    raw = _all_gather(raw, mesh.omm_group, mesh.shape["omm"], 0)
    return raw[plan.inv_valid].transpose(0, 1)


def render_samples_sharded_packed(
        scene_flat, scene_dev: Dict[str, Any], ommatidia: np.ndarray,
        position, local_space, generator: torch.Generator, samples: int,
        background: int, mesh: EyeMesh) -> torch.Tensor:
    """One unlit frame's raw samples (S, N, 3) over the mesh
    (compound_ray_tpu/parallel/sharding.py:456), on every rank: the dense
    raw semantics, with neither the far-field cache nor the sky split
    (per-sample values must be samples, not expectations)."""
    _check_device(mesh, generator.device)
    plan = _plan_for_mesh(scene_flat, scene_dev, ommatidia, position,
                          local_space, generator, samples, background,
                          mesh.shape, allow_cache=False)
    return _gather_samples(
        plan, mesh, shard_core(plan, *mesh.coords, want_samples=True))
