"""The compound-eye frame, unlit and lit: planning, packing, tracing,
shading (compound_ray_tpu/eye/pipeline.py in torch).

Per frame:
  1. plan (memoised): scene tables (scene_plan), the eye's group layout
     (eye_plan), the far-field split and its radiance cache (_farfield_plan
     -> _render_cache on K2, trace/cluster_tracer.py) and the pose's packed
     payload at the widths it measures (_packed_plan -> _pack_fused: cone
     cull -> near clusters -> cluster shortlist -> per-triangle refine
     (run_refine: csrc/refine_mask.cu on CUDA tensors, its twin
     _refine_mask on the CPU) -> payload pack); with the sky split on, the
     compacted live groups and the sky groups' cache expectation
     (_sky_build);
  2. draw (N, S) cone-jitter angles from the caller's torch.Generator;
     a lit frame then takes its memoised shadow plan (_shadow_plan: a K1
     probe of the first frame's hit points at the pose, per-light occluder
     shafts, one ragged table of reverse-affine occluder rows);
  3. _trace_shade_angles: world rays in one launch (run_ray_features:
     csrc/ray_features.cu on CUDA tensors, its twin ray_features_reference
     on the CPU) -> K1 (trace/mm_tracer.py) -> winner attributes ->
     texture -> GGX direct light with shadow rays on K3 when lit -> miss
     shading or the far-field cache -> per-ommatidium mean, returned in the
     original ommatidium order.  An unlit means frame
     shades and reduces in one launch (run_shade_means:
     csrc/shade_means.cu on CUDA tensors, its twin shade_means_reference,
     the eager _shade_planes and the mean, on the CPU); lit frames and raw
     samples shade in _shade_planes.
A burst (render_means_frames) plans once and renders F frames at the
pose, stacked on the sample axis into one frame core or one frame core
each; raw samples (render_samples) are the frame core's samples before
the mean.

Ommatidia are permuted by view direction so that groups of G neighbours
share coherent shortlists (G shrinks to 1 once an ommatidium's samples fill
a ray block).  Ray directions are unit length and tmin is rescaled by
|axis|, so the tracer's t is a world distance.  With config.affine_rays and
G = 1, each group's origin and tmin are folded into its pose-memoised pack
(_pack_fused) and the frame traces [d, 1, 0 x 4] rays on K1's 8-feature
form; config.refine_mode = "sphere" keeps the refine to the triangle
bounding spheres.  Both are part of every plan key.

Not ported here (TPU workarounds whose results the port already matches):
precision modes, direct1, the uv/uvs/flat/loc emit variants (the lit path's
one-hot local resolve is a plain indexed gather here), the shadow table's
rows-per-block layout, speculative widths, the polynomial equirect
addressing (FAST_EQUIRECT) and bf16 texture-and-cache tables.  The sharded
path (parallel/sharding.py) plans here (_plan_frame's omm_axis) and renders
each shard with _trace_shade_angles.

Under a profiler the layers record spans (spans.py): cr.plan around
_plan_frame with cr.plan.farfield and cr.plan.angles inside it, a
cr.plan.build.* span (pack, cache, sky, shadow) only where a memo misses
and builds (the cache's with cr.plan.cache.cull, its tile cull and
shortlist, and cr.plan.cache.trace, its K2 launch, shading, mean
and quad table, inside it), cr.refine around each refine kernel launch,
and cr.core around _trace_shade_angles with cr.core.rays, cr.core.shade and
cr.core.lit inside it, and cr.core.farfield (the far-field sphere's hit
test and the cache lookups) inside cr.core.shade; the ray generation
launch is cr.raygen, inside cr.core.rays; an unlit means frame's shading
launch is cr.shade, inside cr.core.shade and, on a cache frame, inside
cr.core.farfield, since the one kernel does the far field's work.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from compound_ray_tpu_torch.accel.clusters import build_clusters
from compound_ray_tpu_torch.accel.cull import eye_world_geometry
from compound_ray_tpu_torch.config import get_config
from compound_ray_tpu_torch.eye.sampling import (
    FWHM_SD_RATIO,
    cone_offset_components,
    sample_angles_ns,
)
from compound_ray_tpu_torch.spans import span, spanned
from compound_ray_tpu_torch.trace.attrs import (
    ATTR_COMPS,
    ATTR_COMPS_FLAT,
    ATTR_COMPS_TEX,
    KERNEL_LEAF,
    OUT_COMPS,
    build_attr_table,
)
from compound_ray_tpu_torch.trace.cluster_tracer import (
    build_kernel_payload,
    pack_rays,
    run_tracer_kernel,
)
from compound_ray_tpu_torch.trace.lighting import (
    apply_material_textures_from_rows,
    build_shading_rows,
    ggx_light_contrib_planar,
    unpack_shading_cols,
)
from compound_ray_tpu_torch.trace.mm_tracer import (
    BATCH_RAYS as MM_BATCH_RAYS,
    MM_BLOCKS,
    MM_COLS,
    MM_FEATS,
    RAY_FEATS,
    RAY_FEATS_AFFINE,
    build_mm_features,
    run_packed_tracer,
    run_rows_occlusion,
    slot_spheres,
    transform_payload_affine,
)
from compound_ray_tpu_torch.trace.shade import (
    build_quad_table,
    miss_color_c,
    quad_bilinear_c,
    texture_quad_coords_c,
)

# (groups x candidate slots) elements per refine chunk: the torch twin
# (_refine_mask, the CPU path) keeps ~60 temporaries of this size alive, so
# 2**23 f32 elements (32 MB) bounds its peak near 2 GB whatever the
# shortlist width; the kernel (run_refine on CUDA) writes at most the
# chunk's key, which the pack's sort then copies
_REFINE_CHUNK_ELEMS = 1 << 23
# refine kernel launches by run_refine (the kernel only, never the twin)
refine_launches = 0
# shading kernel launches by run_shade_means (the kernel only, never the
# twin)
shade_launches = 0
# ray generation kernel launches by run_ray_features (the kernel only,
# never the twin)
raygen_launches = 0
# far-field caches rendered by _farfield_plan (each cache_store miss, on
# any device; a store hit builds none)
cache_builds = 0
# cache cull and shortlist kernel launches by run_cache_shortlist (the
# kernel only, never the twin): one a cache build on a card
cache_cull_launches = 0
# the widest shortlist csrc/cache_cull.cu takes (kmax rounded up to 128)
CACHE_CULL_MAX_KP = 4096

# Inflation of the per-group hit-bound spheres the shadow plan is built
# from (compound_ray_tpu/eye/pipeline.py:86-101): the probe samples one
# frame's hit cloud and later frames jitter within the same cones, so the
# memoised occluder shafts must cover a neighbourhood of the probed
# bounds.  A later hit outside its shaft (a silhouette edge the probe never
# crossed) sees only shaft-local occluders; the lit frame's audit counts
# such hits and mark_shadow_unsound corrects them.
SHADOW_BOUND_INFLATE = 1.25
# shadow rows keep only the product feature rows [Q_d, Q_c, 0 x 4]: the
# occlusion test never reads the metadata rows 8-15
SHADOW_FEATS = 8
# of which K3 reads the first 4: rows 4-7 are zero by construction
# (transform_payload_affine), as are the shadow rays' [D, 1, 0 x 4]
SHADOW_LIVE_FEATS = 4


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def canonical_device(device) -> torch.device:
    """`device` with its index filled in ("cuda" -> "cuda:0"), so plans
    cached per device match whichever spelling a caller used."""
    return torch.empty(0, device=device).device


@dataclass
class ScenePlan:
    """Per-scene tables on one device (compound_ray_tpu/eye/pipeline.py:108,
    the fields the packed path reads, unlit and lit)."""

    device: torch.device
    mm_flat: torch.Tensor  # (S+128, 64) per-slot feature columns
    attr_table: torch.Tensor  # (S, A) winner attributes
    slot_center_cl: torch.Tensor  # (C, 128, 3) per-slot triangle spheres
    slot_radius_cl: torch.Tensor  # (C, 128); -1 on padding slots
    slot_tri_cl: torch.Tensor  # (C, 128, 9) [v0|e1|e2] for the exact refine
    half_center: torch.Tensor  # (C, H, 3) cluster sub-spheres
    half_radius: torch.Tensor  # (C, H)
    quad_table: torch.Tensor  # (P, 16) texel 2x2 quads ((1, 16) untextured)
    textured: bool
    tex_only: bool  # every triangle textured, no vertex colours
    payload: torch.Tensor  # (C, 16, 128) K2 intersection constants
    sphere_center_np: np.ndarray  # (C, 3) cluster spheres: far-field split
    sphere_radius_np: np.ndarray  # (C,)
    # their device copies: the camera image culls its tiles against them
    sphere_center: torch.Tensor
    sphere_radius: torch.Tensor
    packed_store: Dict = field(default_factory=dict)  # bounded LRU of packs
    cache_store: Dict = field(default_factory=dict)  # viewpoint -> cache
    sky_store: Dict = field(default_factory=dict)  # pose -> sky plan, LRU
    # (eye sig, samples, quantum) -> the sky split's live-group high-water
    sky_ngl: Dict = field(default_factory=dict)
    slot_tri: torch.Tensor = None  # (S,) int32 slot -> triangle id, -1 pad
    # (T, 18 | 26) build_shading_rows of the scene, built by the first lit
    # frame
    shading_rows: torch.Tensor = None
    # (pose, lights, samples) -> shadow plan, LRU (_shadow_plan)
    shadow_store: Dict = field(default_factory=dict)
    # the corrective modes of mark_shadow_unsound: guaranteed shadow bounds
    # for every group, or for these groups (eye-plan group indices)
    shadow_sound_all: bool = False
    shadow_unsound_groups: set = field(default_factory=set)
    # the camera image has warned that its shortlist cap truncates
    image_cap_warned: bool = False

    @property
    def num_clusters(self) -> int:
        return int(self.slot_center_cl.shape[0])

    @classmethod
    def from_arrays(cls, device, mm_flat, attr_table, slot_center_cl,
                    slot_radius_cl, slot_tri_cl, half_center, half_radius,
                    quad_table, textured: bool, tex_only: bool, payload,
                    sphere_center, sphere_radius,
                    slot_tri=None) -> "ScenePlan":
        def dev(x):  # a copy: the arrays may be read-only views
            return torch.tensor(np.asarray(x, np.float32), device=device)

        return cls(
            device=torch.device(device),
            mm_flat=dev(mm_flat), attr_table=dev(attr_table),
            slot_center_cl=dev(slot_center_cl),
            slot_radius_cl=dev(slot_radius_cl),
            slot_tri_cl=dev(slot_tri_cl),
            half_center=dev(half_center), half_radius=dev(half_radius),
            quad_table=dev(quad_table),
            textured=bool(textured), tex_only=bool(tex_only),
            payload=dev(payload),
            sphere_center_np=np.array(sphere_center, np.float32),
            sphere_radius_np=np.array(sphere_radius, np.float32),
            sphere_center=dev(sphere_center),
            sphere_radius=dev(sphere_radius),
            slot_tri=(None if slot_tri is None else torch.tensor(
                np.asarray(slot_tri, np.int32), device=device)),
        )


def scene_plan(scene_flat, device) -> ScenePlan:
    """Build (once per scene and device) the tracers' tables
    (compound_ray_tpu/eye/pipeline.py:195): clusters of 128 triangles, K1's
    per-slot feature columns, K2's per-cluster payload, the
    winner-attribute table, per-slot and per-cluster spheres and, for
    textured scenes, the texel quad table."""
    device = canonical_device(device)
    plan = getattr(scene_flat, "_kernel_plan", None)
    if plan is not None and plan.device == device:
        return plan
    cs = build_clusters(scene_flat.v0, scene_flat.e1, scene_flat.e2,
                        leaf_size=KERNEL_LEAF)
    textured = scene_flat.has_any_texture
    used_mats = np.maximum(np.asarray(scene_flat.mat_id), 0)
    tex_only = bool(
        textured
        and not np.asarray(scene_flat.has_color).any()
        and (np.asarray(scene_flat.mat_tex)[used_mats] >= 0).all()
    )
    attr = build_attr_table(
        {k: getattr(scene_flat, k) for k in (
            "has_color", "mat_id", "mat_base_color", "mat_tex", "c0", "c1",
            "c2", "uv0", "uv1", "uv2")},
        cs, tex_only)
    if textured:
        quad = build_quad_table({k: getattr(scene_flat, k) for k in (
            "tex_data", "tex_offset", "tex_width", "tex_height",
            "tex_wrap_s", "tex_wrap_t")})
    else:
        quad = np.zeros((1, 16), np.float32)
    safe_s = np.maximum(cs.tri_id.reshape(-1), 0)
    mat_id_slot = np.maximum(np.asarray(scene_flat.mat_id)[safe_s], 0)
    texid_slot = np.asarray(scene_flat.mat_tex)[mat_id_slot]
    flat_attrs = attr.shape[1] == ATTR_COMPS_FLAT
    mm_feats = build_mm_features(
        cs,
        uv=(np.asarray(scene_flat.uv0), np.asarray(scene_flat.uv1),
            np.asarray(scene_flat.uv2)),
        texid=texid_slot,
        rgb=(np.asarray(scene_flat.mat_base_color)[mat_id_slot][:, :3]
             if flat_attrs else None),
    )  # (S+128, 4, 16)
    tri_c, tri_r, _ = slot_spheres(cs)
    c_cl = cs.tri_id.shape[0]
    plan = ScenePlan.from_arrays(
        device,
        mm_flat=mm_feats.reshape(mm_feats.shape[0], -1),
        attr_table=attr,
        slot_center_cl=tri_c.reshape(c_cl, KERNEL_LEAF, 3),
        slot_radius_cl=tri_r.reshape(c_cl, KERNEL_LEAF),
        slot_tri_cl=np.concatenate([cs.v0, cs.e1, cs.e2], axis=1)
        .reshape(c_cl, KERNEL_LEAF, 9),
        half_center=cs.half_center, half_radius=cs.half_radius,
        quad_table=quad, textured=textured, tex_only=tex_only,
        payload=build_kernel_payload(cs),
        sphere_center=cs.sphere_center, sphere_radius=cs.sphere_radius,
        slot_tri=cs.tri_id.reshape(-1),
    )
    scene_flat._kernel_plan = plan
    return plan


@dataclass
class EyePlan:
    """Per-(eye, samples) static layout: permutation + group geometry
    (compound_ray_tpu/eye/pipeline.py:332)."""

    perm: np.ndarray  # (Np,) padded permutation into original omms
    inv_valid: np.ndarray  # (N,) position of omm i in permuted order
    n: int
    n_pad: int
    g: int  # omms per group
    ng: int
    rg_pad: int  # padded rays per group
    rb_size: int
    nrb: int
    kmax_hint: int = 8
    rmax_hint: int = 1  # packed payload rows per group (high-water)
    sig: bytes = b""  # unique plan signature for pose/payload cache keys
    _dev: Dict = field(default_factory=dict)  # device -> (omms_p, inv_valid)

    def device_arrays(self, ommatidia: np.ndarray, device):
        """(omms_p (Np, 8), inv_valid (N,) int64) on `device`, cached."""
        device = canonical_device(device)
        hit = self._dev.get(device)
        if hit is None:
            hit = (torch.as_tensor(ommatidia[self.perm], device=device),
                   torch.as_tensor(self.inv_valid, device=device))
            self._dev[device] = hit
        return hit


# an LRU of eye plans, oldest first: each plan keeps device copies of its
# eye, and every render_batch_poses call folds its poses into a new eye
EYE_PLAN_STORE_SIZE = 16
_eye_plans: Dict[Tuple, EyePlan] = {}


def eye_plan(ommatidia: np.ndarray, samples: int,
             ng_multiple: int = 1) -> EyePlan:
    """Static layout for an (eye, samples) pair
    (compound_ray_tpu/eye/pipeline.py:354).  ng_multiple pads the group
    count to a multiple of it, so the group axis splits evenly over a mesh
    of ranks (parallel/sharding.py).  Padding replicates the last
    ommatidium in the scan order; padded outputs are dropped by inv_valid.
    Memoised in an LRU of EYE_PLAN_STORE_SIZE plans (the JAX memo has no
    bound); a plan built again has the same signature, so the pack memo
    keyed by it still serves it.  Plans that pad differently have
    different signatures, so no pose memo serves one plan's pack to
    another."""
    h = hashlib.blake2b(np.ascontiguousarray(ommatidia).tobytes(),
                        digest_size=12).hexdigest()
    key = (h, samples, ng_multiple)
    plan = _eye_plans.pop(key, None)
    if plan is not None:
        _eye_plans[key] = plan  # LRU refresh
        return plan

    n = ommatidia.shape[0]
    # group size: fill at least 128 rays per group
    g = max(1, min(32, _ceil_to(128, max(samples, 1)) // max(samples, 1)))
    # sort by direction: theta bands then phi, so groups look the same way
    d = ommatidia[:, 3:6].astype(np.float64)
    dn = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    theta = np.arccos(np.clip(dn[:, 1], -1, 1))
    phi = np.arctan2(dn[:, 2], dn[:, 0])
    band = np.floor(theta / 0.35).astype(np.int64)
    order = np.lexsort((phi, band))
    n_pad = _ceil_to(n, g * ng_multiple)
    perm = np.concatenate([order, np.full(n_pad - n, order[-1])])
    inv_valid = np.empty(n, np.int64)
    inv_valid[order] = np.arange(n)

    ng = n_pad // g
    rg = g * samples
    # one ray block per group, padded to the ray batch
    nrb = 1
    rb_size = _ceil_to(rg, MM_BATCH_RAYS)
    plan = EyePlan(
        perm=perm, inv_valid=inv_valid, n=n, n_pad=n_pad, g=g, ng=ng,
        rg_pad=nrb * rb_size, rb_size=rb_size, nrb=nrb,
        sig=repr(key).encode() + np.int64(n_pad).tobytes(),
    )
    while len(_eye_plans) >= EYE_PLAN_STORE_SIZE:
        _eye_plans.pop(next(iter(_eye_plans)))
    _eye_plans[key] = plan
    return plan


def _cull_groups(omms_p, position, local_space, centers, radii,
                 cull_sigmas: float, g: int):
    """Cone-vs-cluster cull per group (compound_ray_tpu/eye/pipeline.py:415).
    Returns (gmask (NG, C) bool, counts (NG,) int32, dmin (NG, C)): a
    cluster survives when either of its sub-spheres meets an ommatidium's
    cull cone; dmin is the group's apex-to-sphere-surface distance."""
    apex, axis = eye_world_geometry(omms_p, position, local_space)
    half = torch.clamp(omms_p[:, 6] / FWHM_SD_RATIO * cull_sigmas,
                       max=math.pi)
    c, h = centers.shape[0], centers.shape[1]
    cx = centers[:, :, 0].reshape(1, c * h)
    cy = centers[:, :, 1].reshape(1, c * h)
    cz = centers[:, :, 2].reshape(1, c * h)
    rad = radii.reshape(1, c * h)
    tx = cx - apex[:, 0:1]
    ty = cy - apex[:, 1:2]
    tz = cz - apex[:, 2:3]  # (Np, C*H)
    dist = torch.sqrt(tx * tx + ty * ty + tz * tz)
    inv_d = 1.0 / torch.clamp(dist, min=1e-30)
    inside = dist <= rad
    cos_a = (tx * axis[:, 0:1] + ty * axis[:, 1:2] + tz * axis[:, 2:3]) * inv_d
    alpha = torch.arccos(torch.clamp(cos_a, -1.0, 1.0))
    beta = torch.arcsin(torch.clamp(rad * inv_d, 0.0, 1.0))
    hit = inside | (alpha <= half[:, None] + beta)  # (Np, C*H)
    np_ = omms_p.shape[0]
    mask = hit.reshape(np_, c, h).any(dim=2)  # (Np, C)
    ng = np_ // g
    gmask = mask.reshape(ng, g, c).any(dim=1)
    counts = gmask.sum(dim=-1).to(torch.int32)
    surf = (dist - rad).reshape(ng, g, c, h)
    dmin_all = torch.clamp(surf.amin(dim=(1, 3)), min=0.0)
    return gmask, counts, dmin_all


def _shortlist_sorted(gmask, dmin_all, kmax: int):
    """Surviving cluster ids nearest first, with their distance bounds
    (compound_ray_tpu/eye/pipeline.py:468, stable like jnp.argsort).
    Returns (ids (NG, KP) int32, dmin (NG, KP) f32) with KP = kmax rounded
    up to 128; columns past the survivors hold dmin 3e38, and columns past
    the C clusters id 0.  The refine reads ids[:, :kcand]; K2 reads
    both."""
    kp = _ceil_to(kmax, 128)
    masked = torch.where(gmask, dmin_all, torch.inf)
    ng, c = masked.shape
    if kp > c:
        masked = torch.cat(
            [masked, torch.full((ng, kp - c), torch.inf,
                                device=masked.device)], dim=-1)
    order = torch.argsort(masked, dim=-1, stable=True)[:, :kp]
    dmin_s = masked.gather(-1, order)
    dmin_s = torch.where(torch.isfinite(dmin_s), dmin_s, 3e38)
    ids = torch.where(order < c, order, 0).to(torch.int32)
    return ids, dmin_s.to(torch.float32)


def _near_counts(gmask, counts, near_mask):
    """The cull restricted to the near clusters when the far-field cache
    serves the far ones (compound_ray_tpu/eye/pipeline.py:943-946)."""
    if near_mask is None:
        return gmask, counts
    gmask = gmask & near_mask[None, :]
    return gmask, gmask.sum(dim=-1).to(torch.int32)


def _refine_tri_cl(splan, cfg):
    """The exact refine's triangle table under refine_mode "exact", None
    (the triangle-sphere test alone) under "sphere"."""
    return splan.slot_tri_cl if cfg.refine_mode == "exact" else None


def _refine_cones(omms_p, position, local_space, cull_sigmas: float,
                  exact: bool, dmax):
    """(Np, 11) per-ommatidium rows of the refine, read by _refine_mask
    and csrc/refine_mask.cu alike: apex, axis, the cone's half-angle
    `half`, the exact refine's cos(hs), sin(min(hs, pi/2)) and hs >= pi/2
    with hs = half + 1e-3 rad of slack (zeros under "sphere"), and dmax
    (zeros without it)."""
    apex, axis = eye_world_geometry(omms_p, position, local_space)
    half = torch.clamp(omms_p[:, 6] / FWHM_SD_RATIO * cull_sigmas,
                       max=math.pi)
    zero = torch.zeros_like(half)
    cap = [zero] * 3
    if exact:
        # rad; absorbs f32 sign noise at arc/vertex boundaries
        hs = torch.clamp(half + 1e-3, max=math.pi)
        cap = [torch.cos(hs), torch.sin(torch.clamp(hs, max=math.pi / 2.0)),
               (hs >= math.pi / 2.0).to(torch.float32)]
    return torch.cat([apex, axis, torch.stack(
        [half, *cap, zero if dmax is None else dmax], dim=1)], dim=1)


def _refine_slots(ids):
    """(NG, kcand*128) global slot ids of a shortlist, candidate-major."""
    return (ids[:, :, None] * KERNEL_LEAF
            + torch.arange(KERNEL_LEAF, device=ids.device)).reshape(
                ids.shape[0], -1)


def _refine_mask(omms_p, position, local_space, ids, cl_counts, center_cl,
                 radius_cl, g: int, cull_sigmas: float, tri_cl, dmax=None):
    """Level-2 cull of the shortlisted clusters' triangles against the cones
    (compound_ray_tpu/eye/pipeline.py:486): the triangle-sphere test, then,
    when tri_cl (C, 128, 9) is given (refine_mode "exact"), the exact
    cone-vs-triangle test on the unit sphere around the apex (a triangle
    meets the cone iff a vertex lies in the cap, an edge arc passes within
    `half` of the axis, or the axis pierces the triangle; 1e-3 rad slack).
    Works on any run of whole groups: omms_p holds their g * len(ids)
    ommatidia.  dmax (Np,), the shadow refine's apex-distance bound, also
    drops triangles whose sphere starts beyond it (:636-639).  The
    per-ommatidium terms are _refine_cones' columns, as the kernel reads
    them.  Returns (mask, dist, slots), each (NG, kcand*128)."""
    cones = _refine_cones(omms_p, position, local_space, cull_sigmas,
                          tri_cl is not None, dmax)
    apex, axis, half = cones[:, 0:3], cones[:, 3:6], cones[:, 6]
    kcand = ids.shape[1]
    np_ = omms_p.shape[0]
    ng = np_ // g
    kc = kcand * KERNEL_LEAF
    cx = center_cl[:, :, 0][ids].reshape(ng, kc)
    cy = center_cl[:, :, 1][ids].reshape(ng, kc)
    cz = center_cl[:, :, 2][ids].reshape(ng, kc)
    r = radius_cl[ids].reshape(ng, kc)

    def po(x):  # (Np,) -> (Np, 1)
        return x[:, None]

    def pc(x):  # per-group (NG, kc) -> (Np, kc) member view
        if g == 1:
            return x
        return x[:, None, :].expand(ng, g, kc).reshape(np_, kc)

    tx = pc(cx) - po(apex[:, 0])
    ty = pc(cy) - po(apex[:, 1])
    tz = pc(cz) - po(apex[:, 2])
    dist = torch.sqrt(tx * tx + ty * ty + tz * tz)
    inv_d = 1.0 / torch.clamp(dist, min=1e-30)
    rb = pc(r)
    inside = dist <= rb
    cos_a = (tx * po(axis[:, 0]) + ty * po(axis[:, 1])
             + tz * po(axis[:, 2])) * inv_d
    alpha = torch.arccos(torch.clamp(cos_a, -1.0, 1.0))
    beta = torch.arcsin(torch.clamp(rb * inv_d, 0.0, 1.0))
    m = inside | (alpha <= half[:, None] + beta)
    if tri_cl is not None:
        # the cap widened by the slack: cos(hs), sin(min(hs, pi/2)) and
        # hs >= pi/2, each (Np, 1)
        cosh, sinh = po(cones[:, 7]), po(cones[:, 8])
        wide = po(cones[:, 9]) != 0.0

        def gat(comp):  # slot component -> (NG, kc) candidate-major rows
            return tri_cl[:, :, comp][ids].reshape(ng, kc)

        wxp = po(axis[:, 0])
        wyp = po(axis[:, 1])
        wzp = po(axis[:, 2])
        d0x = pc(gat(0)) - po(apex[:, 0])
        d0y = pc(gat(1)) - po(apex[:, 1])
        d0z = pc(gat(2)) - po(apex[:, 2])
        d1x, d1y, d1z = d0x + pc(gat(3)), d0y + pc(gat(4)), d0z + pc(gat(5))
        d2x, d2y, d2z = d0x + pc(gat(6)), d0y + pc(gat(7)), d0z + pc(gat(8))

        def unit3(x, y, z):
            l2 = x * x + y * y + z * z
            inv = torch.rsqrt(torch.clamp(l2, min=1e-24))
            return x * inv, y * inv, z * inv, l2

        u0x, u0y, u0z, l0 = unit3(d0x, d0y, d0z)
        u1x, u1y, u1z, l1 = unit3(d1x, d1y, d1z)
        u2x, u2y, u2z, l2_ = unit3(d2x, d2y, d2z)
        vert_in = (
            (u0x * wxp + u0y * wyp + u0z * wzp >= cosh)
            | (u1x * wxp + u1y * wyp + u1z * wzp >= cosh)
            | (u2x * wxp + u2y * wyp + u2z * wzp >= cosh)
        )

        def edge_test(uix, uiy, uiz, ujx, ujy, ujz):
            # minor arc u_i -> u_j; |w . n| <= sin(half) is exact for
            # half <= pi/2 and `wide` covers the rest
            cxx = uiy * ujz - uiz * ujy
            cyy = uiz * ujx - uix * ujz
            czz = uix * ujy - uiy * ujx
            cl2 = cxx * cxx + cyy * cyy + czz * czz
            invc = torch.rsqrt(torch.clamp(cl2, min=1e-24))
            nx, ny, nz = cxx * invc, cyy * invc, czz * invc
            sind = wxp * nx + wyp * ny + wzp * nz
            # closest great-circle point to the axis; in-arc = positive span
            ccx = wxp - sind * nx
            ccy = wyp - sind * ny
            ccz = wzp - sind * nz
            in1 = ((uiy * ccz - uiz * ccy) * nx + (uiz * ccx - uix * ccz) * ny
                   + (uix * ccy - uiy * ccx) * nz) >= 0.0
            in2 = ((ccy * ujz - ccz * ujy) * nx + (ccz * ujx - ccx * ujz) * ny
                   + (ccx * ujy - ccy * ujx) * nz) >= 0.0
            # u_i ~ -u_j: the apex lies ON the edge segment -> intersects
            dotij = uix * ujx + uiy * ujy + uiz * ujz
            deg = (cl2 < 1e-12) & (dotij < 0.0)
            return (in1 & in2 & ((torch.abs(sind) <= sinh) | wide)) | deg, (
                cxx, cyy, czz)

        e01, n01 = edge_test(u0x, u0y, u0z, u1x, u1y, u1z)
        e12, n12 = edge_test(u1x, u1y, u1z, u2x, u2y, u2z)
        e20, n20 = edge_test(u2x, u2y, u2z, u0x, u0y, u0z)

        def same_side(n, px, py, pz):  # axis and opposite vertex agree on n
            nx, ny, nz = n
            return ((wxp * nx + wyp * ny + wzp * nz)
                    * (px * nx + py * ny + pz * nz)) >= 0.0

        axis_in = (
            same_side(n01, u2x, u2y, u2z)
            & same_side(n12, u0x, u0y, u0z)
            & same_side(n20, u1x, u1y, u1z)
        )
        # apex within f32 range of a vertex: projection undefined -> keep
        deg_len = (l0 < 1e-12) | (l1 < 1e-12) | (l2_ < 1e-12)
        m = m & (vert_in | e01 | e12 | e20 | axis_in | deg_len)
    if dmax is not None:
        # occluders past the shaft's far side cannot block a light -> hit
        # segment
        m = m & (dist - rb <= po(cones[:, 10]))
    if g > 1:
        m = m.reshape(ng, g, kc).any(dim=1)
        dist = dist.reshape(ng, g, kc).amin(dim=1)
    cand = torch.arange(kcand, device=ids.device)
    cand_valid = (cand[None, :] < cl_counts[:, None])[:, :, None].expand(
        ng, kcand, KERNEL_LEAF).reshape(ng, kc)
    # r < 0 marks padding slots: their zero centroid could otherwise pass
    # the angular test whenever the cone looks at the origin
    mask = m & cand_valid & (r >= 0.0)
    return mask, dist, _refine_slots(ids)


def refine_reference(omms_p, position, local_space, ids, cl_counts,
                     center_cl, radius_cl, g: int, cull_sigmas: float,
                     tri_cl, dmax=None):
    """run_refine's plain torch twin: _refine_mask, then the refined rows
    per group and the pack's sort key."""
    mask, dist, _ = _refine_mask(omms_p, position, local_space, ids,
                                 cl_counts, center_cl, radius_cl, g,
                                 cull_sigmas, tri_cl, dmax=dmax)
    return _rows(mask.sum(dim=-1)), torch.where(mask, dist, torch.inf)


def run_refine(omms_p, position, local_space, ids, cl_counts, center_cl,
               radius_cl, g: int, cull_sigmas: float, tri_cl, dmax=None):
    """The per-triangle refine of a run of whole groups, _refine_mask's
    arguments: (rows (NG,) int32, key (NG, kcand*128) f32).  rows is _rows
    of the refined slots per group; key, the pack's sort key, is
    where(mask, dist, inf) of _refine_mask's mask and distance.  CUDA
    tensors launch csrc/refine_mask.cu once on the current stream (or
    raise), and equal the twin bit for bit on the same card; CPU tensors
    take refine_reference."""
    dev = ids.device
    if dev.type == "cpu":
        return refine_reference(omms_p, position, local_space, ids,
                                cl_counts, center_cl, radius_cl, g,
                                cull_sigmas, tri_cl, dmax=dmax)
    if dev.type != "cuda":
        raise ValueError(f"run_refine takes CPU or CUDA tensors, not "
                         f"{dev.type}")
    ng, kcand = ids.shape
    c = center_cl.shape[0]
    want = [("ids", ids, torch.int32, (ng, kcand)),
            ("cl_counts", cl_counts, torch.int32, (ng,)),
            ("omms_p", omms_p[:, 0], torch.float32, (ng * g,)),
            ("center_cl", center_cl, torch.float32, (c, KERNEL_LEAF, 3)),
            ("radius_cl", radius_cl, torch.float32, (c, KERNEL_LEAF))]
    if tri_cl is not None:
        want.append(("tri_cl", tri_cl, torch.float32, (c, KERNEL_LEAF, 9)))
    if dmax is not None:
        want.append(("dmax", dmax, torch.float32, (ng * g,)))
    for name, x, dtype, shape in want:
        if x.dtype != dtype or x.device != dev:
            raise TypeError(f"{name} must be {dtype} on {dev}, not "
                            f"{x.dtype} on {x.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} {tuple(x.shape)} != {shape}")
        if name in ("cl_counts", "center_cl", "radius_cl", "tri_cl") and (
                not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous")
    if ids.stride(1) != 1:
        raise ValueError("ids rows must be contiguous")
    if not 1 <= g <= 32:
        raise ValueError(f"g={g}: the refine kernel takes 1 to 32 "
                         f"ommatidia per group")
    rows = torch.empty(ng, dtype=torch.int32, device=dev)
    key = torch.empty((ng, kcand * KERNEL_LEAF), dtype=torch.float32,
                      device=dev)
    cones = _refine_cones(omms_p, position, local_space, cull_sigmas,
                          tri_cl is not None, dmax)
    _launch_refine(cones, ids, cl_counts, center_cl, radius_cl, tri_cl, g,
                   dmax is not None, rows, key)
    return rows, key


def _launch_refine(cones, ids, cl_counts, center_cl, radius_cl, tri_cl,
                   g: int, has_dmax: bool, rows, key) -> None:
    """One launch of csrc/refine_mask.cu on run_refine's checked inputs and
    _refine_cones' rows, writing rows and key."""
    global refine_launches
    from compound_ray_tpu_torch.trace import _build

    lib = _build.refine_mask_lib()
    dev = ids.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with span("cr.refine"):
            err = lib.cr_refine_mask(
                ctypes.c_void_p(cones.data_ptr()),
                ctypes.c_void_p(ids.data_ptr()), ids.stride(0),
                ctypes.c_void_p(cl_counts.data_ptr()),
                ctypes.c_void_p(center_cl.data_ptr()),
                ctypes.c_void_p(radius_cl.data_ptr()),
                ctypes.c_void_p(0 if tri_cl is None else tri_cl.data_ptr()),
                ids.shape[0], g, ids.shape[1], int(tri_cl is not None),
                int(has_dmax), ctypes.c_void_p(rows.data_ptr()),
                ctypes.c_void_p(key.data_ptr()),
                ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"refine launch failed: CUDA error {err}")
    refine_launches += 1


def _refine_chunks(ng: int, g: int, kcand: int, max_groups: int = None):
    """Group ranges that bound _refine_mask's temporaries: eager torch
    materialises every (groups*g, kcand*128) intermediate that XLA fused.
    max_groups also caps a range (the shadow plan's shadow_pack_chunk)."""
    step = max(1, _REFINE_CHUNK_ELEMS // (g * kcand * KERNEL_LEAF))
    if max_groups is not None:
        step = min(step, max_groups)
    return [(g0, min(ng, g0 + step)) for g0 in range(0, ng, step)]


def _rows(refined):
    return ((refined + KERNEL_LEAF - 1) // KERNEL_LEAF).to(torch.int32)


def _refine_sorted(omms_p, position, local_space, ids, cl_counts, center_cl,
                   radius_cl, g: int, cull_sigmas: float, tri_cl,
                   pad_slot: int, dmax=None):
    """One chunk's refine (run_refine's arguments), its refined slots
    nearest first: (rows (n,) int32, the same rows read to the host, slots
    (n, r*128) int32) with r the chunk's most rows.  A group's columns
    past its refined slots hold pad_slot, and no group refines past r*128
    slots, so the cut drops padding only."""
    rows, key = run_refine(omms_p, position, local_space, ids, cl_counts,
                           center_cl, radius_cl, g, cull_sigmas,
                           tri_cl=tri_cl, dmax=dmax)
    sk, order = torch.sort(key, dim=-1, stable=True)
    rows_np = rows.cpu().numpy()
    w = int(rows_np.max()) * KERNEL_LEAF
    ss = _refine_slots(ids).gather(-1, order[:, :w])
    slots = torch.where(torch.isfinite(sk[:, :w]), ss, pad_slot)
    return rows, rows_np, slots.to(torch.int32)


def _gather_payload(mm_flat, slots):
    """(n, r, 16, 512) payload blocks of (n, r*128) packed slot ids, each
    slot's feature columns as K1 reads them."""
    n, r = slots.shape[0], slots.shape[1] // KERNEL_LEAF
    return (mm_flat[slots].reshape(n, r, KERNEL_LEAF, MM_BLOCKS, MM_FEATS)
            .permute(0, 1, 4, 3, 2).reshape(n, r, MM_FEATS, MM_COLS))


def _refine_pack(omms_p, position, local_space, ids, cl_counts, center_cl,
                 radius_cl, mm_flat, g: int, rmin: int, cull_sigmas: float,
                 tri_cl):
    """Refine + compact: the surviving triangles' feature columns, nearest
    first, as per-group (rmax, 16, 512) payload blocks
    (compound_ray_tpu/eye/pipeline.py:681).  rmax is the most rows any
    group refines, rounded up to 2, no less than rmin and no more than the
    shortlist's width (the rounding of compound_ray_tpu/eye/pipeline.py:
    1552).  Returns (row_counts (NG,) int32, packed_mm (NG, rmax, 16,
    512)).  Padding columns point at the all-zero PAD rows of mm_flat.
    Equal distances may pack in another order than the JAX package's
    unstable co-sort; the slot sets agree.  Between the refine and the
    gather each chunk keeps only its sorted slot ids, 1/64 of the payload
    they become."""
    ng, kcand = ids.shape
    pad_slot = mm_flat.shape[0] - 1
    chunks = _refine_chunks(ng, g, kcand)
    parts = [_refine_sorted(
        omms_p[g0 * g:g1 * g], position, local_space, ids[g0:g1],
        cl_counts[g0:g1], center_cl, radius_cl, g, cull_sigmas, tri_cl,
        pad_slot) for g0, g1 in chunks]
    r_needed = max(slots.shape[1] for _, _, slots in parts) // KERNEL_LEAF
    rmax = min(max(rmin, _ceil_to(max(r_needed, 1), 2)), kcand)
    packed_mm = torch.empty((ng, rmax, MM_FEATS, MM_COLS),
                            dtype=torch.float32, device=ids.device)
    for (g0, g1), (_, _, slots) in zip(chunks, parts):
        packed_mm[g0:g1] = _gather_payload(mm_flat, F.pad(
            slots, (0, rmax * KERNEL_LEAF - slots.shape[1]), value=pad_slot))
    return torch.cat([rows for rows, _, _ in parts]), packed_mm


def _pack_fused(mm_flat, slot_center_cl, slot_radius_cl, half_center,
                half_radius, omms_p, position, local_space, g: int,
                kmin: int, rmin: int, cull_sigmas: float, tri_cl,
                near_mask=None, affine: bool = False):
    """Pose-dependent plan: cull -> shortlist -> triangle refine -> packed
    per-group payload (compound_ray_tpu/eye/pipeline.py:906), at the
    widths it measures: kcand, the most clusters a group keeps after the
    cull rounded up to 8, no less than kmin and no more than the C
    clusters; rmax as _refine_pack measures it, no less than rmin.  The
    cull's maximum comes to the host once, and the refine's rows once a
    chunk.  With the far-field cache on, near_mask (C,) bool keeps only
    the near clusters: the cache serves the far ones.  tri_cl None refines
    on the triangle spheres alone (refine_mode "sphere").  affine (g == 1
    only) folds each group's ray origin and tmin into its payload
    (transform_payload_affine, :955-963), for [d, 1, 0 x 4] rays.  Depends
    only on (scene, eye, pose, far-field split, the two modes), not on the
    RNG or the sample count: the shortlist and the refine's sort are
    stable, so the floors change the padding only.  Returns (row_counts,
    packed_mm, kcand, rmax)."""
    gmask, counts, dmin_all = _cull_groups(
        omms_p, position, local_space, half_center, half_radius,
        cull_sigmas, g)
    gmask, counts = _near_counts(gmask, counts, near_mask)
    k_needed = int(counts.max().item())
    kcand = min(slot_center_cl.shape[0],
                max(kmin, _ceil_to(max(k_needed, 1), 8)))
    ids = _shortlist_sorted(gmask, dmin_all, kcand)[0][:, :kcand]
    row_counts, packed_mm = _refine_pack(
        omms_p, position, local_space, ids, counts, slot_center_cl,
        slot_radius_cl, mm_flat, g, rmin, cull_sigmas, tri_cl=tri_cl)
    if affine:
        if g != 1:
            raise ValueError(f"affine payloads need one ommatidium per "
                             f"group, not {g}")
        (ox, oy, oz), tmin_w, _, _ = _omm_world_origins(
            omms_p, position, local_space)
        packed_mm = transform_payload_affine(
            packed_mm, torch.stack([ox, oy, oz], dim=-1), tmin_w)
    return row_counts, packed_mm, kcand, packed_mm.shape[1]


def _packed_key(eplan, samples, pose_sig, use_cache: bool, d_thresh: float,
                cfg, affine: bool = False):
    """packed_store key (compound_ray_tpu/eye/pipeline.py:1625, without the
    widths, which the pack measures): the far-field split, the refine mode
    and affine-ness are part of it, so a dense pack and a near-masked pack
    at one pose, an exact and a sphere refine, or an affine and a plain
    payload are never served for each other."""
    return (eplan.sig, samples, pose_sig, use_cache, d_thresh,
            cfg.cull_sigmas, cfg.refine_mode, affine)


def _pack_nbytes(pack) -> int:
    """Device bytes of a (row_counts, packed_mm, kcand, rmax) pack."""
    return sum(t.numel() * t.element_size() for t in pack[:2])


def _packed_plan(splan, eplan, omms_p, position, local_space, pose_sig,
                 samples, near_mask=None, d_thresh=0.0,
                 affine: bool = False):
    """Memoised _pack_fused with a bounded LRU
    (compound_ray_tpu/eye/pipeline.py:1594): a fixed-pose sequence of
    frames pays the refine and pack once.  near_mask and d_thresh describe
    the far-field split (None and 0.0 with the cache off), affine the
    payload's form (_pack_fused).  A build packs at no less than the eye
    plan's width hints and raises them to its widths, high-water marks as
    in the JAX package (:1584-1585), so a pose packed again after its
    eviction has the same rows at the widest widths seen.  The store keeps
    at most config.packed_store_size packs and config.packed_store_bytes
    bytes: the oldest go until a new pack fits, and a pack larger than the
    byte bound serves its frame without being kept.  Returns (row_counts,
    packed_mm, kcand, rmax)."""
    cfg = get_config()
    pk = _packed_key(eplan, samples, pose_sig, near_mask is not None,
                     d_thresh, cfg, affine)
    hit = splan.packed_store.get(pk)
    if hit is not None:
        splan.packed_store[pk] = splan.packed_store.pop(pk)  # LRU refresh
        return hit
    with span("cr.plan.build.pack"):
        out = _pack_fused(
            splan.mm_flat, splan.slot_center_cl, splan.slot_radius_cl,
            splan.half_center, splan.half_radius, omms_p, position,
            local_space, g=eplan.g, kmin=eplan.kmax_hint,
            rmin=eplan.rmax_hint, cull_sigmas=cfg.cull_sigmas,
            tri_cl=_refine_tri_cl(splan, cfg), near_mask=near_mask,
            affine=affine)
    eplan.kmax_hint, eplan.rmax_hint = out[2], out[3]
    size = _pack_nbytes(out)
    if size > cfg.packed_store_bytes:
        return out
    store = splan.packed_store
    while store and (len(store) >= cfg.packed_store_size
                     or sum(map(_pack_nbytes, store.values())) + size
                     > cfg.packed_store_bytes):
        store.pop(next(iter(store)))
    store[pk] = out
    return out


def _attrs_from_rows(attr, u, v, tex_only: bool, flat_attrs: bool):
    """Texture coordinates, texture id and linear colour of the winners
    from their (R, A) attribute rows (compound_ray_tpu/eye/pipeline.py:725).
    rgb is None for tex_only scenes."""
    w0n = 1.0 - u - v
    cu = w0n * attr[:, 0] + u * attr[:, 2] + v * attr[:, 4]
    cv = w0n * attr[:, 1] + u * attr[:, 3] + v * attr[:, 5]
    texid = attr[:, 6].to(torch.int32)
    if tex_only:
        rgb = None
    elif flat_attrs:
        rgb = (attr[:, 7], attr[:, 8], attr[:, 9])
    else:
        lin = attr[:, 7] > 0.5
        rgb = tuple(
            torch.where(lin, torch.pow(torch.clamp(ch, min=0.0), 2.2), ch)
            for ch in (
                w0n * attr[:, 8] + u * attr[:, 11] + v * attr[:, 14],
                w0n * attr[:, 9] + u * attr[:, 12] + v * attr[:, 15],
                w0n * attr[:, 10] + u * attr[:, 13] + v * attr[:, 16],
            )
        )
    return cu, cv, texid, rgb


def resolve_kernel_hits(out, attr_table, tex_only: bool):
    """Winner attributes from K1's planar (8, R) [t, u, v, slot] rows with
    one row gather per ray (compound_ray_tpu/eye/pipeline.py:837, packed,
    emit "bary").  Returns (t, cu, cv, texid, rgb), all (R,); rows of
    missed rays are clamped garbage that callers mask with t < 1e30 and
    group liveness."""
    row = torch.clamp(out[3].long(), 0, attr_table.shape[0] - 1)
    return _resolve_rows(out[0], out[1], out[2], row, attr_table, tex_only)


def resolve_cluster_hits(out, attr_table, tex_only: bool):
    """resolve_kernel_hits for K2's (R, 8) [t, u, v, cluster, lane] rows:
    the winner's attribute row is cluster * 128 + lane
    (compound_ray_tpu/eye/pipeline.py:877-891)."""
    cluster = torch.clamp(out[:, 3].long(), 0,
                          attr_table.shape[0] // KERNEL_LEAF - 1)
    lane = torch.clamp(out[:, 4].long(), 0, KERNEL_LEAF - 1)
    return _resolve_rows(out[:, 0], out[:, 1], out[:, 2],
                         cluster * KERNEL_LEAF + lane, attr_table, tex_only)


def _resolve_rows(t, u, v, row, attr_table, tex_only: bool):
    attr = attr_table[row]  # (R, A)
    cu, cv, texid, rgb = _attrs_from_rows(
        attr, u, v, tex_only, attr_table.shape[1] == ATTR_COMPS_FLAT)
    return t, cu, cv, texid, rgb


def _omm_world_origins(omms_p, position, local_space):
    """Per-ommatidium world ray origin (focal-retracted), world tmin, axis
    and axis length, all (Np,) (compound_ray_tpu/eye/pipeline.py:1036)."""
    ax, ay, az = omms_p[:, 3], omms_p[:, 4], omms_p[:, 5]
    axis_len = torch.sqrt(ax * ax + ay * ay + az * az)
    inv_al = 1.0 / torch.clamp(axis_len, min=1e-30)
    focal = omms_p[:, 7]
    rx = omms_p[:, 0] - ax * inv_al * focal
    ry = omms_p[:, 1] - ay * inv_al * focal
    rz = omms_p[:, 2] - az * inv_al * focal
    L = local_space  # rows are the eye's world x/y/z axes
    ox = position[0] + rx * L[0, 0] + ry * L[1, 0] + rz * L[2, 0]
    oy = position[1] + rx * L[0, 1] + ry * L[1, 1] + rz * L[2, 1]
    oz = position[2] + rx * L[0, 2] + ry * L[1, 2] + rz * L[2, 2]
    return (ox, oy, oz), focal * axis_len, (ax, ay, az), axis_len


def ray_features_reference(omms_p, position, local_space, splay, spin,
                           samples: int, ng: int, g: int, nrb: int,
                           rb_size: int, affine: bool = False):
    """run_ray_features' plain torch twin: sample angles -> world rays ->
    K1's planar features (compound_ray_tpu/eye/pipeline.py:1057), in eager
    torch."""
    origins = _omm_world_origins(omms_p, position, local_space)
    (ox, oy, oz), tmin_w, (ax, ay, az), _ = origins
    L = local_space
    rdx, rdy, rdz = cone_offset_components(
        ax[:, None], ay[:, None], az[:, None], splay, spin)  # (Np, S)
    wdx = rdx * L[0, 0] + rdy * L[1, 0] + rdz * L[2, 0]
    wdy = rdx * L[0, 1] + rdy * L[1, 1] + rdz * L[2, 1]
    wdz = rdx * L[0, 2] + rdy * L[1, 2] + rdz * L[2, 2]
    # normalise: t becomes world distance, tmin scales by |axis|
    inv_n = torch.rsqrt(torch.clamp(wdx * wdx + wdy * wdy + wdz * wdz,
                                    min=1e-60))
    dx, dy, dz = wdx * inv_n, wdy * inv_n, wdz * inv_n
    ones = torch.ones_like(dx)
    zeros = torch.zeros_like(dx)
    if affine:
        comps = [dx, dy, dz, ones]
        n_feats = RAY_FEATS_AFFINE
    else:
        tmin = tmin_w[:, None]
        oxb, oyb, ozb = ox[:, None], oy[:, None], oz[:, None]
        # Plücker moment m = o x d; tmin folded into the origin,
        # o' = o + tmin d
        mx = oyb * dz - ozb * dy
        my = ozb * dx - oxb * dz
        mz = oxb * dy - oyb * dx
        comps = [dx, dy, dz, mx, my, mz, -(oxb + tmin * dx),
                 -(oyb + tmin * dy), -(ozb + tmin * dz), ones]
        n_feats = RAY_FEATS
    comps += [zeros] * (n_feats - len(comps))
    rg = g * samples
    rg_pad = nrb * rb_size
    rays = torch.stack([c.reshape(ng, rg) for c in comps])  # (F, NG, rg)
    if rg_pad != rg:
        rays = F.pad(rays, (0, rg_pad - rg), mode="replicate")
    return rays.reshape(n_feats, ng * rg_pad), origins[:2]


def run_ray_features(omms_p, position, local_space, splay, spin,
                     samples: int, ng: int, g: int, nrb: int, rb_size: int,
                     affine: bool = False):
    """The frame core's ray generation from the drawn (Np, S) angles: (rays,
    origins).  rays is K1's (16, NG*rg_pad) [d, m, -o', 1, 0 x 6], or (8,
    NG*rg_pad) [d, 1, 0 x 4] when `affine` (the origin and tmin live in the
    transform_payload_affine'd payload), with unit world directions d; each
    group's ray block is edge-padded (the last real ray repeated) so padded
    rays stay finite.  origins is ((ox, oy, oz), tmin), each (Np,): the
    per-ommatidium world ray origin and tmin of _omm_world_origins.  CUDA
    tensors launch csrc/ray_features.cu once on the current stream (or
    raise), and equal the twin bit for bit on the same card; CPU tensors
    take ray_features_reference."""
    global raygen_launches
    args = (omms_p, position, local_space, splay, spin, samples, ng, g, nrb,
            rb_size, affine)
    dev = omms_p.device
    if dev.type == "cpu":
        return ray_features_reference(*args)
    if dev.type != "cuda":
        raise ValueError(f"run_ray_features takes CPU or CUDA tensors, not "
                         f"{dev.type}")
    n_pad, rg_pad = ng * g, nrb * rb_size
    if g * samples > rg_pad:
        raise ValueError(f"g={g} x {samples} samples do not fit blocks of "
                         f"{rg_pad}")
    omms_p, position, local_space = (
        x.contiguous() for x in (omms_p, position, local_space))
    splay, spin = (x if x.stride(1) == 1 else x.contiguous()
                   for x in (splay, spin))
    for name, x, shape in (("omms_p", omms_p, (n_pad, 8)),
                           ("position", position, (3,)),
                           ("local_space", local_space, (3, 3)),
                           ("splay", splay, (n_pad, samples)),
                           ("spin", spin, (n_pad, samples))):
        if x.dtype != torch.float32 or x.device != dev:
            raise TypeError(f"{name} must be float32 on {dev}, not "
                            f"{x.dtype} on {x.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} {tuple(x.shape)} != {shape}")
    feats = RAY_FEATS_AFFINE if affine else RAY_FEATS
    rays = torch.empty((feats, ng * rg_pad), dtype=torch.float32, device=dev)
    origins = torch.empty((4, n_pad), dtype=torch.float32, device=dev)
    from compound_ray_tpu_torch.trace import _build

    lib = _build.ray_features_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with span("cr.raygen"):
            err = lib.cr_ray_features(
                ctypes.c_void_p(omms_p.data_ptr()),
                ctypes.c_void_p(position.data_ptr()),
                ctypes.c_void_p(local_space.data_ptr()),
                ctypes.c_void_p(splay.data_ptr()), splay.stride(0),
                ctypes.c_void_p(spin.data_ptr()), spin.stride(0), ng, g,
                samples, rg_pad, feats, ctypes.c_void_p(rays.data_ptr()),
                ctypes.c_void_p(origins.data_ptr()),
                ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"ray generation launch failed: CUDA error {err}")
    raygen_launches += 1
    return rays, ((origins[0], origins[1], origins[2]), origins[3])


def ray_dirs(rays, ng: int, g: int, samples: int, rg_pad: int):
    """The (Np, S) unit direction planes (dx, dy, dz): rows 0-2 of K1's
    rays (either form) without the ray-block padding."""
    n_pad, rg = ng * g, g * samples
    return tuple(rays[c].reshape(ng, rg_pad)[:, :rg].reshape(n_pad, samples)
                 for c in range(3))


def _repad(x, ng: int, rg: int, rg_pad: int):
    """(Np, S) -> (R,) in kernel ray order, each group's block zero-padded
    to rg_pad (the JAX lit branch's repad, compound_ray_tpu/eye/
    pipeline.py:1329-1333; bool planes pad with False)."""
    x2 = x.reshape(ng, rg)
    if rg_pad != rg:
        x2 = torch.cat([x2, x2.new_zeros((ng, rg_pad - rg))], dim=1)
    return x2.reshape(-1)


def _neg_origins(origins, dx, dy, dz):
    """-o' = -(o + tmin d), the tmin-shifted ray origins negated, as (Np, S)
    planes, from run_ray_features' origins and directions: the lit branch
    and the shadow probe rebuild hit points from them
    (compound_ray_tpu/eye/pipeline.py:1099-1101).  Bit-equal to the rows
    6-8 of the 16-feature rays."""
    (ox, oy, oz), tmin_w = origins[:2]
    tmin = tmin_w[:, None]
    return (-(ox[:, None] + tmin * dx), -(oy[:, None] + tmin * dy),
            -(oz[:, None] + tmin * dz))


def _inside_far_sphere(t, origins, dx, dy, dz, far_sphere):
    """(Np, S) bool: the hit points o' + t d of K1's t (Np, S) lie within
    the far-field sphere far_sphere = (centre (3,), D), with o and tmin
    from origins, run_ray_features' (or _omm_world_origins' result).  Each
    ray starts inside it (D exceeds the eye's extent), so the first hit
    lies inside iff some triangle is hit before the ray leaves the sphere;
    a first hit beyond it belongs to the cache, which shows the first
    surface past D from the centre.  Misses (t = inf) come out False."""
    if far_sphere is None:
        raise ValueError("a frame with the far-field cache needs its "
                         "far_sphere (centre, D)")
    centre, d_far = far_sphere
    (ox, oy, oz), tmin_w = origins[:2]
    tt = t + tmin_w[:, None]
    px = torch.addcmul((ox - centre[0])[:, None], tt, dx)
    py = torch.addcmul((oy - centre[1])[:, None], tt, dy)
    pz = torch.addcmul((oz - centre[2])[:, None], tt, dz)
    r2 = torch.addcmul(torch.addcmul(px * px, py, py), pz, pz)
    return r2 <= d_far * d_far


def _lit_epilogue(out, hit, rr, gg, bb, dx, dy, dz, neg_o, scene_dev,
                  shading_rows, slot_tri, lights, shadow, samples: int,
                  ng: int, g: int, nrb: int, rb_size: int,
                  shadow_audit: bool, shadow_tracer=None):
    """GGX direct light with shadow rays over the frame's hits
    (compound_ray_tpu/eye/pipeline.py:1314-1501; shaders.cu:826-881).

    out is K1's (8, R) output, hit and the base colour planes (Np, S),
    shadow the _shadow_plan tuple (counts (L, NG), r2v, flag, flat_rows,
    sph).  Hit points p = o' + t d.  One gather of the shading rows per ray
    (slot -> triangle -> build_shading_rows row; the JAX package's one-hot
    local resolve gives the same rows, :755-834), the planar shading
    normal, the material textures where the scene has them, then per light
    the reverse-affine shadow ray [eps l - (light - p), 1, 0 x 4]: origin
    at the light, so t in [0, 1] spans the segment from the light to the
    hit's epsilon band.  All lights go through one K3 launch (`shadow_
    tracer`, run_rows_occlusion by default).  A light adds its GGX term
    where the hit faces it and its shadow ray is clear; zero-row virtual
    groups count as clear.  Returns (rr, gg, bb) planes (Np, S) and the
    audit [leaked, hits, per-group leaks] (int64, or None unless
    shadow_audit): hits outside their group's memoised shaft sphere."""
    counts, r2v, flag, flat_rows, sph = shadow
    n_pad = hit.shape[0]
    rg = g * samples
    rg_pad = nrb * rb_size

    def repad(x):
        return _repad(x, ng, rg, rg_pad)

    eps = 1e-3  # traceOcclusion tmin (shaders.cu:875)
    hit_f = repad(hit)
    dxf, dyf, dzf = repad(dx), repad(dy), repad(dz)
    # missed rays clamp to t = 0 so every shadow feature stays finite
    t_c = torch.where(hit_f, out[0], 0.0)
    pxf = -repad(neg_o[0]) + t_c * dxf
    pyf = -repad(neg_o[1]) + t_c * dyf
    pzf = -repad(neg_o[2]) + t_c * dzf
    audit = None
    if shadow_audit:
        hm2 = hit_f.reshape(ng, rg_pad)
        ddx = pxf.reshape(ng, rg_pad) - sph[:, 0:1]
        ddy = pyf.reshape(ng, rg_pad) - sph[:, 1:2]
        ddz = pzf.reshape(ng, rg_pad) - sph[:, 2:3]
        d2 = ddx * ddx + ddy * ddy + ddz * ddz
        r_s = sph[:, 3:4]
        # r < 0: the group hit nothing in the probe, so any hit now traced
        # no occluder rows
        leak = hm2 & ((d2 > r_s * r_s) | (r_s < 0.0))
        leak_g = leak.sum(dim=1)
        audit = torch.cat([torch.stack([leak_g.sum(), hm2.sum()]), leak_g])
    u_b, v_b = out[1], out[2]
    slot = torch.clamp(out[3].long(), 0, slot_tri.shape[0] - 1)
    tid = torch.clamp(slot_tri[slot], min=0).long()
    rows_g = shading_rows[tid]  # (R, C)
    (e1g, e2g, n0g, n1g, n2g, has_n, metallic, roughness) = (
        unpack_shading_cols(rows_g.t()))
    w_b = 1.0 - u_b - v_b
    gx = e1g[1] * e2g[2] - e1g[2] * e2g[1]
    gy = e1g[2] * e2g[0] - e1g[0] * e2g[2]
    gz = e1g[0] * e2g[1] - e1g[1] * e2g[0]
    nx = torch.where(has_n, w_b * n0g[0] + u_b * n1g[0] + v_b * n2g[0], gx)
    ny = torch.where(has_n, w_b * n0g[1] + u_b * n1g[1] + v_b * n2g[1], gy)
    nz = torch.where(has_n, w_b * n0g[2] + u_b * n1g[2] + v_b * n2g[2], gz)
    n_inv = 1.0 / torch.clamp(torch.sqrt(nx * nx + ny * ny + nz * nz),
                              min=1e-20)
    nx, ny, nz = nx * n_inv, ny * n_inv, nz * n_inv
    if "mat_mr_tex" in scene_dev:
        # metallic-roughness and normal maps (shaders.cu:831-852): the dict
        # has these keys only when some material uses such a texture
        n_vec, metallic, roughness = apply_material_textures_from_rows(
            scene_dev, rows_g, torch.stack([nx, ny, nz], dim=-1), metallic,
            roughness, u_b, v_b)
        nx, ny, nz = n_vec[:, 0], n_vec[:, 1], n_vec[:, 2]
    base_p = (repad(rr), repad(gg), repad(bb))
    res_r, res_g, res_b = base_p
    n_lights = lights.shape[0]
    r_per_light = ng * rg_pad
    ray_parts, ldirs = [], []
    for li in range(n_lights):
        lpos = lights[li, 4:7]
        tox = lpos[0] - pxf
        toy = lpos[1] - pyf
        toz = lpos[2] - pzf
        ldist = torch.sqrt(tox * tox + toy * toy + toz * toz)
        inv_ld = 1.0 / torch.clamp(ldist, min=1e-20)
        lx, ly, lz = tox * inv_ld, toy * inv_ld, toz * inv_ld
        one_f = torch.ones_like(lx)
        zero_f = torch.zeros_like(lx)
        ray_parts.append(torch.stack(
            [eps * lx - tox, eps * ly - toy, eps * lz - toz, one_f, zero_f,
             zero_f, zero_f, zero_f]))
        ldirs.append((lx, ly, lz))
    trace = run_rows_occlusion if shadow_tracer is None else shadow_tracer
    occ_all = trace(r2v, flag, flat_rows, torch.cat(ray_parts, dim=1),
                    nrb=nrb, rb_size=rb_size,
                    live_feats=SHADOW_LIVE_FEATS)[0]
    for li in range(n_lights):
        o_l = occ_all[li * r_per_light:(li + 1) * r_per_light]
        cnt_ray = torch.repeat_interleave(counts[li], rg_pad)
        occ = (o_l > 0.0) & (cnt_ray > 0)
        (c_r, c_g, c_b), facing = ggx_light_contrib_planar(
            (nx, ny, nz), (-dxf, -dyf, -dzf), ldirs[li], base_p, metallic,
            roughness, lights[li, 0:3], lights[li, 3])
        sel = facing & ~occ & hit_f
        res_r = res_r + torch.where(sel, c_r, 0.0)
        res_g = res_g + torch.where(sel, c_g, 0.0)
        res_b = res_b + torch.where(sel, c_b, 0.0)

    def unpad(x):
        return x.reshape(ng, rg_pad)[:, :rg].reshape(n_pad, samples)

    return unpad(res_r), unpad(res_g), unpad(res_b), audit


def scatter_sky(means, sky_means, sky_scatter):
    """The live groups' means (Ngl, ..., 3) scattered over the
    (frame-invariant) sky means (Ng0, 3): row k replaces group
    sky_scatter[k]; padding rows point past Ng0 and land on a dump row,
    which is cut off (compound_ray_tpu/eye/pipeline.py:1537-1542)."""
    n0 = sky_means.shape[0]
    tail = means.shape[1:-1]
    base = sky_means.reshape(n0, *(1,) * len(tail), 3).expand(n0, *tail, 3)
    full = torch.cat([base, sky_means.new_zeros((1, *tail, 3))])
    full.index_copy_(0, torch.clamp(sky_scatter, max=n0), means)
    return full[:n0]


def _shade_planes(out, dx, dy, dz, row_counts, attr_table, scene_dev,
                  quad_table, origins, background: int, ng: int, g: int,
                  rg_pad: int, samples: int, textured: bool, tex_only: bool,
                  cache=None, cache_shape: Tuple[int, int] = (0, 0),
                  far_sphere=None, lit=None):
    """The frame core's eager shading of K1's (8, R) rows `out`
    (compound_ray_tpu/eye/pipeline.py:1191-1517): (rr, gg, bb, audit), each
    plane (Np, S) in permuted ommatidium order.  dx, dy, dz are the rays'
    (Np, S) unit directions, origins run_ray_features' (or
    _omm_world_origins' result; read on a cache frame).  Winner
    attributes, texture, then `lit` (hit, rr, gg, bb) -> (rr, gg, bb,
    audit) where the frame is lit, then the far-field cache or the miss
    shader where nothing is hit; audit is None unless `lit` gives one.
    _trace_shade_angles' other arguments keep their meaning."""
    n_pad = ng * g
    rg = g * samples
    audit = None
    t_f, cu_f, cv_f, texid_f, rgb_f = resolve_kernel_hits(
        out, attr_table, tex_only)

    def unpad(x):
        return x.reshape(ng, rg_pad)[:, :rg].reshape(n_pad, samples)

    t = unpad(t_f)
    # groups with empty payloads are misses whatever their rows hold
    group_live = torch.repeat_interleave(row_counts > 0, g)[:, None]
    hit = (t < 1e30) & group_live
    if cache is not None:
        with span("cr.core.farfield"):
            hit = hit & _inside_far_sphere(t, origins, dx, dy, dz,
                                           far_sphere)
    if tex_only:
        rr = gg = bb = torch.zeros_like(t)
    else:
        rr, gg, bb = (unpad(c) for c in rgb_f)
    if textured:
        texid = unpad(texid_f)
        tex_idx, tfx, tfy = texture_quad_coords_c(
            scene_dev, torch.clamp(texid.reshape(-1), min=0),
            unpad(cu_f).reshape(-1), unpad(cv_f).reshape(-1))
    if textured and cache is not None:
        # one gather from the combined table: texture quads for textured
        # hits, cache quads for misses
        with span("cr.core.farfield"):
            ch, cw = cache_shape
            c_idx, cfx, cfy = _equirect_coords_c(
                ch, cw, dx.reshape(-1), dy.reshape(-1), dz.reshape(-1))
            sel_tex = (hit & (texid >= 0)).reshape(-1)
            idx = torch.where(sel_tex, tex_idx,
                              cache.shape[0] - ch * cw + c_idx)
            qr, qg, qb = quad_bilinear_c(
                cache[idx], torch.where(sel_tex, tfx, cfx),
                torch.where(sel_tex, tfy, cfy))
        # hits on untextured triangles keep their interpolated colour
        keep = hit & (texid < 0)
        rr = torch.where(keep, rr, qr.reshape(n_pad, samples))
        gg = torch.where(keep, gg, qg.reshape(n_pad, samples))
        bb = torch.where(keep, bb, qb.reshape(n_pad, samples))
    else:
        if textured:
            qr, qg, qb = quad_bilinear_c(quad_table[tex_idx], tfx, tfy)
            sel = (texid >= 0) & hit
            rr = torch.where(sel, qr.reshape(n_pad, samples), rr)
            gg = torch.where(sel, qg.reshape(n_pad, samples), gg)
            bb = torch.where(sel, qb.reshape(n_pad, samples), bb)
        if lit is not None:
            rr, gg, bb, audit = lit(hit, rr, gg, bb)
        if cache is not None:
            # the cache already holds the miss shader where nothing is hit
            with span("cr.core.farfield"):
                c_idx, cfx, cfy = _equirect_coords_c(
                    cache.shape[0], cache.shape[1], dx.reshape(-1),
                    dy.reshape(-1), dz.reshape(-1))
                mr, mg, mb = quad_bilinear_c(
                    cache.reshape(-1, 16)[c_idx], cfx, cfy)
        else:
            mr, mg, mb = miss_color_c(dx.reshape(-1), dy.reshape(-1),
                                      dz.reshape(-1), background)
        rr = torch.where(hit, rr, mr.reshape(n_pad, samples))
        gg = torch.where(hit, gg, mg.reshape(n_pad, samples))
        bb = torch.where(hit, bb, mb.reshape(n_pad, samples))
    return rr, gg, bb, audit


def _plane_means(planes, frames: int):
    """(Np, F, 3): each (ommatidium, frame)'s mean of (Np, S) colour
    planes over its S // F contiguous samples."""
    n_pad, samples = planes[0].shape
    return torch.stack([c.reshape(n_pad, frames, samples // frames)
                        .mean(dim=2) for c in planes], dim=-1)


def shade_means_reference(out, rays, row_counts, attr_table, scene_dev,
                          quad_table, origins, background: int, ng: int,
                          g: int, rg_pad: int, samples: int, frames: int,
                          textured: bool, tex_only: bool, cache=None,
                          cache_shape: Tuple[int, int] = (0, 0),
                          far_sphere=None):
    """run_shade_means' plain torch twin: the directions from rows 0-2 of
    K1's rays, _shade_planes, then each (ommatidium, frame)'s mean over
    its samples // frames contiguous samples."""
    dx, dy, dz = ray_dirs(rays, ng, g, samples, rg_pad)
    planes = _shade_planes(
        out, dx, dy, dz, row_counts, attr_table, scene_dev, quad_table,
        origins, background, ng, g, rg_pad, samples, textured, tex_only,
        cache=cache, cache_shape=cache_shape, far_sphere=far_sphere)[:3]
    return _plane_means(planes, frames)


_TEX_KEYS = ("tex_offset", "tex_width", "tex_height", "tex_wrap_s",
             "tex_wrap_t", "tex_filter")


def run_shade_means(out, rays, row_counts, attr_table, scene_dev,
                    quad_table, origins, background: int, ng: int, g: int,
                    rg_pad: int, samples: int, frames: int, textured: bool,
                    tex_only: bool, cache=None,
                    cache_shape: Tuple[int, int] = (0, 0), far_sphere=None):
    """The unlit frame's shading and means from K1's (8, R) rows `out` and
    its (F, R) rays: (Np, frames, 3), each (ommatidium, frame)'s mean over
    its samples // frames contiguous samples, in permuted order.  origins
    is run_ray_features' (or _omm_world_origins' result; read on a cache
    frame); the rest is _trace_shade_angles'.  CUDA tensors launch
    csrc/shade_means.cu once on the current stream (or raise): each
    sample's colour equals the twin's on the same card, and only the mean's
    order of summation differs; CPU tensors take shade_means_reference."""
    global shade_launches
    dev = out.device
    args = (out, rays, row_counts, attr_table, scene_dev, quad_table,
            origins, background, ng, g, rg_pad, samples, frames, textured,
            tex_only)
    if dev.type == "cpu":
        return shade_means_reference(*args, cache=cache,
                                     cache_shape=cache_shape,
                                     far_sphere=far_sphere)
    if dev.type != "cuda":
        raise ValueError(f"run_shade_means takes CPU or CUDA tensors, not "
                         f"{dev.type}")
    r, n_pad = ng * rg_pad, ng * g
    if samples % frames or g * samples > rg_pad:
        raise ValueError(f"{frames} frames of {samples} samples do not fit "
                         f"g={g} in blocks of {rg_pad}")
    want = [("out", out, torch.float32, (OUT_COMPS, r)),
            ("rays", rays, torch.float32, (rays.shape[0], r)),
            ("row_counts", row_counts, torch.int32, (ng,)),
            ("attr_table", attr_table, torch.float32,
             (attr_table.shape[0], attr_table.shape[1]))]
    quads, cache_row, ch, cw, d2 = None, 0, 0, 0, 0.0
    tex = [scene_dev[k] if textured else None for k in _TEX_KEYS]
    orig = [None] * 5
    if textured:
        want += [(k, scene_dev[k], torch.int32, (scene_dev[k].shape[0],))
                 for k in _TEX_KEYS]
        quads = quad_table
    if cache is not None:
        centre, d_far = far_sphere
        (ox, oy, oz), tmin_w = origins[:2]
        want += [(k, x, torch.float32, (n_pad,)) for k, x in
                 (("ox", ox), ("oy", oy), ("oz", oz), ("tmin", tmin_w))]
        want.append(("centre", centre, torch.float32, (3,)))
        orig = [ox, oy, oz, tmin_w, centre]
        d2 = float(d_far) * float(d_far)  # the twin's r2 <= D * D, in f32
        ch, cw = cache_shape
        quads = cache.reshape(-1, 16)
        cache_row = quads.shape[0] - ch * cw
        if cache_row != (quad_table.shape[0] if textured else 0):
            raise ValueError(f"cache {tuple(cache.shape)} is not the "
                             f"{'texture quads and ' if textured else ''}"
                             f"{ch} x {cw} cache quads")
    if quads is not None:
        want.append(("quads", quads, torch.float32, (quads.shape[0], 16)))
    for name, x, dtype, shape in want:
        if x.dtype != dtype or x.device != dev:
            raise TypeError(f"{name} must be {dtype} on {dev}, not "
                            f"{x.dtype} on {x.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} {tuple(x.shape)} != {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rays.shape[0] < 3 or attr_table.shape[1] not in (
            ATTR_COMPS_TEX, ATTR_COMPS_FLAT, ATTR_COMPS) or (
                tex_only != (attr_table.shape[1] == ATTR_COMPS_TEX)):
        raise ValueError(f"rays {tuple(rays.shape)} or attributes "
                         f"{tuple(attr_table.shape)} (tex_only {tex_only}) "
                         f"are not the shading's")
    if quads is not None and quads.data_ptr() % 16:
        raise ValueError("the quad table must be 16-byte aligned")
    means = torch.empty((n_pad, frames, 3), dtype=torch.float32, device=dev)

    def ptr(x):
        return ctypes.c_void_p(0 if x is None else x.data_ptr())

    from compound_ray_tpu_torch.trace import _build

    lib = _build.shade_means_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with span("cr.shade"):
            err = lib.cr_shade_means(
                ptr(out), ptr(rays), r, ptr(row_counts), ptr(attr_table),
                attr_table.shape[0], attr_table.shape[1], *map(ptr, tex),
                ptr(quads), cache_row, ch, cw, *map(ptr, orig), d2,
                background, n_pad, g, frames, samples // frames, rg_pad,
                int(textured), int(cache is not None), ptr(means),
                ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"shading launch failed: CUDA error {err}")
    shade_launches += 1
    return means


@spanned("cr.core")
def _trace_shade_angles(packed_mm, row_counts, attr_table, scene_dev,
                        quad_table, omms_p, position, local_space, splay,
                        spin, samples: int, background: int, ng: int, g: int,
                        nrb: int, rb_size: int, rmax: int, textured: bool,
                        tex_only: bool, tracer=None, cache=None,
                        cache_shape: Tuple[int, int] = (0, 0),
                        far_sphere=None, sky_means=None, sky_scatter=None,
                        lights=None,
                        slot_tri=None, shading_rows=None, shadow=None,
                        shadow_audit: bool = False, shadow_tracer=None,
                        want_samples: bool = False, frames: int = 1,
                        affine: bool = False, shader=None):
    """Angle-parameterised frame core: trace + shade + reduce
    (compound_ray_tpu/eye/pipeline.py:1134, branches :1191-1545).  Returns
    (Np, 3) means in permuted order, or (means, audit) for a lit frame with
    shadow_audit; with want_samples, the (Np, S, 3) samples before the mean
    (:1516-1517).  frames = F > 1 is a stacked burst (:1518-1536):
    `samples` is then F * S, column f * S + s of splay and spin is frame
    f's sample s, and the means are (Np, F, 3), each frame's the same
    contiguous S-column reduction a single frame makes.  `tracer` defaults to
    run_packed_tracer (K1), `shadow_tracer` to run_rows_occlusion (K3) and
    `shader`, the unlit means frame's shading and mean, to run_shade_means
    (csrc/shade_means.cu on CUDA tensors); the chip check passes the twins
    to render through them.  The rays come from run_ray_features
    (csrc/ray_features.cu on CUDA tensors); lit frames and raw samples
    shade in eager torch (_shade_planes) from their rows 0-2.  affine:
    the pack was built with _pack_fused(affine=True), so the rays are [d,
    1, 0 x 4] and K1 runs its 8-feature form (:1167-1219).

    lights (L, 7) on the frame's device turns on GGX direct light with
    shadow rays (_lit_epilogue), which needs slot_tri, shading_rows and the
    _shadow_plan tuple `shadow`; the far-field cache is then off.

    cache is the far-field cache of _farfield_plan: (H, W, 16) equirect
    quads, or for a textured scene the combined (P + H*W, 16) table of
    texture quads followed by cache quads, with cache_shape (H, W), and
    far_sphere its (centre (3,), D): the sphere of radius D about the eye
    centre.  A hit of the near clusters counts only inside that sphere
    (_inside_far_sphere): everything beyond D, near clusters' parts
    included, is the cache's.  Rays with no hit inside read the cache in
    place of the miss shader; in the combined table, textured hits and
    cache lookups share one row gather (:1253-1281).  sky_means (Ng0, 3)
    and sky_scatter (Np,) are the sky split's base means and the group
    each row's mean replaces (rows pointing past Ng0 are dropped;
    :1537-1542)."""
    with span("cr.core.rays"):
        rays, origins = run_ray_features(
            omms_p, position, local_space, splay, spin, samples=samples,
            ng=ng, g=g, nrb=nrb, rb_size=rb_size, affine=affine)
    trace = run_packed_tracer if tracer is None else tracer
    out = trace(row_counts, packed_mm, rays, ng=ng, nrb=nrb, rb_size=rb_size,
                rmax=rmax, ray_feats=rays.shape[0])
    geo = dict(row_counts=row_counts, attr_table=attr_table,
               scene_dev=scene_dev, quad_table=quad_table, origins=origins,
               background=background, ng=ng, g=g, rg_pad=nrb * rb_size,
               samples=samples, textured=textured, tex_only=tex_only,
               cache=cache, cache_shape=cache_shape, far_sphere=far_sphere)
    if lights is None and not want_samples:
        shade = run_shade_means if shader is None else shader
        # on a cache frame the one launch also does the far field's work
        with span("cr.core.shade"), (
                span("cr.core.farfield") if cache is not None
                else contextlib.nullcontext()):
            means = shade(out, rays, frames=frames, **geo)
    else:
        dx, dy, dz = ray_dirs(rays, ng, g, samples, nrb * rb_size)
        lit = None
        if lights is not None:
            def lit(hit, rr, gg, bb):
                with span("cr.core.lit"):
                    return _lit_epilogue(
                        out, hit, rr, gg, bb, dx, dy, dz,
                        _neg_origins(origins, dx, dy, dz),
                        scene_dev, shading_rows, slot_tri, lights, shadow,
                        samples, ng, g, nrb, rb_size, shadow_audit,
                        shadow_tracer)
        with span("cr.core.shade"):
            rr, gg, bb, audit = _shade_planes(out, dx, dy, dz, lit=lit,
                                              **geo)
        if want_samples:
            return torch.stack([rr, gg, bb], dim=-1)
        means = _plane_means((rr, gg, bb), frames)
    if sky_means is not None:
        means = scatter_sky(means, sky_means, sky_scatter)
    if frames == 1:
        means = means[:, 0]
    if lights is not None and shadow_audit:
        return means, audit
    return means


# --------------------------------------------------------------- far field
# Geometry beyond the parallax-safe distance D = eye extent / (tolerance *
# sigma_min) is seen from every point of the eye within a fraction of the
# cone-jitter sd, so it is rendered once per pose into an equirect radiance
# cache from the eye centre (K2 over 16x16-pixel tiles), and the per-sample
# rays trace only the near clusters, falling back to the cache on a miss
# (compound_ray_tpu/eye/pipeline.py:2945-2953).


def _equirect_pixel_dirs(width: int, height: int, device) -> torch.Tensor:
    """(W*H, 3) unit directions at the pixel centres, row-major
    (compound_ray_tpu/eye/pipeline.py:2956)."""
    xs = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) \
        / width
    ys = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) \
        / height
    gy, gx = torch.meshgrid(2.0 * ys - 1.0, 2.0 * xs - 1.0, indexing="ij")
    ax = gx * (-math.pi) + math.pi / 2.0
    ay = gy * (math.pi / 2.0)
    cos_y = torch.cos(ay)
    return torch.stack([torch.cos(ax) * cos_y, torch.sin(ay),
                        torch.sin(ax) * cos_y], dim=-1).reshape(-1, 3)


def build_equirect_quads(cache: torch.Tensor) -> torch.Tensor:
    """(H, W, 16) per-texel 2x2 RGBA neighbourhood of an (H, W, 3) image,
    wrapping in x and clamping in y, in the texture quad table's
    c00|c10|c01|c11 x RGBA layout (compound_ray_tpu/eye/pipeline.py:2970)."""
    h = cache.shape[0]
    c4 = torch.cat([cache, torch.ones_like(cache[..., :1])], dim=-1)
    x1 = torch.roll(c4, -1, dims=1)
    y1 = c4[torch.clamp(torch.arange(h, device=cache.device) + 1, max=h - 1)]
    return torch.cat([c4, x1, y1, torch.roll(y1, -1, dims=1)], dim=-1)


def _equirect_coords_c(h: int, w: int, dx, dy, dz):
    """(row index (R,) int64, fx, fy) into an (h, w) equirect quad cache for
    unit direction components (R,) (compound_ray_tpu/eye/pipeline.py:3041,
    the exact atan2/asin form)."""
    ax = torch.atan2(dz, dx)
    ay = torch.asin(torch.clamp(dy, -1.0, 1.0))
    u = 0.5 + (math.pi / 2.0 - ax) / (2.0 * math.pi)
    v = 0.5 + ay / math.pi
    x = u * w - 0.5
    y = torch.clamp(v * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    xi0 = torch.remainder(x0.to(torch.int64), w)
    yi0 = torch.clamp(y0.to(torch.int64), 0, h - 1)
    return yi0 * w + xi0, x - x0, y - y0


def sample_equirect(quads: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """(R, 3) bilinear lookup of unit directions (R, 3) in an (H, W, 16)
    quad cache (compound_ray_tpu/eye/pipeline.py:3072)."""
    idx, fx, fy = _equirect_coords_c(quads.shape[0], quads.shape[1],
                                     dirs[:, 0], dirs[:, 1], dirs[:, 2])
    q = quads.reshape(-1, 16)[idx]
    fx, fy = fx[:, None], fy[:, None]
    out = (q[:, 0:4] * (1 - fx) * (1 - fy) + q[:, 4:8] * fx * (1 - fy)
           + q[:, 8:12] * (1 - fx) * fy + q[:, 12:16] * fx * fy)
    return out[:, :3]


_CACHE_TILE = 256  # directions per K2 group
_CACHE_BLOCK = 16  # a tile is a 16x16 pixel block: a small, tight cone


def _cache_tile_cones(width: int, device):
    """The cache's pixel directions in 16x16 blocks, one 256-ray tile per
    block, and each tile's bounding cone from the cache's centre
    (compound_ray_tpu/eye/pipeline.py:3093-3120): (blocked (n, 3),
    centroid (NG, 3) unit axes, half_ang (NG,))."""
    height = width // 2
    bs, tile = _CACHE_BLOCK, _CACHE_TILE
    if width % bs or height % bs or (width * height) % tile:
        raise ValueError(
            f"farfield cache width {width}: width and width // 2 must be "
            f"multiples of {bs}")
    dirs = _equirect_pixel_dirs(width, height, device)
    n = dirs.shape[0]
    blocked = (dirs.reshape(height // bs, bs, width // bs, bs, 3)
               .permute(0, 2, 1, 3, 4).reshape(n, 3))
    td = blocked.reshape(n // tile, tile, 3)

    # per-tile bounding cone from the fixed viewpoint
    centroid = td.sum(dim=1)
    centroid = centroid / torch.clamp(
        torch.linalg.norm(centroid, dim=-1, keepdim=True), min=1e-30)
    cosmin = (td[:, :, 0] * centroid[:, None, 0]
              + td[:, :, 1] * centroid[:, None, 1]
              + td[:, :, 2] * centroid[:, None, 2]).amin(dim=1)
    half_ang = torch.arccos(torch.clamp(cosmin, -1.0, 1.0))
    return blocked, centroid, half_ang


def _cache_cluster_terms(half_center, half_radius, center):
    """The per-cluster terms of the cache's cull, read by the twin
    (cache_shortlist_reference) and csrc/cache_cull.cu alike: (to_c (C,
    H, 3), inv_d (C, H), inside (C, H) bool, beta (C, H), dmin_all (C,)),
    each sub-sphere's offset from `center`, its inverse distance, whether
    `center` lies inside it, its angular radius, and the cluster's nearest
    distance, the shortlist's key."""
    to_c = half_center - center  # (C, H, 3)
    dist = torch.linalg.norm(to_c, dim=-1)  # (C, H)
    inside = dist <= half_radius
    inv_d = 1.0 / torch.clamp(dist, min=1e-30)
    beta = torch.arcsin(torch.clamp(half_radius * inv_d, 0.0, 1.0))
    dmin_all = torch.clamp((dist - half_radius).amin(dim=-1), min=0.0)
    return to_c, inv_d, inside, beta, dmin_all


def cache_shortlist_reference(centroid, half_ang, half_center, half_radius,
                              center, far_mask, kmax: int):
    """The torch twin of csrc/cache_cull.cu, run_cache_shortlist's
    arguments: every (tile, cluster of far_mask) pair with a sub-sphere
    that meets the tile's cone from `center`, and each tile's clusters
    nearest first (_shortlist_sorted).  Returns (counts (NG,) int32 =
    min(the tile's clusters, kmax), ids (NG, KP) int32, dmin (NG, KP) f32)
    with KP = kmax rounded up to 128."""
    to_c, inv_d, inside, beta, dmin_all = _cache_cluster_terms(
        half_center, half_radius, center)
    cos_a = (to_c[None, :, :, 0] * centroid[:, None, None, 0]
             + to_c[None, :, :, 1] * centroid[:, None, None, 1]
             + to_c[None, :, :, 2] * centroid[:, None, None, 2]) * inv_d
    alpha = torch.arccos(torch.clamp(cos_a, -1.0, 1.0))  # (G, C, H)
    gmask = (inside | (alpha <= half_ang[:, None, None] + beta)).any(dim=-1)
    gmask = gmask & far_mask[None, :]
    counts = torch.clamp(gmask.sum(dim=-1), max=kmax).to(torch.int32)
    ids, dmin = _shortlist_sorted(gmask, dmin_all[None, :].expand_as(gmask),
                                  kmax)
    return counts, ids, dmin


def run_cache_shortlist(centroid, half_ang, half_center, half_radius,
                        center, far_mask, kmax: int):
    """The far-field cache's cull and shortlist: per tile of cone centroid
    (NG, 3) and half_ang (NG,), the clusters of far_mask (C,) bool whose
    sub-spheres (half_center (C, H, 3), half_radius (C, H); H = 2, or 8
    in scenes of at most 64 clusters) meet the cone from `center` (3,),
    nearest first: (counts (NG,) int32, ids (NG, KP) int32, dmin (NG, KP)
    f32), KP = kmax rounded up to 128, as cache_shortlist_reference gives
    them.  CUDA tensors launch csrc/cache_cull.cu once on the current
    stream (or raise), and equal the twin bit for bit on the same card;
    CPU tensors take the twin.  Either device checks the inputs' dtypes,
    shapes and device first."""
    global cache_cull_launches
    dev = centroid.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"run_cache_shortlist takes CPU or CUDA tensors, "
                         f"not {dev.type}")
    ng, c = centroid.shape[0], far_mask.shape[0]
    h = half_radius.shape[-1]
    for name, x, dtype, shape in (
            ("centroid", centroid, torch.float32, (ng, 3)),
            ("half_ang", half_ang, torch.float32, (ng,)),
            ("half_center", half_center, torch.float32, (c, h, 3)),
            ("half_radius", half_radius, torch.float32, (c, h)),
            ("center", center, torch.float32, (3,)),
            ("far_mask", far_mask, torch.bool, (c,))):
        if x.dtype != dtype or x.device != dev:
            raise TypeError(f"{name} must be {dtype} on {dev}, not "
                            f"{x.dtype} on {x.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} {tuple(x.shape)} != {shape}")
    kp = _ceil_to(kmax, 128)
    if kmax < 1 or kp > CACHE_CULL_MAX_KP:
        raise ValueError(f"kmax={kmax}: the cache's shortlist takes 1 to "
                         f"{CACHE_CULL_MAX_KP} clusters")
    if dev.type == "cpu":
        return cache_shortlist_reference(centroid, half_ang, half_center,
                                         half_radius, center, far_mask, kmax)
    if h not in (2, 8):
        raise ValueError(f"{h} sub-spheres a cluster: the kernel takes 2 "
                         f"or 8")
    terms = [x.contiguous() for x in _cache_cluster_terms(
        half_center, half_radius, center)]
    centroid, half_ang, far_mask = (x.contiguous() for x in (
        centroid, half_ang, far_mask))
    counts = torch.empty(ng, dtype=torch.int32, device=dev)
    ids = torch.empty((ng, kp), dtype=torch.int32, device=dev)
    dmin = torch.empty((ng, kp), dtype=torch.float32, device=dev)
    from compound_ray_tpu_torch.trace import _build

    lib = _build.cache_cull_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with span("cr.cull"):
            err = lib.cr_cache_shortlist(
                ctypes.c_void_p(centroid.data_ptr()),
                ctypes.c_void_p(half_ang.data_ptr()), ng,
                *(ctypes.c_void_p(x.data_ptr()) for x in terms),
                ctypes.c_void_p(far_mask.data_ptr()), c, h, kmax,
                ctypes.c_void_p(counts.data_ptr()),
                ctypes.c_void_p(ids.data_ptr()),
                ctypes.c_void_p(dmin.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"cache shortlist launch failed: CUDA error "
                           f"{err}")
    cache_cull_launches += 1
    return counts, ids, dmin


def _cache_trace_inputs(half_center, half_radius, center, far_mask,
                        width: int, kmax: int, tmin: float = 0.0):
    """The cache's K2 inputs (compound_ray_tpu/eye/pipeline.py:3093-3151):
    the pixel directions in 16x16 blocks, one 256-ray group per block, and
    per block the clusters of far_mask whose half-spheres meet the block's
    bounding cone from `center`, nearest first (run_cache_shortlist);
    every ray starts at `center` and counts hits from t = tmin on.
    Returns (blocked (n, 3), counts (NG,), ids (NG, KP), dmin (NG, KP),
    rays (n, 16))."""
    blocked, centroid, half_ang = _cache_tile_cones(width,
                                                    half_center.device)
    counts, ids, dmin = run_cache_shortlist(
        centroid, half_ang, half_center, half_radius, center, far_mask, kmax)
    n = blocked.shape[0]
    rays = pack_rays(blocked, center[None, :].expand(n, 3),
                     torch.full((n,), tmin, device=blocked.device))
    return blocked, counts, ids, dmin, rays


def shade_cluster_hits(out, live, dirs, attr_table, scene_dev, quad_table,
                       background: int, textured: bool,
                       tex_only: bool) -> torch.Tensor:
    """(R, 3) linear RGB of K2's (R, 8) rows: the winners' attributes, their
    texture where they have one, and miss program `background` for unit
    directions dirs (R, 3) where a ray missed or its tile is not live (a
    tile with an empty shortlist, which the TPU kernel leaves unwritten)
    (compound_ray_tpu/eye/pipeline.py:3156-3181,
    compound_ray_tpu/cameras/fast_image.py:131-157)."""
    t, cu, cv, texid, rgb = resolve_cluster_hits(out, attr_table, tex_only)
    if tex_only:
        rr = gg = bb = torch.zeros_like(t)
    else:
        rr, gg, bb = rgb
    hit = (t < 1e30) & live
    if textured:
        tex_idx, tfx, tfy = texture_quad_coords_c(
            scene_dev, torch.clamp(texid, min=0), cu, cv)
        qr, qg, qb = quad_bilinear_c(quad_table[tex_idx], tfx, tfy)
        sel = (texid >= 0) & hit
        rr = torch.where(sel, qr, rr)
        gg = torch.where(sel, qg, gg)
        bb = torch.where(sel, qb, bb)
    mr, mg, mb = miss_color_c(dirs[:, 0], dirs[:, 1], dirs[:, 2], background)
    return torch.stack([torch.where(hit, rr, mr), torch.where(hit, gg, mg),
                        torch.where(hit, bb, mb)], dim=-1)


def _render_cache(payload, attr_table, scene_dev, quad_table, half_center,
                  half_radius, center, far_mask, width: int, background: int,
                  kmax: int, textured: bool, tex_only: bool = False,
                  tracer=None, tmin: float = 0.0,
                  supersample: int = 1, quads: bool = False) -> torch.Tensor:
    """(H, W, 3) linear-RGB equirect radiance cache of the clusters of
    far_mask from `center` (compound_ray_tpu/eye/pipeline.py:3085): the
    first surface at t >= tmin along each ray, each pixel the mean of
    supersample x supersample rays over its area (the JAX package traces
    one ray, at the pixel's centre).  Each 16x16 block of rays is one
    256-ray group of K2 over its shortlist of at most kmax of those
    clusters (_cache_trace_inputs), traced with the early exit on; the
    winners are resolved and shaded like the frame's hits.  `tracer`
    defaults to run_tracer_kernel (K2); the chip check passes
    cluster_tracer_reference to render through the twin.  With `quads`
    the result is the image's build_equirect_quads, (H, W, 16).  The
    shortlists are span cr.plan.cache.cull, the rest
    cr.plan.cache.trace."""
    ss = supersample
    height, wide = width // 2, width * ss
    bs, tile = _CACHE_BLOCK, _CACHE_TILE
    with span("cr.plan.cache.cull"):
        blocked, counts, ids, dmin, rays = _cache_trace_inputs(
            half_center, half_radius, center, far_mask, wide, kmax, tmin)
    trace = run_tracer_kernel if tracer is None else tracer
    with span("cr.plan.cache.trace"):
        out = trace(counts, ids, dmin, payload, rays, ng=counts.shape[0],
                    nrb=1, rb_size=tile, kmax=kmax, early_exit=True)
        rgb = shade_cluster_hits(
            out, torch.repeat_interleave(counts > 0, tile), blocked,
            attr_table, scene_dev, quad_table, background, textured,
            tex_only)
        # un-block back to row-major, then each pixel the mean of its
        # ss x ss
        image = (rgb.reshape(height * ss // bs, wide // bs, bs, bs, 3)
                 .permute(0, 2, 1, 3, 4).reshape(height, ss, width, ss, 3)
                 .mean(dim=(1, 3)))
        return build_equirect_quads(image) if quads else image


def _farfield_threshold(ommatidia_np: np.ndarray, tol: float) -> float:
    """Parallax-safe distance D = eye extent / (tol * sigma_min)
    (compound_ray_tpu/eye/pipeline.py:3189)."""
    extent = float(np.max(np.linalg.norm(ommatidia_np[:, 0:3], axis=1)
                          + np.abs(ommatidia_np[:, 7])))
    sigma_min = float(np.min(ommatidia_np[:, 6])) / FWHM_SD_RATIO
    if sigma_min <= 0 or extent <= 0:
        return 0.0
    return extent / max(tol * sigma_min, 1e-9)


# rays per cache pixel along each axis, averaged: a pixel holds the mean
# radiance over its area, not the surface at its centre, which would move
# every edge by up to half a pixel (0.18 degrees at width 1024, 0.16 sd of
# a 2.6-degree cone) on top of the parallax that D allows.  The cache is
# built once a pose: at width 1024 on an H100, 1 x 1 takes 4.4 ms, 2 x 2
# 10.3 ms and 4 x 4 35 ms, and a 2.6-degree eye at 3200 samples reads a
# worst ommatidium 0.093, 0.057 and 0.023 off the exact frame
CACHE_SUPERSAMPLE = 2
# the cache store is cleared past this many viewpoints (pose sweeps)
_CACHE_STORE_MAX = 64


def _farfield_split(splan, ommatidia_np, pos_np, ls_np, tol: float):
    """(far (C,) bool, eye centre (3,) f64, D): the clusters whose spheres
    lie wholly beyond the parallax-safe distance D from the eye centre in
    world space, the cache viewpoint (compound_ray_tpu/eye/pipeline.py:
    2461-2470)."""
    d_thresh = _farfield_threshold(ommatidia_np, tol)
    rel_c = ommatidia_np[:, 0:3].mean(axis=0)
    center_np = (np.asarray(pos_np, np.float64)
                 + rel_c @ np.asarray(ls_np, np.float64))
    cdist = np.linalg.norm(splan.sphere_center_np - center_np[None, :],
                           axis=1)
    return (cdist - splan.sphere_radius_np) > d_thresh, center_np, d_thresh


def _farfield_reach(splan, center_np, d_thresh: float) -> np.ndarray:
    """(C,) bool: the clusters whose spheres reach beyond D from the eye
    centre, the far ones and the near ones that straddle D (a ground
    slab): the geometry the cache shows."""
    cdist = np.linalg.norm(splan.sphere_center_np - center_np[None, :],
                           axis=1)
    return (cdist + splan.sphere_radius_np) > d_thresh


def _frame_cache_args(splan, center_np, d_thresh: float) -> Dict[str, Any]:
    """_render_cache's keywords for a frame's cache seen from center_np
    (_farfield_plan): the centre on the device, every cluster that reaches
    past D (_farfield_reach), hits from t = D on, CACHE_SUPERSAMPLE rays a
    side per pixel, and the shortlist's kmax."""
    dev = splan.device
    return dict(
        center=torch.as_tensor(np.asarray(center_np, np.float32),
                               device=dev),
        far_mask=torch.as_tensor(_farfield_reach(splan, center_np, d_thresh),
                                 device=dev),
        kmax=min(splan.num_clusters, 256), tmin=d_thresh,
        supersample=CACHE_SUPERSAMPLE)


@spanned("cr.plan.farfield")
def _farfield_plan(splan, eplan, scene_dev, ommatidia_np, pos_np, ls_np,
                   samples: int, background: int, cfg, tracer=None,
                   lights=None):
    """The far-field split of a frame and its pose-memoised cache
    (compound_ray_tpu/eye/pipeline.py:2437).  Returns (near_mask (C,) bool
    or None, cache or None, far_sphere or None): all None unless the cache
    is on, which needs an unlit frame (lights None: the cached radiance is
    unlit, :2453), farfield="auto", more than 8 clusters, at least as many
    rays as cache pixels and at least one far cluster.

    The split is a sphere of radius D about the eye centre, far_sphere =
    (centre (3,) on the device, D).  The frame traces the clusters that
    meet it (near_mask) and counts a hit only inside it; the cache shows
    the first surface beyond it, K2 tracing from the centre, from t = D on,
    every cluster that reaches past it (_farfield_reach), so the part of a
    near cluster beyond D (a ground slab's) is the cache's too, and cannot
    hide far clusters in front of it (the JAX package's per-cluster split
    lets it).  The cache is (H, W, 16) equirect quads, or for a textured
    scene the combined table of the texture quads followed by the cache
    quads.  It depends on the eye centre, the width, the miss shader and
    D, not on the samples or the RNG, so frames at one pose build it once,
    with the near mask and the centre on the device; `tracer` (K2 by
    default) renders a cache not in splan.cache_store."""
    global cache_builds
    off = (None, None, None)
    if (lights is not None or cfg.farfield != "auto"
            or splan.num_clusters <= 8):
        return off
    width = cfg.farfield_cache_width
    if samples * eplan.n < width * (width // 2):
        return off
    far, center_np, d_thresh = _farfield_split(
        splan, ommatidia_np, pos_np, ls_np, cfg.farfield_tolerance)
    if not far.any():
        return off
    key = (np.asarray(center_np, np.float32).tobytes(), width, background,
           d_thresh)
    hit = splan.cache_store.get(key)
    if hit is None:
        args = _frame_cache_args(splan, center_np, d_thresh)
        with span("cr.plan.build.cache"):
            cache = _render_cache(
                splan.payload, splan.attr_table, scene_dev, splan.quad_table,
                splan.half_center, splan.half_radius, width=width,
                background=background, textured=splan.textured,
                tex_only=splan.tex_only, tracer=tracer, quads=True, **args)
            if splan.textured:
                cache = torch.cat([splan.quad_table, cache.reshape(-1, 16)])
        cache_builds += 1
        if len(splan.cache_store) > _CACHE_STORE_MAX:
            splan.cache_store.clear()
        hit = (torch.as_tensor(~far, device=splan.device), cache,
               args["center"])
        splan.cache_store[key] = hit
    near_t, cache, center_t = hit
    return near_t, cache, (center_t, d_thresh)


# ----------------------------------------------------------------- sky split
# A zero-row group is a shaft that the conservative cull proved empty of
# near geometry: all its samples read the far-field cache.  With the sky
# split on, such groups get their pose-memoised acceptance-cone expectation
# of the cache (a fixed quadrature, once per pose), and the frame traces
# only the live groups, compacted to a multiple of 64
# (compound_ray_tpu/eye/pipeline.py:1751-1770).  Frames are statistically
# interchangeable with the dense path, not bit-identical: the live groups
# draw other rows of the RNG and the sky groups lose their sampling noise.


def _sky_expectation(cache, omms_p, local_space, nq_splay: int,
                     nq_spin: int, cache_shape: Tuple[int, int],
                     row_offset: int) -> torch.Tensor:
    """(Np, 3) expectation of the cache radiance under the acceptance
    distribution (splay ~ N(0, sd), spin ~ U[0, pi)) by quantile-midpoint
    quadrature: splay nodes sd * Phi^-1((i + 0.5) / n), spin nodes
    pi * (j + 0.5) / m, through the same cone offset, world transform and
    equirect bilinear lookup as the samples
    (compound_ray_tpu/eye/pipeline.py:1776)."""
    n_pad = omms_p.shape[0]
    dev = omms_p.device
    sd = omms_p[:, 6] / FWHM_SD_RATIO
    p = (torch.arange(nq_splay, dtype=torch.float32, device=dev) + 0.5) \
        / nq_splay
    z = math.sqrt(2.0) * torch.special.erfinv(2.0 * p - 1.0)
    nq = nq_splay * nq_spin
    splay = (sd[:, None] * z[None, :])[:, :, None].expand(
        n_pad, nq_splay, nq_spin).reshape(n_pad, nq)
    spin_nodes = math.pi * (torch.arange(nq_spin, dtype=torch.float32,
                                         device=dev) + 0.5) / nq_spin
    spin = spin_nodes[None, None, :].expand(n_pad, nq_splay,
                                            nq_spin).reshape(n_pad, nq)
    rdx, rdy, rdz = cone_offset_components(
        omms_p[:, 3:4], omms_p[:, 4:5], omms_p[:, 5:6], splay, spin)
    L = local_space
    wdx = rdx * L[0, 0] + rdy * L[1, 0] + rdz * L[2, 0]
    wdy = rdx * L[0, 1] + rdy * L[1, 1] + rdz * L[2, 1]
    wdz = rdx * L[0, 2] + rdy * L[1, 2] + rdz * L[2, 2]
    inv_n = torch.rsqrt(torch.clamp(wdx * wdx + wdy * wdy + wdz * wdz,
                                    min=1e-60))
    ch, cw = cache_shape
    c_idx, fx, fy = _equirect_coords_c(
        ch, cw, (wdx * inv_n).reshape(-1), (wdy * inv_n).reshape(-1),
        (wdz * inv_n).reshape(-1))
    rows = cache.reshape(-1, cache.shape[-1])[row_offset + c_idx]
    r, g, b = quad_bilinear_c(rows, fx, fy)
    return torch.stack([r.reshape(n_pad, nq).mean(dim=1),
                        g.reshape(n_pad, nq).mean(dim=1),
                        b.reshape(n_pad, nq).mean(dim=1)], dim=-1)


def _compact_live(packed_mm, row_counts, omms_p, gidx, real):
    """The live groups' plan rows (compound_ray_tpu/eye/pipeline.py:1827).
    Padding entries (real == 0) repeat a live group with row_counts 0: K1
    skips them and their means are dropped by the scatter."""
    return packed_mm[gidx], row_counts[gidx] * real, omms_p[gidx]


def _sky_key(eplan, samples, pose_sig, d_thresh, background, affine: bool,
             cfg):
    """sky_store key (compound_ray_tpu/eye/pipeline.py:1835): the refine
    mode and affine-ness are part of it, as of every plan key.  Like the
    JAX key it leaves out the widths: serving the plan must not need the
    dense pack it replaced.  Unlike it, it holds the cache width and the
    miss shader, which the sky means are computed from."""
    return ("sky", eplan.sig, samples, pose_sig, cfg.cull_sigmas,
            cfg.refine_mode, d_thresh, affine, cfg.farfield_cache_width,
            background, cfg.sky_quad_splay, cfg.sky_quad_spin)


def _sky_probe(splan, sk):
    """(found, entry) with an LRU refresh; a found None entry is a pose
    memoised as not worth splitting (compound_ray_tpu/eye/pipeline.py:1848)."""
    if sk in splan.sky_store:
        hit = splan.sky_store.pop(sk)
        splan.sky_store[sk] = hit
        return True, hit
    return False, None


def _sky_put(splan, sk, entry, cfg):
    while len(splan.sky_store) >= cfg.packed_store_size:
        splan.sky_store.pop(next(iter(splan.sky_store)))
    splan.sky_store[sk] = entry


@spanned("cr.plan.build.sky")
def _sky_build(splan, eplan, omms_p, local_space, samples: int, kcand: int,
               rmax: int, cache, cache_shape: Tuple[int, int], row_counts,
               packed_mm, ng_quantum: int = 64):
    """A sky plan from the pose's pack (compound_ray_tpu/eye/pipeline.py:
    1864): (packed_live, rc_live, omms_live, scatter, sky_means, ngl,
    kcand, rmax), or None when more than 90 % of the groups are live (the
    split would only add the scatter).  The live count is rounded up to
    ng_quantum and kept as a high-water mark per (eye, samples), so the
    compacted layout is the JAX package's.  Reads the row counts on the
    host once per new pose."""
    cfg = get_config()
    rc_np = row_counts.cpu().numpy()
    ng = rc_np.shape[0]
    live = np.flatnonzero(rc_np > 0)
    if live.size > 0.9 * ng:
        return None
    hint_key = (eplan.sig, samples, ng_quantum)
    ngl = max(_ceil_to(max(int(live.size), 1), ng_quantum),
              splan.sky_ngl.get(hint_key, 0))
    ngl = _ceil_to(min(ngl, ng), ng_quantum)
    splan.sky_ngl[hint_key] = ngl
    pad = ngl - live.size
    gather = np.concatenate([live, np.zeros(pad, np.int64)])
    scatter = np.concatenate([live, np.full(pad, ng, np.int64)])
    dev = row_counts.device
    packed_live, rc_live, omms_live = _compact_live(
        packed_mm, row_counts, omms_p, torch.as_tensor(gather, device=dev),
        torch.as_tensor((scatter < ng).astype(np.int32), device=dev))
    ch, cw = cache_shape
    row_offset = cache.shape[0] - ch * cw if cache.dim() == 2 else 0
    sky_means = _sky_expectation(
        cache, omms_p, local_space, nq_splay=cfg.sky_quad_splay,
        nq_spin=cfg.sky_quad_spin, cache_shape=(ch, cw),
        row_offset=row_offset)
    return (packed_live, rc_live, omms_live,
            torch.as_tensor(scatter, device=dev), sky_means, ngl, kcand,
            rmax)

# ------------------------------------------------------------ shadow plan
# A lit frame traces one shadow ray per (sample, light).  Each (light,
# group) pair gets its own occluder rows: the triangles that can lie between
# the light and the group's hit points.  The rows are memoised per (eye,
# samples, pose, lights): the first lit frame at a pose probes its own hit
# points with one extra K1 launch, bounds them per group, and packs each
# light's shafts; later frames at the pose pay one K3 launch and the GGX
# math (compound_ray_tpu/eye/pipeline.py:1917-2434).


def _shadow_pseudo_omms(cg, rg, light_pos, ratio: float):
    """(NG, 8) pseudo-ommatidia whose cull cone has its apex at the light
    and covers each group's bound sphere (cg (NG, 3), rg (NG,)), and the
    refine's distance bound dmax (NG,) at the sphere's far side
    (compound_ray_tpu/eye/pipeline.py:1918).  ratio turns a half-angle into
    the omm[6] encoding _cull_groups reads; an empty group (rg < 0) gets a
    zero cone and dmax -1, so it culls everything."""
    d = cg - light_pos[None, :]
    dist = torch.sqrt((d * d).sum(dim=-1))
    axis = d / torch.clamp(dist, min=1e-30)[:, None]
    sin_half = torch.clamp(rg / torch.clamp(dist, min=1e-30), 0.0, 1.0)
    half = torch.where(dist > torch.clamp(rg, min=0.0),
                       torch.arcsin(sin_half), math.pi)
    half = torch.where(rg < 0.0, 0.0, half)
    n = cg.shape[0]
    out = torch.zeros((n, 8), dtype=torch.float32, device=cg.device)
    out[:, 0:3] = light_pos
    out[:, 3:6] = axis
    out[:, 6] = half * ratio
    dmax = torch.where(rg < 0.0, -1.0, dist + rg)
    return out, dmax


def _hit_bound_spheres(hit_f, px, py, pz, ng: int, rg_pad: int):
    """Per-group bounding sphere of the group's hit points (planar kernel-
    order inputs (R,)): centres (NG, 3) and radii (NG,), radius -1 where
    the group hit nothing (compound_ray_tpu/eye/pipeline.py:1940)."""
    big = 3e38
    hm = hit_f.reshape(ng, rg_pad)

    def mm(c):
        c2 = c.reshape(ng, rg_pad)
        return (torch.where(hm, c2, big).amin(dim=1),
                torch.where(hm, c2, -big).amax(dim=1))

    x0, x1 = mm(px)
    y0, y1 = mm(py)
    z0, z1 = mm(pz)
    any_h = hm.any(dim=1)
    cx = torch.where(any_h, 0.5 * (x0 + x1), 0.0)
    cy = torch.where(any_h, 0.5 * (y0 + y1), 0.0)
    cz = torch.where(any_h, 0.5 * (z0 + z1), 0.0)
    dx_, dy_, dz_ = x1 - x0, y1 - y0, z1 - z0
    r = 0.5 * torch.sqrt(dx_ * dx_ + dy_ * dy_ + dz_ * dz_) + 1e-3
    return torch.stack([cx, cy, cz], dim=-1), torch.where(any_h, r, -1.0)


def _sound_bound_spheres(packed_mm, sc_flat, sr_flat):
    """Guaranteed per-group hit bounds from the pack itself: the sphere
    enclosing the bounding spheres of the group's candidate triangles,
    which holds every hit of every frame at this pose
    (compound_ray_tpu/eye/pipeline.py:1966).  Padding columns are found
    by an all-zero normal in the den block."""
    leaf = KERNEL_LEAF
    ids = torch.clamp(packed_mm[:, :, 10, 0:leaf].long(), 0,
                      sr_flat.shape[0] - 1)  # (NG, rmax, 128)
    nmag = torch.abs(packed_mm[:, :, 0:3, 2 * leaf:3 * leaf]).sum(dim=2)
    valid = nmag > 0.0
    c = sc_flat[ids]  # (NG, rmax, 128, 3)
    r = torch.clamp(sr_flat[ids], min=0.0)
    big = 3e38
    lo = torch.where(valid[..., None], c - r[..., None], big).amin(dim=(1, 2))
    hi = torch.where(valid[..., None], c + r[..., None], -big).amax(
        dim=(1, 2))
    any_v = valid.any(dim=2).any(dim=1)
    ctr = torch.where(any_v[:, None], 0.5 * (lo + hi), 0.0)
    ext = hi - lo
    rad = 0.5 * torch.sqrt((ext * ext).sum(dim=-1)) + 1e-3
    return ctr, torch.where(any_v, rad, -1.0)


def mark_shadow_unsound(scene_flat, leak_groups=None, device=None) -> bool:
    """Corrective response to the lit-frame shadow audit
    (compound_ray_tpu/eye/pipeline.py:1997): the groups in `leak_groups`
    (eye-plan group indices, the audit's per-group tail) switch to
    guaranteed candidate-extent bounds; without it the whole scene does
    (shadow_sound_all).  Either way the memoised shadow plans are evicted
    so the next lit frame replans.  Acts on the scene's plan on `device`,
    or on the plan its last frame used.  Returns True when the mode
    changed."""
    if device is not None:
        splan = scene_plan(scene_flat, device)
    else:
        splan = getattr(scene_flat, "_kernel_plan", None)
        if splan is None:
            raise RuntimeError("the scene has no plan yet: render a frame "
                               "first or name the device")
    if leak_groups is None:
        if splan.shadow_sound_all:
            return False
        splan.shadow_sound_all = True
        splan.shadow_store.clear()
        return True
    new = set(int(g_) for g_ in leak_groups) - splan.shadow_unsound_groups
    if not new:
        return False
    splan.shadow_unsound_groups |= new
    splan.shadow_store.clear()
    return True


def _light_frame(device):
    """The light-apexed pseudo-ommatidia's pose: origin, identity axes."""
    return (torch.zeros(3, dtype=torch.float32, device=device),
            torch.eye(3, dtype=torch.float32, device=device))


def _shadow_cull(splan, cg, rg_sph, light_pos, cull_sigmas: float):
    """One light's shafts over all groups: pseudo-ommatidia, the cone cull
    distance-bounded at the sphere's far side, and the nearest-first
    shortlist as wide as the widest shaft needs, its cluster count read to
    the host and rounded up to 8 (compound_ray_tpu/eye/pipeline.py:2144).
    Returns (ps, dmax, counts (NG,), ids (NG, kcand))."""
    ps, dm = _shadow_pseudo_omms(cg, rg_sph, light_pos,
                                 FWHM_SD_RATIO / cull_sigmas)
    zero3, eye3 = _light_frame(cg.device)
    gmask, _, dmin_all = _cull_groups(ps, zero3, eye3, splan.half_center,
                                      splan.half_radius, cull_sigmas, 1)
    gmask = gmask & (dmin_all <= dm[:, None])
    counts = gmask.sum(dim=-1).to(torch.int32)
    kcand = min(splan.num_clusters,
                _ceil_to(max(int(counts.max().item()), 1), 8))
    ids = _shortlist_sorted(gmask, dmin_all, kcand)[0][:, :kcand]
    return ps, dm, counts, ids


def _shadow_probe(packed_mm, row_counts, omms_p, position, local_space,
                  splay, spin, samples: int, ng: int, g: int, nrb: int,
                  rb_size: int, rmax: int, tracer=None,
                  affine: bool = False):
    """The shadow plan's probe (compound_ray_tpu/eye/pipeline.py:2084):
    trace the frame's primary rays once (K1, or `tracer`; its 8-feature
    form on an affine pack), bound each group's hit points and inflate the
    bounds (SHADOW_BOUND_INFLATE).  The JAX probe draws its angles from
    the frame's key (:2099-2100), so it traces exactly the first lit
    frame's rays; here the caller passes that frame's splay and spin.  As
    there, every lane of a live group counts, ray-block padding included.
    Returns the bound spheres (cg (NG, 3), rg_sph (NG,))."""
    rays, origins = run_ray_features(
        omms_p, position, local_space, splay, spin, samples=samples, ng=ng,
        g=g, nrb=nrb, rb_size=rb_size, affine=affine)
    trace = run_packed_tracer if tracer is None else tracer
    t_f = trace(row_counts, packed_mm, rays, ng=ng, nrb=nrb, rb_size=rb_size,
                rmax=rmax, ray_feats=rays.shape[0])[0]
    rg, rg_pad = g * samples, nrb * rb_size
    dx, dy, dz = ray_dirs(rays, ng, g, samples, rg_pad)

    def repad(x):
        return _repad(x, ng, rg, rg_pad)

    hit_f = (t_f < 1e30) & torch.repeat_interleave(row_counts > 0, rg_pad)
    neg_o = _neg_origins(origins, dx, dy, dz)
    t_c = torch.where(hit_f, t_f, 0.0)
    pxf = -repad(neg_o[0]) + t_c * repad(dx)
    pyf = -repad(neg_o[1]) + t_c * repad(dy)
    pzf = -repad(neg_o[2]) + t_c * repad(dz)
    cg, rg_sph = _hit_bound_spheres(hit_f, pxf, pyf, pzf, ng, rg_pad)
    return cg, torch.where(rg_sph >= 0.0,
                           rg_sph * SHADOW_BOUND_INFLATE + 1e-2, rg_sph)


def _shadow_rows(ps, dm, ids, counts, light_pos, splan, cull_sigmas: float,
                 tri_cl):
    """One light's occluder rows for a run of groups, slices of its
    _shadow_cull (compound_ray_tpu/eye/pipeline.py:2028): refine with dmax
    and pack as the primary payload is packed, at the run's own most rows,
    fold the light in as the shared ray origin with tmin 0
    (transform_payload_affine) and keep feature rows 0-7.  Returns (rows
    (n,) on the host, the live rows (sum(rows), 8, 512) group-major, None
    where no group has one)."""
    zero3, eye3 = _light_frame(ps.device)
    _, rows_np, slots = _refine_sorted(
        ps, zero3, eye3, ids, counts, splan.slot_center_cl,
        splan.slot_radius_cl, 1, cull_sigmas, tri_cl,
        splan.mm_flat.shape[0] - 1, dmax=dm)
    r = slots.shape[1] // KERNEL_LEAF
    if r == 0:
        return rows_np, None
    n = slots.shape[0]
    packed_s = transform_payload_affine(
        _gather_payload(splan.mm_flat, slots),
        light_pos[None, :].expand(n, 3),
        torch.zeros(n, dtype=torch.float32, device=ps.device))
    src = np.concatenate([gl * r + np.arange(rows_np[gl]) for gl in range(n)])
    return rows_np, packed_s[:, :, 0:SHADOW_FEATS, :].reshape(
        -1, SHADOW_FEATS, MM_COLS)[torch.as_tensor(src, device=ps.device)]


def _shadow_key(splan, eplan, samples, pose_sig, lights_np, cfg,
                shards: int = 1, affine: bool = False):
    """shadow_store key (compound_ray_tpu/eye/pipeline.py:2240-2243 without
    the rows-per-block field, which is not ported): a plan laid out for
    another number of shards, refined in the other mode or probed through
    the other payload form is another plan."""
    return (eplan.sig, samples, pose_sig, lights_np.tobytes(),
            cfg.cull_sigmas, cfg.refine_mode, shards, affine,
            splan.shadow_sound_all,
            tuple(sorted(splan.shadow_unsound_groups)))


def _shadow_plan(splan, eplan, omms_p, position, local_space, pose_sig,
                 lights_np: np.ndarray, samples: int, splay, spin,
                 packed_mm, row_counts, rmax: int, tracer=None,
                 shards: int = 1, affine: bool = False):
    """The memoised shadow plan of a lit frame
    (compound_ray_tpu/eye/pipeline.py:2200, one row per block):
    (counts (L, NG) int32, r2v (TB,) int32, flag (TB,) int32, flat_rows
    (TB, 8, 512) f32, sph (NG, 4) [centre, radius]).

    Per light, each group's shaft is culled, exact-refined and packed
    from the probed (or, in a corrective mode, guaranteed) bound spheres,
    and the live rows of each chunk's transient dense pack go into one
    table sorted by
    virtual group light * NG + group: flag 2 marks a group's first row, 1
    a live row, 0 padding; TB is padded to a multiple of 64 and padding
    rows inherit the last live group.  With shards > 1 (the mesh plan of
    parallel/sharding.py) the table is laid out shard-major: shard k owns
    groups [k * NG / shards, (k + 1) * NG / shards) and rows [k * TB /
    shards, (k + 1) * TB / shards), its part padded to the largest part's
    multiple of 64, and its r2v holds shard-local virtual groups light *
    NG_local + g_local, so a shard's rows, r2v and flag are a plain slice.
    The probe stays global: one K1 launch over every sample of the frame.
    Chunked over each shard's groups at shadow_pack_chunk, and no wider
    than a refine of every cluster fits in a chunk: an unchunked dense
    pack at 256 clusters takes several GB.  Each light's cull maximum
    comes to the host once and the row counts once per chunk; a plan in
    splan.shadow_store is served as it is."""
    cfg = get_config()
    sk = _shadow_key(splan, eplan, samples, pose_sig, lights_np, cfg, shards,
                     affine)
    hit = splan.shadow_store.get(sk)
    if hit is not None:
        splan.shadow_store[sk] = splan.shadow_store.pop(sk)  # LRU refresh
        return hit
    out = _shadow_build(splan, eplan, omms_p, position, local_space,
                        lights_np, samples, splay, spin, packed_mm,
                        row_counts, rmax, tracer, shards, affine)
    while len(splan.shadow_store) >= cfg.shadow_store_size:
        splan.shadow_store.pop(next(iter(splan.shadow_store)))
    splan.shadow_store[sk] = out
    return out


@spanned("cr.plan.build.shadow")
def _shadow_build(splan, eplan, omms_p, position, local_space,
                  lights_np: np.ndarray, samples: int, splay, spin,
                  packed_mm, row_counts, rmax: int, tracer, shards: int,
                  affine: bool):
    """_shadow_plan's tuple built anew: the probe (or the guaranteed
    bounds), then each light's cull and its shafts packed chunk by
    chunk."""
    cfg = get_config()
    dev = packed_mm.device
    lights = torch.as_tensor(lights_np, device=dev)
    ng = eplan.ng
    sig = cfg.cull_sigmas
    tri_cl = _refine_tri_cl(splan, cfg)
    unsound = splan.shadow_unsound_groups
    if splan.shadow_sound_all or unsound:
        cg_s, rg_s = _sound_bound_spheres(
            packed_mm, splan.slot_center_cl.reshape(-1, 3),
            splan.slot_radius_cl.reshape(-1))
    if splan.shadow_sound_all:
        cg, rg_sph = cg_s, rg_s
    else:
        cg, rg_sph = _shadow_probe(
            packed_mm, row_counts, omms_p, position, local_space, splay,
            spin, samples, ng, eplan.g, eplan.nrb, eplan.rb_size, rmax,
            tracer=tracer, affine=affine)
        if unsound:
            um = np.zeros(ng, bool)
            um[[g_ for g_ in unsound if g_ < ng]] = True
            um_d = torch.as_tensor(um, device=dev)
            cg = torch.where(um_d[:, None], cg_s, cg)
            rg_sph = torch.where(um_d, rg_s, rg_sph)
    n_lights = lights_np.shape[0]
    ngl = ng // shards
    # chunk bounds that fit a shortlist of every cluster: no light's
    # shafts need more
    chunks = _refine_chunks(ngl, 1, splan.num_clusters,
                            max_groups=cfg.shadow_pack_chunk)
    cnts_np = np.zeros((n_lights, ng), np.int64)
    parts = [[] for _ in range(shards)]  # each shard's live rows, in order
    for li in range(n_lights):
        ps, dm, counts, ids = _shadow_cull(splan, cg, rg_sph,
                                           lights[li, 4:7], sig)
        for k in range(shards):
            for lo, hi in chunks:
                lo, hi = k * ngl + lo, k * ngl + hi
                rows_np, live = _shadow_rows(
                    ps[lo:hi], dm[lo:hi], ids[lo:hi], counts[lo:hi],
                    lights[li, 4:7], splan, sig, tri_cl)
                cnts_np[li, lo:hi] = rows_np
                if live is not None:
                    parts[k].append(live)
    # shard k's counts in its virtual group order light * NG_local + g
    cnt_k = [cnts_np[:, k * ngl:(k + 1) * ngl].reshape(-1)
             for k in range(shards)]
    tb = _ceil_to(max(max(int(c.sum()) for c in cnt_k), 1), 64)
    r2v_np = np.zeros(shards * tb, np.int32)
    flag_np = np.zeros(shards * tb, np.int32)
    tables = []
    for k, cnt in enumerate(cnt_k):
        rows = int(cnt.sum())
        r2v, flag = r2v_np[k * tb:(k + 1) * tb], flag_np[k * tb:(k + 1) * tb]
        live_v = np.flatnonzero(cnt)
        if rows:
            r2v[:rows] = np.repeat(live_v, cnt[live_v])
            flag[:rows] = 1
            flag[np.cumsum(cnt[live_v]) - cnt[live_v]] = 2
            # padding rows inherit the last live group
            r2v[rows:] = r2v[rows - 1]
        tables += parts[k] + [torch.zeros((tb - rows, SHADOW_FEATS, MM_COLS),
                                          dtype=torch.float32, device=dev)]
    flat_rows = torch.cat(tables) if len(tables) > 1 else tables[0]
    return (torch.as_tensor(cnts_np.astype(np.int32), device=dev),
            torch.as_tensor(r2v_np, device=dev),
            torch.as_tensor(flag_np, device=dev), flat_rows,
            torch.cat([cg, rg_sph[:, None]], dim=-1))


def _shading_rows(splan, scene_dev):
    """The scene's build_shading_rows table, built once per plan."""
    if splan.shading_rows is None:
        splan.shading_rows = build_shading_rows(scene_dev)
    return splan.shading_rows


@spanned("cr.plan")
def _plan_frame(scene_flat, scene_dev: Dict[str, Any], omms_np: np.ndarray,
                position, local_space, generator: torch.Generator,
                samples: int, background: int, lights=None, tracer=None,
                cache_tracer=None, shadow_tracer=None, omm_axis: int = 1,
                allow_cache: bool = True, angles=None):
    """Shared frame planning (compound_ray_tpu/eye/pipeline.py:2516-2673,
    without the speculative widths): the far-field split and its cache,
    the sky plan and the pose's pack at its widths, then frame 0's (Np, S)
    angles from `generator` and, for a lit frame, the memoised shadow plan,
    whose first build at a pose probes those angles.  Returns (kw,
    inv_valid): kw holds every _trace_shade_angles argument (frame 0's
    splay and spin among them) but shadow_audit, and inv_valid (N,) puts
    the permuted rows back in ommatidium order.  render_means and the
    bursts both plan here, at S samples, so a burst makes the decisions
    of its frame 0 (the far-field gate, the sky key, the shadow plan).

    The mesh plan of parallel/sharding.py (compound_ray_tpu/parallel/
    sharding.py:75-199) plans here too, with omm_axis shards of the group
    axis: the group count padded to a multiple of it, the sky split's live
    count to a multiple of lcm(64, omm_axis) under a key that holds the
    axis, and the shadow table laid out shard-major.  allow_cache=False
    keeps the far-field cache (and so the sky split) off, as raw samples
    need; angles (splay, spin) replaces the draw from `generator`.

    config.affine_rays applies where the eye plan has one ommatidium per
    group (:2567): the pack, the sky plan and the shadow probe are then
    affine, kw["affine"] is True and every frame core traces K1's
    8-feature form; elsewhere the flag changes nothing."""
    device = (generator if angles is None else angles[0]).device
    splan = scene_plan(scene_flat, device)
    eplan = eye_plan(omms_np, samples, ng_multiple=omm_axis)
    omms_p, inv_valid = eplan.device_arrays(omms_np, device)
    pos_np = np.asarray(position, np.float32)
    ls_np = np.asarray(local_space, np.float32)
    pose_sig = (pos_np.tobytes(), ls_np.tobytes())
    pos = torch.as_tensor(pos_np, device=device)
    ls = torch.as_tensor(ls_np, device=device)
    cfg = get_config()
    lit = lights is not None
    affine = bool(cfg.affine_rays) and eplan.g == 1
    near_mask = cache = far_sphere = None
    if allow_cache:
        near_mask, cache, far_sphere = _farfield_plan(
            splan, eplan, scene_dev, omms_np, pos_np, ls_np, samples,
            background, cfg, tracer=cache_tracer, lights=lights)
    use_cache = near_mask is not None
    d_thresh = far_sphere[1] if use_cache else 0.0
    cache_shape = (cfg.farfield_cache_width // 2, cfg.farfield_cache_width)
    sky = sky_key = None
    if cfg.sky_split and use_cache and not lit and eplan.g == 1:
        sky_key = _sky_key(eplan, samples, pose_sig, d_thresh, background,
                           affine, cfg)
        if omm_axis > 1:
            sky_key += (omm_axis,)
        found, sky = _sky_probe(splan, sky_key)
        if found:
            sky_key = None  # a memoised plan, or memoised not worth it
    if sky is None:
        row_counts, packed_mm, kcand, rmax = _packed_plan(
            splan, eplan, omms_p, pos, ls, pose_sig, samples,
            near_mask=near_mask, d_thresh=d_thresh, affine=affine)
        if sky_key is not None:
            sky = _sky_build(splan, eplan, omms_p, ls, samples, kcand, rmax,
                             cache, cache_shape, row_counts, packed_mm,
                             ng_quantum=int(np.lcm(64, omm_axis)))
            _sky_put(splan, sky_key, sky, cfg)
            if sky is not None:
                # the compacted plan supersedes the dense pack at this pose
                splan.packed_store.pop(_packed_key(
                    eplan, samples, pose_sig, True, d_thresh, cfg, affine),
                    None)
    ng, omms_f = eplan.ng, omms_p
    sky_means = sky_scatter = None
    if sky is not None:
        (packed_mm, row_counts, omms_f, sky_scatter, sky_means, ng, kcand,
         rmax) = sky
    if angles is None:
        with span("cr.plan.angles"):
            splay, spin = sample_angles_ns(
                generator, omms_f[:, 6] / FWHM_SD_RATIO, samples)
    else:
        splay, spin = angles
    kw = dict(
        packed_mm=packed_mm, row_counts=row_counts,
        attr_table=splan.attr_table, scene_dev=scene_dev,
        quad_table=splan.quad_table, omms_p=omms_f, position=pos,
        local_space=ls, splay=splay, spin=spin, samples=samples,
        background=background, ng=ng, g=eplan.g, nrb=eplan.nrb,
        rb_size=eplan.rb_size, rmax=rmax, textured=splan.textured,
        tex_only=splan.tex_only, tracer=tracer, cache=cache,
        cache_shape=cache_shape, far_sphere=far_sphere, sky_means=sky_means,
        sky_scatter=sky_scatter, affine=affine)
    if lit:
        lights_np = np.ascontiguousarray(np.asarray(lights, np.float32))
        kw.update(
            lights=torch.as_tensor(lights_np, device=device),
            slot_tri=splan.slot_tri,
            shading_rows=_shading_rows(splan, scene_dev),
            shadow=_shadow_plan(splan, eplan, omms_p, pos, ls, pose_sig,
                                lights_np, samples, splay, spin, packed_mm,
                                row_counts, rmax, tracer=tracer,
                                shards=omm_axis, affine=affine),
            shadow_tracer=shadow_tracer)
    return kw, inv_valid


def render_means(scene_flat, scene_dev: Dict[str, Any],
                 omms_np: np.ndarray, position, local_space,
                 generator: torch.Generator, samples: int, background: int,
                 lights=None, shadow_audit: bool = False, tracer=None,
                 cache_tracer=None, shadow_tracer=None, shader=None):
    """One frame: (N, 3) mean radiance per ommatidium in the original
    ommatidium order (compound_ray_tpu/eye/pipeline.py:2676,
    render_means_pallas, planned by _plan_frame).  The frame runs on the
    generator's device; scene_dev must live there too.  position (3,) and
    local_space (3, 3) are host arrays: the pose keys the memoised plans.

    lights (L, 7) host rows [colour, intensity, position] light the frame:
    the far-field cache and the sky split are off, the dense pack is traced
    by K1 and the shadow rays by K3 over the memoised shadow plan, whose
    first build at a pose probes this frame's own rays (one more K1
    launch).  With shadow_audit a lit frame returns (means, audit), audit
    = [out-of-shaft hits, hits, per-group out-of-shaft hits] (int64 on the
    device).  `tracer`, `cache_tracer`, `shadow_tracer` and `shader`
    replace K1, K2, K3 and the unlit shading kernel (the chip check
    renders through the twins with them)."""
    kw, inv_valid = _plan_frame(
        scene_flat, scene_dev, omms_np, position, local_space, generator,
        samples, background, lights=lights, tracer=tracer,
        cache_tracer=cache_tracer, shadow_tracer=shadow_tracer)
    audit_on = lights is not None and shadow_audit
    out = _trace_shade_angles(shadow_audit=audit_on, shader=shader, **kw)
    if audit_on:
        means_p, audit = out
        return means_p[inv_valid], audit
    return out[inv_valid]


# ------------------------------------------------------------------ bursts
# F frames at one pose on one plan, each frame drawing its angles from its
# own generator, so every frame is the render_means frame of that generator
# (compound_ray_tpu/eye/pipeline.py:2744-2887).  Small bursts stack the
# frames on the sample axis and trace them with one K1 launch; past
# STACK_BURST_MAX_SAMPLES rays per ommatidium the kernel is no longer
# launch-bound and the (Np, F * S) temporaries grow, so the frames run one
# frame core each, with no host sync between them.

STACK_BURST_MAX_SAMPLES = 4096


def _frame_angles(kw, generators, samples: int):
    """Each frame's (splay, spin), (Np, S) each: frame 0's from the plan,
    frame f's drawn from generators[f] as _plan_frame draws frame 0's."""
    yield kw["splay"], kw["spin"]
    sd = kw["omms_p"][:, 6] / FWHM_SD_RATIO
    for gen in generators[1:]:
        yield sample_angles_ns(gen, sd, samples)


def _render_frames_scanned(kw, angles) -> torch.Tensor:
    """(F, Np, 3): one frame core per frame on the one plan
    (compound_ray_tpu/eye/pipeline.py:2744, a lax.scan there)."""
    return torch.stack([_trace_shade_angles(**dict(kw, splay=sp, spin=sn))
                        for sp, sn in angles])


def _render_frames_stacked(kw, angles) -> torch.Tensor:
    """(F, Np, 3) from one frame core over the frames stacked on the sample
    axis (compound_ray_tpu/eye/pipeline.py:2801): column f * S + s is frame
    f's sample s, so K1 traces the burst in one launch over ray blocks F
    times longer.  The blocks keep eye_plan's rule, one per group padded to
    the ray batch; a ray's result does not depend on its block."""
    splay, spin = (torch.stack(x, dim=1) for x in zip(*angles))  # (Np, F, S)
    n_pad, f, s = splay.shape
    out = _trace_shade_angles(**dict(
        kw, splay=splay.reshape(n_pad, f * s), spin=spin.reshape(n_pad, f * s),
        samples=f * s, nrb=1, rb_size=_ceil_to(kw["g"] * f * s,
                                                MM_BATCH_RAYS), frames=f))
    return out.reshape(out.shape[0], f, 3).transpose(0, 1)


def render_means_frames(scene_flat, scene_dev: Dict[str, Any],
                        omms_np: np.ndarray, position, local_space,
                        generators, samples: int, background: int,
                        lights=None, tracer=None, cache_tracer=None,
                        shadow_tracer=None, shader=None) -> torch.Tensor:
    """(F, N, 3) means of F consecutive frames at one pose, frame f drawn
    from generators[f] (compound_ray_tpu/eye/pipeline.py:2854,
    render_means_pallas_frames): planned once by _plan_frame from frame 0,
    then stacked when 1 < F * S <= STACK_BURST_MAX_SAMPLES (one K1 launch;
    lit, one K3 launch), else scanned (F of each).  Frame f equals
    render_means(generators[f]) on the same plan.  No frame is audited
    against its shadow shafts.  The tracers and the shader are
    render_means'."""
    kw, inv_valid = _plan_frame(
        scene_flat, scene_dev, omms_np, position, local_space, generators[0],
        samples, background, lights=lights, tracer=tracer,
        cache_tracer=cache_tracer, shadow_tracer=shadow_tracer)
    kw["shader"] = shader
    stacked = 1 < len(generators) * samples <= STACK_BURST_MAX_SAMPLES
    burst = _render_frames_stacked if stacked else _render_frames_scanned
    return burst(kw, _frame_angles(kw, generators, samples))[:, inv_valid]


def render_samples(scene_flat, scene_dev: Dict[str, Any],
                   omms_np: np.ndarray, position, local_space,
                   generator: torch.Generator, samples: int,
                   background: int, tracer=None) -> torch.Tensor:
    """One unlit frame's raw samples: (S, N, 3) radiance, sample s of
    ommatidium o at [s, o] in the original ommatidium order, the
    reference's compound sample buffer layout
    (compound_ray_tpu/eye/pipeline.py:2890, render_samples_pallas).  The
    dense pack traced by K1, with neither the far-field cache nor the sky
    split; the angles are the ones render_means draws from the same
    generator with the far field off.  `tracer` replaces K1, as in
    render_means."""
    kw, inv_valid = _plan_frame(
        scene_flat, scene_dev, omms_np, position, local_space, generator,
        samples, background, tracer=tracer, allow_cache=False)
    raw_p = _trace_shade_angles(want_samples=True, **kw)
    return raw_p[inv_valid].transpose(0, 1)
