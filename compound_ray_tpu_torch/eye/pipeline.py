"""The compound-eye frame, unlit and lit: planning, packing, tracing,
shading (compound_ray_tpu/eye/pipeline.py in torch).

Per frame:
  1. plan (memoised): scene tables (scene_plan), the eye's group layout
     (eye_plan), the far-field split and its radiance cache (_farfield_plan
     -> _render_cache on K2, trace/cluster_tracer.py), the kernel widths at
     this pose (_plan_widths) and the pose's packed payload (_packed_plan ->
     _pack_fused: cone cull -> near clusters -> cluster shortlist ->
     per-triangle refine -> payload pack); with the sky split on, the
     compacted live groups and the sky groups' cache expectation
     (_sky_build);
  2. draw (N, S) cone-jitter angles from the caller's torch.Generator;
     a lit frame then takes its memoised shadow plan (_shadow_plan: a K1
     probe of the first frame's hit points at the pose, per-light occluder
     shafts, one ragged table of reverse-affine occluder rows);
  3. _trace_shade_angles: world rays -> K1 (trace/mm_tracer.py) -> winner
     attributes -> texture -> GGX direct light with shadow rays on K3 when
     lit -> miss shading or the far-field cache -> per-ommatidium mean,
     returned in the original ommatidium order.
A burst (render_means_frames) plans once and renders F frames at the
pose, stacked on the sample axis into one frame core or one frame core
each; raw samples (render_samples) are the frame core's samples before
the mean.

Ommatidia are permuted by view direction so that groups of G neighbours
share coherent shortlists (G shrinks to 1 once an ommatidium's samples fill
a ray block).  Ray directions are unit length and tmin is rescaled by
|axis|, so the tracer's t is a world distance.

Not ported here (TPU workarounds or later slices of ROADMAP.md): precision
modes, direct1, the uv/uvs/flat/loc emit variants (the lit path's one-hot
local resolve is a plain indexed gather here), affine primary rays, the
shadow table's rows-per-block and shard layouts, speculative widths, the
polynomial equirect addressing (FAST_EQUIRECT), bf16 texture-and-cache
tables and the sharded path.
"""

from __future__ import annotations

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
from compound_ray_tpu_torch.trace.attrs import (
    ATTR_COMPS_FLAT,
    KERNEL_LEAF,
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

# (groups x candidate slots) elements per refine chunk: the refine keeps
# ~60 temporaries of this size alive, so 2**23 f32 elements (32 MB) bounds
# its peak near 2 GB whatever the shortlist width
_REFINE_CHUNK_ELEMS = 1 << 23

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
    kmax_cache: Dict = field(default_factory=dict)  # pose -> (kcand, rmax)
    packed_store: Dict = field(default_factory=dict)  # bounded LRU of packs
    cache_store: Dict = field(default_factory=dict)  # viewpoint -> cache
    sky_store: Dict = field(default_factory=dict)  # pose -> sky plan, LRU
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


def eye_plan(ommatidia: np.ndarray, samples: int) -> EyePlan:
    """Static layout for an (eye, samples) pair
    (compound_ray_tpu/eye/pipeline.py:354).  Padding replicates the last
    ommatidium in the scan order; padded outputs are dropped by inv_valid.
    Memoised in an LRU of EYE_PLAN_STORE_SIZE plans (the JAX memo has no
    bound); a plan built again has the same signature, so the width and
    pack memos keyed by it still serve it."""
    h = hashlib.blake2b(np.ascontiguousarray(ommatidia).tobytes(),
                        digest_size=12).hexdigest()
    key = (h, samples, 1)
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
    n_pad = _ceil_to(n, g)
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


def _refine_mask(omms_p, position, local_space, ids, cl_counts, center_cl,
                 radius_cl, g: int, cull_sigmas: float, tri_cl, dmax=None):
    """Level-2 cull of the shortlisted clusters' triangles against the cones
    (compound_ray_tpu/eye/pipeline.py:486, refine_mode="exact"): the
    triangle-sphere test, then the exact cone-vs-triangle test on the unit
    sphere around the apex (a triangle meets the cone iff a vertex lies in
    the cap, an edge arc passes within `half` of the axis, or the axis
    pierces the triangle; 1e-3 rad slack).  Works on any run of whole
    groups: omms_p holds their g * len(ids) ommatidia.  dmax (Np,), the
    shadow refine's apex-distance bound, also drops triangles whose sphere
    starts beyond it (:636-639).  Returns (mask, dist, slots), each
    (NG, kcand*128)."""
    apex, axis = eye_world_geometry(omms_p, position, local_space)
    half = torch.clamp(omms_p[:, 6] / FWHM_SD_RATIO * cull_sigmas,
                       max=math.pi)
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
    slack = 1e-3  # rad; absorbs f32 sign noise at arc/vertex boundaries
    hs = torch.clamp(half + slack, max=math.pi)[:, None]  # (Np, 1)
    cosh = torch.cos(hs)
    sinh = torch.sin(torch.clamp(hs, max=math.pi / 2.0))
    wide = hs >= math.pi / 2.0

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
        m = m & (dist - rb <= dmax[:, None])
    if g > 1:
        m = m.reshape(ng, g, kc).any(dim=1)
        dist = dist.reshape(ng, g, kc).amin(dim=1)
    cand = torch.arange(kcand, device=ids.device)
    cand_valid = (cand[None, :] < cl_counts[:, None])[:, :, None].expand(
        ng, kcand, KERNEL_LEAF).reshape(ng, kc)
    # r < 0 marks padding slots: their zero centroid could otherwise pass
    # the angular test whenever the cone looks at the origin
    mask = m & cand_valid & (r >= 0.0)
    slots = (ids[:, :, None] * KERNEL_LEAF
             + torch.arange(KERNEL_LEAF, device=ids.device)).reshape(ng, kc)
    return mask, dist, slots


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


def _refine_counts(omms_p, position, local_space, half_center, half_radius,
                   center_cl, radius_cl, g: int, kcand: int,
                   cull_sigmas: float, tri_cl, near_mask=None):
    """Packed payload rows per group at this pose
    (compound_ray_tpu/eye/pipeline.py:660), over the near clusters only
    when near_mask (C,) is given."""
    gmask, counts, dmin_all = _cull_groups(
        omms_p, position, local_space, half_center, half_radius,
        cull_sigmas, g)
    gmask, counts = _near_counts(gmask, counts, near_mask)
    ids = _shortlist_sorted(gmask, dmin_all, kcand)[0][:, :kcand]
    cl_counts = torch.clamp(counts, max=kcand)
    parts = []
    for g0, g1 in _refine_chunks(ids.shape[0], g, kcand):
        mask, _, _ = _refine_mask(
            omms_p[g0 * g:g1 * g], position, local_space, ids[g0:g1],
            cl_counts[g0:g1], center_cl, radius_cl, g, cull_sigmas,
            tri_cl=tri_cl)
        parts.append(_rows(mask.sum(dim=-1)))
    return torch.cat(parts)


def _refine_pack(omms_p, position, local_space, ids, cl_counts, center_cl,
                 radius_cl, mm_flat, g: int, kcand: int, rmax: int,
                 cull_sigmas: float, tri_cl, dmax=None):
    """Refine + compact: the surviving triangles' feature columns, nearest
    first, as per-group (rmax, 16, 512) payload blocks
    (compound_ray_tpu/eye/pipeline.py:681).  Returns (row_counts (NG,)
    int32, packed_mm (NG, rmax, 16, 512)).  Padding columns point at the
    all-zero PAD rows of mm_flat.  Equal distances may pack in another
    order than the JAX package's unstable co-sort; the slot sets agree.
    dmax (Np,) bounds the refine as in _refine_mask (the shadow pack)."""
    ng = ids.shape[0]
    pad_slot = mm_flat.shape[0] - 1
    row_counts = torch.empty(ng, dtype=torch.int32, device=ids.device)
    packed_mm = torch.empty((ng, rmax, MM_FEATS, MM_COLS),
                            dtype=torch.float32, device=ids.device)
    for g0, g1 in _refine_chunks(ng, g, kcand):
        mask, dist, slots = _refine_mask(
            omms_p[g0 * g:g1 * g], position, local_space, ids[g0:g1],
            cl_counts[g0:g1], center_cl, radius_cl, g, cull_sigmas,
            tri_cl=tri_cl,
            dmax=None if dmax is None else dmax[g0 * g:g1 * g])
        # the tracer loops row_counts[g] rows of an rmax block: never more
        row_counts[g0:g1] = torch.clamp(_rows(mask.sum(dim=-1)), max=rmax)
        key = torch.where(mask, dist, torch.inf)
        sk, order = torch.sort(key, dim=-1, stable=True)
        sk = sk[:, :rmax * KERNEL_LEAF]
        ss = slots.gather(-1, order[:, :rmax * KERNEL_LEAF])
        packed_slot = torch.where(torch.isfinite(sk), ss, pad_slot)
        gathered = mm_flat[packed_slot]  # (G, rmax*128, 64)
        packed_mm[g0:g1] = (
            gathered.reshape(g1 - g0, rmax, KERNEL_LEAF, MM_BLOCKS, MM_FEATS)
            .permute(0, 1, 4, 3, 2)
            .reshape(g1 - g0, rmax, MM_FEATS, MM_COLS))
    return row_counts, packed_mm


def _pack_fused(mm_flat, slot_center_cl, slot_radius_cl, half_center,
                half_radius, omms_p, position, local_space, g: int,
                kcand: int, rmax: int, cull_sigmas: float, tri_cl,
                near_mask=None):
    """Pose-dependent plan: cull -> shortlist -> triangle refine -> packed
    per-group payload (compound_ray_tpu/eye/pipeline.py:906).  With the
    far-field cache on, near_mask (C,) bool keeps only the near clusters:
    the cache serves the far ones.  Depends only on (scene, eye, pose,
    widths, far-field split), not on the RNG or the sample count.
    Returns (row_counts, packed_mm)."""
    gmask, counts, dmin_all = _cull_groups(
        omms_p, position, local_space, half_center, half_radius,
        cull_sigmas, g)
    gmask, counts = _near_counts(gmask, counts, near_mask)
    ids = _shortlist_sorted(gmask, dmin_all, kcand)[0][:, :kcand]
    cl_counts = torch.clamp(counts, max=kcand)
    return _refine_pack(
        omms_p, position, local_space, ids, cl_counts, slot_center_cl,
        slot_radius_cl, mm_flat, g, kcand, rmax, cull_sigmas, tri_cl=tri_cl)


def _plan_widths(splan, eplan, omms_p, position, local_space, cache_key,
                 near_mask=None):
    """Kernel widths for a (scene, eye, samples, pose, far-field split):
    kcand (candidate clusters for the refine) and rmax (payload rows per
    group), measured exactly with two planning passes over the clusters
    the pack will trace (near_mask, when the cache is on) and memoised;
    high-water rounding as in compound_ray_tpu/eye/pipeline.py:1552.  The
    caller's cache_key must tell far-field splits apart, as the JAX
    package's width key does with (use_cache, d_thresh) (:1700-1701)."""
    cfg = get_config()
    sig = cfg.cull_sigmas
    cache_key = cache_key + (sig,)
    cached = splan.kmax_cache.get(cache_key)
    if cached is not None:
        return cached
    gmask, counts, _ = _cull_groups(
        omms_p, position, local_space, splan.half_center, splan.half_radius,
        sig, eplan.g)
    _, counts = _near_counts(gmask, counts, near_mask)
    k_needed = int(counts.max().item())
    kcand = min(splan.num_clusters,
                max(eplan.kmax_hint, _ceil_to(max(k_needed, 1), 8)))
    row_counts = _refine_counts(
        omms_p, position, local_space, splan.half_center, splan.half_radius,
        splan.slot_center_cl, splan.slot_radius_cl, eplan.g, kcand, sig,
        tri_cl=splan.slot_tri_cl, near_mask=near_mask)
    r_needed = int(row_counts.max().item())
    rmax = min(max(eplan.rmax_hint, _ceil_to(max(r_needed, 1), 2)), kcand)
    eplan.kmax_hint = kcand  # high-water: nearby poses reuse the widths
    eplan.rmax_hint = rmax
    splan.kmax_cache[cache_key] = (kcand, rmax)
    return kcand, rmax


def _packed_key(eplan, samples, pose_sig, kcand, rmax, use_cache: bool,
                d_thresh: float, cfg):
    """packed_store key (compound_ray_tpu/eye/pipeline.py:1625): the
    far-field split is part of it, so a dense pack and a near-masked pack
    at one pose are never served for each other."""
    return (eplan.sig, samples, pose_sig, kcand, rmax, use_cache, d_thresh,
            cfg.cull_sigmas)


def _pack_nbytes(pack) -> int:
    """Device bytes of a (row_counts, packed_mm) pack."""
    return sum(t.numel() * t.element_size() for t in pack)


def _packed_plan(splan, eplan, omms_p, position, local_space, pose_sig,
                 samples, kcand, rmax, near_mask=None, d_thresh=0.0):
    """Memoised _pack_fused with a bounded LRU
    (compound_ray_tpu/eye/pipeline.py:1594): a fixed-pose sequence of
    frames pays the refine and pack once.  near_mask and d_thresh describe
    the far-field split (None and 0.0 with the cache off).  The store keeps
    at most config.packed_store_size packs and config.packed_store_bytes
    bytes: the oldest go until a new pack fits, and a pack larger than the
    byte bound serves its frame without being kept."""
    cfg = get_config()
    pk = _packed_key(eplan, samples, pose_sig, kcand, rmax,
                     near_mask is not None, d_thresh, cfg)
    hit = splan.packed_store.get(pk)
    if hit is not None:
        splan.packed_store[pk] = splan.packed_store.pop(pk)  # LRU refresh
        return hit
    out = _pack_fused(
        splan.mm_flat, splan.slot_center_cl, splan.slot_radius_cl,
        splan.half_center, splan.half_radius, omms_p, position, local_space,
        g=eplan.g, kcand=kcand, rmax=rmax, cull_sigmas=cfg.cull_sigmas,
        tri_cl=splan.slot_tri_cl, near_mask=near_mask)
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


def _gen_ray_features(omms_p, position, local_space, splay, spin,
                      samples: int, ng: int, g: int, nrb: int, rb_size: int):
    """Sample angles -> world rays -> K1's planar features
    (compound_ray_tpu/eye/pipeline.py:1057, 16-feature form).

    Returns (rays (16, NG*rg_pad) [d, m, -o', 1, 0 x 6], (dx, dy, dz)) with
    (Np, S) unit world directions.  Each group's ray block is edge-padded
    (the last real ray repeated) so padded rays stay finite."""
    (ox, oy, oz), tmin_w, (ax, ay, az), _ = _omm_world_origins(
        omms_p, position, local_space)
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
    tmin = tmin_w[:, None]
    oxb, oyb, ozb = ox[:, None], oy[:, None], oz[:, None]
    # Plücker moment m = o x d; tmin folded into the origin, o' = o + tmin d
    mx = oyb * dz - ozb * dy
    my = ozb * dx - oxb * dz
    mz = oxb * dy - oyb * dx
    ones = torch.ones_like(dx)
    zeros = torch.zeros_like(dx)
    comps = [dx, dy, dz, mx, my, mz, -(oxb + tmin * dx), -(oyb + tmin * dy),
             -(ozb + tmin * dz), ones]
    comps += [zeros] * (RAY_FEATS - len(comps))
    rg = g * samples
    rg_pad = nrb * rb_size
    rays = torch.stack([c.reshape(ng, rg) for c in comps])  # (16, NG, rg)
    if rg_pad != rg:
        rays = F.pad(rays, (0, rg_pad - rg), mode="replicate")
    return rays.reshape(RAY_FEATS, ng * rg_pad), (dx, dy, dz)


def _repad(x, ng: int, rg: int, rg_pad: int):
    """(Np, S) -> (R,) in kernel ray order, each group's block zero-padded
    to rg_pad (the JAX lit branch's repad, compound_ray_tpu/eye/
    pipeline.py:1329-1333; bool planes pad with False)."""
    x2 = x.reshape(ng, rg)
    if rg_pad != rg:
        x2 = torch.cat([x2, x2.new_zeros((ng, rg_pad - rg))], dim=1)
    return x2.reshape(-1)


def _neg_origins(omms_p, position, local_space, dx, dy, dz):
    """-o' = -(o + tmin d), the tmin-shifted ray origins negated, as (Np, S)
    planes: the lit branch and the shadow probe rebuild hit points from
    them (compound_ray_tpu/eye/pipeline.py:1099-1101).  Bit-equal to the
    rows 6-8 that _gen_ray_features puts into the rays."""
    (ox, oy, oz), tmin_w, _, _ = _omm_world_origins(omms_p, position,
                                                    local_space)
    tmin = tmin_w[:, None]
    return (-(ox[:, None] + tmin * dx), -(oy[:, None] + tmin * dy),
            -(oz[:, None] + tmin * dz))


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


def _trace_shade_angles(packed_mm, row_counts, attr_table, scene_dev,
                        quad_table, omms_p, position, local_space, splay,
                        spin, samples: int, background: int, ng: int, g: int,
                        nrb: int, rb_size: int, rmax: int, textured: bool,
                        tex_only: bool, tracer=None, cache=None,
                        cache_shape: Tuple[int, int] = (0, 0),
                        sky_means=None, sky_scatter=None, lights=None,
                        slot_tri=None, shading_rows=None, shadow=None,
                        shadow_audit: bool = False, shadow_tracer=None,
                        want_samples: bool = False, frames: int = 1):
    """Angle-parameterised frame core: trace + shade + reduce
    (compound_ray_tpu/eye/pipeline.py:1134, branches :1191-1545).  Returns
    (Np, 3) means in permuted order, or (means, audit) for a lit frame with
    shadow_audit; with want_samples, the (Np, S, 3) samples before the mean
    (:1516-1517).  frames = F > 1 is a stacked burst (:1518-1536):
    `samples` is then F * S, column f * S + s of splay and spin is frame
    f's sample s, and the means are (Np, F, 3), each frame's the same
    contiguous S-column reduction a single frame makes.  `tracer` defaults to
    run_packed_tracer (K1) and `shadow_tracer` to run_rows_occlusion (K3);
    the chip check passes the twins to render through them.

    lights (L, 7) on the frame's device turns on GGX direct light with
    shadow rays (_lit_epilogue), which needs slot_tri, shading_rows and the
    _shadow_plan tuple `shadow`; the far-field cache is then off.

    cache is the far-field cache of _farfield_plan: (H, W, 16) equirect
    quads, or for a textured scene the combined (P + H*W, 16) table of
    texture quads followed by cache quads, with cache_shape (H, W).  Rays
    that miss the near clusters then read the cache in place of the miss
    shader; in the combined table, textured hits and cache lookups share
    one row gather (:1253-1281).  sky_means (Ng0, 3) and sky_scatter (Np,)
    are the sky split's base means and the group each row's mean replaces
    (rows pointing past Ng0 are dropped; :1537-1542)."""
    n_pad = omms_p.shape[0]
    rg = g * samples
    rg_pad = nrb * rb_size
    rays, (dx, dy, dz) = _gen_ray_features(
        omms_p, position, local_space, splay, spin, samples=samples, ng=ng,
        g=g, nrb=nrb, rb_size=rb_size)
    trace = run_packed_tracer if tracer is None else tracer
    out = trace(row_counts, packed_mm, rays, ng=ng, nrb=nrb, rb_size=rb_size,
                rmax=rmax)
    t_f, cu_f, cv_f, texid_f, rgb_f = resolve_kernel_hits(
        out, attr_table, tex_only)

    def unpad(x):
        return x.reshape(ng, rg_pad)[:, :rg].reshape(n_pad, samples)

    t = unpad(t_f)
    # groups with empty payloads are misses whatever their rows hold
    group_live = torch.repeat_interleave(row_counts > 0, g)[:, None]
    hit = (t < 1e30) & group_live
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
        ch, cw = cache_shape
        c_idx, cfx, cfy = _equirect_coords_c(
            ch, cw, dx.reshape(-1), dy.reshape(-1), dz.reshape(-1))
        sel_tex = (hit & (texid >= 0)).reshape(-1)
        idx = torch.where(sel_tex, tex_idx, cache.shape[0] - ch * cw + c_idx)
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
        if lights is not None:
            rr, gg, bb, audit = _lit_epilogue(
                out, hit, rr, gg, bb, dx, dy, dz,
                _neg_origins(omms_p, position, local_space, dx, dy, dz),
                scene_dev, shading_rows, slot_tri, lights, shadow, samples,
                ng, g, nrb, rb_size, shadow_audit, shadow_tracer)
        if cache is not None:
            # the cache already holds the miss shader where nothing is hit
            c_idx, cfx, cfy = _equirect_coords_c(
                cache.shape[0], cache.shape[1], dx.reshape(-1),
                dy.reshape(-1), dz.reshape(-1))
            mr, mg, mb = quad_bilinear_c(cache.reshape(-1, 16)[c_idx], cfx,
                                         cfy)
        else:
            mr, mg, mb = miss_color_c(dx.reshape(-1), dy.reshape(-1),
                                      dz.reshape(-1), background)
        rr = torch.where(hit, rr, mr.reshape(n_pad, samples))
        gg = torch.where(hit, gg, mg.reshape(n_pad, samples))
        bb = torch.where(hit, bb, mb.reshape(n_pad, samples))
    if want_samples:
        return torch.stack([rr, gg, bb], dim=-1)
    means = torch.stack([c.reshape(n_pad, frames, samples // frames)
                         .mean(dim=2) for c in (rr, gg, bb)],
                        dim=-1)  # (Np, F, 3)
    if sky_means is not None:
        # scatter the live means over the (frame-invariant) sky means;
        # padding rows land on a dump row past the end, which is cut off
        n0 = sky_means.shape[0]
        full = torch.cat([sky_means[:, None, :].expand(n0, frames, 3),
                          sky_means.new_zeros((1, frames, 3))])
        full.index_copy_(0, torch.clamp(sky_scatter, max=n0), means)
        means = full[:n0]
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


def _cache_trace_inputs(half_center, half_radius, center, far_mask,
                        width: int, kmax: int):
    """The cache's K2 inputs (compound_ray_tpu/eye/pipeline.py:3093-3151):
    the pixel directions in 16x16 blocks, one 256-ray group per block, and
    per block the far clusters whose half-spheres meet the block's bounding
    cone from `center`, nearest first.  Returns (blocked (n, 3), counts
    (NG,), ids (NG, KP), dmin (NG, KP), rays (n, 16))."""
    height = width // 2
    bs, tile = _CACHE_BLOCK, _CACHE_TILE
    if width % bs or height % bs or (width * height) % tile:
        raise ValueError(
            f"farfield cache width {width}: width and width // 2 must be "
            f"multiples of {bs}")
    dirs = _equirect_pixel_dirs(width, height, half_center.device)
    n = dirs.shape[0]
    blocked = (dirs.reshape(height // bs, bs, width // bs, bs, 3)
               .permute(0, 2, 1, 3, 4).reshape(n, 3))
    ng = n // tile
    td = blocked.reshape(ng, tile, 3)

    # per-tile bounding cone from the fixed viewpoint
    centroid = td.sum(dim=1)
    centroid = centroid / torch.clamp(
        torch.linalg.norm(centroid, dim=-1, keepdim=True), min=1e-30)
    cosmin = (td[:, :, 0] * centroid[:, None, 0]
              + td[:, :, 1] * centroid[:, None, 1]
              + td[:, :, 2] * centroid[:, None, 2]).amin(dim=1)
    half_ang = torch.arccos(torch.clamp(cosmin, -1.0, 1.0))

    to_c = half_center - center  # (C, 2, 3)
    dist = torch.linalg.norm(to_c, dim=-1)  # (C, 2)
    inside = dist <= half_radius
    inv_d = 1.0 / torch.clamp(dist, min=1e-30)
    cos_a = (to_c[None, :, :, 0] * centroid[:, None, None, 0]
             + to_c[None, :, :, 1] * centroid[:, None, None, 1]
             + to_c[None, :, :, 2] * centroid[:, None, None, 2]) * inv_d
    alpha = torch.arccos(torch.clamp(cos_a, -1.0, 1.0))  # (G, C, 2)
    beta = torch.arcsin(torch.clamp(half_radius * inv_d, 0.0, 1.0))
    gmask = (inside | (alpha <= half_ang[:, None, None] + beta)).any(dim=-1)
    gmask = gmask & far_mask[None, :]
    counts = torch.clamp(gmask.sum(dim=-1), max=kmax).to(torch.int32)
    dmin_all = torch.clamp((dist - half_radius).amin(dim=-1), min=0.0)
    ids, dmin = _shortlist_sorted(gmask, dmin_all[None, :].expand_as(gmask),
                                  kmax)
    rays = pack_rays(blocked, center[None, :].expand(n, 3),
                     torch.zeros(n, device=blocked.device))
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
                  tracer=None) -> torch.Tensor:
    """(H, W, 3) linear-RGB equirect radiance cache of the far clusters
    from `center` (compound_ray_tpu/eye/pipeline.py:3085).  Each 16x16
    pixel block is one 256-ray group of K2 over its shortlist of at most
    kmax far clusters (_cache_trace_inputs), traced with the early exit on;
    the winners are resolved and shaded like the frame's hits.  `tracer`
    defaults to run_tracer_kernel (K2); the chip check passes
    cluster_tracer_reference to render through the twin."""
    height = width // 2
    bs, tile = _CACHE_BLOCK, _CACHE_TILE
    blocked, counts, ids, dmin, rays = _cache_trace_inputs(
        half_center, half_radius, center, far_mask, width, kmax)
    trace = run_tracer_kernel if tracer is None else tracer
    out = trace(counts, ids, dmin, payload, rays, ng=counts.shape[0], nrb=1,
                rb_size=tile, kmax=kmax, early_exit=True)
    rgb = shade_cluster_hits(out, torch.repeat_interleave(counts > 0, tile),
                             blocked, attr_table, scene_dev, quad_table,
                             background, textured, tex_only)
    # un-block back to row-major (H, W)
    return (rgb.reshape(height // bs, width // bs, bs, bs, 3)
            .permute(0, 2, 1, 3, 4).reshape(height, width, 3))


def _farfield_threshold(ommatidia_np: np.ndarray, tol: float) -> float:
    """Parallax-safe distance D = eye extent / (tol * sigma_min)
    (compound_ray_tpu/eye/pipeline.py:3189)."""
    extent = float(np.max(np.linalg.norm(ommatidia_np[:, 0:3], axis=1)
                          + np.abs(ommatidia_np[:, 7])))
    sigma_min = float(np.min(ommatidia_np[:, 6])) / FWHM_SD_RATIO
    if sigma_min <= 0 or extent <= 0:
        return 0.0
    return extent / max(tol * sigma_min, 1e-9)


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


def _farfield_plan(splan, eplan, scene_dev, ommatidia_np, pos_np, ls_np,
                   samples: int, background: int, cfg, tracer=None,
                   lights=None):
    """The far-field split of a frame and its pose-memoised cache
    (compound_ray_tpu/eye/pipeline.py:2437).  Returns (near_mask (C,) bool
    or None, cache or None, d_thresh): None and 0.0 unless the cache is on,
    which needs an unlit frame (lights None: the cached radiance is unlit,
    :2453), farfield="auto", more than 8 clusters, at least as many rays as
    cache pixels and at least one far cluster.  The cache is
    (H, W, 16) equirect quads, or for a textured scene the combined table
    of the texture quads followed by the cache quads.  It depends on the
    eye centre, the width, the miss shader and D, not on the samples or the
    RNG, so frames at one pose build it once; `tracer` (K2 by default)
    renders a cache not in splan.cache_store."""
    off = (None, None, 0.0)
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
    dev = splan.device
    center32 = np.asarray(center_np, np.float32)
    key = (center32.tobytes(), width, background, d_thresh)
    cache = splan.cache_store.get(key)
    if cache is None:
        cache = build_equirect_quads(_render_cache(
            splan.payload, splan.attr_table, scene_dev, splan.quad_table,
            splan.half_center, splan.half_radius,
            torch.as_tensor(center32, device=dev),
            torch.as_tensor(far, device=dev), width=width,
            background=background, kmax=min(splan.num_clusters, 256),
            textured=splan.textured, tex_only=splan.tex_only,
            tracer=tracer))
        if splan.textured:
            cache = torch.cat([splan.quad_table, cache.reshape(-1, 16)])
        if len(splan.cache_store) > _CACHE_STORE_MAX:
            splan.cache_store.clear()
        splan.cache_store[key] = cache
    return torch.as_tensor(~far, device=dev), cache, d_thresh


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


def _sky_key(eplan, samples, pose_sig, d_thresh, background, cfg):
    """sky_store key (compound_ray_tpu/eye/pipeline.py:1835, without the
    affine field, which is not ported).  Like the JAX key it leaves out the
    widths: serving the plan must not need the dense pack it replaced.
    Unlike it, it holds the cache width and the miss shader, which the sky
    means are computed from."""
    return ("sky", eplan.sig, samples, pose_sig, cfg.cull_sigmas, d_thresh,
            cfg.farfield_cache_width, background, cfg.sky_quad_splay,
            cfg.sky_quad_spin)


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
    hint_key = ("sky_ngl", eplan.sig, samples, ng_quantum)
    ngl = max(_ceil_to(max(int(live.size), 1), ng_quantum),
              splan.kmax_cache.get(hint_key, 0))
    ngl = _ceil_to(min(ngl, ng), ng_quantum)
    splan.kmax_cache[hint_key] = ngl
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


def _shadow_cull(splan, cg, rg_sph, light_pos, cull_sigmas: float,
                 kcand: int):
    """One light's shafts over all groups: pseudo-ommatidia, the cone cull
    distance-bounded at the sphere's far side, and the nearest-first
    shortlist.  Returns (ps, dmax, counts (NG,), ids (NG, kcand))."""
    ps, dm = _shadow_pseudo_omms(cg, rg_sph, light_pos,
                                 FWHM_SD_RATIO / cull_sigmas)
    zero3, eye3 = _light_frame(cg.device)
    gmask, _, dmin_all = _cull_groups(ps, zero3, eye3, splan.half_center,
                                      splan.half_radius, cull_sigmas, 1)
    gmask = gmask & (dmin_all <= dm[:, None])
    counts = gmask.sum(dim=-1).to(torch.int32)
    ids = _shortlist_sorted(gmask, dmin_all, kcand)[0][:, :kcand]
    return ps, dm, counts, ids


def _shadow_probe_widths(cg, rg_sph, lights, splan, cull_sigmas: float,
                         kcand_probe: int, probe_chunk: int):
    """Per light, the shafts' widths on given per-group bound spheres
    (compound_ray_tpu/eye/pipeline.py:2144): the most clusters (kc_need)
    and refined payload rows (rows_need) any group's shaft needs, both
    (L,) tensors, returned with (cg, rg_sph).  The refine runs in group
    chunks (probe_chunk groups at most)."""
    zero3, eye3 = _light_frame(cg.device)
    kc_list, row_list = [], []
    for li in range(lights.shape[0]):
        ps, dm, counts, ids = _shadow_cull(splan, cg, rg_sph,
                                           lights[li, 4:7], cull_sigmas,
                                           kcand_probe)
        cl = torch.clamp(counts, max=kcand_probe)
        row_max = []
        for g0, g1 in _refine_chunks(ps.shape[0], 1, kcand_probe,
                                     max_groups=probe_chunk):
            mask, _, _ = _refine_mask(
                ps[g0:g1], zero3, eye3, ids[g0:g1], cl[g0:g1],
                splan.slot_center_cl, splan.slot_radius_cl, 1, cull_sigmas,
                tri_cl=splan.slot_tri_cl, dmax=dm[g0:g1])
            row_max.append(_rows(mask.sum(dim=-1)).max())
        kc_list.append(counts.max())
        row_list.append(torch.stack(row_max).max())
    return torch.stack(kc_list), torch.stack(row_list), cg, rg_sph


def _shadow_probe(packed_mm, row_counts, omms_p, position, local_space,
                  splay, spin, lights, splan, samples: int, ng: int, g: int,
                  nrb: int, rb_size: int, rmax: int, cull_sigmas: float,
                  kcand_probe: int, probe_chunk: int, tracer=None):
    """The shadow plan's probe (compound_ray_tpu/eye/pipeline.py:2084):
    trace the frame's primary rays once (K1, or `tracer`), bound each
    group's hit points, inflate the bounds (SHADOW_BOUND_INFLATE) and
    measure the shafts' widths on them.  The JAX probe draws its angles
    from the frame's key (:2099-2100), so it traces exactly the first lit
    frame's rays; here the caller passes that frame's splay and spin.  As
    there, every lane of a live group counts, ray-block padding included.
    Returns _shadow_probe_widths' (kc_need, rows_need, cg, rg_sph)."""
    rays, (dx, dy, dz) = _gen_ray_features(
        omms_p, position, local_space, splay, spin, samples=samples, ng=ng,
        g=g, nrb=nrb, rb_size=rb_size)
    trace = run_packed_tracer if tracer is None else tracer
    t_f = trace(row_counts, packed_mm, rays, ng=ng, nrb=nrb, rb_size=rb_size,
                rmax=rmax)[0]
    del rays
    rg, rg_pad = g * samples, nrb * rb_size

    def repad(x):
        return _repad(x, ng, rg, rg_pad)

    hit_f = (t_f < 1e30) & torch.repeat_interleave(row_counts > 0, rg_pad)
    neg_o = _neg_origins(omms_p, position, local_space, dx, dy, dz)
    t_c = torch.where(hit_f, t_f, 0.0)
    pxf = -repad(neg_o[0]) + t_c * repad(dx)
    pyf = -repad(neg_o[1]) + t_c * repad(dy)
    pzf = -repad(neg_o[2]) + t_c * repad(dz)
    cg, rg_sph = _hit_bound_spheres(hit_f, pxf, pyf, pzf, ng, rg_pad)
    rg_sph = torch.where(rg_sph >= 0.0,
                         rg_sph * SHADOW_BOUND_INFLATE + 1e-2, rg_sph)
    return _shadow_probe_widths(cg, rg_sph, lights, splan, cull_sigmas,
                                kcand_probe, probe_chunk)


def _shadow_pack_one(cg, rg_sph, light_pos, splan, kcand_s: int,
                     rmax_s: int, cull_sigmas: float):
    """One light's occluder payload for a run of groups
    (compound_ray_tpu/eye/pipeline.py:2028): cull, shortlist, refine with
    dmax and pack as the primary payload is packed, then fold the light in
    as the shared ray origin with tmin 0 (transform_payload_affine) and
    keep feature rows 0-7.  Returns (rc_s (n,) int32, packed_s (n, rmax_s,
    8, 512)), a transient the caller flattens."""
    ps, dm, counts, ids = _shadow_cull(splan, cg, rg_sph, light_pos,
                                       cull_sigmas, kcand_s)
    zero3, eye3 = _light_frame(cg.device)
    rc_s, packed_s = _refine_pack(
        ps, zero3, eye3, ids, torch.clamp(counts, max=kcand_s),
        splan.slot_center_cl, splan.slot_radius_cl, splan.mm_flat, 1,
        kcand_s, rmax_s, cull_sigmas, tri_cl=splan.slot_tri_cl, dmax=dm)
    n = packed_s.shape[0]
    packed_s = transform_payload_affine(
        packed_s, light_pos[None, :].expand(n, 3),
        torch.zeros(n, dtype=torch.float32, device=cg.device))
    return rc_s, packed_s[:, :, 0:SHADOW_FEATS, :]


def _shadow_key(splan, eplan, samples, pose_sig, lights_np, cfg):
    """shadow_store key (compound_ray_tpu/eye/pipeline.py:2240-2243 without
    the affine, rows-per-block and shard fields, which are not ported)."""
    return (eplan.sig, samples, pose_sig, lights_np.tobytes(),
            cfg.cull_sigmas, splan.shadow_sound_all,
            tuple(sorted(splan.shadow_unsound_groups)))


def _shadow_plan(splan, eplan, omms_p, position, local_space, pose_sig,
                 lights_np: np.ndarray, samples: int, splay, spin,
                 packed_mm, row_counts, rmax: int, tracer=None):
    """The memoised shadow plan of a lit frame
    (compound_ray_tpu/eye/pipeline.py:2200, one row per block, one shard):
    (counts (L, NG) int32, r2v (TB,) int32, flag (TB,) int32, flat_rows
    (TB, 8, 512) f32, sph (NG, 4) [centre, radius]).

    Per light, each group's shaft is exact-refined and packed from the
    probed (or, in a corrective mode, guaranteed) bound spheres, and the
    live rows of the transient dense pack go into one table sorted by
    virtual group light * NG + group: flag 2 marks a group's first row, 1
    a live row, 0 padding; TB is padded to a multiple of 64 and padding
    rows inherit the last live group.  Chunked over groups at
    shadow_pack_chunk: an unchunked dense pack at 256 clusters takes
    several GB.  Row counts come to the host once per chunk; a plan in
    splan.shadow_store is served as it is."""
    cfg = get_config()
    sk = _shadow_key(splan, eplan, samples, pose_sig, lights_np, cfg)
    hit = splan.shadow_store.get(sk)
    if hit is not None:
        splan.shadow_store[sk] = splan.shadow_store.pop(sk)  # LRU refresh
        return hit
    dev = packed_mm.device
    lights = torch.as_tensor(lights_np, device=dev)
    # probe every cluster: a narrower probe would under-measure the rows
    # and the pack's rmax would drop the farthest occluders
    kcand_probe = splan.num_clusters
    ng = eplan.ng
    sig = cfg.cull_sigmas
    chunk = cfg.shadow_pack_chunk
    unsound = splan.shadow_unsound_groups
    if splan.shadow_sound_all or unsound:
        cg_s, rg_s = _sound_bound_spheres(
            packed_mm, splan.slot_center_cl.reshape(-1, 3),
            splan.slot_radius_cl.reshape(-1))
    if splan.shadow_sound_all:
        kc_need, rows_need, cg, rg_sph = _shadow_probe_widths(
            cg_s, rg_s, lights, splan, sig, kcand_probe, chunk)
    else:
        kc_need, rows_need, cg, rg_sph = _shadow_probe(
            packed_mm, row_counts, omms_p, position, local_space, splay,
            spin, lights, splan, samples, ng, eplan.g, eplan.nrb,
            eplan.rb_size, rmax, sig, kcand_probe, chunk, tracer=tracer)
        if unsound:
            um = np.zeros(ng, bool)
            um[[g_ for g_ in unsound if g_ < ng]] = True
            um_d = torch.as_tensor(um, device=dev)
            cg = torch.where(um_d[:, None], cg_s, cg)
            rg_sph = torch.where(um_d, rg_s, rg_sph)
            # re-measure on the hybrid spheres so rmax covers the fattened
            # shafts
            kc_need, rows_need, _, _ = _shadow_probe_widths(
                cg, rg_sph, lights, splan, sig, kcand_probe, chunk)
    kc = int(kc_need.max().item())
    rw_all = rows_need.cpu().numpy()
    shadow_kmax = min(splan.num_clusters, _ceil_to(max(kc, 1), 8))
    n_lights = lights_np.shape[0]
    cnts_np = np.zeros((n_lights, ng), np.int64)
    parts = []
    for li in range(n_lights):
        rmax_li = min(shadow_kmax, _ceil_to(max(int(rw_all[li]), 1), 2))
        for lo, hi in _refine_chunks(ng, 1, shadow_kmax, max_groups=chunk):
            rc_s, packed_s = _shadow_pack_one(
                cg[lo:hi], rg_sph[lo:hi], lights[li, 4:7], splan,
                shadow_kmax, rmax_li, sig)
            rc_np = np.minimum(rc_s.cpu().numpy().astype(np.int64), rmax_li)
            cnts_np[li, lo:hi] = rc_np
            if rc_np.sum():
                # the live rows of the chunk's dense transient, group-major
                src = np.concatenate([gl * rmax_li + np.arange(rc_np[gl])
                                      for gl in range(hi - lo)])
                parts.append(packed_s.reshape(-1, SHADOW_FEATS, MM_COLS)[
                    torch.as_tensor(src, device=dev)])
            del packed_s  # the dense transient is freed per chunk
    rows = int(cnts_np.sum())
    tb = _ceil_to(max(rows, 1), 64)
    r2v_np = np.zeros(tb, np.int32)
    flag_np = np.zeros(tb, np.int32)
    cnt_flat = cnts_np.reshape(-1)  # virtual group order light * NG + g
    live_v = np.flatnonzero(cnt_flat)
    if rows:
        r2v_np[:rows] = np.repeat(live_v, cnt_flat[live_v])
        flag_np[:rows] = 1
        flag_np[np.cumsum(cnt_flat[live_v]) - cnt_flat[live_v]] = 2
        # padding rows inherit the last live group
        r2v_np[rows:] = r2v_np[rows - 1]
    parts.append(torch.zeros((tb - rows, SHADOW_FEATS, MM_COLS),
                             dtype=torch.float32, device=dev))
    flat_rows = torch.cat(parts) if len(parts) > 1 else parts[0]
    out = (torch.as_tensor(cnts_np.astype(np.int32), device=dev),
           torch.as_tensor(r2v_np, device=dev),
           torch.as_tensor(flag_np, device=dev), flat_rows,
           torch.cat([cg, rg_sph[:, None]], dim=-1))
    while len(splan.shadow_store) >= cfg.shadow_store_size:
        splan.shadow_store.pop(next(iter(splan.shadow_store)))
    splan.shadow_store[sk] = out
    return out


def _shading_rows(splan, scene_dev):
    """The scene's build_shading_rows table, built once per plan."""
    if splan.shading_rows is None:
        splan.shading_rows = build_shading_rows(scene_dev)
    return splan.shading_rows


def _plan_frame(scene_flat, scene_dev: Dict[str, Any], omms_np: np.ndarray,
                position, local_space, generator: torch.Generator,
                samples: int, background: int, lights=None, tracer=None,
                cache_tracer=None, shadow_tracer=None):
    """Shared frame planning (compound_ray_tpu/eye/pipeline.py:2516-2673,
    without the speculative widths): the far-field split and its cache,
    the sky plan, the widths and the pose's pack, then frame 0's (Np, S)
    angles from `generator` and, for a lit frame, the memoised shadow plan,
    whose first build at a pose probes those angles.  Returns (kw,
    inv_valid): kw holds every _trace_shade_angles argument (frame 0's
    splay and spin among them) but shadow_audit, and inv_valid (N,) puts
    the permuted rows back in ommatidium order.  render_means and the
    bursts both plan here, at S samples, so a burst makes the decisions
    of its frame 0 (the far-field gate, the sky key, the shadow plan)."""
    device = generator.device
    splan = scene_plan(scene_flat, device)
    eplan = eye_plan(omms_np, samples)
    omms_p, inv_valid = eplan.device_arrays(omms_np, device)
    pos_np = np.asarray(position, np.float32)
    ls_np = np.asarray(local_space, np.float32)
    pose_sig = (pos_np.tobytes(), ls_np.tobytes())
    pos = torch.as_tensor(pos_np, device=device)
    ls = torch.as_tensor(ls_np, device=device)
    cfg = get_config()
    lit = lights is not None
    near_mask, cache, d_thresh = _farfield_plan(
        splan, eplan, scene_dev, omms_np, pos_np, ls_np, samples, background,
        cfg, tracer=cache_tracer, lights=lights)
    use_cache = near_mask is not None
    cache_shape = (cfg.farfield_cache_width // 2, cfg.farfield_cache_width)
    sky = sky_key = None
    if cfg.sky_split and use_cache and not lit and eplan.g == 1:
        sky_key = _sky_key(eplan, samples, pose_sig, d_thresh, background,
                           cfg)
        found, sky = _sky_probe(splan, sky_key)
        if found:
            sky_key = None  # a memoised plan, or memoised not worth it
    if sky is None:
        kcand, rmax = _plan_widths(
            splan, eplan, omms_p, pos, ls,
            (eplan.sig, samples, pose_sig, use_cache, d_thresh), near_mask)
        row_counts, packed_mm = _packed_plan(
            splan, eplan, omms_p, pos, ls, pose_sig, samples, kcand, rmax,
            near_mask=near_mask, d_thresh=d_thresh)
        if sky_key is not None:
            sky = _sky_build(splan, eplan, omms_p, ls, samples, kcand, rmax,
                             cache, cache_shape, row_counts, packed_mm)
            _sky_put(splan, sky_key, sky, cfg)
            if sky is not None:
                # the compacted plan supersedes the dense pack at this pose
                splan.packed_store.pop(_packed_key(
                    eplan, samples, pose_sig, kcand, rmax, True, d_thresh,
                    cfg), None)
    ng, omms_f = eplan.ng, omms_p
    sky_means = sky_scatter = None
    if sky is not None:
        (packed_mm, row_counts, omms_f, sky_scatter, sky_means, ng, kcand,
         rmax) = sky
    splay, spin = sample_angles_ns(generator, omms_f[:, 6] / FWHM_SD_RATIO,
                                   samples)
    kw = dict(
        packed_mm=packed_mm, row_counts=row_counts,
        attr_table=splan.attr_table, scene_dev=scene_dev,
        quad_table=splan.quad_table, omms_p=omms_f, position=pos,
        local_space=ls, splay=splay, spin=spin, samples=samples,
        background=background, ng=ng, g=eplan.g, nrb=eplan.nrb,
        rb_size=eplan.rb_size, rmax=rmax, textured=splan.textured,
        tex_only=splan.tex_only, tracer=tracer, cache=cache,
        cache_shape=cache_shape, sky_means=sky_means,
        sky_scatter=sky_scatter)
    if lit:
        lights_np = np.ascontiguousarray(np.asarray(lights, np.float32))
        kw.update(
            lights=torch.as_tensor(lights_np, device=device),
            slot_tri=splan.slot_tri,
            shading_rows=_shading_rows(splan, scene_dev),
            shadow=_shadow_plan(splan, eplan, omms_p, pos, ls, pose_sig,
                                lights_np, samples, splay, spin, packed_mm,
                                row_counts, rmax, tracer=tracer),
            shadow_tracer=shadow_tracer)
    return kw, inv_valid


def render_means(scene_flat, scene_dev: Dict[str, Any],
                 omms_np: np.ndarray, position, local_space,
                 generator: torch.Generator, samples: int, background: int,
                 lights=None, shadow_audit: bool = False, tracer=None,
                 cache_tracer=None, shadow_tracer=None):
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
    device).  `tracer`, `cache_tracer` and `shadow_tracer` replace K1, K2
    and K3 (the chip check renders through the twins with them)."""
    kw, inv_valid = _plan_frame(
        scene_flat, scene_dev, omms_np, position, local_space, generator,
        samples, background, lights=lights, tracer=tracer,
        cache_tracer=cache_tracer, shadow_tracer=shadow_tracer)
    audit_on = lights is not None and shadow_audit
    out = _trace_shade_angles(shadow_audit=audit_on, **kw)
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
                        shadow_tracer=None) -> torch.Tensor:
    """(F, N, 3) means of F consecutive frames at one pose, frame f drawn
    from generators[f] (compound_ray_tpu/eye/pipeline.py:2854,
    render_means_pallas_frames): planned once by _plan_frame from frame 0,
    then stacked when 1 < F * S <= STACK_BURST_MAX_SAMPLES (one K1 launch;
    lit, one K3 launch), else scanned (F of each).  Frame f equals
    render_means(generators[f]) on the same plan.  No frame is audited
    against its shadow shafts.  The tracers are render_means'."""
    kw, inv_valid = _plan_frame(
        scene_flat, scene_dev, omms_np, position, local_space, generators[0],
        samples, background, lights=lights, tracer=tracer,
        cache_tracer=cache_tracer, shadow_tracer=shadow_tracer)
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
    device = generator.device
    splan = scene_plan(scene_flat, device)
    eplan = eye_plan(omms_np, samples)
    omms_p, inv_valid = eplan.device_arrays(omms_np, device)
    pos_np = np.asarray(position, np.float32)
    ls_np = np.asarray(local_space, np.float32)
    pose_sig = (pos_np.tobytes(), ls_np.tobytes())
    pos = torch.as_tensor(pos_np, device=device)
    ls = torch.as_tensor(ls_np, device=device)
    kcand, rmax = _plan_widths(splan, eplan, omms_p, pos, ls,
                               (eplan.sig, samples, pose_sig, False, 0.0))
    row_counts, packed_mm = _packed_plan(splan, eplan, omms_p, pos, ls,
                                         pose_sig, samples, kcand, rmax)
    splay, spin = sample_angles_ns(generator, omms_p[:, 6] / FWHM_SD_RATIO,
                                   samples)
    raw_p = _trace_shade_angles(
        packed_mm, row_counts, splan.attr_table, scene_dev,
        splan.quad_table, omms_p, pos, ls, splay, spin, samples=samples,
        background=background, ng=eplan.ng, g=eplan.g, nrb=eplan.nrb,
        rb_size=eplan.rb_size, rmax=rmax, textured=splan.textured,
        tex_only=splan.tex_only, tracer=tracer, want_samples=True)
    return raw_p[inv_valid].transpose(0, 1)
