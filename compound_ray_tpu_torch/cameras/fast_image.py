"""The tile-culled real-camera image on K2 (compound_ray_tpu/cameras/
fast_image.py in torch).

A tile of 256 adjacent pixels is a coherent ray bundle: its bounding cone
(direction centroid and half-angle, origin centroid and spread) culls the
scene's 128-triangle clusters as an ommatidium's acceptance cone does.
Each tile becomes one group of the cluster-shortlist tracer K2
(trace/cluster_tracer.py run_tracer_kernel, csrc/cluster_tracer.cu), which
walks the tile's surviving clusters nearest first with the early exit on.
The winners are then resolved, textured and shaded as the far-field
cache's are (pipeline.shade_cluster_hits).  This replaces the brute-force sweep of cameras/raygen.py for scenes
of at least min_triangles_for_culling triangles (the noncompound
optixLaunch of libEyeRenderer.cpp:228-237).
"""

from __future__ import annotations

import numpy as np
import torch

from compound_ray_tpu_torch.cameras.raygen import camera_rays
from compound_ray_tpu_torch.eye.pipeline import (
    _ceil_to,
    _shortlist_sorted,
    scene_plan,
    shade_cluster_hits,
)
from compound_ray_tpu_torch.trace.cluster_tracer import (
    pack_rays,
    run_tracer_kernel,
)
from compound_ray_tpu_torch.trace.shade import make_color

TILE = 256  # pixels per K2 group
# the per-tile shortlist's cap: beyond it a tile keeps its nearest clusters
KMAX_CAP = 256


def _unit_rows(x: torch.Tensor):
    """(x / |x| guarded at 1e-30, |x|) over the last axis."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=1e-30), n[..., 0]


def image_trace_inputs(sphere_center, sphere_radius, position, local_space,
                       cam_param, kind: str, width: int, height: int,
                       kmax: int):
    """K2's inputs for a camera image (compound_ray_tpu/cameras/
    fast_image.py:49-127): the rays of `kind`, normalised with tmin rescaled
    by |d| and edge-padded to whole tiles, and per tile its bounding cone's
    cull of the cluster spheres and the survivors nearest first.  Returns
    (counts (NG,) int32, ids (NG, KP) int32, dmin (NG, KP), rays (NG * 256,
    16), unit directions (W * H, 3))."""
    origins, dirs, tmin = camera_rays(kind, position, local_space, cam_param,
                                      width, height)
    n = width * height
    n_pad = _ceil_to(n, TILE)
    dirs_n, dlen = _unit_rows(dirs)
    # t is in |d| units in raygen; the unit directions need tmin rescaled
    tmin_w = tmin * dlen

    def pad_edge(x):
        # the last real ray repeated into the tail: zero padding rays would
        # widen the last tile's cone to >= 90 degrees (dot(0, centroid) = 0)
        # and skew its apex and spread, so that tile would cull nothing
        # whenever W * H is not a multiple of TILE
        return torch.cat([x, x[n - 1:n].expand(n_pad - n, 3)])

    dirs_p = pad_edge(dirs_n)
    orig_p = pad_edge(origins.expand(n, 3))
    tmin_p = torch.cat([tmin_w, tmin_w.new_zeros(n_pad - n)])
    ng = n_pad // TILE
    td = dirs_p.reshape(ng, TILE, 3)
    to = orig_p.reshape(ng, TILE, 3)

    # per-tile bounding cone
    centroid, _ = _unit_rows(td.sum(dim=1))  # (NG, 3)
    cosmin = (td[:, :, 0] * centroid[:, None, 0]
              + td[:, :, 1] * centroid[:, None, 1]
              + td[:, :, 2] * centroid[:, None, 2]).amin(dim=1)
    half = torch.arccos(torch.clamp(cosmin, -1.0, 1.0))
    apex = to.mean(dim=1)
    spread = torch.linalg.vector_norm(to - apex[:, None, :], dim=-1).amax(1)

    # cone-vs-sphere cull (the conservative test of accel/cull.py)
    to_c = sphere_center[None, :, :] - apex[:, None, :]  # (NG, C, 3)
    dist = torch.linalg.vector_norm(to_c, dim=-1)
    radii_eff = sphere_radius[None, :] + spread[:, None]
    inside = dist <= radii_eff
    dist_g = torch.clamp(dist, min=1e-30)
    cos_a = (to_c[..., 0] * centroid[:, None, 0]
             + to_c[..., 1] * centroid[:, None, 1]
             + to_c[..., 2] * centroid[:, None, 2]) / dist_g
    alpha = torch.arccos(torch.clamp(cos_a, -1.0, 1.0))
    beta = torch.arcsin(torch.clamp(radii_eff / dist_g, 0.0, 1.0))
    gmask = inside | (alpha <= half[:, None] + beta)
    counts = torch.clamp(gmask.sum(dim=-1), max=kmax).to(torch.int32)
    # dmin is exactly 0 for every cluster whose sphere holds the apex, so
    # ties are common: the sort is stable, as jnp.argsort
    ids, dmin = _shortlist_sorted(gmask,
                                  torch.clamp(dist - radii_eff, min=0.0),
                                  kmax)
    return counts, ids, dmin, pack_rays(dirs_p, orig_p, tmin_p), dirs_n


def render_camera_image_fast(scene_flat, scene_dev, kind: str, position,
                             local_space, cam_param, width: int, height: int,
                             background: int) -> torch.Tensor:
    """(H, W, 4) uint8 RGBA camera image through K2
    (compound_ray_tpu/cameras/fast_image.py:150): one 256-pixel tile per
    group over its shortlist of at most kmax = min(clusters, 256) clusters,
    early exit on.  position (3,), local_space (3, 3) and cam_param are
    host arrays; the image renders on scene_dev's device."""
    dev = scene_dev["v0"].device
    splan = scene_plan(scene_flat, dev)
    # horizon tiles can see much of the scene, so the shortlist holds up to
    # KMAX_CAP clusters; past it a tile keeps the nearest and drops the rest
    kmax = min(splan.num_clusters, KMAX_CAP)
    if splan.num_clusters > KMAX_CAP and not splan.image_cap_warned:
        splan.image_cap_warned = True
        print(f"[PyEye] fast image path: per-tile cluster shortlist capped "
              f"at {KMAX_CAP} of {splan.num_clusters} (nearest-first); "
              f"distant geometry may drop in wide-view tiles — set "
              f"CR_TPU_BACKEND=naive for the exact (slower) camera path")
    # one host-to-device copy for the pose and the camera's parameter
    ls = np.asarray(local_space, np.float32).reshape(9)
    param = np.asarray(cam_param, np.float32).reshape(-1)
    host = np.concatenate([np.asarray(position, np.float32).reshape(3), ls,
                           param])
    pose = torch.as_tensor(host, device=dev)
    counts, ids, dmin, rays, dirs_n = image_trace_inputs(
        splan.sphere_center, splan.sphere_radius, pose[0:3],
        pose[3:12].reshape(3, 3), pose[12:], kind, width, height, kmax)
    out = run_tracer_kernel(counts, ids, dmin, splan.payload, rays,
                            ng=counts.shape[0], nrb=1, rb_size=TILE,
                            kmax=kmax, early_exit=True)
    n = width * height
    rgb = shade_cluster_hits(
        out[:n], torch.repeat_interleave(counts > 0, TILE)[:n], dirs_n,
        splan.attr_table, scene_dev, splan.quad_table, background,
        splan.textured, splan.tex_only)
    return make_color(rgb).reshape(height, width, 4)
