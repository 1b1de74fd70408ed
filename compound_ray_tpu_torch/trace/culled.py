"""The cone-culled compound frame of backend "xla"
(compound_ray_tpu/trace/culled.py in torch).

Every ommatidium owns a K-entry shortlist of candidate clusters
(accel/cull.py); its S samples are traced only against those K x L
triangles, gathered as dense blocks, with the Plücker side-product test
(trace/plucker.py), then shaded (trace/shade.py shade_rays) and summed per
ommatidium.  The sweep runs in chunks of omm_chunk ommatidia and
sample_chunk samples, each chunk's shaded samples summed into the
ommatidium's total, so no (samples x ommatidia) buffer is kept.

The angles are the (S, N) arrays of eye/sampling.py sample_angles, drawn
from the frame's generator exactly as the brute-force oracle
(eye/render.py) draws them, so both paths trace the same rays and differ
only where a cone's truncation at cull_sigmas drops a triangle.  Every
product is written out as f32 multiplies and adds, never a matmul, so no
TF32 mode touches it on a card.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from compound_ray_tpu_torch.eye.sampling import (
    cone_offset_directions,
    sample_angles,
    to_world,
)
from compound_ray_tpu_torch.trace.intersect import cross3
from compound_ray_tpu_torch.trace.shade import shade_rays


def render_means_culled(scene: Dict[str, Any], clusters: Dict[str, Any],
                        ommatidia: torch.Tensor, position: torch.Tensor,
                        local_space: torch.Tensor,
                        generator: torch.Generator,
                        cluster_ids: torch.Tensor,
                        cluster_valid: torch.Tensor, samples: int,
                        background: int, omm_chunk: int = 64,
                        sample_chunk: int = 64) -> torch.Tensor:
    """(N, 3) per-ommatidium mean radiance through the culled Plücker sweep
    (compound_ray_tpu/trace/culled.py:34), the angles drawn from
    `generator` on the scene's device."""
    splay, spin = sample_angles(generator, ommatidia.shape[0], samples,
                                ommatidia[:, 6])
    return render_means_culled_angles(
        scene, clusters, ommatidia, position, local_space, splay, spin,
        cluster_ids, cluster_valid, background, omm_chunk=omm_chunk,
        sample_chunk=sample_chunk)


def _closest(r6, dirs, w6, nrm, c0, onum, tid, tmin):
    """Closest hit of a chunk's rays over their ommatidium's candidates:
    r6 (oc, sc, 6) Plücker rays, dirs (oc, sc, 3); w6 (oc, T, 3, 6), nrm
    (oc, T, 3), c0, onum = o . n and tid (oc, T); tmin (oc,).  Returns
    intersect_rays' dict over the oc * sc rays, ommatidium-major."""
    oc, sc = dirs.shape[0], dirs.shape[1]

    def side(e):  # (oc, sc, T) side products against edge e
        acc = r6[:, :, None, 0] * w6[:, None, :, e, 0]
        for k in range(1, 6):
            acc = acc + r6[:, :, None, k] * w6[:, None, :, e, k]
        return acc

    w = torch.stack([side(0), side(1), side(2)], dim=-1)  # (oc, sc, T, 3)
    den = (dirs[:, :, None, 0] * nrm[:, None, :, 0]
           + dirs[:, :, None, 1] * nrm[:, None, :, 1]
           + dirs[:, :, None, 2] * nrm[:, None, :, 2])
    t = (c0 - onum)[:, None, :] / den  # inf or NaN where den == 0
    wsum = w[..., 0] + w[..., 1] + w[..., 2]
    ok = (((w >= 0.0).all(dim=-1) | (w <= 0.0).all(dim=-1))
          & (den != 0.0) & (wsum != 0.0) & (tid[:, None, :] >= 0)
          & (t >= tmin[:, None, None]) & (t <= 1e16))
    t = torch.where(ok, t, torch.inf)
    j = torch.argmin(t, dim=-1, keepdim=True)  # (oc, sc, 1)
    tj = t.gather(-1, j)[..., 0]
    hit = torch.isfinite(tj)
    wj = w.gather(2, j[..., None].expand(oc, sc, 1, 3))[:, :, 0]
    wsj = wsum.gather(-1, j)[..., 0]
    wsj = torch.where(wsj == 0.0, 1.0, wsj)
    tidj = tid.gather(1, j.reshape(oc, sc))
    return {"t": tj.reshape(-1),
            "u": torch.where(hit, wj[..., 1] / wsj, 0.0).reshape(-1),
            "v": torch.where(hit, wj[..., 2] / wsj, 0.0).reshape(-1),
            "tri_id": torch.where(hit, tidj, -1).reshape(-1),
            "hit": hit.reshape(-1)}


def render_means_culled_angles(scene: Dict[str, Any],
                               clusters: Dict[str, Any],
                               ommatidia: torch.Tensor,
                               position: torch.Tensor,
                               local_space: torch.Tensor,
                               splay: torch.Tensor, spin: torch.Tensor,
                               cluster_ids: torch.Tensor,
                               cluster_valid: torch.Tensor, background: int,
                               omm_chunk: int = 64,
                               sample_chunk: int = 64) -> torch.Tensor:
    """render_means_culled on pre-drawn (S, N) angles
    (compound_ray_tpu/trace/culled.py:59), so a caller can split the
    ommatidium axis (the K-classes of trace/dispatch.py) without changing
    the sampled noise.  cluster_ids (N, K) int32 and cluster_valid (N, K)
    bool are each ommatidium's shortlist (accel/cull.py
    shortlist_from_mask); clusters is ClusterSet.device_arrays.  Returns
    (N, 3)."""
    n = ommatidia.shape[0]
    samples = splay.shape[0]
    axis = ommatidia[:, 3:6]
    focal = ommatidia[:, 7]
    axis_n = axis / torch.clamp(
        torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=1e-30)
    origins = position[None, :] + to_world(ommatidia[:, 0:3]
                                           - axis_n * focal[:, None],
                                           local_space)  # (N, 3)
    sums = []
    for o0 in range(0, n, omm_chunk):
        o1 = min(n, o0 + omm_chunk)
        oc = o1 - o0
        ids = cluster_ids[o0:o1].long()
        vm = cluster_valid[o0:o1]  # (oc, K)
        # the shortlist's triangles, invalid entries masked to degenerate
        w6 = torch.where(vm[..., None, None, None], clusters["edge6"][ids],
                         0.0).reshape(oc, -1, 3, 6)
        nrm = torch.where(vm[..., None, None], clusters["normal"][ids],
                          0.0).reshape(oc, -1, 3)
        c0 = torch.where(vm[..., None], clusters["c0"][ids],
                         0.0).reshape(oc, -1)
        tid = torch.where(vm[..., None], clusters["tri_id"][ids],
                          -1).reshape(oc, -1)
        or_c = origins[o0:o1]
        onum = (or_c[:, None, 0] * nrm[..., 0] + or_c[:, None, 1] * nrm[..., 1]
                + or_c[:, None, 2] * nrm[..., 2])  # (oc, T)
        acc = torch.zeros((oc, 3), dtype=torch.float32,
                          device=ommatidia.device)
        for s0 in range(0, samples, sample_chunk):
            s1 = min(samples, s0 + sample_chunk)
            sc = s1 - s0
            rel_dir = cone_offset_directions(
                axis[None, o0:o1].expand(sc, oc, 3), splay[s0:s1, o0:o1],
                spin[s0:s1, o0:o1])  # (sc, oc, 3)
            dirs = to_world(rel_dir.reshape(-1, 3), local_space).reshape(
                sc, oc, 3).transpose(0, 1)  # (oc, sc, 3)
            r6 = torch.cat([dirs, cross3(or_c[:, None, :].expand_as(dirs),
                                         dirs)], dim=-1)
            hit = _closest(r6, dirs, w6, nrm, c0, onum, tid, focal[o0:o1])
            rgb = shade_rays(scene, dirs.reshape(-1, 3), hit, background)
            acc = acc + rgb.reshape(oc, sc, 3).sum(dim=1)
        sums.append(acc)
    return torch.cat(sums) / samples
