"""Triangle clustering: the cone-culled acceleration structure.

A numpy copy of compound_ray_tpu/accel/clusters.py, always on the numpy
median split (the JAX package may take a native build whose leaf order
differs; both are valid cluster sets).

OptiX answers "which triangles might this ray hit?" with a per-ray BVH
traversal — divergent control flow and pointer chasing that a vector machine
cannot hide.  The TPU answer exploits the compound-eye workload's structure:
all samples of an ommatidium live inside a narrow acceptance cone, so culling
is done ONCE per ommatidium (amortised over every sample) against a flat list
of triangle clusters, and the surviving clusters are traced densely.

The build (host, numpy, at scene-load time — the analogue of the reference's
GAS build in MulticamScene::buildMeshAccels): recursive median split over
triangle centroids along the widest axis, producing leaves of at most
`leaf_size` triangles.  Triangles are REORDERED so each cluster is a
contiguous, padded row block — a cluster fetch is then a dynamic slice, not a
gather.  Padding uses degenerate (all-zero) triangles whose intersection
determinant is always 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch


@dataclass
class ClusterSet:
    """Flat cluster arrays (C clusters x L triangles)."""

    leaf_size: int
    # padded, cluster-ordered triangle data; shape (C*L, 3)
    v0: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    tri_id: np.ndarray  # (C, L) int32 original triangle index, -1 = padding
    aabb_min: np.ndarray  # (C, 3)
    aabb_max: np.ndarray  # (C, 3)
    # bounding sphere per cluster (for the angular cull test)
    sphere_center: np.ndarray  # (C, 3)
    sphere_radius: np.ndarray  # (C,)
    # sub-spheres per cluster (recursive median splits): tighter angular
    # culling for elongated/curved clusters.  H=2 for large scenes (cull cost
    # scales with C*H); H=8 for small-cluster-count scenes (closed arenas)
    # where fine granularity is what makes culling work at all.
    half_center: np.ndarray = None  # (C, H, 3)
    half_radius: np.ndarray = None  # (C, H)
    # device -> device_arrays' dict
    _device_cache: Dict[Any, Dict[str, torch.Tensor]] = field(
        default_factory=dict, repr=False)

    @property
    def num_clusters(self) -> int:
        return int(self.aabb_min.shape[0])

    def device_arrays(self, device) -> Dict[str, torch.Tensor]:
        """The culled sweep's per-cluster tables on `device`, built once per
        device (compound_ray_tpu/accel/clusters.py:55): v0, e1, e2 (C, L,
        3), the Plücker operands edge6 (C, L, 3, 6), normal (C, L, 3) and
        c0 (C, L) (trace/plucker.py triangle_constants), tri_id (C, L),
        the AABBs and the bounding spheres."""
        device = torch.empty(0, device=device).device
        hit = self._device_cache.get(device)
        if hit is not None:
            return hit
        from compound_ray_tpu_torch.trace.plucker import triangle_constants

        c, l = self.tri_id.shape
        tri = triangle_constants(self.v0, self.e1, self.e2)

        def dev(x, *shape):
            return torch.tensor(np.asarray(x).reshape(*shape) if shape
                                else np.asarray(x), device=device)

        hit = {
            "v0": dev(self.v0, c, l, 3), "e1": dev(self.e1, c, l, 3),
            "e2": dev(self.e2, c, l, 3),
            "edge6": dev(np.asarray(tri["edge6"], np.float32), c, l, 3, 6),
            "normal": dev(np.asarray(tri["normal"], np.float32), c, l, 3),
            "c0": dev(np.asarray(tri["c0"], np.float32), c, l),
            "tri_id": dev(self.tri_id), "aabb_min": dev(self.aabb_min),
            "aabb_max": dev(self.aabb_max),
            "sphere_center": dev(self.sphere_center),
            "sphere_radius": dev(self.sphere_radius),
        }
        self._device_cache[device] = hit
        return hit


def _median_split(centroids: np.ndarray, indices: np.ndarray, leaf_size: int,
                  out: List[np.ndarray]) -> None:
    if len(indices) <= leaf_size:
        out.append(indices)
        return
    c = centroids[indices]
    axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
    order = np.argsort(c[:, axis], kind="stable")
    half = len(indices) // 2
    _median_split(centroids, indices[order[:half]], leaf_size, out)
    _median_split(centroids, indices[order[half:]], leaf_size, out)


def build_clusters(
    v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, leaf_size: int = 64
) -> ClusterSet:
    """Build the cluster set for a triangle soup (host-side, one-time)."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    n = v0.shape[0]
    if n == 0:
        z = np.zeros((leaf_size, 3), np.float32)
        return ClusterSet(
            leaf_size=leaf_size,
            v0=z, e1=z.copy(), e2=z.copy(),
            tri_id=np.full((1, leaf_size), -1, np.int32),
            aabb_min=np.zeros((1, 3), np.float32),
            aabb_max=np.zeros((1, 3), np.float32),
            sphere_center=np.zeros((1, 3), np.float32),
            sphere_radius=np.zeros(1, np.float32),
            half_center=np.zeros((1, 2, 3), np.float32),
            half_radius=np.zeros((1, 2), np.float32),  # H=2 trivial case
        )

    p1 = v0 + e1
    p2 = v0 + e2

    leaves: List[np.ndarray] = []
    centroids = (v0 + p1 + p2) / 3.0
    _median_split(centroids, np.arange(n), leaf_size, leaves)
    c = len(leaves)

    pv0 = np.zeros((c, leaf_size, 3), np.float32)
    pe1 = np.zeros((c, leaf_size, 3), np.float32)
    pe2 = np.zeros((c, leaf_size, 3), np.float32)
    tri_id = np.full((c, leaf_size), -1, np.int32)
    amin = np.zeros((c, 3), np.float32)
    amax = np.zeros((c, 3), np.float32)
    # fine sub-spheres for small scenes; coarse for big ones (cull cost ~ C*H)
    n_half = 8 if c <= 64 else 2
    half_center = np.zeros((c, n_half, 3), np.float32)
    half_radius = np.zeros((c, n_half), np.float32)

    centroids_all = (v0 + p1 + p2) / 3.0
    for i, leaf in enumerate(leaves):
        k = len(leaf)
        pv0[i, :k] = v0[leaf]
        pe1[i, :k] = e1[leaf]
        pe2[i, :k] = e2[leaf]
        tri_id[i, :k] = leaf
        pts = np.concatenate([v0[leaf], p1[leaf], p2[leaf]])
        amin[i] = pts.min(axis=0)
        amax[i] = pts.max(axis=0)
        # sub-spheres: recursive median splits along the locally widest
        # centroid axis down to n_half parts
        cen = centroids_all[leaf]

        def split2(sel_idx):
            if len(sel_idx) <= 1:
                return [sel_idx, sel_idx]
            cc = cen[sel_idx]
            ax = int(np.argmax(cc.max(axis=0) - cc.min(axis=0)))
            order = sel_idx[np.argsort(cc[:, ax], kind="stable")]
            h = max(len(order) // 2, 1)
            return [order[:h], order[h:] if len(order) > h else order[:1]]

        parts = [np.arange(k)]
        while len(parts) < n_half:
            parts = [q for p_ in parts for q in split2(p_)]
        for hi, part in enumerate(parts):
            sel = leaf[part]
            hp = np.concatenate([v0[sel], p1[sel], p2[sel]])
            hmin, hmax = hp.min(axis=0), hp.max(axis=0)
            half_center[i, hi] = (hmin + hmax) / 2.0
            half_radius[i, hi] = np.linalg.norm(hmax - half_center[i, hi])

    center = (amin + amax) / 2.0
    radius = np.linalg.norm(amax - center, axis=1)
    return ClusterSet(
        half_center=half_center,
        half_radius=half_radius,
        leaf_size=leaf_size,
        v0=pv0.reshape(-1, 3),
        e1=pe1.reshape(-1, 3),
        e2=pe2.reshape(-1, 3),
        tri_id=tri_id,
        aabb_min=amin,
        aabb_max=amax,
        sphere_center=center,
        sphere_radius=radius.astype(np.float32),
    )



def scene_clusters(scene, leaf_size: int = 64) -> ClusterSet:
    """The cluster set of a FlatScene at `leaf_size`, built on first use and
    kept on the scene (compound_ray_tpu/accel/clusters.py:202)."""
    cache = scene._accel_cache
    if cache is None or cache.leaf_size != leaf_size:
        scene._accel_cache = build_clusters(scene.v0, scene.e1, scene.e2,
                                            leaf_size)
    return scene._accel_cache
