"""Plücker-form ray-triangle intersection (compound_ray_tpu/trace/
plucker.py in torch).

  * a ray is the 6-vector  [d, o x d]  (direction + Plücker moment)
  * each triangle edge a->b is the 6-vector  [a x b, b - a]
  * side(ray, edge) = d.(a x b) + (o x d).(b - a)  — a plain dot product
  * t = (v0.n - o.n) / (d.n),   n = e1 x e2

A ray hits iff the three side products share a sign (both-sided) and t is
inside [tmin, tmax]; u = w1 / (w0 + w1 + w2), v = w2 / (w0 + w1 + w2).
The packed tracer (trace/mm_tracer.py) and K2's payload build their
per-triangle operands from triangle_constants; plucker_closest_hit is the
same test over all pairs, held to the Möller-Trumbore oracle
(trace/intersect.py) and on no render path.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from compound_ray_tpu_torch.trace.intersect import cross3


def triangle_constants(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    """Per-triangle operands (host, numpy, once per scene).

    Returns dict:
      edge6:  (T, 3, 6)  the three edge 6-vectors [a x b, b - a]
              (edges: p1->p2 [opposite v0], p2->p0 [opp v1 -> u],
               p0->p1 [opp v2 -> v])
      normal: (T, 3)     n = e1 x e2
      c0:     (T,)       v0 . n
    Degenerate (all-zero) padding triangles yield n = 0 -> den = 0 -> miss.
    The moments a x b are worked out in float64 from the corners and
    rounded once: in float32 a x b of two corners far from the origin and
    close together cancels to a few bits (a grass blade's 0.024-wide edge
    36 units out: 8e-5 of error against a side product of 7e-5 for a ray
    3 mm off the edge from 3.7 cm away), which puts near rays on the wrong
    side of the edge; rounded once, the error is the moment's own ulp.
    """
    p0 = v0
    p1 = v0 + e1
    p2 = v0 + e2

    def edge(a, b):
        moment = np.cross(np.asarray(a, np.float64),
                          np.asarray(b, np.float64)).astype(a.dtype)
        return np.concatenate([moment, b - a], axis=-1)  # (T, 6)

    edge6 = np.stack([edge(p1, p2), edge(p2, p0), edge(p0, p1)], axis=1)
    normal = np.cross(e1, e2)
    c0 = np.sum(v0 * normal, axis=-1)
    return {"edge6": edge6, "normal": normal, "c0": c0}


def ray6(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(R, 6) Plücker ray vectors [d, o x d]
    (compound_ray_tpu/trace/plucker.py:59)."""
    return torch.cat([d, cross3(o, d)], dim=-1)


def plucker_closest_hit(o: torch.Tensor, d: torch.Tensor,
                        tri: Dict[str, object], tri_id, tmin, tmax=1e16):
    """Closest hit of rays (R, 3) over the T triangles of tri
    (triangle_constants, numpy or tensors) whose ids tri_id (T,) are >= 0
    (-1 marks padding) (compound_ray_tpu/trace/plucker.py:64).  Every
    product is written out as f32 multiplies and adds.  Returns (t, u, v,
    id, hit), each (R,)."""
    dev = o.device
    edge6, normal, c0 = (torch.as_tensor(tri[k], dtype=torch.float32,
                                         device=dev)
                         for k in ("edge6", "normal", "c0"))
    tri_id = torch.as_tensor(tri_id, device=dev)
    r6 = ray6(o, d)

    def side(e):  # (R, T) side products against edge e of every triangle
        acc = r6[:, 0:1] * edge6[:, e, 0]
        for k in range(1, 6):
            acc = acc + r6[:, k:k + 1] * edge6[:, e, k]
        return acc

    w0, w1, w2 = side(0), side(1), side(2)
    den = (d[:, 0:1] * normal[:, 0] + d[:, 1:2] * normal[:, 1]
           + d[:, 2:3] * normal[:, 2])
    onum = (o[:, 0:1] * normal[:, 0] + o[:, 1:2] * normal[:, 1]
            + o[:, 2:3] * normal[:, 2])
    t = (c0[None, :] - onum) / den  # inf or NaN where den == 0
    all_pos = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
    all_neg = (w0 <= 0.0) & (w1 <= 0.0) & (w2 <= 0.0)
    wsum = w0 + w1 + w2
    ok = ((all_pos | all_neg) & (den != 0.0) & (wsum != 0.0)
          & (tri_id[None, :] >= 0))
    lo = torch.as_tensor(tmin, dtype=torch.float32, device=dev).expand(
        o.shape[0])
    ok &= (t >= lo[:, None]) & (t <= tmax)
    t = torch.where(ok, t, torch.inf)
    j = torch.argmin(t, dim=1)
    rows = torch.arange(t.shape[0], device=dev)
    tj = t[rows, j]
    hit = torch.isfinite(tj)
    wsum_j = wsum[rows, j]
    u = w1[rows, j] / wsum_j
    v = w2[rows, j] / wsum_j
    return (tj, torch.where(hit, u, 0.0), torch.where(hit, v, 0.0),
            torch.where(hit, tri_id[j], -1), hit)
