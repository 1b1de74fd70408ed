"""GGX/Schlick direct lighting of the lit frame
(compound_ray_tpu/trace/lighting.py in torch; shaders.cu:63-101, 826-881).

Off by default, as in the reference (params.lighting = false).  The lit
branch of eye/pipeline.py's frame core gathers one wide per-triangle row of
build_shading_rows per ray, unpacks it component-planar (unpack_shading_cols),
applies the material textures where some material has them, and adds
ggx_light_contrib_planar per light where the shadow ray (kernel K3) is
clear.  Everything per ray is a (R,) tensor per component.

The brute-force oracle's lit path works on (R, 3) rows instead:
shade.shade_rays calls ggx_direct, which gathers the hit's attributes per
triangle (shading_basis, triangle_dpduv, apply_material_textures) and adds
ggx_light_contrib per light where a shadow ray, one occlusion_test over the
whole soup, is clear.  Both forms compute the same BRDF.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from compound_ray_tpu_torch.trace.intersect import (
    cross3,
    dot3,
    occlusion_test,
    oracle_ray_chunk,
)
from compound_ray_tpu_torch.trace.shade import sample_texture


def default_lights(aabb_min: np.ndarray, aabb_max: np.ndarray) -> np.ndarray:
    """The reference's four point lights, (4, 7) float32 rows [colour(3),
    intensity, position(3)] around the scene AABB
    (compound_ray_tpu/trace/lighting.py:21; libEyeRenderer.cpp:130-148)."""
    center = (np.asarray(aabb_min) + np.asarray(aabb_max)) / 2.0
    loffset = float(np.max(aabb_max - aabb_min))
    rows = [
        ([1.0, 1.0, 0.8], 5.0, center + loffset),
        ([0.8, 0.8, 1.0], 3.0,
         center + np.array([-loffset, 0.5 * loffset, -0.5 * loffset])),
        ([1.0, 1.0, 0.8], 5.0, center + np.array([0.0, 4.0, -5.0])),
        ([1.0, 1.0, 0.8], 0.5, center + np.array([1.0, -6.0, 0.0])),
    ]
    out = np.zeros((4, 7), np.float32)
    for i, (c, inten, p) in enumerate(rows):
        out[i, 0:3] = c
        out[i, 3] = inten
        out[i, 4:7] = p
    return out


# Column layout of build_shading_rows (compound_ray_tpu/trace/lighting.py:
# 67-79): the per-triangle lit attributes in one row, so the epilogue reads
# them with one gather per ray.  Material scalars are baked per triangle;
# texture ids ride as float32 (exact below 2**24).
_BC_E1 = slice(0, 3)
_BC_E2 = slice(3, 6)
_BC_N0 = slice(6, 9)
_BC_N1 = slice(9, 12)
_BC_N2 = slice(12, 15)
_BC_HAS_N = 15
_BC_METALLIC = 16
_BC_ROUGHNESS = 17
_BC_UV0 = slice(18, 20)
_BC_UV1 = slice(20, 22)
_BC_UV2 = slice(22, 24)
_BC_MR_TEX = 24
_BC_NM_TEX = 25


def shading_basis(scene: Dict[str, Any], tri: torch.Tensor):
    """Per-ray shading inputs gathered by triangle id
    (compound_ray_tpu/trace/lighting.py:39): (e1, e2, n0, n1, n2, has_n,
    metallic, roughness), (R, 3) and (R,).  tri must already be clipped to
    the valid range."""
    tri = tri.long()
    mat = torch.clamp(scene["mat_id"][tri], min=0).long()
    return (scene["e1"][tri], scene["e2"][tri], scene["n0"][tri],
            scene["n1"][tri], scene["n2"][tri], scene["has_normals"][tri],
            scene["mat_metallic"][mat], scene["mat_roughness"][mat])


def build_shading_rows(scene: Dict[str, Any]) -> torch.Tensor:
    """(T, 18 | 26) per-triangle lit-attribute table in the _BC_* layout
    (compound_ray_tpu/trace/lighting.py:82).  The eight texture columns
    exist only when the scene dict carries mat_mr_tex (some material
    references a metallic-roughness or normal texture)."""
    mat = torch.clamp(scene["mat_id"], min=0).long()
    cols = [
        scene["e1"], scene["e2"],
        scene["n0"], scene["n1"], scene["n2"],
        scene["has_normals"].to(torch.float32)[:, None],
        scene["mat_metallic"][mat][:, None],
        scene["mat_roughness"][mat][:, None],
    ]
    if "mat_mr_tex" in scene:
        cols += [
            scene["uv0"], scene["uv1"], scene["uv2"],
            scene["mat_mr_tex"][mat].to(torch.float32)[:, None],
            scene["mat_normal_tex"][mat].to(torch.float32)[:, None],
        ]
    return torch.cat(cols, dim=1)


def shading_basis_from_rows(rows_g: torch.Tensor):
    """shading_basis from one gathered (R, C) slab of build_shading_rows
    (compound_ray_tpu/trace/lighting.py:105): the same values."""
    return (rows_g[:, _BC_E1], rows_g[:, _BC_E2], rows_g[:, _BC_N0],
            rows_g[:, _BC_N1], rows_g[:, _BC_N2], rows_g[:, _BC_HAS_N] > 0.5,
            rows_g[:, _BC_METALLIC], rows_g[:, _BC_ROUGHNESS])


def unpack_shading_cols(cols: torch.Tensor):
    """Component-planar unpack of a transposed gathered slab (C, R)
    (compound_ray_tpu/trace/lighting.py:224).  Returns ((e1x, e1y, e1z),
    (e2...), (n0...), (n1...), (n2...), has_n, metallic, roughness), every
    entry (R,)."""
    e1 = (cols[0], cols[1], cols[2])
    e2 = (cols[3], cols[4], cols[5])
    n0 = (cols[6], cols[7], cols[8])
    n1 = (cols[9], cols[10], cols[11])
    n2 = (cols[12], cols[13], cols[14])
    return (e1, e2, n0, n1, n2, cols[_BC_HAS_N] > 0.5,
            cols[_BC_METALLIC], cols[_BC_ROUGHNESS])


def triangle_dpduv(scene: Dict[str, Any], tri: torch.Tensor):
    """UV-parametrisation tangents (dpdu, dpdv), each (R, 3), of triangles
    tri (compound_ray_tpu/trace/lighting.py:118; cuda/LocalGeometry.h:
    193-205): the reference solves [dp1 dp2] = [du1 dv1; du2 dv2] [dpdu
    dpdv] with dp1 = P0 - P2 = -e2 and dp2 = P1 - P2 = e1 - e2.  The
    triangles are baked to world space, so the tangents are too."""
    tri = tri.long()
    return _dpduv_vals(scene["e1"][tri], scene["e2"][tri], scene["uv0"][tri],
                       scene["uv1"][tri], scene["uv2"][tri])


def _dpduv_vals(e1, e2, uv0, uv1, uv2):
    """UV-parametrisation tangents (dpdu, dpdv), each (R, 3), from gathered
    per-ray values (compound_ray_tpu/trace/lighting.py:136;
    cuda/LocalGeometry.h:193-205).  A degenerate UV mapping gives zero
    tangents, which the caller's normalise guard turns into no
    perturbation."""
    dp1 = -e2
    dp2 = e1 - e2
    du1 = (uv0[:, 0] - uv2[:, 0])[:, None]
    du2 = (uv1[:, 0] - uv2[:, 0])[:, None]
    dv1 = (uv0[:, 1] - uv2[:, 1])[:, None]
    dv2 = (uv1[:, 1] - uv2[:, 1])[:, None]
    det = du1 * dv2 - dv1 * du2
    inv = torch.where(torch.abs(det) < 1e-20, 0.0,
                      1.0 / torch.where(det == 0.0, 1.0, det))
    dpdu = (dv2 * dp1 - dv1 * dp2) * inv
    dpdv = (-du2 * dp1 + du1 * dp2) * inv
    return dpdu, dpdv


def _unit(x: torch.Tensor) -> torch.Tensor:
    """Rows of x (R, 3) scaled to unit length, guarded at 1e-20
    (compound_ray_tpu/trace/lighting.py:152)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-20)


def apply_material_textures(scene: Dict[str, Any], tri: torch.Tensor,
                            uv: torch.Tensor, n: torch.Tensor,
                            metallic: torch.Tensor, roughness: torch.Tensor):
    """Metallic-roughness texture and normal-map modulation of the hits on
    triangles tri (R,) at texture coordinates uv (R, 2) with unit normals n
    (R, 3) (compound_ray_tpu/trace/lighting.py:156; shaders.cu:838-852).
    Callers gate on "mat_mr_tex" in scene.  Returns (n, metallic,
    roughness)."""
    tri = tri.long()
    mat = torch.clamp(scene["mat_id"][tri], min=0).long()
    dpdu, dpdv = triangle_dpduv(scene, tri)
    return _apply_material_textures_vals(
        scene, scene["mat_mr_tex"][mat], scene["mat_normal_tex"][mat], uv, n,
        metallic, roughness, dpdu, dpdv)


def apply_material_textures_from_rows(scene: Dict[str, Any], rows_g, n,
                                      metallic, roughness, u, v):
    """Metallic-roughness and normal-map modulation fed from the gathered
    (R, 26) shading slab (compound_ray_tpu/trace/lighting.py:182;
    shaders.cu:838-852): roughness *= mr.g, metallic *= mr.b, and
    N = normalize(NN.x * unit(dpdu) + NN.y * unit(dpdv) + NN.z * N) with
    NN = 2 * tex - 1.  n is (R, 3) unit normals, u and v the hit's
    barycentrics (R,).  Returns (n, metallic, roughness)."""
    w = (1.0 - u - v)[:, None]
    uv0 = rows_g[:, _BC_UV0]
    uv1 = rows_g[:, _BC_UV1]
    uv2 = rows_g[:, _BC_UV2]
    uv = w * uv0 + u[:, None] * uv1 + v[:, None] * uv2
    mr_tex = rows_g[:, _BC_MR_TEX].to(torch.int32)
    nm_tex = rows_g[:, _BC_NM_TEX].to(torch.int32)
    dpdu, dpdv = _dpduv_vals(rows_g[:, _BC_E1], rows_g[:, _BC_E2], uv0, uv1,
                             uv2)
    return _apply_material_textures_vals(scene, mr_tex, nm_tex, uv, n,
                                         metallic, roughness, dpdu, dpdv)


def _apply_material_textures_vals(scene, mr_tex, nm_tex, uv, n, metallic,
                                  roughness, dpdu, dpdv):
    """The modulation itself on per-ray texture ids and tangents
    (compound_ray_tpu/trace/lighting.py:210)."""
    mr = sample_texture(scene, mr_tex, uv)
    has_mr = mr_tex >= 0
    roughness = torch.where(has_mr, roughness * mr[:, 1], roughness)
    metallic = torch.where(has_mr, metallic * mr[:, 2], metallic)
    nn = sample_texture(scene, nm_tex, uv) * 2.0 - 1.0
    n_pert = (nn[:, 0:1] * _unit(dpdu) + nn[:, 1:2] * _unit(dpdv)
              + nn[:, 2:3] * n)
    n = torch.where((nm_tex >= 0)[:, None], _unit(n_pert), n)
    return n, metallic, roughness


def ggx_light_contrib_planar(n, view, l, base, metallic, roughness,
                             lcol, lint):
    """One light's unoccluded GGX/Schlick contribution on component-planar
    inputs (compound_ray_tpu/trace/lighting.py:244; shaders.cu:826-881).
    n, view (hit to eye), l (hit to light) and base are 3-tuples of (R,)
    tensors, metallic and roughness (R,), lcol a 3-sequence and lint a
    scalar (Python floats or 0-d tensors).  Returns ((cr, cg, cb), facing)
    with facing = n.l > 0 and n.v > 0."""
    nx, ny, nz = n
    vx, vy, vz = view
    lx, ly, lz = l
    f0 = 0.04
    one_m_m = 1.0 - metallic
    alpha = roughness * roughness
    hx, hy, hz = lx + vx, ly + vy, lz + vz
    hinv = 1.0 / torch.clamp(torch.sqrt(hx * hx + hy * hy + hz * hz),
                             min=1e-20)
    hx, hy, hz = hx * hinv, hy * hinv, hz * hinv
    n_dot_l = nx * lx + ny * ly + nz * lz
    n_dot_v = nx * vx + ny * vy + nz * vz
    n_dot_h = nx * hx + ny * hy + nz * hz
    v_dot_h = vx * hx + vy * hy + vz * hz
    facing = (n_dot_l > 0.0) & (n_dot_v > 0.0)
    pw5 = torch.pow(1.0 - v_dot_h, 5.0)
    g_vis = _vis(n_dot_l, n_dot_v, alpha)
    d = _ggx_normal(n_dot_h, alpha)
    scale = lint * n_dot_l
    out = []
    for c, bc in enumerate(base):
        spec_c = f0 * one_m_m + bc * metallic
        diff_c = bc * (1.0 - f0) * one_m_m
        f = spec_c + (1.0 - spec_c) * pw5
        out.append(lcol[c] * scale
                   * ((1.0 - f) * diff_c / math.pi + f * g_vis * d))
    return tuple(out), facing


def ggx_light_contrib(n, view, l, base, metallic, roughness, lcol, lint):
    """One light's unoccluded GGX/Schlick contribution on (R, 3) rows: unit
    normal n, view (hit to eye) and l (hit to light), base colour; metallic
    and roughness (R,); lcol (3,) and lint () (compound_ray_tpu/trace/
    lighting.py:286; shaders.cu:826-881).  Returns (contrib (R, 3), facing
    (R,)) with facing = n.l > 0 and n.v > 0."""
    f0 = 0.04
    diff_color = base * (1.0 - f0) * (1.0 - metallic[:, None])
    spec_color = f0 * (1.0 - metallic[:, None]) + base * metallic[:, None]
    alpha = roughness * roughness
    h = l + view
    h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True),
                        min=1e-20)
    n_dot_l = dot3(n, l)
    n_dot_v = dot3(n, view)
    n_dot_h = dot3(n, h)
    v_dot_h = dot3(view, h)
    facing = (n_dot_l > 0.0) & (n_dot_v > 0.0)
    f = _schlick(spec_color, v_dot_h)
    g_vis = _vis(n_dot_l, n_dot_v, alpha)[:, None]
    d = _ggx_normal(n_dot_h, alpha)[:, None]
    diff = (1.0 - f) * diff_color / math.pi
    spec = f * g_vis * d
    contrib = lcol[None, :] * lint * n_dot_l[:, None] * (diff + spec)
    return contrib, facing


def _schlick(spec_color, v_dot_h):
    """Schlick's Fresnel (compound_ray_tpu/trace/lighting.py:322)."""
    return spec_color + (1.0 - spec_color) * torch.pow(
        1.0 - v_dot_h, 5.0)[..., None]


def _vis(n_dot_l, n_dot_v, alpha):
    """Smith-GGX visibility (compound_ray_tpu/trace/lighting.py:325)."""
    alpha_sq = alpha * alpha
    ggx0 = n_dot_l * torch.sqrt(n_dot_v * n_dot_v * (1.0 - alpha_sq)
                                + alpha_sq)
    ggx1 = n_dot_v * torch.sqrt(n_dot_l * n_dot_l * (1.0 - alpha_sq)
                                + alpha_sq)
    return 2.0 * n_dot_l * n_dot_v / (ggx0 + ggx1)


def _ggx_normal(n_dot_h, alpha):
    """GGX normal distribution (compound_ray_tpu/trace/lighting.py:332)."""
    alpha_sq = alpha * alpha
    x = n_dot_h * n_dot_h * (alpha_sq - 1.0) + 1.0
    return alpha_sq / (math.pi * x * x)


def ggx_direct(scene: Dict[str, Any], origins: torch.Tensor,
               dirs: torch.Tensor, hit: Dict[str, torch.Tensor],
               base_color: torch.Tensor, lighting: Dict[str, Any]
               ) -> torch.Tensor:
    """The hits' base colours (R, 3) plus GGX direct light from each of
    lighting["lights"] (L, 7) rows [colour, intensity, position], where the
    light faces the hit and its shadow ray is clear: one occlusion_test over
    the whole soup in [0.001, |to light| - 0.001]
    (compound_ray_tpu/trace/lighting.py:338; the light loop of
    __closesthit__radiance, shaders.cu:826-881), with the material-texture
    modulation where a material has such textures."""
    tri = torch.clamp(hit["tri_id"], min=0).long()
    u = hit["u"][:, None]
    v = hit["v"][:, None]
    w = 1.0 - u - v
    e1, e2 = scene["e1"][tri], scene["e2"][tri]
    # hit position P = v0 + u e1 + v e2 (world space already)
    p = scene["v0"][tri] + u * e1 + v * e2
    # shading normal: interpolated vertex normals, else the geometric one
    n_sm = w * scene["n0"][tri] + u * scene["n1"][tri] + v * scene["n2"][tri]
    n = torch.where(scene["has_normals"][tri][:, None], n_sm,
                    cross3(e1, e2))
    n = _unit(n)
    mat = torch.clamp(scene["mat_id"][tri], min=0).long()
    metallic = scene["mat_metallic"][mat]
    roughness = scene["mat_roughness"][mat]
    if "mat_mr_tex" in scene:
        uv = (w * scene["uv0"][tri] + u * scene["uv1"][tri]
              + v * scene["uv2"][tri])
        n, metallic, roughness = apply_material_textures(
            scene, tri, uv, n, metallic, roughness)
    view = -_unit(dirs)
    result = base_color
    lights = torch.as_tensor(lighting["lights"], dtype=torch.float32,
                             device=p.device)
    chunk = oracle_ray_chunk(p.device)
    for li in range(lights.shape[0]):
        to_l = lights[li, 4:7][None, :] - p
        l_dist = torch.linalg.vector_norm(to_l, dim=-1)
        l = to_l / torch.clamp(l_dist[:, None], min=1e-20)
        occluded = occlusion_test(p, l, scene["v0"], scene["e1"], scene["e2"],
                                  0.001, l_dist - 0.001, ray_chunk=chunk)
        contrib, facing = ggx_light_contrib(
            n, view, l, base_color, metallic, roughness, lights[li, 0:3],
            lights[li, 3])
        lit = facing & ~occluded & hit["hit"]
        result = result + torch.where(lit[:, None], contrib, 0.0)
    return result
