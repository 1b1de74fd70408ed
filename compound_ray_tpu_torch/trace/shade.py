"""Miss shaders and texture sampling of the compound-eye frame
(compound_ray_tpu/trace/shade.py in torch).

Colour priority of __closesthit__radiance (shaders.cu:797-824):
  1. vertex colours present -> linearize(interp(C).rgb)   [pow 2.2]
  2. material base-colour texture -> bilinear sample at interpolated UV
  3. material baseColorFactor
Rays that hit nothing take one of the four miss programs
(shaders.cu:745-764).  The frame pipeline works component-planar, with
(R,) tensors per channel; the brute-force oracle's shade_rays and
miss_color work on (R, 3) rows over the intersect_rays result.

Only the general texture path is ported: every textured scene samples
through the (P, 16) quad table with per-ray sampler constants, and the
lit path's material textures through the per-ray four-texel
sample_texture.  The JAX package's single-texture and grayscale variants
(texture_quad_coords_single,
texture_bilinear4_single, quad_bilinear_gray_c) exist to dodge TPU gather
costs and compute the same texels.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

MISS_SHADERS = ("default_background", "white", "black", "simple_sky")


def miss_id(background_shader: str) -> int:
    """Map a miss-program name (scene 'background-shader' extra) to an id
    (compound_ray_tpu/trace/shade.py:27)."""
    name = background_shader
    if name.startswith("__miss__"):
        name = name[len("__miss__"):]
    try:
        return MISS_SHADERS.index(name)
    except ValueError:
        return 0


def miss_color_c(dx, dy, dz, which: int):
    """Miss program `which` for unit direction components (R,) -> (r, g, b)
    components (R,) (compound_ray_tpu/trace/shade.py:69)."""
    pi = math.pi
    if which == 1:  # white
        one = torch.ones_like(dx)
        return one, one, one
    if which == 2:  # black
        zero = torch.zeros_like(dx)
        return zero, zero, zero
    if which == 3:  # simple_sky (shaders.cu:757-764)
        mix = torch.clamp(
            torch.asin(torch.clamp(dy, -1.0, 1.0)) * 2.0 / pi, 0.0, 1.0)
        upper = (1.0 / 255.0, 31.0 / 255.0, 117.0 / 255.0)
        lower = (143.0 / 255.0 * 0.8, 179.0 / 255.0 * 0.8, 203.0 / 255.0 * 0.8)
        return tuple(lo * (1.0 - mix) + up * mix
                     for lo, up in zip(lower, upper))
    # default_background (shaders.cu:745-752)
    u = (torch.atan2(dz, dx) + pi) / (2.0 * pi)
    v = (torch.asin(torch.clamp(dy, -1.0, 1.0)) + pi / 2.0) / pi
    border = 0.01
    on_axis = ((torch.abs(dx) < border) | (torch.abs(dy) < border)
               | (torch.abs(dz) < border))
    return (torch.where(on_axis, 0.0, u), torch.where(on_axis, 0.0, v),
            torch.zeros_like(u))


def miss_color(dirs: torch.Tensor, which: int) -> torch.Tensor:
    """Miss program `which` for (R, 3) ray directions of any length ->
    (R, 3) linear RGB (compound_ray_tpu/trace/shade.py:38)."""
    d = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    return torch.stack(miss_color_c(d[:, 0], d[:, 1], d[:, 2], which),
                       dim=-1)


def shade_rays(scene: Dict[str, Any], dirs: torch.Tensor,
               hit: Dict[str, torch.Tensor], background: int,
               lighting: Dict[str, Any] = None,
               origins: torch.Tensor = None) -> torch.Tensor:
    """(R, 3) linear radiance of traced rays
    (compound_ray_tpu/trace/shade.py:409): `hit` is intersect_rays' dict,
    `background` a miss id.  With lighting ({"lights": (L, 7) rows
    [colour, intensity, position]}) the base colour gets GGX direct light
    with brute-force shadow rays (lighting.ggx_direct, which needs the
    origins); otherwise it is the unlit base colour, the reference's
    default."""
    tri = torch.clamp(hit["tri_id"], min=0).long()
    u = hit["u"][:, None]
    v = hit["v"][:, None]
    w = 1.0 - u - v
    # vertex colour path: interpolate, then linearise (pow 2.2)
    c_interp = w * scene["c0"][tri] + u * scene["c1"][tri] \
        + v * scene["c2"][tri]
    vc_rgb = torch.pow(torch.clamp(c_interp[:, :3], min=0.0), 2.2)
    mat_id = scene["mat_id"][tri]
    mat = torch.clamp(mat_id, min=0).long()
    mat_rgb = scene["mat_base_color"][mat][:, :3]
    tex_id = scene["mat_tex"][mat]
    has_tex = (tex_id >= 0) & (mat_id >= 0)
    if scene["tex_offset"].shape[0] > 0:
        uv = w * scene["uv0"][tri] + u * scene["uv1"][tri] \
            + v * scene["uv2"][tri]
        tex_rgb = sample_texture(scene, tex_id, uv)[:, :3]
    else:
        tex_rgb = mat_rgb
    # priority: vertex colour > texture > material factor (a triangle with
    # mat_id -1 and no vertex colours takes material slot 0)
    base = torch.where(scene["has_color"][tri][:, None], vc_rgb,
                       torch.where(has_tex[:, None], tex_rgb, mat_rgb))
    if lighting is not None:
        from compound_ray_tpu_torch.trace.lighting import ggx_direct

        base = ggx_direct(scene, origins, dirs, hit, base, lighting)
    return torch.where(hit["hit"][:, None], base,
                       miss_color(dirs, background))


def make_color(rgb: torch.Tensor) -> torch.Tensor:
    """Linear RGB (..., 3) -> uchar4 RGBA (..., 4) with clamp and gamma
    1/2.2 (shaders.cu:180-189; compound_ray_tpu/trace/shade.py:465).  The
    reference C-casts (truncates) the scaled value, as here."""
    g = torch.pow(torch.clamp(rgb, 0.0, 1.0), 1.0 / 2.2) * 255.0
    rgbu = torch.floor(g).to(torch.uint8)
    alpha = torch.full(rgbu.shape[:-1] + (1,), 255, dtype=torch.uint8,
                       device=rgbu.device)
    return torch.cat([rgbu, alpha], dim=-1)


def _addr_dynamic(coord, n, mode):
    """Wrap/clamp/mirror texel addressing with per-ray sizes and modes
    (continuous texel space in, clamped int32 texel index out;
    compound_ray_tpu/trace/shade.py:96)."""
    nf = n.to(torch.float32)
    wrapped = coord - torch.floor(coord / nf) * nf  # repeat
    clamped = torch.minimum(torch.clamp(coord, min=0.0), nf - 1.0)
    period = 2.0 * nf
    m = coord - torch.floor(coord / period) * period
    mirrored = torch.where(m < nf, m, period - 1.0 - m)
    out = torch.where(mode == 1, clamped,
                      torch.where(mode == 2, mirrored, wrapped))
    out = torch.minimum(torch.clamp(out, min=0.0), nf - 1.0)
    return out.to(torch.int32)


def sample_texture(scene: Dict[str, Any], tex_id, uv) -> torch.Tensor:
    """(R, 4) per-ray bilinear or nearest fetch from the flat texture atlas
    for texture ids (R,) and coordinates uv (R, 2)
    (compound_ray_tpu/trace/shade.py:128): normalised coordinates,
    wrap/clamp/mirror addressing, texel centres at (i + 0.5) / w, no sRGB
    conversion.  The lit path's metallic-roughness and normal maps read
    through it."""
    safe_tex = torch.clamp(tex_id, min=0).long()
    off = scene["tex_offset"][safe_tex]
    w = scene["tex_width"][safe_tex]
    h = scene["tex_height"][safe_tex]
    wrap_s = scene["tex_wrap_s"][safe_tex]
    wrap_t = scene["tex_wrap_t"][safe_tex]
    filt = scene["tex_filter"][safe_tex]
    x = uv[:, 0] * w.to(torch.float32) - 0.5
    y = uv[:, 1] * h.to(torch.float32) - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f

    def fetch(xi, yi):
        xi = _addr_dynamic(xi, w, wrap_s)
        yi = _addr_dynamic(yi, h, wrap_t)
        return scene["tex_data"][(off + yi * w + xi).long()]

    c00 = fetch(x0f, y0f)
    c10 = fetch(x0f + 1.0, y0f)
    c01 = fetch(x0f, y0f + 1.0)
    c11 = fetch(x0f + 1.0, y0f + 1.0)
    fx4, fy4 = fx[:, None], fy[:, None]
    bilinear = (c00 * (1 - fx4) * (1 - fy4) + c10 * fx4 * (1 - fy4)
                + c01 * (1 - fx4) * fy4 + c11 * fx4 * fy4)
    # nearest rounds half to even, as jnp.round
    nearest = fetch(torch.round(x), torch.round(y))
    return torch.where((filt == 1)[:, None], bilinear, nearest)


def _wrap_index_np(i, n, mode):
    """Integer texel wrap (numpy, build time)."""
    if mode == 1:  # clamp
        return np.clip(i, 0, n - 1)
    if mode == 2:  # mirror
        p = 2 * n
        m = i % p
        return np.where(m < n, m, p - 1 - m)
    return i % n  # repeat


def build_quad_table(scene: Dict[str, Any]) -> np.ndarray:
    """Each texel's wrap-resolved 2x2 neighbourhood, (P, 16) float32 rows
    [c00 | c10 | c01 | c11] x RGBA (compound_ray_tpu/trace/shade.py:173):
    bilinear sampling then reads one row per ray."""
    tex_data = np.asarray(scene["tex_data"])
    offs = np.asarray(scene["tex_offset"])
    ws = np.asarray(scene["tex_width"])
    hs = np.asarray(scene["tex_height"])
    wrap_s = np.asarray(scene["tex_wrap_s"])
    wrap_t = np.asarray(scene["tex_wrap_t"])
    out = np.zeros((tex_data.shape[0], 16), np.float32)
    for t in range(len(offs)):
        o, w, h = int(offs[t]), int(ws[t]), int(hs[t])
        img = tex_data[o:o + w * h].reshape(h, w, 4)
        x1 = _wrap_index_np(np.arange(w) + 1, w, int(wrap_s[t]))
        y1 = _wrap_index_np(np.arange(h) + 1, h, int(wrap_t[t]))
        q = np.concatenate(
            [img, img[:, x1], img[y1][:, :], img[y1][:, x1]], axis=-1
        )  # (h, w, 16): c00 c10 c01 c11
        out[o:o + w * h] = q.reshape(-1, 16)
    return out


def texture_quad_coords_c(scene: Dict[str, Any], tex_id, cu, cv):
    """(row index (R,) int64, fx, fy) into the quad table for per-ray
    texture ids and coordinates (compound_ray_tpu/trace/shade.py:261).
    Nearest-filter textures get fx = fy = 0 with a rounded base texel, so
    one bilinear blend covers both filter modes."""
    safe_tex = torch.clamp(tex_id, min=0).long()
    off = scene["tex_offset"][safe_tex]
    w = scene["tex_width"][safe_tex]
    h = scene["tex_height"][safe_tex]
    wrap_s = scene["tex_wrap_s"][safe_tex]
    wrap_t = scene["tex_wrap_t"][safe_tex]
    filt = scene["tex_filter"][safe_tex]

    x = cu * w.to(torch.float32) - 0.5
    y = cv * h.to(torch.float32) - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    linear = filt == 1
    fx = torch.where(linear, x - x0f, 0.0)
    fy = torch.where(linear, y - y0f, 0.0)
    # nearest-filter rounds (half to even, as jnp.round); bilinear takes
    # the floor cell
    xi = _addr_dynamic(torch.where(linear, x0f, torch.round(x)), w, wrap_s)
    yi = _addr_dynamic(torch.where(linear, y0f, torch.round(y)), h, wrap_t)
    return (off + yi * w + xi).long(), fx, fy


def quad_bilinear_c(quad, fx, fy):
    """Blend gathered (R, 16) quad rows with weights (fx, fy) -> planar
    (r, g, b) (compound_ray_tpu/trace/shade.py:383)."""
    w00 = (1.0 - fx) * (1.0 - fy)
    w10 = fx * (1.0 - fy)
    w01 = (1.0 - fx) * fy
    w11 = fx * fy

    def ch(c):
        return (quad[:, c] * w00 + quad[:, c + 4] * w10
                + quad[:, c + 8] * w01 + quad[:, c + 12] * w11)

    return ch(0), ch(1), ch(2)
