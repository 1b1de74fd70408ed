"""The plain reference of one compound-eye frame, in PyTorch.

It works out a frame from the benchmark's own scene and eye arrays
(scene.py), the pose, the sample count and the seed, and nothing that the
program made:

1. The sample angles.  The program documents its draw: frame f of an eye
   seeds a torch.Generator on the render device with
   (base_seed & 0xFFFFFFFF) << 32 | f, then draws normal splay angles
   (sd = acceptance / FWHM_SD_RATIO) and uniform spin angles in [0, pi),
   each an (ommatidia, samples) plane in its group order: ommatidia sorted
   by 0.35-radian bands of the axis's polar angle, then by azimuth, padded
   to a multiple of the group size with the last.  draw_angles is a frozen
   copy of that draw, so both sides trace the same rays.
2. Rays: CompoundRay's generateOffsetRay (shaders.cu:653-664): splay about
   normalize(+y x axis) (+z where that is zero), then spin about the axis;
   origin = eye position + local space . (position - axis * focal offset).
3. Closest hit: Moller-Trumbore, both-sided, over every triangle that
   could meet the ray.  A triangle is skipped only where its bounding
   sphere lies wholly outside the cone about the ommatidium's axis that
   holds all of that ommatidium's rays, which no ray can then hit: the
   answer is the brute-force one over the whole soup.
4. Shading: vertex colours interpolated and raised to 2.2, else the
   material's texture (bilinear or nearest, wrap / clamp / mirror, texel
   centres at (i + 0.5) / w), else its base colour; misses take the
   background miss shader (shaders.cu:745-764).
5. The mean over each ommatidium's samples.

There is no far-field cache here: every ray is traced to its exact hit,
so the gap to the program's frame includes what its cache approximates.

It imports neither the program nor JAX.  `dtype` computes the rays, the
hits and the shading in another precision (the control: bfloat16 for the
float32 the configurations state); the draw and the cull stay float32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from benchmark.scene import SceneArrays

# FWHM of a Gaussian = 2 sqrt(2 ln 2) sigma (shaders.cu:53)
FWHM_SD_RATIO = 2.35482004503094938202313865291
MISS_SHADERS = ("default_background", "white", "black", "simple_sky")
CULL_MARGIN = 1e-3  # radians added to each cone: float32 rounding


def frame_seed(base_seed: int, frame: int) -> int:
    return ((int(base_seed) & 0xFFFFFFFF) << 32) | (int(frame) & 0xFFFFFFFF)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def group_order(omms: np.ndarray, samples: int) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """(perm (Np,), row (N,)): the draw's row order and the row of each
    ommatidium in it."""
    n = omms.shape[0]
    g = max(1, min(32, _ceil_to(128, max(samples, 1)) // max(samples, 1)))
    d = omms[:, 3:6].astype(np.float64)
    dn = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    theta = np.arccos(np.clip(dn[:, 1], -1, 1))
    phi = np.arctan2(dn[:, 2], dn[:, 0])
    band = np.floor(theta / 0.35).astype(np.int64)
    order = np.lexsort((phi, band))
    perm = np.concatenate([order, np.full(_ceil_to(n, g) - n, order[-1])])
    row = np.empty(n, np.int64)
    row[order] = np.arange(n)
    return perm, row


def draw_angles(omms: np.ndarray, samples: int, base_seed: int, frame: int,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, S) splay and spin angles of frame `frame`, in ommatidium order,
    drawn on `device` as the program draws them."""
    perm, row = group_order(omms, samples)
    gen = torch.Generator(device=device)
    gen.manual_seed(frame_seed(base_seed, frame))
    sd = torch.as_tensor(omms[perm], device=device)[:, 6] / FWHM_SD_RATIO
    splay = torch.randn((len(perm), samples), generator=gen,
                        device=device) * sd[:, None]
    spin = torch.rand((len(perm), samples), generator=gen,
                      device=device) * math.pi
    idx = torch.as_tensor(row, device=device)
    return splay[idx], spin[idx]


def _rotate(p, angle, a):
    """Rodrigues rotation of component triples p about a (unnormalised)."""
    c, s = torch.cos(angle), torch.sin(angle)
    cross = (a[1] * p[2] - a[2] * p[1], a[2] * p[0] - a[0] * p[2],
             a[0] * p[1] - a[1] * p[0])
    k = (1.0 - c) * (a[0] * p[0] + a[1] * p[1] + a[2] * p[2])
    return tuple(c * p[i] + s * cross[i] + k * a[i] for i in range(3))


def eye_rays(omms: np.ndarray, position, local_space, splay, spin,
             dtype=torch.float32):
    """Origins (N, 3), unit directions (N, S, 3) and tmin (N,) of a frame."""
    dev = splay.device
    om = torch.as_tensor(omms, device=dev).to(dtype)
    L = torch.as_tensor(np.asarray(local_space, np.float32),
                        device=dev).to(dtype)
    pos = torch.as_tensor(np.asarray(position, np.float32),
                          device=dev).to(dtype)
    a = om[:, 3:6]
    alen = torch.sqrt((a * a).sum(-1))
    focal = om[:, 7]
    rel = om[:, 0:3] - a / alen[:, None] * focal[:, None]
    origins = pos + (rel[:, 0:1] * L[0] + rel[:, 1:2] * L[1]
                     + rel[:, 2:3] * L[2])
    ax, ay, az = (a[:, i:i + 1] for i in range(3))
    pnorm = torch.sqrt(az * az + ax * ax)
    degenerate = (az - ax) == 0.0
    perp = (torch.where(degenerate, 0.0, az / pnorm.clamp(min=1e-30)),
            torch.zeros_like(ax),
            torch.where(degenerate, 1.0, -ax / pnorm.clamp(min=1e-30)))
    splay, spin = splay.to(dtype), spin.to(dtype)
    d = _rotate((ax, ay, az), splay, perp)
    d = _rotate(d, spin, (ax, ay, az))
    w = [d[0] * L[0, i] + d[1] * L[1, i] + d[2] * L[2, i] for i in range(3)]
    inv = torch.rsqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])
    dirs = torch.stack([c * inv for c in w], dim=-1)
    return origins, dirs, focal * alen


def _ggx(n, view, l, base, colour, intensity, metallic=0.0,
         roughness=0.5):
    """One light's GGX/Schlick term (shaders.cu:826-881) for unit normals
    n, view and light directions (..., 3), base colours (..., 3) and the
    default material (metallic 0, roughness 0.5): (contribution (..., 3),
    facing (...,) = n.l > 0 and n.v > 0)."""
    f0 = 0.04
    alpha = roughness * roughness
    a2 = alpha * alpha
    h = l + view
    h = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp(
        min=1e-20)
    nl = (n * l).sum(-1)
    nv = (n * view).sum(-1)
    nh = (n * h).sum(-1)
    vh = (view * h).sum(-1)
    spec = f0 * (1.0 - metallic) + base * metallic
    diff = base * (1.0 - f0) * (1.0 - metallic)
    fres = spec + (1.0 - spec) * torch.pow(1.0 - vh, 5.0)[..., None]
    vis = 2.0 * nl * nv / (nl * torch.sqrt(nv * nv * (1.0 - a2) + a2)
                           + nv * torch.sqrt(nl * nl * (1.0 - a2) + a2))
    x = nh * nh * (a2 - 1.0) + 1.0
    d = a2 / (math.pi * x * x)
    contrib = colour * intensity * nl[..., None] * (
        (1.0 - fres) * diff / math.pi + fres * (vis * d)[..., None])
    return contrib, (nl > 0.0) & (nv > 0.0)


class Reference:
    """The reference frame renderer of one scene on one device."""

    def __init__(self, scene: SceneArrays, device, dtype=torch.float32,
                 budget: Optional[int] = None):
        self.scene = scene
        self.device = torch.device(device)
        self.dtype = dtype
        self.budget = budget or (
            1 << 24 if self.device.type == "cuda" else 1 << 20)
        dev, dt = self.device, dtype
        p = scene.corners()  # (T, 3, 3) float64
        self.v0 = torch.as_tensor(p[:, 0].astype(np.float32), device=dev)
        self.e1 = torch.as_tensor((p[:, 1] - p[:, 0]).astype(np.float32),
                                  device=dev)
        self.e2 = torch.as_tensor((p[:, 2] - p[:, 0]).astype(np.float32),
                                  device=dev)
        centre = p.mean(axis=1)
        radius = np.linalg.norm(p - centre[:, None], axis=2).max(axis=1)
        self.centre = torch.as_tensor(centre, dtype=torch.float32,
                                      device=dev)
        self.radius = torch.as_tensor(radius * (1 + 1e-5) + 1e-6,
                                      dtype=torch.float32, device=dev)
        t = scene.num_triangles
        if scene.vertex_colors is not None:
            vc = scene.vertex_colors[scene.faces][..., :3]  # (T, 3, 3)
            self.vcol = torch.as_tensor(vc, device=dev).to(dt)
        else:
            self.vcol = None
        mat_id = (scene.mat_id if scene.mat_id is not None
                  else np.zeros(t, np.int32))
        mat_color = (scene.mat_color if scene.mat_color is not None
                     else np.array([[0.8, 0.8, 0.8, 1.0]], np.float32))
        mat_tex = (scene.mat_tex if scene.mat_tex is not None
                   else np.full(len(mat_color), -1, np.int32))
        self.tri_color = torch.as_tensor(mat_color[mat_id][:, :3],
                                         device=dev).to(dt)
        self.tri_tex = torch.as_tensor(mat_tex[mat_id].astype(np.int64),
                                       device=dev)
        self.uv = (torch.as_tensor(scene.uv, device=dev).to(dt)
                   if scene.uv is not None else None)
        if scene.textures:
            sizes = [tx.data.shape[0] * tx.data.shape[1]
                     for tx in scene.textures]
            self.tex_off = torch.as_tensor(np.cumsum([0] + sizes[:-1]),
                                           device=dev)
            self.tex_w = torch.as_tensor(
                [tx.data.shape[1] for tx in scene.textures], device=dev)
            self.tex_h = torch.as_tensor(
                [tx.data.shape[0] for tx in scene.textures], device=dev)
            self.tex_mode = torch.as_tensor(
                [[tx.wrap_s, tx.wrap_t, tx.filter] for tx in scene.textures],
                device=dev)
            self.texels = torch.as_tensor(np.concatenate(
                [tx.data.reshape(-1, 4)[:, :3] for tx in scene.textures]),
                device=dev).to(dt)
        self.miss = MISS_SHADERS.index(scene.background) \
            if scene.background in MISS_SHADERS else 0

    # ------------------------------------------------------------ tracing
    def _cull(self, origins, axes, half, length=None):
        """(N, T) bool: triangles whose bounding spheres meet each cone
        (apex origin, unit axis, half-angle half) within `length` of its
        apex (unbounded when None)."""
        w = self.centre[None] - origins[:, None]  # (N, T, 3)
        dist = torch.sqrt((w * w).sum(-1))
        cosang = (w * axes[:, None]).sum(-1) / dist.clamp(min=1e-30)
        ang = torch.acos(cosang.clamp(-1.0, 1.0))
        r = self.radius[None]
        reach = torch.asin((r / dist.clamp(min=1e-30)).clamp(max=1.0))
        keep = (dist <= r) | (ang <= half[:, None] + reach + CULL_MARGIN)
        if length is not None:
            keep &= dist - r <= length[:, None] * (1 + 1e-5) + 1e-4
        return keep

    def _closest(self, o, d, tmin, ids, live):
        """Closest hits of rays d (C, s, 3) from origins o (C, 3) over the
        candidate triangles ids (C, K) (live marks the real ones): (t, u, v,
        tri), each (C, s); t is inf and tri -1 on a miss."""
        dt = self.dtype
        v0, e1, e2 = (x[ids].to(dt) for x in (self.v0, self.e1, self.e2))
        # (C, 1, K) per-triangle terms, (C, s, 1) per-ray terms
        v0, e1, e2 = v0[:, None], e1[:, None], e2[:, None]
        dx, dy, dz = (d[..., i:i + 1] for i in range(3))
        e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
        e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv = torch.where(det == 0.0, 0.0, 1.0 / det)
        tv = o[:, None, None, :] - v0  # (C, 1, K, 3)
        tx, ty, tz = tv[..., 0], tv[..., 1], tv[..., 2]
        u = (tx * px + ty * py + tz * pz) * inv
        qx, qy, qz = ty * e1z - tz * e1y, tz * e1x - tx * e1z, \
            tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = (e2x * qx + e2y * qy + e2z * qz) * inv
        ok = ((det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t >= tmin[:, None, None]) & live[:, None, :])
        t = torch.where(ok, t, torch.inf)
        j = torch.argmin(t, dim=2, keepdim=True)
        tj = torch.gather(t, 2, j)[..., 0]
        uj = torch.gather(u.expand_as(t), 2, j)[..., 0]
        vj = torch.gather(v, 2, j)[..., 0]
        tri = torch.gather(ids[:, None, :].expand(t.shape), 2, j)[..., 0]
        tri = torch.where(torch.isinf(tj), -1, tri)
        return tj, uj, vj, tri

    def trace(self, origins, dirs, tmin, valid=None, length=None):
        """(t, u, v, tri) of every ray (N, S): rays dirs (N, S, 3) from
        origins (N, 3), hits at t >= tmin (N,) in units of |dirs|.  Only
        the rays that `valid` (N, S) marks need be right; `length` (N,)
        bounds how far along from its origin a ray can meet anything."""
        n, s = dirs.shape[:2]
        dev = self.device
        unit = dirs.float() / torch.linalg.vector_norm(
            dirs.float(), dim=-1, keepdim=True).clamp(min=1e-30)
        if valid is None:
            valid = torch.ones((n, s), dtype=torch.bool, device=dev)
        axes = torch.where(valid[..., None], unit, 0.0).sum(dim=1)
        axes = axes / torch.linalg.vector_norm(
            axes, dim=-1, keepdim=True).clamp(min=1e-30)
        cosd = (unit * axes[:, None]).sum(-1).clamp(-1.0, 1.0)
        half = torch.where(valid, torch.acos(cosd), 0.0).amax(dim=1)
        cand = self._cull(origins.float(), axes, half, length)
        cand &= valid.any(dim=1)[:, None]
        counts = cand.sum(dim=1)
        order = torch.argsort(counts).cpu().numpy()
        counts_np = counts.cpu().numpy()
        out_t = torch.full((n, s), torch.inf, dtype=self.dtype, device=dev)
        out_u = torch.zeros((n, s), dtype=self.dtype, device=dev)
        out_v = torch.zeros((n, s), dtype=self.dtype, device=dev)
        out_tri = torch.full((n, s), -1, dtype=torch.int64, device=dev)
        i = 0
        while i < n:
            c = 1
            while (i + c < n and (c + 1) * s * max(1, counts_np[order[i + c]])
                   <= self.budget):
                c += 1
            sel = torch.as_tensor(order[i:i + c], device=dev)
            k = max(1, int(counts_np[order[i + c - 1]]))
            ids = torch.argsort((~cand[sel]).to(torch.int8), dim=1,
                                stable=True)[:, :k]
            live = torch.arange(k, device=dev)[None] < counts[sel][:, None]
            step = max(1, self.budget // (c * k))
            for s0 in range(0, s, step):
                cols = slice(s0, min(s, s0 + step))
                t, u, v, tri = self._closest(
                    origins[sel], dirs[sel, cols], tmin[sel], ids, live)
                out_t[sel, cols], out_u[sel, cols] = t, u
                out_v[sel, cols], out_tri[sel, cols] = v, tri
            i += c
        return out_t, out_u, out_v, out_tri

    # ------------------------------------------------------------ shading
    def _texture(self, tex, uv):
        """(R, 3) texels of textures tex (R,) at uv (R, 2)."""
        w, h = self.tex_w[tex], self.tex_h[tex]
        mode = self.tex_mode[tex]
        x = uv[:, 0].float() * w - 0.5
        y = uv[:, 1].float() * h - 0.5

        def wrap(i, n, m):
            rep = torch.remainder(i, n)
            clamp = i.clamp(min=0).minimum(n - 1)
            per = torch.remainder(i, 2 * n)
            mirror = torch.where(per < n, per, 2 * n - 1 - per)
            return torch.where(m == 1, clamp, torch.where(m == 2, mirror,
                                                          rep))

        def fetch(xi, yi):
            xi = wrap(xi, w, mode[:, 0])
            yi = wrap(yi, h, mode[:, 1])
            return self.texels[self.tex_off[tex] + yi * w + xi]

        x0, y0 = torch.floor(x), torch.floor(y)
        fx = (x - x0).to(self.dtype)[:, None]
        fy = (y - y0).to(self.dtype)[:, None]
        x0, y0 = x0.long(), y0.long()
        bil = (fetch(x0, y0) * (1 - fx) * (1 - fy)
               + fetch(x0 + 1, y0) * fx * (1 - fy)
               + fetch(x0, y0 + 1) * (1 - fx) * fy
               + fetch(x0 + 1, y0 + 1) * fx * fy)
        near = fetch(torch.round(x).long(), torch.round(y).long())
        return torch.where((mode[:, 2] == 1)[:, None], bil, near)

    def _miss(self, d):
        """(R, 3) background of unit directions d (R, 3)."""
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        if self.miss == 1:
            return torch.ones_like(d)
        if self.miss == 2:
            return torch.zeros_like(d)
        if self.miss == 3:  # simple_sky
            mix = (torch.asin(dy.clamp(-1.0, 1.0)) * 2.0 / math.pi
                   ).clamp(0.0, 1.0)[:, None]
            upper = torch.tensor([1.0, 31.0, 117.0], device=d.device) / 255.0
            lower = torch.tensor([143.0, 179.0, 203.0],
                                 device=d.device) / 255.0 * 0.8
            return (lower * (1.0 - mix) + upper * mix).to(d.dtype)
        u = (torch.atan2(dz, dx) + math.pi) / (2.0 * math.pi)
        v = (torch.asin(dy.clamp(-1.0, 1.0)) + math.pi / 2.0) / math.pi
        edge = (dx.abs() < 0.01) | (dy.abs() < 0.01) | (dz.abs() < 0.01)
        return torch.stack([torch.where(edge, 0.0, u),
                            torch.where(edge, 0.0, v),
                            torch.zeros_like(u)], dim=-1).to(d.dtype)

    def shade(self, dirs, u, v, tri):
        """(N, S, 3) radiance of the traced rays."""
        shape = tri.shape
        d = dirs.reshape(-1, 3)
        u, v, tri = u.reshape(-1), v.reshape(-1), tri.reshape(-1)
        hit = tri >= 0
        t = tri.clamp(min=0)
        w = (1.0 - u - v)[:, None]
        u, v = u[:, None], v[:, None]
        col = self.tri_color[t]
        tex = self.tri_tex[t]
        if self.uv is not None and self.scene.textures:
            uvc = self.uv[t]
            uv = w * uvc[:, 0] + u * uvc[:, 1] + v * uvc[:, 2]
            col = torch.where((tex >= 0)[:, None],
                              self._texture(tex.clamp(min=0), uv), col)
        if self.vcol is not None:
            c = self.vcol[t]
            col = torch.pow((w * c[:, 0] + u * c[:, 1] + v * c[:, 2])
                            .clamp(min=0.0), 2.2)
        rgb = torch.where(hit[:, None], col, self._miss(d))
        return rgb.reshape(shape + (3,))

    def lights(self) -> np.ndarray:
        """CompoundRay's four default point lights about the scene's
        bounds (libEyeRenderer.cpp:130-148), (4, 7) rows [colour,
        intensity, position]."""
        lo = self.scene.vertices.min(axis=0)
        hi = self.scene.vertices.max(axis=0)
        c, off = (lo + hi) / 2.0, float(np.max(hi - lo))
        rows = [([1.0, 1.0, 0.8], 5.0, c + off),
                ([0.8, 0.8, 1.0], 3.0, c + np.array([-off, 0.5 * off,
                                                     -0.5 * off])),
                ([1.0, 1.0, 0.8], 5.0, c + np.array([0.0, 4.0, -5.0])),
                ([1.0, 1.0, 0.8], 0.5, c + np.array([1.0, -6.0, 0.0]))]
        return np.array([list(col) + [i] + list(p) for col, i, p in rows],
                        np.float32)

    def light(self, origins, dirs, t, tri, base):
        """base (N, S, 3) plus GGX/Schlick direct light (shaders.cu:
        826-881) from each default light that the hit faces and that no
        triangle hides: the shadow ray runs from the light to the hit, a
        thousandth short of it (traceOcclusion's tmin)."""
        dt, dev = self.dtype, self.device
        hit = tri >= 0
        tc = torch.where(hit, t, 0.0)[..., None]
        p = origins[:, None, :] + tc * dirs  # (N, S, 3)
        tr = tri.clamp(min=0)
        n = torch.cross(self.e1[tr].to(dt), self.e2[tr].to(dt), dim=-1)
        n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp(
            min=1e-20)
        view = -dirs
        out = base
        for row in torch.as_tensor(self.lights(), device=dev).to(dt):
            to_l = row[4:7] - p
            dist = torch.linalg.vector_norm(to_l, dim=-1, keepdim=True)
            l = to_l / dist.clamp(min=1e-20)
            seg = p + 1e-3 * l - row[4:7]  # light -> just short of the hit
            apex = row[4:7].expand(p.shape[0], 3)
            length = torch.where(hit, torch.linalg.vector_norm(
                seg.float(), dim=-1), 0.0).amax(dim=1)
            ts, _, _, _ = self.trace(apex, seg, torch.zeros_like(length),
                                     valid=hit, length=length)
            shadow = ts <= 1.0
            contrib, facing = _ggx(n, view, l, base, row[0:3], row[3])
            lit = facing & ~shadow & hit
            out = out + torch.where(lit[..., None], contrib, 0.0)
        return out

    # -------------------------------------------------------------- frame
    def frame(self, omms: np.ndarray, position, local_space, samples: int,
              base_seed: int, frame: int, lit: bool = False) -> np.ndarray:
        """(N, 3) float32 per-ommatidium mean radiance of one frame, lit
        by the default lights when `lit`."""
        splay, spin = draw_angles(omms, samples, base_seed, frame,
                                  self.device)
        origins, dirs, tmin = eye_rays(omms, position, local_space, splay,
                                       spin, self.dtype)
        t, u, v, tri = self.trace(origins, dirs, tmin)
        rgb = self.shade(dirs, u, v, tri)
        if lit:
            rgb = self.light(origins, dirs, t, tri, rgb)
        return rgb.mean(dim=1).float().cpu().numpy()
