"""Procedural scenes and eyes for tests and benchmarks (no external assets).

A copy of compound_ray_tpu/testing.py: the same factories, building the
port's FlatScene, so both packages see identical arrays from one call.  At
the end, small frames traced from fixed angles for the card checks.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from types import SimpleNamespace
from typing import List, Tuple

import numpy as np
import torch

from compound_ray_tpu_torch.cameras import fast_image as FI
from compound_ray_tpu_torch.cameras.raygen import camera_rays
from compound_ray_tpu_torch.config import get_config
from compound_ray_tpu_torch.eye import pipeline as P
from compound_ray_tpu_torch.scene.eye_io import Ommatidium
from compound_ray_tpu_torch.scene.flat import FlatScene, build_scene_from_arrays
from compound_ray_tpu_torch.trace.shade import miss_id


def box_mesh(center, size) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-aligned box: 8 vertices, 12 triangles (outward winding)."""
    c = np.asarray(center, np.float64)
    s = np.asarray(size, np.float64) / 2.0
    corners = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        np.float64,
    )
    verts = c + corners * s
    # faces as quads over corner indices (x-,x+,y-,y+,z-,z+)
    quads = [
        (0, 1, 3, 2),  # x-
        (4, 6, 7, 5),  # x+
        (0, 4, 5, 1),  # y-
        (2, 3, 7, 6),  # y+
        (0, 2, 6, 4),  # z-
        (1, 5, 7, 3),  # z+
    ]
    faces = []
    for a, b, cc, d in quads:
        faces.append((a, b, cc))
        faces.append((a, cc, d))
    return verts, np.array(faces, np.int64)


def make_box_scene(
    background: str = "simple_sky",
    colored: bool = True,
) -> FlatScene:
    """A small test scene: a coloured unit cube at the origin over a ground
    plane, plus a distant pillar — enough structure for hit/miss/projection
    coverage."""
    all_v: List[np.ndarray] = []
    all_f: List[np.ndarray] = []
    all_c: List[np.ndarray] = []
    offset = 0

    def add(verts, faces, color):
        nonlocal offset
        all_v.append(verts)
        all_f.append(faces + offset)
        all_c.append(np.tile(np.asarray(color, np.float32), (len(verts), 1)))
        offset += len(verts)

    add(*box_mesh((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), (0.9, 0.2, 0.1, 1.0))
    add(*box_mesh((0.0, -2.0, 0.0), (20.0, 0.2, 20.0)), (0.2, 0.7, 0.2, 1.0))
    add(*box_mesh((3.0, 0.5, -2.0), (0.5, 3.0, 0.5)), (0.2, 0.2, 0.9, 1.0))
    verts = np.concatenate(all_v)
    faces = np.concatenate(all_f)
    colors = np.concatenate(all_c) if colored else None
    return build_scene_from_arrays(
        verts, faces, vertex_colors=colors, background_shader=background,
        name="box-scene",
    )


def make_sphere_eye(
    n: int,
    acceptance_deg: float = 5.0,
    radius: float = 0.1,
    focal_offset: float = 0.0,
) -> List[Ommatidium]:
    """n ommatidia on a Fibonacci sphere, outward-looking (equidistant-ish,
    like the reference's relaxed eyes but deterministic and dependency-free)."""
    golden = (1.0 + math.sqrt(5.0)) / 2.0
    out = []
    for i in range(n):
        theta = 2.0 * math.pi * i / golden
        z = 1.0 - (2.0 * i + 1.0) / n
        r = math.sqrt(max(0.0, 1.0 - z * z))
        d = np.array([r * math.cos(theta), z, r * math.sin(theta)])
        out.append(
            Ommatidium(d * radius, d, math.radians(acceptance_deg), focal_offset)
        )
    return out


def _big_scene_boxes(n_boxes: int, seed: int):
    """make_big_scene's (centre, size, colour) per box, the ground plane
    last."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-50, 50, size=(n_boxes, 3))
    centers[:, 1] = rng.uniform(0.0, 5.0, size=n_boxes)
    sizes = rng.uniform(0.5, 3.0, size=(n_boxes, 3))
    colors = rng.uniform(0.1, 1.0, size=(n_boxes, 3))
    return list(zip(centers, sizes, colors)) + [
        (np.array([0.0, -1.0, 0.0]), np.array([200.0, 0.5, 200.0]),
         np.array([0.3, 0.5, 0.2]))]


def make_big_scene(n_boxes: int = 500, seed: int = 0,
                   background: str = "simple_sky") -> FlatScene:
    """A larger procedural field of boxes for accel/perf testing
    (~12*n_boxes triangles)."""
    all_v, all_f, all_c = [], [], []
    offset = 0
    for center, size, color in _big_scene_boxes(n_boxes, seed):
        v, f = box_mesh(center, size)
        all_v.append(v)
        all_f.append(f + offset)
        all_c.append(np.tile(np.append(color, 1.0).astype(np.float32), (len(v), 1)))
        offset += len(v)
    return build_scene_from_arrays(
        np.concatenate(all_v),
        np.concatenate(all_f),
        vertex_colors=np.concatenate(all_c),
        background_shader=background,
        name=f"big-scene-{n_boxes}",
    )


def natural_sweep(n_poses: int, seed: int, root: str = None):
    """The natural-1000 configuration under the pose-sweep traffic, read
    as data from benchmark/configs/natural-1000.json and
    benchmark/traffic/posesweep-s100.json under `root` (by default the
    repository that holds this package) and built by make_big_scene and
    make_sphere_eye, whose frozen copies the benchmark renders: (scene,
    (N, 8) float32 ommatidia, the RenderConfig fields, samples per
    ommatidium, poses).  poses holds (x, y, z, rx, ry, rz) tuples in
    set_camera_pose's terms: the configuration's pose, then n_poses drawn
    from `seed`, positions uniform in the sweep's region and a yaw
    uniform in its range, each redrawn while the eye's sphere meets a
    box (the ground slab included)."""
    import json
    import os

    from compound_ray_tpu_torch.scene.eye_io import ommatidia_to_array

    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs",
                           "natural-1000.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           "posesweep-s100.json")) as f:
        traffic = json.load(f)
    sc, ey = cfg["scene"], cfg["eye"]
    if (sc["generator"], ey["generator"]) != ("boxes_field", "sphere_eye"):
        raise ValueError(f"natural-1000 names {sc['generator']} and "
                         f"{ey['generator']}, not boxes_field and sphere_eye")
    scene = make_big_scene(**sc["params"])
    e = ey["params"]
    omms = ommatidia_to_array(make_sphere_eye(
        e["n"], e["acceptance_deg"], e["radius"], e["focal_offset"]))
    boxes = _big_scene_boxes(sc["params"]["n_boxes"], sc["params"]["seed"])
    lo_s = np.array([c - s / 2.0 for c, s, _ in boxes])
    hi_s = np.array([c + s / 2.0 for c, s, _ in boxes])
    radius = float(np.max(np.linalg.norm(omms[:, 0:3], axis=1)
                          + np.abs(omms[:, 7])))
    spec = traffic["poses"]
    lo = np.array([r[0] for r in spec["region"]], np.float64)
    hi = np.array([r[1] for r in spec["region"]], np.float64)
    rng = np.random.default_rng(seed)
    poses = [tuple(float(v) for v in cfg["pose"]["position"]
                   + cfg["pose"]["rotation"])]
    drawn = []
    while len(drawn) < n_poses:
        pos = rng.uniform(lo, hi, size=(n_poses, 3))
        yaw = rng.uniform(*spec["yaw"], size=n_poses)
        gap = np.maximum(np.maximum(lo_s[None] - pos[:, None],
                                    pos[:, None] - hi_s[None]), 0.0)
        clear = ~(np.sum(gap * gap, axis=-1) <= radius * radius).any(axis=1)
        drawn += [(float(p[0]), float(p[1]), float(p[2]), 0.0, float(a), 0.0)
                  for p, a in zip(pos[clear], yaw[clear])]
    return (scene, omms, cfg["render_config"], traffic["samples"],
            poses + drawn[:n_poses])


def pose_arrays(pose) -> Tuple[np.ndarray, np.ndarray]:
    """(position (3,), local space (3, 3)), float32, of an (x, y, z, rx,
    ry, rz) pose as set_camera_pose sets it."""
    from compound_ray_tpu_torch.cameras.types import Camera

    cam = Camera("pose")
    cam.set_pose(*pose)
    return (np.asarray(cam.position, np.float32),
            np.asarray(cam.local_space, np.float32))


def make_textured_quad_scene(tex_size: int = 8,
                             background: str = "black") -> FlatScene:
    """A textured floor quad (z-up plane at y=0, 20x20) with a checker
    texture — exercises the texture atlas + tex-only kernel paths."""
    verts = np.array(
        [[-10, 0, -10], [10, 0, -10], [10, 0, 10], [-10, 0, 10]], np.float64
    )
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    scene = build_scene_from_arrays(verts, faces, background_shader=background,
                                    name="textured-quad")
    # uv per corner: map the quad to the full texture
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    scene.uv0 = uvs[faces[:, 0]]
    scene.uv1 = uvs[faces[:, 1]]
    scene.uv2 = uvs[faces[:, 2]]
    scene.has_uv = np.ones(2, bool)
    # checker texture
    yy, xx = np.mgrid[0:tex_size, 0:tex_size]
    checker = ((xx + yy) % 2).astype(np.float32)
    tex = np.stack([checker, 1.0 - checker, np.full_like(checker, 0.5),
                    np.ones_like(checker)], axis=-1)
    scene.tex_data = tex.reshape(-1, 4)
    scene.tex_offset = np.array([0], np.int32)
    scene.tex_width = np.array([tex_size], np.int32)
    scene.tex_height = np.array([tex_size], np.int32)
    scene.tex_wrap_s = np.array([0], np.int32)
    scene.tex_wrap_t = np.array([0], np.int32)
    scene.tex_filter = np.array([1], np.int32)
    scene.mat_tex = np.array([0], np.int32)
    scene._device_cache = None
    return scene


def add_textured_quads(scene):
    """Two textured quads (a near one at z = -4 and a far one at z = -40)
    on a checker texture, appended to a FlatScene of either package."""
    quads = [((-1.0, 1.0, -4.0), (1.0, 3.0, -4.0)),
             ((-12.0, 0.0, -40.0), (12.0, 12.0, -40.0))]
    p0, p1, p2, uv = [], [], [], []
    for (x0, y0, z), (x1, y1, _) in quads:
        a, b = np.array([x0, y0, z]), np.array([x1, y0, z])
        c, d = np.array([x1, y1, z]), np.array([x0, y1, z])
        p0 += [a, a]
        p1 += [b, c]
        p2 += [c, d]
        uv += [([0, 0], [1, 0], [1, 1]), ([0, 0], [1, 1], [0, 1])]
    p0, p1, p2 = (np.array(v, np.float32) for v in (p0, p1, p2))
    uv = np.array(uv, np.float32)
    nt = len(p0)
    z3 = np.zeros((nt, 3), np.float32)
    z4 = np.zeros((nt, 4), np.float32)
    cat = np.concatenate
    scene.v0 = cat([scene.v0, p0])
    scene.e1 = cat([scene.e1, p1 - p0])
    scene.e2 = cat([scene.e2, p2 - p0])
    scene.n0, scene.n1, scene.n2 = (cat([n, z3]) for n in
                                    (scene.n0, scene.n1, scene.n2))
    scene.has_normals = cat([scene.has_normals, np.zeros(nt, bool)])
    scene.uv0, scene.uv1, scene.uv2 = (cat([u, uv[:, i]]) for i, u in
                                       enumerate((scene.uv0, scene.uv1,
                                                  scene.uv2)))
    scene.has_uv = cat([scene.has_uv, np.ones(nt, bool)])
    scene.c0, scene.c1, scene.c2 = (cat([c, z4]) for c in
                                    (scene.c0, scene.c1, scene.c2))
    scene.has_color = cat([scene.has_color, np.zeros(nt, bool)])
    m = scene.mat_base_color.shape[0]
    scene.mat_id = cat([scene.mat_id, np.full(nt, m, np.int32)])
    scene.mat_base_color = cat([scene.mat_base_color,
                                np.ones((1, 4), np.float32)])
    scene.mat_metallic = cat([scene.mat_metallic, np.zeros(1, np.float32)])
    scene.mat_roughness = cat([scene.mat_roughness,
                               np.full(1, 0.5, np.float32)])
    scene.mat_tex = cat([scene.mat_tex, np.zeros(1, np.int32)])
    scene.mat_mr_tex = cat([scene.mat_mr_tex, np.full(1, -1, np.int32)])
    scene.mat_normal_tex = cat([scene.mat_normal_tex,
                                np.full(1, -1, np.int32)])
    yy, xx = np.mgrid[0:8, 0:8]
    checker = ((xx + yy) % 2).astype(np.float32)
    tex = np.stack([checker, 1.0 - checker, np.full_like(checker, 0.5),
                    np.ones_like(checker)], axis=-1)
    scene.tex_data = tex.reshape(-1, 4)
    scene.tex_offset = np.array([0], np.int32)
    scene.tex_width = scene.tex_height = np.array([8], np.int32)
    scene.tex_wrap_s = scene.tex_wrap_t = np.array([0], np.int32)
    scene.tex_filter = np.array([1], np.int32)
    pts = cat([p0, p1, p2])
    scene.aabb_min = np.minimum(scene.aabb_min, pts.min(axis=0))
    scene.aabb_max = np.maximum(scene.aabb_max, pts.max(axis=0))
    scene._device_cache = None
    return scene


def make_mixed_flat_scene(tex_size: int = 8,
                          background: str = "black") -> FlatScene:
    """A textured floor quad + an UNtextured coloured box (two materials,
    no vertex colours) — the ofstad-shaped 'flat attrs' case that the
    emit_flat kernel variant resolves entirely in-register."""
    scene = make_textured_quad_scene(tex_size, background)
    bv, bf = box_mesh((3.0, 1.0, 3.0), (2.0, 2.0, 2.0))
    n0 = scene.v0.shape[0]
    p0, p1, p2 = bv[bf[:, 0]], bv[bf[:, 1]], bv[bf[:, 2]]
    nb = len(bf)
    scene.v0 = np.concatenate([scene.v0, p0.astype(np.float32)])
    scene.e1 = np.concatenate([scene.e1, (p1 - p0).astype(np.float32)])
    scene.e2 = np.concatenate([scene.e2, (p2 - p0).astype(np.float32)])
    z3 = np.zeros((nb, 3), np.float32)
    z2 = np.zeros((nb, 2), np.float32)
    z4 = np.zeros((nb, 4), np.float32)
    scene.n0 = np.concatenate([scene.n0, z3])
    scene.n1 = np.concatenate([scene.n1, z3])
    scene.n2 = np.concatenate([scene.n2, z3])
    scene.has_normals = np.concatenate([scene.has_normals, np.zeros(nb, bool)])
    scene.uv0 = np.concatenate([scene.uv0, z2])
    scene.uv1 = np.concatenate([scene.uv1, z2])
    scene.uv2 = np.concatenate([scene.uv2, z2])
    scene.has_uv = np.concatenate([scene.has_uv, np.zeros(nb, bool)])
    scene.c0 = np.concatenate([scene.c0, z4])
    scene.c1 = np.concatenate([scene.c1, z4])
    scene.c2 = np.concatenate([scene.c2, z4])
    scene.has_color = np.concatenate([scene.has_color, np.zeros(nb, bool)])
    scene.mat_id = np.concatenate(
        [scene.mat_id, np.full(nb, 1, np.int32)]
    )
    scene.mat_base_color = np.concatenate(
        [scene.mat_base_color,
         np.array([[0.2, 0.5, 0.8, 1.0]], np.float32)]
    )
    scene.mat_metallic = np.concatenate(
        [scene.mat_metallic, np.array([0.0], np.float32)]
    )
    scene.mat_roughness = np.concatenate(
        [scene.mat_roughness, np.array([0.5], np.float32)]
    )
    scene.mat_tex = np.concatenate(
        [scene.mat_tex, np.array([-1], np.int32)]
    )
    scene.mat_mr_tex = np.full(2, -1, np.int32)
    scene.mat_normal_tex = np.full(2, -1, np.int32)
    scene.aabb_min = np.minimum(scene.aabb_min, bv.min(axis=0))
    scene.aabb_max = np.maximum(scene.aabb_max, bv.max(axis=0))
    scene._device_cache = None
    return scene


def make_two_texture_scene(background: str = "black") -> FlatScene:
    """Two floor quads side by side, each with its OWN texture (different
    sizes) — exercises multi-texture atlas indexing in every backend."""
    verts = np.array(
        [[-20, 0, -10], [0, 0, -10], [0, 0, 10], [-20, 0, 10],   # left quad
         [0, 0, -10], [20, 0, -10], [20, 0, 10], [0, 0, 10]],    # right quad
        np.float64,
    )
    faces = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int64)
    scene = build_scene_from_arrays(verts, faces, background_shader=background,
                                    name="two-tex")
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]] * 2, np.float32)
    scene.uv0 = uvs[faces[:, 0]]
    scene.uv1 = uvs[faces[:, 1]]
    scene.uv2 = uvs[faces[:, 2]]
    scene.has_uv = np.ones(4, bool)

    # texture 0: solid red 4x4; texture 1: solid blue 8x8
    t0 = np.tile(np.array([1, 0, 0, 1], np.float32), (16, 1))
    t1 = np.tile(np.array([0, 0, 1, 1], np.float32), (64, 1))
    scene.tex_data = np.concatenate([t0, t1])
    scene.tex_offset = np.array([0, 16], np.int32)
    scene.tex_width = np.array([4, 8], np.int32)
    scene.tex_height = np.array([4, 8], np.int32)
    scene.tex_wrap_s = np.zeros(2, np.int32)
    scene.tex_wrap_t = np.zeros(2, np.int32)
    scene.tex_filter = np.ones(2, np.int32)
    scene.mat_base_color = np.array([[1, 1, 1, 1], [1, 1, 1, 1]], np.float32)
    scene.mat_metallic = np.zeros(2, np.float32)
    scene.mat_roughness = np.full(2, 0.5, np.float32)
    scene.mat_tex = np.array([0, 1], np.int32)
    scene.mat_mr_tex = np.full(2, -1, np.int32)
    scene.mat_normal_tex = np.full(2, -1, np.int32)
    scene.mat_id = np.array([0, 0, 1, 1], np.int32)
    scene._device_cache = None
    return scene


def make_mr_normal_scene(background: str = "black") -> FlatScene:
    """The textured floor quad with a metallic-roughness texture and a
    normal map on its material (compound_ray_tpu/testing.py:155): the lit
    path's material-texture modulation.  The MR map halves roughness and
    quarters metallic on the left half; the normal map tilts normals
    toward +u on the left half and leaves them flat on the right."""
    scene = make_textured_quad_scene(8, background)
    scene.mat_metallic = np.array([0.8], np.float32)
    scene.mat_roughness = np.array([0.6], np.float32)
    # upward vertex normals: the quad's winding gives a downward geometric
    # normal, which would fail the facing test for an eye above the floor
    up = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (2, 1))
    scene.n0 = up.copy()
    scene.n1 = up.copy()
    scene.n2 = up.copy()
    scene.has_normals = np.ones(2, bool)
    mr = np.ones((4, 4, 4), np.float32)  # (occlusion, roughness, metal, 1)
    mr[:, :2, 1] = 0.5
    mr[:, :2, 2] = 0.25
    nm = np.empty((4, 4, 4), np.float32)
    nm[:, :, 0] = 0.5
    nm[:, :, 1] = 0.5
    nm[:, :, 2] = 1.0
    nm[:, :, 3] = 1.0
    nm[:, :2, 0] = 0.7
    base = scene.tex_data.shape[0]
    scene.tex_data = np.concatenate(
        [scene.tex_data, mr.reshape(-1, 4), nm.reshape(-1, 4)])
    scene.tex_offset = np.concatenate(
        [scene.tex_offset, np.array([base, base + 16], np.int32)])
    scene.tex_width = np.concatenate([scene.tex_width,
                                      np.array([4, 4], np.int32)])
    scene.tex_height = np.concatenate([scene.tex_height,
                                       np.array([4, 4], np.int32)])
    scene.tex_wrap_s = np.concatenate([scene.tex_wrap_s,
                                       np.zeros(2, np.int32)])
    scene.tex_wrap_t = np.concatenate([scene.tex_wrap_t,
                                       np.zeros(2, np.int32)])
    scene.tex_filter = np.concatenate([scene.tex_filter,
                                       np.ones(2, np.int32)])
    scene.mat_mr_tex = np.array([1], np.int32)
    scene.mat_normal_tex = np.array([2], np.int32)
    scene._device_cache = None
    return scene


def make_silhouette_leak_scene(with_slab: bool = True,
                               pillar_half_width: float = 0.18) -> FlatScene:
    """The shadow plan's adversarial geometry (compound_ray_tpu/testing.py:
    200): a near pillar in front of a far wall, and a horizontal slab that
    shadows the wall but not the pillar from leak_scene_light.  A probe
    whose samples all hit the pillar packs a shaft without the slab; a
    later sample past the pillar's edge hits the wall outside the shaft
    and leaks the wall's light term.

    Layout: pillar x in [-w, w], y in [-2, 2], z = -2; wall x, y in
    [-20, 20], z = -10; slab x in [-12, 12], z in [-11, -4], y = 5."""
    w = pillar_half_width
    quads = [
        ([[-w, -2, -2], [w, -2, -2], [w, 2, -2], [-w, 2, -2]],
         (0.9, 0.3, 0.2)),
        ([[-20, -20, -10], [20, -20, -10], [20, 20, -10], [-20, 20, -10]],
         (0.6, 0.6, 0.6)),
    ]
    if with_slab:
        quads.append(([[-12, 5, -11], [12, 5, -11], [12, 5, -4],
                       [-12, 5, -4]], (0.2, 0.2, 0.8)))
    all_v, all_f, all_c = [], [], []
    off = 0
    for corners, col in quads:
        all_v.append(np.asarray(corners, np.float64))
        all_f.append(np.array([[0, 1, 2], [0, 2, 3]], np.int64) + off)
        all_c.append(np.tile(np.asarray(col, np.float32), (4, 1)))
        off += 4
    return build_scene_from_arrays(
        np.concatenate(all_v), np.concatenate(all_f),
        vertex_colors=np.concatenate(all_c),
        background_shader="black", name="silhouette-leak",
    )


def leak_scene_light() -> np.ndarray:
    """The single point light the leak scene is built around."""
    out = np.zeros((1, 7), np.float32)
    out[0, 0:3] = [1.0, 1.0, 0.9]
    out[0, 3] = 15.0
    out[0, 4:7] = [0.0, 30.0, -7.0]
    return out


def make_canopy_scene() -> FlatScene:
    """A floor, a partial canopy and a side wall, grey-blue, on a black
    background: the mixed-occlusion scene of the JAX package's lit-frame
    test (tests/test_lighting.py:79-98), where the canopy shadows some
    lights and the wall others."""
    v1, f1 = box_mesh((0.0, -1.0, 0.0), (20.0, 0.2, 20.0))
    v2, f2 = box_mesh((3.0, 3.0, 0.0), (4.0, 0.2, 4.0))
    v3, f3 = box_mesh((-4.0, 1.0, 0.0), (0.2, 4.0, 6.0))
    verts = np.concatenate([v1, v2, v3])
    faces = np.concatenate([f1, f2 + len(v1), f3 + len(v1) + len(v2)])
    return build_scene_from_arrays(verts, faces, base_color=(0.4, 0.5, 0.6),
                                   background_shader="black",
                                   name="canopy")


def canopy_eye(accept_deg: float = 2.0) -> List[Ommatidium]:
    """30 ommatidia in a 6 x 5 fan over the canopy scene's floor, looking
    down and outward (tests/test_lighting.py:100-106, with a real
    acceptance cone)."""
    out = []
    for ix in range(6):
        for iz in range(5):
            p = np.array([ix - 2.5, 2.0, iz - 2.0])
            d = np.array([0.15 * (ix - 2.5), -1.0, 0.1 * (iz - 2.0)])
            out.append(Ommatidium(p, d / np.linalg.norm(d),
                                  math.radians(accept_deg), 0.0))
    return out


# -- small frames from fixed angles: the card checks of tests/test_torch_cuda.py
# -- and chip_smoke.py trace the same rays on two devices or through two tracers


def frame_pack(scene: FlatScene, omms: np.ndarray, samples: int, pos,
               device, seed: int = 0, cache_width: int = 0,
               sky: bool = False, affine: bool = False) -> SimpleNamespace:
    """A small frame on `device`: scene and eye plans, the permuted
    ommatidia, the pose (local space = identity), its packed payload at the
    widths it measures (no narrower than the eye plan's hints, which it
    raises as a frame's plan does), and splay and spin angles for every traced group drawn
    with numpy from `seed`, so every device traces the same rays.
    cache_width > 0 turns the far-field cache on at that width (it must
    engage): the pack then holds the near clusters only.  sky also splits
    the frame (it must not decline): the compacted live groups are traced
    and the others take their cache expectation.  affine folds the groups'
    origins into the pack (one ommatidium per group only), and the frame
    then traces affine rays on K1's 8-feature form."""
    device = torch.device(device)
    splan = P.scene_plan(scene, device)
    eplan = P.eye_plan(omms, samples)
    omms_p, inv = eplan.device_arrays(omms, device)
    pos_np = np.asarray(pos, np.float32)
    tpos = torch.tensor(pos_np, device=device)
    tls = torch.eye(3, device=device)
    near = cache = sphere = None
    if cache_width:
        cfg = dataclasses.replace(get_config(), farfield="auto",
                                  farfield_cache_width=cache_width)
        near, cache, sphere = P._farfield_plan(
            splan, eplan, scene.device_triangles(device), omms, pos_np,
            np.eye(3, dtype=np.float32), samples,
            miss_id(scene.background_shader), cfg)
        if near is None:
            raise ValueError("the far-field cache does not engage here")
    rc, pmm, kcand, rmax = P._pack_fused(
        splan.mm_flat, splan.slot_center_cl, splan.slot_radius_cl,
        splan.half_center, splan.half_radius, omms_p, tpos, tls, g=eplan.g,
        kmin=eplan.kmax_hint, rmin=eplan.rmax_hint,
        cull_sigmas=get_config().cull_sigmas,
        tri_cl=P._refine_tri_cl(splan, get_config()), near_mask=near,
        affine=affine)
    eplan.kmax_hint, eplan.rmax_hint = kcand, rmax
    ng, omms_f, sky_means, scatter = eplan.ng, omms_p, None, None
    if sky:
        split = P._sky_build(splan, eplan, omms_p, tls, samples, kcand,
                             rmax, cache, (cache_width // 2, cache_width),
                             rc, pmm)
        if split is None:
            raise ValueError("the sky split declines here")
        pmm, rc, omms_f, scatter, sky_means, ng, _, _ = split
    rng = np.random.default_rng(seed)
    sd = omms_f[:, 6].cpu().numpy() / P.FWHM_SD_RATIO
    shape = (omms_f.shape[0], samples)
    splay = torch.tensor(rng.standard_normal(shape) * sd[:, None],
                         dtype=torch.float32, device=device)
    spin = torch.tensor(rng.uniform(size=shape) * np.pi,
                        dtype=torch.float32, device=device)
    return SimpleNamespace(splan=splan, eplan=eplan, omms_p=omms_f, inv=inv,
                           pos=tpos, ls=tls, row_counts=rc, packed_mm=pmm,
                           rmax=rmax, splay=splay, spin=spin,
                           samples=samples, cache=cache,
                           cache_shape=(cache_width // 2, cache_width),
                           far_sphere=sphere,
                           ng=ng, sky_means=sky_means, sky_scatter=scatter,
                           affine=affine)


def frame_means(scene: FlatScene, f: SimpleNamespace) -> np.ndarray:
    """(N, 3) unlit means of a frame_pack frame, in ommatidium order."""
    ep = f.eplan
    means = P._trace_shade_angles(
        f.packed_mm, f.row_counts, f.splan.attr_table,
        scene.device_triangles(f.pos.device), f.splan.quad_table, f.omms_p,
        f.pos, f.ls, f.splay, f.spin, samples=f.samples,
        background=miss_id(scene.background_shader), ng=f.ng, g=ep.g,
        nrb=ep.nrb, rb_size=ep.rb_size, rmax=f.rmax,
        textured=f.splan.textured, tex_only=f.splan.tex_only, cache=f.cache,
        cache_shape=f.cache_shape, far_sphere=f.far_sphere,
        sky_means=f.sky_means,
        sky_scatter=f.sky_scatter, affine=f.affine)
    return means[f.inv].cpu().numpy()


def shade_inputs(scene: FlatScene, f: SimpleNamespace, frames: int = 1,
                 seed: int = 1, tracer=None):
    """The unlit shading's inputs in a frame_pack frame, as
    _trace_shade_angles hands them to run_shade_means: (out, rays, dirs,
    kw) with K1's (8, R) rows (or `tracer`'s), its rays, the (Np, S)
    direction planes and the remaining keywords.  frames > 1 stacks that
    many frames on the sample axis as a stacked burst does (frame 0's
    angles are f's, the others drawn with numpy from `seed`), in one ray
    block per group."""
    ep = f.eplan
    samples, nrb, rb_size = f.samples, ep.nrb, ep.rb_size
    splay, spin = f.splay, f.spin
    if frames > 1:
        rng = np.random.default_rng(seed)
        sd = f.omms_p[:, 6].cpu().numpy() / P.FWHM_SD_RATIO
        shape = (f.omms_p.shape[0], (frames - 1) * samples)
        dev = splay.device
        splay = torch.cat([splay, torch.tensor(
            rng.standard_normal(shape) * sd[:, None], dtype=torch.float32,
            device=dev)], dim=1)
        spin = torch.cat([spin, torch.tensor(
            rng.uniform(size=shape) * np.pi, dtype=torch.float32,
            device=dev)], dim=1)
        samples *= frames
        nrb, rb_size = 1, P._ceil_to(ep.g * samples, P.MM_BATCH_RAYS)
    rays, origins = P.run_ray_features(
        f.omms_p, f.pos, f.ls, splay, spin, samples=samples, ng=f.ng,
        g=ep.g, nrb=nrb, rb_size=rb_size, affine=f.affine)
    dirs = P.ray_dirs(rays, f.ng, ep.g, samples, nrb * rb_size)
    trace = P.run_packed_tracer if tracer is None else tracer
    out = trace(f.row_counts, f.packed_mm, rays, ng=f.ng, nrb=nrb,
                rb_size=rb_size, rmax=f.rmax, ray_feats=rays.shape[0])
    kw = dict(row_counts=f.row_counts, attr_table=f.splan.attr_table,
              scene_dev=scene.device_triangles(f.pos.device),
              quad_table=f.splan.quad_table, origins=origins,
              background=miss_id(scene.background_shader), ng=f.ng, g=ep.g,
              rg_pad=nrb * rb_size, samples=samples, frames=frames,
              textured=f.splan.textured, tex_only=f.splan.tex_only,
              cache=f.cache, cache_shape=f.cache_shape,
              far_sphere=f.far_sphere)
    return out, rays, dirs, kw


# name -> (ommatidia, g, samples, nrb, rb_size, column step of the angles)
RAYGEN_CASES = {
    "g1-s3200": (6, 1, 3200, 13, 256, 1),
    "g1-s320-pad512": (5, 1, 320, 2, 256, 1),
    "g2-s100": (6, 2, 100, 1, 256, 1),
    "g1-s600-3blocks": (3, 1, 600, 3, 256, 1),
    "burst-3x64": (4, 1, 3 * 64, 1, 256, 1),
    "sharded-columns": (4, 2, 50, 1, 128, 2),
    "degenerate-axes": (8, 2, 16, 1, 64, 1),
}


def raygen_inputs(name: str, device, seed: int = 7) -> dict:
    """run_ray_features' arguments for RAYGEN_CASES[name] on `device`,
    drawn with numpy from `seed` (so every device generates the same
    rays): random ommatidium rows, pose and rotation, and (Np, S) angles
    in the cone jitter's ranges.  A column step of 2 takes every other
    column of wider angle planes, as a sharded frame slices them;
    "degenerate-axes" puts axes along +-y and two axes off it whose perp
    sums to 0 (the reference's test), where perp falls back to +z; a
    burst's F x S columns are drawn as one plane."""
    n, g, samples, nrb, rb_size, step = RAYGEN_CASES[name]
    rng = np.random.default_rng(seed)
    omms = np.zeros((n, 8), np.float32)
    omms[:, 0:3] = rng.normal(size=(n, 3)) * 0.1
    axes = rng.normal(size=(n, 3))
    if name == "degenerate-axes":
        axes[:4] = [[0, 1, 0], [0, -2, 0], [1, 0, 1], [-0.5, 3, -0.5]]
    omms[:, 3:6] = axes * rng.uniform(0.5, 2.0, size=(n, 1))
    omms[:, 6] = np.radians(rng.uniform(2.0, 10.0, size=n))
    omms[:, 7] = rng.uniform(0.0, 0.05, size=n)
    shape = (n, samples * step)
    splay = rng.standard_normal(shape) * (omms[:, 6:7] / P.FWHM_SD_RATIO)
    spin = rng.uniform(size=shape) * np.pi
    rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))

    def dev(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return dict(omms_p=dev(omms), position=dev(rng.normal(size=3) * 5),
                local_space=dev(rot), splay=dev(splay)[:, ::step],
                spin=dev(spin)[:, ::step], samples=samples, ng=n // g, g=g,
                nrb=nrb, rb_size=rb_size)


def hit_agreement(ref, got, row_counts, rg: int):
    """Two (8, R) packed-tracer outputs on live rays (groups with payload
    rows): the share of equal slot ids, and the max absolute and max
    relative t error where the slots agree and hit."""
    live = torch.repeat_interleave(row_counts > 0, rg)
    agree = ref[3][live] == got[3][live]
    both = agree & torch.isfinite(ref[0][live])
    t_ref, t_got = ref[0][live][both], got[0][live][both]
    err = (t_got - t_ref).abs()
    rel = err / t_ref.abs().clamp(min=1e-30)
    return (agree.double().mean().item(),
            err.max().item() if err.numel() else 0.0,
            rel.max().item() if rel.numel() else 0.0)


def edge_moment_bounds(v0, e1, e2) -> np.ndarray:
    """(T, 3) how far the port's edge moments a x b may lie from the JAX
    package's, edge by edge in triangle_constants' order (p1 p2, p2 p0,
    p0 p1).  The port works a x b out in float64 from the float32 corners
    and rounds once (trace/plucker.py); the JAX package rounds each
    product and the difference in float32.  A component then differs by
    at most 3 u |a| |b| (u = 2**-24), inside the 4 ulp of |a| |b| given
    here."""
    p0 = np.asarray(v0, np.float32)
    p1 = p0 + np.asarray(e1, np.float32)
    p2 = p0 + np.asarray(e2, np.float32)
    r0, r1, r2 = (np.linalg.norm(p.astype(np.float64), axis=-1)
                  for p in (p0, p1, p2))
    ab = np.stack([r1 * r2, r2 * r0, r0 * r1], axis=-1).astype(np.float32)
    return 4.0 * np.spacing(ab).astype(np.float64)


def assert_equal_but_moments(got, want, bound, err_msg: str = ""):
    """`got` equal to `want` bit for bit, save the entries where `bound`
    (broadcast to their shape) is above 0, each of which lies within it:
    a table the port and the JAX package build from the same corners,
    the edge moments' entries bounded by edge_moment_bounds."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    gap = np.abs(got - want)
    bound = np.broadcast_to(bound, gap.shape)
    off = ~(gap <= bound)
    assert not off.any(), (
        f"{err_msg}: {int(off.sum())} of {gap.size} entries differ; "
        f"{int((off & (bound == 0)).sum())} of them exact ones, the worst "
        f"moment gap {float((gap / np.where(bound > 0, bound, np.inf)).max())}"
        " of its bound")


def cache_trace_inputs(scene: FlatScene, omms: np.ndarray, pos, device,
                       width: int, split: str = "frame") -> SimpleNamespace:
    """K2's inputs of a far-field cache of `omms` at `pos` (local space =
    identity) on `device`, traced from the eye centre by
    _cache_trace_inputs: counts, ids, dmin, payload, rays, the clusters
    traced (`far`, numpy) and the shape keywords.  split "frame" is the
    cache a frame renders (_frame_cache_args: every cluster that reaches
    past D, from t = D, width x CACHE_SUPERSAMPLE rays wide); "far" the
    split's far clusters and "all" every cluster, from t = 0 at `width`
    rays (the JAX package's cache, and K2 on every cluster)."""
    device = torch.device(device)
    splan = P.scene_plan(scene, device)
    far, center, d = P._farfield_split(
        splan, omms, np.asarray(pos, np.float32), np.eye(3),
        get_config().farfield_tolerance)
    if split == "frame":
        a = P._frame_cache_args(splan, center, d)
        mask, kmax = a["far_mask"], a["kmax"]
        wide, tmin, center = width * a["supersample"], a["tmin"], a["center"]
    elif split in ("far", "all"):
        mask = torch.tensor(far if split == "far" else np.ones_like(far),
                            device=device)
        kmax, wide, tmin = min(splan.num_clusters, 256), width, 0.0
        center = torch.tensor(np.asarray(center, np.float32), device=device)
    else:
        raise ValueError(f"split {split!r}: frame, far or all")
    _, counts, ids, dmin, rays = P._cache_trace_inputs(
        splan.half_center, splan.half_radius, center, mask, wide, kmax, tmin)
    return SimpleNamespace(
        counts=counts, ids=ids, dmin=dmin, payload=splan.payload, rays=rays,
        far=mask.cpu().numpy(),
        kw=dict(ng=counts.shape[0], nrb=1, rb_size=P._CACHE_TILE,
                kmax=kmax))


def cache_cull_inputs(scene: FlatScene, omms: np.ndarray, pose, device,
                      kmax: int = None) -> dict:
    """run_cache_shortlist's keywords for the cache a frame of `omms` at
    `pose` ((x, y, z, rx, ry, rz), set_camera_pose's terms) builds on
    `device` under the current RenderConfig, as _farfield_plan and
    _cache_trace_inputs pass them: the tile cones of the supersampled
    cache, the scene's sub-spheres, the eye centre, the clusters that reach
    past D and the frame's kmax (or `kmax`)."""
    device = torch.device(device)
    splan = P.scene_plan(scene, device)
    pos, ls = pose_arrays(pose)
    cfg = get_config()
    _, center, d = P._farfield_split(splan, omms, pos, ls,
                                     cfg.farfield_tolerance)
    a = P._frame_cache_args(splan, center, d)
    _, centroid, half_ang = P._cache_tile_cones(
        cfg.farfield_cache_width * a["supersample"], device)
    return dict(centroid=centroid, half_ang=half_ang,
                half_center=splan.half_center, half_radius=splan.half_radius,
                center=a["center"], far_mask=a["far_mask"],
                kmax=a["kmax"] if kmax is None else kmax)


def camera_trace_inputs(scene: FlatScene, kind: str, pos, local_space,
                        param, width: int, height: int,
                        device) -> SimpleNamespace:
    """K2's inputs of the tile-culled image of camera `kind` on `device`,
    as render_camera_image_fast traces them: counts, ids, dmin, payload,
    rays and the shape keywords."""
    device = torch.device(device)
    splan = P.scene_plan(scene, device)
    kmax = min(splan.num_clusters, FI.KMAX_CAP)

    def dev(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    counts, ids, dmin, rays, _ = FI.image_trace_inputs(
        splan.sphere_center, splan.sphere_radius, dev(pos), dev(local_space),
        dev(param), kind, width, height, kmax)
    return SimpleNamespace(
        counts=counts, ids=ids, dmin=dmin, payload=splan.payload, rays=rays,
        kw=dict(ng=counts.shape[0], nrb=1, rb_size=FI.TILE, kmax=kmax))


def camera_near_ties(scene: FlatScene, kind: str, pos, local_space, param,
                     width: int, height: int, device,
                     rel: float = 1e-6) -> np.ndarray:
    """(H, W) bool: the pixels of camera `kind` whose two closest hits over
    the whole soup lie within `rel` of each other in t, where two exact
    tracers may keep different winners.  Möller-Trumbore in chunks of 512
    rays, a running two smallest t per ray."""
    from compound_ray_tpu_torch.trace.intersect import moller_trumbore

    device = torch.device(device)
    dev_tris = scene.device_triangles(device)

    def dev(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    o, d, tmin = camera_rays(kind, dev(pos), dev(local_space), dev(param),
                             width, height)
    o = o.expand(d.shape)
    out = []
    for r0 in range(0, d.shape[0], 512):
        best = torch.full((min(512, d.shape[0] - r0), 2), torch.inf,
                          device=device)
        for t0 in range(0, scene.num_triangles, 2048):
            t, _, _, ok = moller_trumbore(
                o[r0:r0 + 512], d[r0:r0 + 512],
                *(dev_tris[k][t0:t0 + 2048] for k in ("v0", "e1", "e2")))
            t = torch.where(ok & (t >= tmin), t, torch.inf)
            best = torch.topk(torch.cat([best, t], dim=1), 2, dim=1,
                              largest=False).values
        out.append((best[:, 1] - best[:, 0]) <= rel * best[:, 0].abs())
    return torch.cat(out).reshape(height, width).cpu().numpy()


def cluster_hit_agreement(ref, got, counts, rg: int):
    """Two (R, 8) cluster-tracer outputs on live rays (groups with
    counts > 0): the share of equal (cluster, lane) winners, and the max
    absolute and max relative t error where the winners agree and hit."""
    live = torch.repeat_interleave(counts > 0, rg)
    r, g = ref[live], got[live]
    agree = (r[:, 3] == g[:, 3]) & (r[:, 4] == g[:, 4])
    both = agree & torch.isfinite(r[:, 0])
    err = (g[both, 0] - r[both, 0]).abs()
    rel = err / r[both, 0].abs().clamp(min=1e-30)
    return (agree.double().mean().item() if agree.numel() else 1.0,
            err.max().item() if err.numel() else 0.0,
            rel.max().item() if rel.numel() else 0.0)


def lit_frame_means(scene: FlatScene, f: SimpleNamespace, lights,
                    tracer=None, shadow_tracer=None) -> np.ndarray:
    """(N, 3) lit means of a frame_pack frame (the far field off), in
    ommatidium order: the shadow plan probes the frame's own angles, then
    the frame traces its shadow rays on K3 (or `shadow_tracer`)."""
    ep = f.eplan
    lights_np = np.asarray(lights, np.float32)
    dev = f.pos.device
    scene_dev = scene.device_triangles(dev)
    pose_sig = (f.pos.cpu().numpy().tobytes(), f.ls.cpu().numpy().tobytes())
    shadow = P._shadow_plan(f.splan, ep, f.omms_p, f.pos, f.ls, pose_sig,
                            lights_np, f.samples, f.splay, f.spin,
                            f.packed_mm, f.row_counts, f.rmax, tracer=tracer,
                            affine=f.affine)
    means = P._trace_shade_angles(
        f.packed_mm, f.row_counts, f.splan.attr_table, scene_dev,
        f.splan.quad_table, f.omms_p, f.pos, f.ls, f.splay, f.spin,
        samples=f.samples, background=miss_id(scene.background_shader),
        ng=f.ng, g=ep.g, nrb=ep.nrb, rb_size=ep.rb_size, rmax=f.rmax,
        textured=f.splan.textured, tex_only=f.splan.tex_only, tracer=tracer,
        lights=torch.as_tensor(lights_np, device=dev),
        slot_tri=f.splan.slot_tri,
        shading_rows=P._shading_rows(f.splan, scene_dev), shadow=shadow,
        shadow_tracer=shadow_tracer, affine=f.affine)
    return means[f.inv].cpu().numpy()


def lit_occlusion_inputs(scene: FlatScene, f: SimpleNamespace, lights):
    """K3's inputs in the lit frame of a frame_pack frame, exactly as the
    frame hands them over: (r2v, flag, flat_rows, rays, {nrb, rb_size}).
    The recorded frame traces its shadow rays through the twin."""
    from compound_ray_tpu_torch.trace.mm_tracer import (
        rows_occlusion_reference,
    )

    seen = []

    def record(*args, **kw):
        seen.append((args, kw))
        return rows_occlusion_reference(*args, **kw)

    lit_frame_means(scene, f, lights, shadow_tracer=record)
    (args, kw), = seen
    return (*args, kw)


def pack_occlusion_table(f: SimpleNamespace, feats: int = 16, skip=(),
                         scale: float = 50.0):
    """A K3 table from a frame_pack frame's pose pack, one row per block,
    sorted by group, with 5 padding rows at the end (flag 0): (r2v, flag,
    flat_rows, rays, row counts (NG,) numpy, {nrb, rb_size}).  Groups in
    `skip` get no rows.  feats 16: the frame's 16-feature rays with the
    direction rows (d and o x d) scaled by `scale`, so t in [0, 1] spans
    that many world units; feats 8: the rows folded with their group's ray
    origin (transform_payload_affine) against [scale d, 1, 0 x 4]."""
    from compound_ray_tpu_torch.trace.mm_tracer import (
        transform_payload_affine,
    )

    ep = f.eplan
    rc = f.row_counts.cpu().numpy().copy()
    rc[list(skip)] = 0
    g_of_row = np.repeat(np.arange(ep.ng), rc)
    j_of_row = np.concatenate([np.arange(c) for c in rc])
    dev = f.packed_mm.device
    rows = f.packed_mm[torch.as_tensor(g_of_row, device=dev),
                       torch.as_tensor(j_of_row, device=dev)]
    flag = np.where(j_of_row == 0, 2, 1).astype(np.int32)
    r2v = g_of_row.astype(np.int32)
    rays, ((ox, oy, oz), tmin) = P.run_ray_features(
        f.omms_p, f.pos, f.ls, f.splay, f.spin, samples=f.samples, ng=ep.ng,
        g=ep.g, nrb=ep.nrb, rb_size=ep.rb_size)
    if feats == 8:
        gi = torch.as_tensor(g_of_row, device=dev)
        rows = transform_payload_affine(
            rows[:, None], torch.stack([ox, oy, oz], dim=-1)[gi],
            tmin[gi])[:, 0, 0:8]
        rays8 = torch.zeros((8, rays.shape[1]), device=dev)
        rays8[0:3] = rays[0:3] * scale
        rays8[3] = 1.0
        rays = rays8
    else:
        rays = rays.clone()
        rays[0:6] *= scale
    rows = torch.cat([rows, rows.new_zeros((5,) + rows.shape[1:])])
    r2v = np.concatenate([r2v, np.full(5, r2v[-1], np.int32)])
    flag = np.concatenate([flag, np.zeros(5, np.int32)])
    return (torch.as_tensor(r2v, device=dev),
            torch.as_tensor(flag, device=dev), rows.contiguous(),
            rays.contiguous(), rc,
            dict(nrb=ep.nrb, rb_size=ep.rb_size))


def probe_agreement(ref, got, rc, rb_size: int, rtol: float = 1e-5):
    """Two (1, NG*rb) probe outputs (K4, K5) on live rays (groups with
    rc > 0): the share of rays that agree (both +inf, or both finite within
    rtol of ref), and the max absolute and max relative error over the rays
    that agree.  A candidate near a boundary may pass on one side only, so
    the dot modes are held to a share, not to every ray."""
    live = torch.repeat_interleave(rc > 0, rb_size)
    a, b = ref[0, live], got[0, live]
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = (a - b).abs()
    close = fin & (err <= rtol * a.abs())
    agree = close | (~fin & (a == b))
    err, rel = err[close], err[close] / a[close].abs().clamp(min=1e-30)
    return (agree.double().mean().item(),
            err.max().item() if err.numel() else 0.0,
            rel.max().item() if rel.numel() else 0.0)


def dot_bench_scale(ft, mm, prec: str, n_steps: int) -> torch.Tensor:
    """Sum of |terms| of each K6 output element, in f64: the sum over j <
    n_steps and k of |ft[k, i]| |mm[j % 4, k, l]| (bf16-rounded operands for
    "default"), the scale that K6's error is measured against."""
    from compound_ray_tpu_torch.tools.microbench_k import (
        NROWS,
        OUT_COLS,
        bf16_round,
    )

    if prec == "default":
        ft, mm = bf16_round(ft), bf16_round(mm)
    a = ft.abs().double().t()
    scale = torch.zeros((a.shape[0], OUT_COLS), dtype=torch.float64,
                        device=ft.device)
    for r in range(NROWS):
        steps_r = (n_steps - r + NROWS - 1) // NROWS
        scale += steps_r * (a @ mm[r, :, :OUT_COLS].abs().double())
    return scale


def voronoi_agreement(got, want, refs, width: int, height: int):
    """Two (H, W) Voronoi index maps of the same refs (N, 3): (the share of
    pixels where they agree, the largest gap in f64 between the two
    winners' angles where they differ).  A pixel that differs is a near-tie
    when its gap is tiny."""
    from compound_ray_tpu_torch.projection.project import _pixel_sphere_dirs

    got, want = np.asarray(got), np.asarray(want)
    diff = got != want
    gap = 0.0
    if diff.any():
        d = _pixel_sphere_dirs(width, height, "cpu").numpy()[diff]
        d = d.astype(np.float64)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        r = np.asarray(refs, np.float64)
        r = r / np.linalg.norm(r, axis=1, keepdims=True)
        a, b = (np.arccos(np.clip((d * r[m[diff]]).sum(axis=1), -1.0, 1.0))
                for m in (got, want))
        gap = float(np.abs(a - b).max())
    return 1.0 - float(diff.mean()), gap


# -- .blend files: the tests and the chip check write their own, since the
# -- repo holds none; nothing on the render path writes one

# the SDNA of write_blend: only the structs and fields scene/blend.py reads
# (ListBase.last, IDPropertyData.val2 and the bNodeSocketValueRGBA value
# complete what it reads through them: a ListBase, a double, a colour)
_SDNA_BASE = (("char", 1), ("short", 2), ("int", 4), ("float", 4),
              ("double", 8))
_SDNA_STRUCTS = (
    ("ListBase", (("void", "*first"), ("void", "*last"))),
    ("ID", (("char", "name[66]"), ("IDProperty", "*properties"))),
    ("IDPropertyData", (("void", "*pointer"), ("ListBase", "group"),
                        ("int", "val"), ("int", "val2"))),
    ("IDProperty", (("IDProperty", "*next"), ("char", "type"),
                    ("char", "name[64]"), ("IDPropertyData", "data"),
                    ("int", "len"))),
    ("Object", (("ID", "id"), ("void", "*data"), ("short", "type"),
                ("float", "obmat[4][4]"))),
    ("Mesh", (("ID", "id"), ("Material", "**mat"), ("MVert", "*mvert"),
              ("MPoly", "*mpoly"), ("MLoop", "*mloop"),
              ("MLoopUV", "*mloopuv"), ("int", "totvert"),
              ("int", "totpoly"), ("int", "totloop"))),
    ("MVert", (("float", "co[3]"),)),
    ("MPoly", (("int", "loopstart"), ("int", "totloop"))),
    ("MLoop", (("int", "v"),)),
    ("MLoopUV", (("float", "uv[2]"),)),
    ("Material", (("ID", "id"), ("float", "r"), ("float", "g"),
                  ("float", "b"), ("bNodeTree", "*nodetree"),
                  ("char", "use_nodes"))),
    ("bNodeTree", (("ListBase", "nodes"),)),
    ("bNode", (("bNode", "*next"), ("ListBase", "inputs"),
               ("char", "idname[64]"), ("ID", "*id"))),
    ("bNodeSocket", (("bNodeSocket", "*next"), ("char", "name[64]"),
                     ("void", "*default_value"))),
    ("bNodeSocketValueRGBA", (("float", "value[4]"),)),
    ("Image", (("ID", "id"),)),
    ("Camera", (("ID", "id"), ("char", "type"), ("char", "sensor_fit"),
                ("float", "lens"), ("float", "ortho_scale"),
                ("float", "sensor_x"), ("float", "sensor_y"))),
    ("RenderData", (("int", "xsch"), ("int", "ysch"), ("float", "xasp"),
                    ("float", "yasp"))),
    ("Scene", (("ID", "id"), ("RenderData", "r"))),
)
_IDP_CODES = {str: 0, int: 1, float: 8}  # IDP_STRING, IDP_INT, IDP_DOUBLE
_IDP_GROUP = 6
_OB_MESH, _OB_CAMERA = 1, 11


def _sdna_tables():
    """(layouts, SDNA bytes): layouts[struct] = ({field:
    (offset, type, size, is_pointer)}, struct size), laid out as the
    loader does."""
    types = ([t for t, _ in _SDNA_BASE] + ["void"]
             + [sname for sname, _ in _SDNA_STRUCTS])
    tlen = dict(_SDNA_BASE, void=0)
    layouts, names = {}, []
    for sname, fields in _SDNA_STRUCTS:
        lay, off = {}, 0
        for ftype, fname in fields:
            ptr = fname.startswith("*")
            size = 8 if ptr else tlen[ftype]
            for dim in fname.split("[")[1:]:
                size *= int(dim.rstrip("]"))
            lay[fname.lstrip("*").split("[")[0]] = (off, ftype, size, ptr)
            off += size
            if fname not in names:
                names.append(fname)
        layouts[sname] = (lay, off)
        tlen[sname] = off

    def strings(tag, items):
        body = tag + struct.pack("<I", len(items)) + b"".join(
            s.encode() + b"\0" for s in items)
        return body + b"\0" * (-len(body) % 4)

    dna = b"SDNA" + strings(b"NAME", names) + strings(b"TYPE", types)
    dna += b"TLEN" + struct.pack(f"<{len(types)}H",
                                 *(tlen[t] for t in types))
    dna += b"\0" * (-len(dna) % 4)
    dna += b"STRC" + struct.pack("<I", len(_SDNA_STRUCTS))
    for sname, fields in _SDNA_STRUCTS:
        dna += struct.pack("<HH", types.index(sname), len(fields))
        for ftype, fname in fields:
            dna += struct.pack("<HH", types.index(ftype), names.index(fname))
    return layouts, dna


class _BlendWriter:
    """File blocks with unique old pointers, packed by the SDNA layouts."""

    _FMT = {"char": "B", "short": "h", "int": "i", "float": "f",
            "double": "d"}

    def __init__(self):
        self.layouts, self.dna = _sdna_tables()
        self.struct_index = {s: i for i, (s, _) in enumerate(_SDNA_STRUCTS)}
        self.blocks = []
        self._ptr = 0x10000

    def pack(self, sname: str, **vals) -> bytearray:
        """One struct's bytes: each value is a pointer (an int, for a
        pointer field), bytes, a nested struct's bytes or numbers."""
        lay, size = self.layouts[sname]
        buf = bytearray(size)
        for key, v in vals.items():
            off, ftype, n, ptr = lay[key]
            if ptr:
                struct.pack_into("<Q", buf, off, int(v))
            elif isinstance(v, (bytes, bytearray)):
                if len(v) > n:
                    raise ValueError(f"{sname}.{key}: {len(v)} > {n} bytes")
                buf[off:off + len(v)] = v
            else:
                a = np.atleast_1d(np.asarray(v)).ravel()
                struct.pack_into(f"<{a.size}{self._FMT[ftype]}", buf, off,
                                 *a.tolist())
        return buf

    def add(self, code: str, data: bytes, sname: str = None,
            count: int = 1) -> int:
        """Append a block; returns its old pointer."""
        self._ptr += 0x100
        sdna = self.struct_index[sname] if sname else 0
        self.blocks.append((code, sdna, count, bytes(data), self._ptr))
        return self._ptr

    def rows(self, sname: str, count: int, **cols) -> bytes:
        """count structs in one block: each column an array of count rows
        (with the field's element count per row)."""
        lay, size = self.layouts[sname]
        buf = np.zeros((count, size), np.uint8)
        for key, v in cols.items():
            off, ftype, n, _ = lay[key]
            dt = np.dtype("<" + self._FMT[ftype])
            a = np.ascontiguousarray(np.asarray(v, dt).reshape(count, -1))
            buf[:, off:off + n] = a.view(np.uint8).reshape(count, -1)
        return buf.tobytes()

    def id_name(self, prefix: str, name: str) -> bytes:
        return (prefix + name).encode()[:65]

    def tobytes(self) -> bytes:
        out = [b"BLENDER-v293"]
        blocks = self.blocks + [("DNA1", 0, 1, self.dna, 0),
                                ("ENDB", 0, 0, b"", 0)]
        for code, sdna, count, data, ptr in blocks:
            out.append(code.encode().ljust(4, b"\0")
                       + struct.pack("<IQII", len(data), ptr, sdna, count)
                       + data)
        return b"".join(out)


def _blend_material(w: _BlendWriter, name: str, colour, image_name,
                    images: dict) -> int:
    """A node material: a Principled BSDF whose Base Color is `colour`
    and, with image_name, an Image Texture node naming that Image."""
    rgba = w.add("DATA", w.pack("bNodeSocketValueRGBA",
                                value=[*np.asarray(colour, np.float32)[:3],
                                       1.0]), "bNodeSocketValueRGBA")
    sock = w.add("DATA", w.pack("bNodeSocket", name=b"Base Color",
                                default_value=rgba), "bNodeSocket")
    tex_node = 0
    if image_name is not None:
        if image_name not in images:
            images[image_name] = w.add(
                "IM", w.pack("Image", id=w.pack(
                    "ID", name=w.id_name("IM", image_name))), "Image")
        tex_node = w.add("DATA", w.pack(
            "bNode", idname=b"ShaderNodeTexImage", id=images[image_name]),
            "bNode")
    bsdf = w.add("DATA", w.pack(
        "bNode", next=tex_node, idname=b"ShaderNodeBsdfPrincipled",
        inputs=w.pack("ListBase", first=sock, last=sock)), "bNode")
    tree = w.add("DATA", w.pack("bNodeTree", nodes=w.pack(
        "ListBase", first=bsdf, last=tex_node or bsdf)), "bNodeTree")
    r, g, b = np.asarray(colour, np.float32)[:3]
    return w.add("MA", w.pack("Material", id=w.pack(
        "ID", name=w.id_name("MA", name)), r=r, g=g, b=b, nodetree=tree,
        use_nodes=1), "Material")


def _blend_id_properties(w: _BlendWriter, extras: dict) -> int:
    """The root IDP_GROUP of `extras` (str, int and float values), or 0."""
    if not extras:
        return 0
    nxt = 0
    for key, v in reversed(list(extras.items())):
        kind = _IDP_CODES[type(v)]
        data, length = w.pack("IDPropertyData"), 0
        if kind == 0:
            s = str(v).encode() + b"\0"
            data = w.pack("IDPropertyData", pointer=w.add("DATA", s))
            length = len(s)
        elif kind == 1:
            data = w.pack("IDPropertyData", val=v)
        else:
            off = w.layouts["IDPropertyData"][0]["val"][0]
            struct.pack_into("<d", data, off, v)
        nxt = w.add("DATA", w.pack("IDProperty", next=nxt, type=kind,
                                   name=key.encode(), data=data,
                                   len=length), "IDProperty")
    group = w.pack("IDPropertyData", group=w.pack("ListBase", first=nxt))
    return w.add("DATA", w.pack("IDProperty", type=_IDP_GROUP, data=group),
                 "IDProperty")


def write_blend(path: str, meshes, cameras=(), render_size=(1920, 1080),
                gzip: bool = False) -> str:
    """Write a 64-bit little-endian .blend that scene/blend.py reads back:
    the inverse of load_blend_meshes and load_blend_cameras.  Scaffolding
    for the tests and the chip check, as make_big_scene is: the repo holds
    no .blend file, and nothing on the render path calls this.

    meshes: (name, world_matrix (4, 4), verts (V, 3), faces, colour (3,)
    or None, uvs or None, image_name or None) per mesh object, as
    load_blend_meshes returns them, except that faces may be polygons (an
    (F, k) array with k >= 3, or a list of index sequences), and uvs (the
    loader's top-left origin) are per polygon corner: (F, k, 2) or a list
    of (k_i, 2).  A colour of None writes no material (the loader reads
    white); otherwise a node material with that Base Color, and an Image
    Texture node naming image_name when it is given.
    cameras: dicts as load_blend_cameras returns them (name, obmat,
    extras, lens, sensor_x, sensor_y, ortho_scale, type, sensor_fit); the
    aspect comes from render_size.  Extras of str, int and float values
    become string, int and double ID properties of the Camera datablock.
    gzip compresses the file as Blender's "compress" option does.  Returns
    path."""
    import gzip as gz

    w = _BlendWriter()
    images: dict = {}
    objects = []  # (name, object matrix, data block, object type)
    for name, obmat, verts, faces, colour, uvs, image_name in meshes:
        polys = [np.asarray(p, np.int64) for p in faces]
        loops = np.concatenate(polys) if polys else np.zeros(0, np.int64)
        tot = np.array([len(p) for p in polys], np.int64)
        start = np.concatenate([[0], np.cumsum(tot)[:-1]])
        verts = np.asarray(verts, np.float32)
        mvert = w.add("DATA", w.rows("MVert", len(verts), co=verts),
                      "MVert", len(verts))
        mpoly = w.add("DATA", w.rows("MPoly", len(polys), loopstart=start,
                                     totloop=tot), "MPoly", len(polys))
        mloop = w.add("DATA", w.rows("MLoop", len(loops), v=loops),
                      "MLoop", len(loops))
        mloopuv = 0
        if uvs is not None:
            luv = np.concatenate([np.asarray(u, np.float64).reshape(-1, 2)
                                  for u in uvs])
            luv = np.stack([luv[:, 0], 1.0 - luv[:, 1]], axis=1)
            mloopuv = w.add("DATA", w.rows("MLoopUV", len(loops), uv=luv),
                            "MLoopUV", len(loops))
        matarr = 0
        if colour is not None:
            mat = _blend_material(w, name, colour, image_name, images)
            matarr = w.add("DATA", np.array([mat], "<u8").tobytes())
        me = w.add("ME", w.pack(
            "Mesh", id=w.pack("ID", name=w.id_name("ME", name)), mat=matarr,
            mvert=mvert, mpoly=mpoly, mloop=mloop, mloopuv=mloopuv,
            totvert=len(verts), totpoly=len(polys), totloop=len(loops)),
            "Mesh")
        objects.append((name, obmat, me, _OB_MESH))
    for cd in cameras:
        ca = w.add("CA", w.pack(
            "Camera", id=w.pack("ID", name=w.id_name("CA", cd["name"]),
                                properties=_blend_id_properties(
                                    w, cd.get("extras", {}))),
            type=cd.get("type", 0), sensor_fit=cd.get("sensor_fit", 0),
            lens=cd.get("lens", 50.0), ortho_scale=cd.get("ortho_scale", 6.0),
            sensor_x=cd.get("sensor_x", 36.0),
            sensor_y=cd.get("sensor_y", 24.0)), "Camera")
        objects.append((cd["name"], cd["obmat"], ca, _OB_CAMERA))
    for name, obmat, data, kind in objects:
        w.add("OB", w.pack(
            "Object", id=w.pack("ID", name=w.id_name("OB", name)), data=data,
            type=kind, obmat=np.asarray(obmat, np.float32).T), "Object")
    w.add("SC", w.pack("Scene", id=w.pack("ID", name=b"SCScene"),
                       r=w.pack("RenderData", xsch=render_size[0],
                                ysch=render_size[1], xasp=1.0, yasp=1.0)),
          "Scene")
    raw = w.tobytes()
    with open(path, "wb") as f:
        f.write(gz.compress(raw, mtime=0) if gzip else raw)
    return path


# Blender is Z-up; the loader's Y-up swap (x, y, z) -> (x, z, -y) undoes this
def _z_up(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return np.stack([v[..., 0], -v[..., 2], v[..., 1]], axis=-1)


# a quarter turn about Blender's z axis: every object matrix of
# big_scene_blend_meshes holds it, with exact 0 and 1 entries
_QUARTER_TURN = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
_BOX_QUADS = ((0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
              (0, 2, 6, 4), (1, 5, 7, 3))  # box_mesh's quads


def big_scene_blend_meshes(n_boxes: int = 500, seed: int = 0) -> list:
    """make_big_scene(n_boxes, seed) as write_blend mesh objects: one per
    box and the ground plane last, Z-up, each a quad mesh about its origin
    under an object matrix that turns it a quarter about z and moves it to
    its centre, with its colour as a node material.  load_blend_scene
    gives back make_big_scene's triangles, in its order, to f32
    rounding."""
    out = []
    for i, (center, size, color) in enumerate(_big_scene_boxes(n_boxes,
                                                               seed)):
        local, _ = box_mesh((0.0, 0.0, 0.0), size)
        obmat = np.eye(4)
        obmat[:3, :3] = _QUARTER_TURN
        obmat[:3, 3] = _z_up(center)
        name = "ground" if i == n_boxes else f"box{i:05d}"
        out.append((name, obmat, _z_up(local) @ _QUARTER_TURN,
                    np.array(_BOX_QUADS), color, None, None))
    return out


def blend_camera(name: str, position, extras=None,
                 forward=(0.0, 0.0, -1.0), **lens) -> dict:
    """A write_blend camera at a Y-up `position` looking along `forward`
    (-z, a camera node's own axis, by default) with +x right and +y up: it
    loads with the local space rows (x, y, forward).  `lens` sets the
    Camera fields (lens, sensor_x, sensor_y, ortho_scale, type,
    sensor_fit)."""
    obmat = np.eye(4)
    # columns: right, up, back and the position, in Blender's Z-up frame
    obmat[:3, 0] = _z_up([1.0, 0.0, 0.0])
    obmat[:3, 1] = _z_up([0.0, 1.0, 0.0])
    obmat[:3, 2] = _z_up(-np.asarray(forward, np.float64))
    obmat[:3, 3] = _z_up(position)
    cd = dict(name=name, obmat=obmat, extras=dict(extras or {}), lens=50.0,
              sensor_x=36.0, sensor_y=24.0, ortho_scale=6.0, type=0,
              sensor_fit=0)
    cd.update(lens)
    return cd


def write_big_scene_blend(directory: str, n_boxes: int, seed: int,
                          n_omm: int, accept_deg: float, camera_pos,
                          gzip: bool = False) -> str:
    """make_big_scene(n_boxes, seed) as a .blend in `directory`, with a
    make_sphere_eye(n_omm, accept_deg) .eye file in its eyes/ directory and
    three cameras carrying the reference's markup: the compound eye
    "insect-eye-spherical-projector" (spherical_orientationwise, the .eye
    by a relative path) at the bench pose (the scene's AABB centre + 1 in
    y, the identity local space), and "regular-panoramic", a 60-degree
    "perspective" and a 30-unit "orthographic" camera at camera_pos
    looking along -z.  Returns the .blend's path."""
    import os

    from compound_ray_tpu_torch.scene.eye_io import write_eye_file

    os.makedirs(os.path.join(directory, "eyes"), exist_ok=True)
    eye_rel = f"eyes/sphere-{n_omm}.eye"
    write_eye_file(os.path.join(directory, eye_rel),
                   make_sphere_eye(n_omm, acceptance_deg=accept_deg))
    meshes = big_scene_blend_meshes(n_boxes, seed)
    boxes = _big_scene_boxes(n_boxes, seed)
    lo = np.min([c - s / 2 for c, s, _ in boxes], axis=0)
    hi = np.max([c + s / 2 for c, s, _ in boxes], axis=0)
    bench = (lo + hi) / 2 + np.array([0.0, 1.0, 0.0])
    # vertical sensor fit: yfov = 2 atan(sensor_y / (2 lens)) = 60 degrees
    lens60 = 12.0 / math.tan(math.radians(30.0))
    cameras = [
        blend_camera("insect-eye-spherical-projector", bench, {
            "compound-eye": "true",
            "compound-projection": "spherical_orientationwise",
            "compound-structure": eye_rel}, forward=(0.0, 0.0, 1.0)),
        blend_camera("regular-panoramic", camera_pos, {"panoramic": "true"}),
        blend_camera("perspective", camera_pos, lens=lens60, sensor_fit=2),
        blend_camera("orthographic", camera_pos, type=1, ortho_scale=30.0),
    ]
    name = f"big-scene-{n_boxes}{'-gz' if gzip else ''}.blend"
    return write_blend(os.path.join(directory, name), meshes, cameras,
                       render_size=(640, 480), gzip=gzip)
