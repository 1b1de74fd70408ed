"""A cylindrical arena with patterned inner walls over a textured floor,
open to a simple sky: a seeded stand-in for the Ofstad arena of
CompoundRay's data (data/ofstad-arena, after Ofstad, Zuker and Reiser
2011, Nature 474:204), whose .blend and pattern image are not in this
repository.

The wall is `segments` flat quads (two triangles each) on a circle of
`radius` from y = 0 to y = `height`, its uv running once around (u) and
up (v) a (tex_height, tex_width) texture of four patterns, one to a
quarter of the wall: vertical bars, horizontal bars, diagonal bars and a
checkerboard, each with a phase drawn from `seed`.  The floor is a fan of
`segments` triangles about the centre, planar-mapped onto a second,
noise texture.  Both textures are bilinear; the wall wraps around (u)
and clamps at its ends (v), the floor repeats.
"""

import math

import numpy as np

from benchmark.scene import SceneArrays, Texture

ON = np.array([0.15, 0.85, 0.25, 1.0], np.float32)  # a lit LED panel
OFF = np.array([0.02, 0.06, 0.03, 1.0], np.float32)


def wall_texture(width: int, height: int, period: int, rng) -> np.ndarray:
    yy, xx = np.mgrid[0:height, 0:width]
    phase = rng.integers(0, period, size=4)
    quarter = (4 * xx) // width
    half = period // 2
    bars = np.stack([
        (xx + phase[0]) % period < half,  # vertical bars
        (yy + phase[1]) % period < half,  # horizontal bars
        (xx + yy + phase[2]) % period < half,  # diagonal bars
        ((xx + phase[3]) // half + yy // half) % 2 == 0,  # checkerboard
    ])
    on = np.take_along_axis(bars, quarter[None], axis=0)[0]
    return np.where(on[..., None], ON, OFF).astype(np.float32)


def build(radius: float, height: float, segments: int, tex_width: int,
          tex_height: int, period: int, floor_tex: int, seed: int,
          background: str = "simple_sky") -> SceneArrays:
    rng = np.random.default_rng(seed)
    k = np.arange(segments + 1)
    ang = 2.0 * math.pi * k / segments
    ring = np.stack([radius * np.cos(ang), np.zeros_like(ang),
                     radius * np.sin(ang)], axis=1)
    top = ring + np.array([0.0, height, 0.0])
    # wall: vertices [bottom ring | top ring], u = k / segments
    verts = [ring, top]
    faces, uv = [], []
    nr = segments + 1
    for i in range(segments):
        b0, b1, t0, t1 = i, i + 1, nr + i, nr + i + 1
        u0, u1 = i / segments, (i + 1) / segments
        faces += [(b0, t0, t1), (b0, t1, b1)]
        uv += [[(u0, 0), (u0, 1), (u1, 1)], [(u0, 0), (u1, 1), (u1, 0)]]
    n_wall = len(faces)
    # floor: a fan about the centre, uv = (x, z) mapped onto [0, 1]
    centre = 2 * nr
    verts.append(np.zeros((1, 3)))
    for i in range(segments):
        faces.append((centre, i + 1, i))
        pts = (np.zeros(3), ring[i + 1], ring[i])
        uv.append([((p[0] / radius + 1) / 2, (p[2] / radius + 1) / 2)
                   for p in pts])
    wall = wall_texture(tex_width, tex_height, period, rng)
    grey = rng.uniform(0.25, 0.55, size=(floor_tex, floor_tex, 1))
    floor = np.concatenate([grey * np.array([1.0, 0.9, 0.7]),
                            np.ones((floor_tex, floor_tex, 1))], axis=-1)
    n = len(faces)
    return SceneArrays(
        vertices=np.concatenate(verts).astype(np.float64),
        faces=np.asarray(faces, np.int64),
        background=background,
        uv=np.asarray(uv, np.float32),
        mat_id=np.where(np.arange(n) < n_wall, 0, 1).astype(np.int32),
        mat_color=np.array([[0.8, 0.8, 0.8, 1.0]] * 2, np.float32),
        mat_tex=np.array([0, 1], np.int32),
        textures=[Texture(wall, wrap_s=0, wrap_t=1, filter=1),
                  Texture(floor.astype(np.float32), wrap_s=0, wrap_t=0,
                          filter=1)],
        # the ground under the floor; the wall is a thin shell
        solids=np.array([[[-radius, -1.0, -radius], [radius, 0.0, radius]]]))
