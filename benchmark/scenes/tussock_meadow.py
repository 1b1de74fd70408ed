"""A meadow of grass tussocks on a ground slab under a simple sky: a
seeded stand-in, at a field scan's scale, for the natural scene of
CompoundRay's speed test (the "natural" field scan, not in this
repository), laid out as the grass-tussock worlds that ant-route view
models walk through (Baddeley et al. 2012, PLoS Comput Biol 8:e1002336).

n_tussocks tussock centres uniform in [-extent, extent]^2 on the top of a
200 x 0.5 x 200 ground slab at y = -1 (top at y = -0.75).  Each tussock
has `blades` blades whose bases scatter about its centre with sd 0.08.
A blade is three triangles, a quad from its base to half its height and
a tip above: half-width 0.02 at the base and 0.012 at the middle, height
uniform in [0.3, 1.2], its flat side facing a uniform azimuth, leaning
towards that side by a fraction uniform in [0, 0.35] of its height at
the tip (a quarter of that at the middle: a bending blade).  Vertex
colours run from a dark green at the base to a lighter tip whose hue,
one to a blade, lies between fresh green and straw.  Only the slab is a
solid: an eye may sit among the blades, as an ant's does.

The draws are frozen in this order from numpy's default_rng(seed): the
centres (n_tussocks, 2), then per blade (n_tussocks, blades) the base
offsets (x, z), the heights, the azimuths, the leans and the hues.
"""

import math

import numpy as np

from benchmark.scene import SceneArrays

SLAB_CENTER = np.array([0.0, -1.0, 0.0])
SLAB_SIZE = np.array([200.0, 0.5, 200.0])
GROUND_Y = SLAB_CENTER[1] + SLAB_SIZE[1] / 2.0  # -0.75
SLAB_COLOR = np.array([0.28, 0.22, 0.14, 1.0], np.float32)  # soil
BASE_SD = 0.08
HALF_WIDTH = (0.02, 0.012)  # at the base, at the middle
HEIGHT = (0.3, 1.2)
MAX_LEAN = 0.35
BASE_GREEN = np.array([0.08, 0.22, 0.04], np.float32)
TIP_GREEN = np.array([0.32, 0.62, 0.14], np.float32)
TIP_STRAW = np.array([0.78, 0.72, 0.38], np.float32)
# a blade's five corners (base left, base right, middle left, middle
# right, tip) and its three triangles: the quad, then the tip
BLADE_FACES = np.array([[0, 1, 3], [0, 3, 2], [2, 3, 4]], np.int64)

# the slab as twelve triangles over its eight corners (x-, x+, y-, y+,
# z-, z+ faces, outward winding)
_QUADS = ((0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
          (0, 2, 6, 4), (1, 5, 7, 3))


def slab_mesh():
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], np.float64)
    faces = []
    for a, b, c, d in _QUADS:
        faces += [(a, b, c), (a, c, d)]
    return SLAB_CENTER + corners * SLAB_SIZE / 2.0, np.array(faces,
                                                             np.int64)


def blades_of(n_tussocks: int, blades: int, seed: int, extent: float):
    """(corners (B, 5, 3) float64, colours (B, 5, 4) float32) of the
    n_tussocks x blades blades, tussock by tussock."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-extent, extent, size=(n_tussocks, 2))
    shape = (n_tussocks, blades)
    offsets = rng.normal(0.0, BASE_SD, size=shape + (2,))
    height = rng.uniform(*HEIGHT, size=shape).reshape(-1)
    azimuth = rng.uniform(0.0, 2.0 * math.pi, size=shape).reshape(-1)
    lean = rng.uniform(0.0, MAX_LEAN, size=shape).reshape(-1)
    hue = rng.uniform(0.0, 1.0, size=shape).reshape(-1).astype(np.float32)

    base = (centres[:, None, :] + offsets).reshape(-1, 2)
    n = len(base)
    # the blade's width runs along `across`, its flat side faces `facing`
    across = np.stack([np.cos(azimuth), np.zeros(n), np.sin(azimuth)], -1)
    facing = np.stack([-np.sin(azimuth), np.zeros(n), np.cos(azimuth)], -1)
    root = np.stack([base[:, 0], np.full(n, GROUND_Y), base[:, 1]], -1)
    up = np.array([0.0, 1.0, 0.0])
    mid = (root + 0.5 * height[:, None] * up
           + 0.25 * (lean * height)[:, None] * facing)
    tip = root + height[:, None] * up + (lean * height)[:, None] * facing
    w0 = HALF_WIDTH[0] * across
    w1 = HALF_WIDTH[1] * across
    corners = np.stack([root - w0, root + w0, mid - w1, mid + w1, tip], 1)

    top = (1.0 - hue)[:, None] * TIP_GREEN + hue[:, None] * TIP_STRAW
    middle = 0.5 * (BASE_GREEN + top)
    rgb = np.stack([np.broadcast_to(BASE_GREEN, top.shape),
                    np.broadcast_to(BASE_GREEN, top.shape),
                    middle, middle, top], 1)
    colours = np.concatenate([rgb, np.ones(rgb.shape[:2] + (1,),
                                           np.float32)], -1)
    return corners, colours.astype(np.float32)


def build(n_tussocks: int = 12288, blades: int = 16, seed: int = 0,
          extent: float = 50.0, background: str = "simple_sky"
          ) -> SceneArrays:
    corners, colours = blades_of(n_tussocks, blades, seed, extent)
    nb = len(corners)
    faces = (BLADE_FACES[None] + 5 * np.arange(nb)[:, None, None]
             ).reshape(-1, 3)
    slab_v, slab_f = slab_mesh()
    verts = np.concatenate([corners.reshape(-1, 3), slab_v])
    faces = np.concatenate([faces, slab_f + 5 * nb])
    cols = np.concatenate([colours.reshape(-1, 4),
                           np.tile(SLAB_COLOR, (8, 1))])
    solids = np.array([[SLAB_CENTER - SLAB_SIZE / 2.0,
                        SLAB_CENTER + SLAB_SIZE / 2.0]], np.float64)
    return SceneArrays(vertices=verts, faces=faces, background=background,
                       vertex_colors=cols, solids=solids)
