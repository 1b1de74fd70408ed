"""A field of vertex-coloured boxes over a ground slab under a simple sky:
the stand-in the speed test takes where natural-standin-sky.gltf is absent.

A frozen copy of compound_ray_tpu_torch.testing's make_big_scene
(_big_scene_boxes and box_mesh): n_boxes boxes with centres uniform in
[-50, 50] x [0, 5] x [-50, 50], sides uniform in [0.5, 3] and colours
uniform in [0.1, 1], then a 200 x 0.5 x 200 ground slab at y = -1; twelve
triangles a box, each box one colour at its eight corners.
"""

import numpy as np

from benchmark.scene import SceneArrays

# faces as quads over corner indices (x-, x+, y-, y+, z-, z+)
_QUADS = ((0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
          (0, 2, 6, 4), (1, 5, 7, 3))


def box_mesh(center, size):
    """Axis-aligned box: 8 vertices, 12 triangles (outward winding)."""
    c = np.asarray(center, np.float64)
    s = np.asarray(size, np.float64) / 2.0
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], np.float64)
    faces = []
    for a, b, cc, d in _QUADS:
        faces += [(a, b, cc), (a, cc, d)]
    return c + corners * s, np.array(faces, np.int64)


def boxes(n_boxes: int, seed: int):
    """(centre, size, colour) per box, the ground slab last."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-50, 50, size=(n_boxes, 3))
    centers[:, 1] = rng.uniform(0.0, 5.0, size=n_boxes)
    sizes = rng.uniform(0.5, 3.0, size=(n_boxes, 3))
    colors = rng.uniform(0.1, 1.0, size=(n_boxes, 3))
    return list(zip(centers, sizes, colors)) + [
        (np.array([0.0, -1.0, 0.0]), np.array([200.0, 0.5, 200.0]),
         np.array([0.3, 0.5, 0.2]))]


def build(n_boxes: int, seed: int, background: str = "simple_sky"
          ) -> SceneArrays:
    verts, faces, cols, solids = [], [], [], []
    for center, size, color in boxes(n_boxes, seed):
        v, f = box_mesh(center, size)
        faces.append(f + 8 * len(verts))
        verts.append(v)
        cols.append(np.tile(np.append(color, 1.0).astype(np.float32),
                            (8, 1)))
        solids.append([center - size / 2.0, center + size / 2.0])
    return SceneArrays(
        vertices=np.concatenate(verts), faces=np.concatenate(faces),
        background=background, vertex_colors=np.concatenate(cols),
        solids=np.asarray(solids, np.float64))
