"""The benchmark's own scene and eye arrays, and the configuration files
that name them.

A configuration file (configs/<name>.json) names a scene generator
(scenes/<generator>.py) and an eye generator (eyes/<generator>.py) with
their parameters.  Each generator is a frozen copy, kept here so that a
change to the program cannot change what is rendered: the harness hands
the same arrays to the program (through its public scene entry) and to
the plain reference (reference.py).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
import os
from typing import List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Texture:
    data: np.ndarray  # (h, w, 4) float32 in [0, 1], row 0 at v = 0
    wrap_s: int = 0  # 0 repeat, 1 clamp, 2 mirror
    wrap_t: int = 0
    filter: int = 1  # 0 nearest, 1 bilinear


@dataclasses.dataclass
class SceneArrays:
    """A triangle soup with what shades it.  Colour priority per triangle,
    as CompoundRay's closest-hit shader: vertex colours (interpolated, then
    raised to 2.2), else the material's texture at the interpolated uv,
    else the material's base colour; rays that hit nothing take the
    background miss shader."""

    vertices: np.ndarray  # (V, 3) float64
    faces: np.ndarray  # (T, 3) int64
    background: str = "simple_sky"
    vertex_colors: Optional[np.ndarray] = None  # (V, 4) float32
    uv: Optional[np.ndarray] = None  # (T, 3, 2) float32, per corner
    mat_id: Optional[np.ndarray] = None  # (T,) int32
    mat_color: Optional[np.ndarray] = None  # (M, 4) float32
    mat_tex: Optional[np.ndarray] = None  # (M,) int32, -1 = none
    textures: List[Texture] = dataclasses.field(default_factory=list)
    # solid axis-aligned boxes (B, 2, 3) [lo, hi] an eye may not touch
    solids: Optional[np.ndarray] = None

    @property
    def num_triangles(self) -> int:
        return int(self.faces.shape[0])

    def corners(self) -> np.ndarray:
        """(T, 3, 3) float64 corner positions."""
        return self.vertices[self.faces]


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_plugin(kind: str, name: str, root: str = HERE):
    """The module <kind>/<name>.py under the benchmark's root, by name."""
    path = os.path.join(root, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return _load_module(path, f"benchmark_{kind}_{name.replace('-', '_')}")


def build_scene(cfg: dict, root: str = HERE) -> SceneArrays:
    spec = cfg["scene"]
    return load_plugin("scenes", spec["generator"], root).build(
        **spec["params"])


def build_eye(cfg: dict, root: str = HERE) -> np.ndarray:
    """(N, 8) float32 ommatidia [position, axis, acceptance (rad), focal
    offset], the layout of a CompoundRay .eye file's rows."""
    spec = cfg["eye"]
    omms = load_plugin("eyes", spec["generator"], root).build(
        **spec["params"])
    return np.ascontiguousarray(omms, np.float32)


def rotate_point(point, angle: float, axis) -> np.ndarray:
    """Rodrigues rotation about a normalised axis (DataRecordCamera.h:
    96-100 of CompoundRay), in float64."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    c, s = math.cos(angle), math.sin(angle)
    point = np.asarray(point, np.float64)
    return (c * point + s * np.cross(axis, point)
            + (1.0 - c) * np.dot(axis, point) * axis)


def pose_local_space(rx: float, ry: float, rz: float) -> np.ndarray:
    """The (3, 3) local space (rows: the eye's x, y, z axes in world space)
    that CompoundRay's setCameraPose gives: reset, then rotate about world
    X, Y and Z in that order (libEyeRenderer.cpp:441-450)."""
    ls = np.eye(3)
    for angle, axis in ((rx, (1, 0, 0)), (ry, (0, 1, 0)), (rz, (0, 0, 1))):
        ls = np.stack([rotate_point(ls[i], angle, axis) for i in range(3)])
    return ls


def sphere_meets_solids(centers: np.ndarray, radius: float,
                        solids: Optional[np.ndarray],
                        chunk: int = 16) -> np.ndarray:
    """(P,) bool: whether a sphere of `radius` about each of the centres
    (P, 3) meets (touches or lies inside) any of the solid boxes."""
    centers = np.atleast_2d(np.asarray(centers, np.float64))
    out = np.zeros(len(centers), bool)
    if solids is None or len(solids) == 0:
        return out
    lo, hi = solids[None, :, 0], solids[None, :, 1]
    for i in range(0, len(centers), chunk):
        c = centers[i:i + chunk, None, :]
        gap = np.maximum(np.maximum(lo - c, c - hi), 0.0)
        out[i:i + chunk] = (np.sum(gap * gap, axis=-1)
                            <= radius * radius).any(axis=1)
    return out


def eye_radius(omms: np.ndarray) -> float:
    """The radius about the eye's origin that holds every ray origin."""
    return float(np.max(np.linalg.norm(omms[:, 0:3], axis=1)
                        + np.abs(omms[:, 7])))
