"""EyeRenderer on PyTorch: the compound-eye subset of
compound_ray_tpu/api/renderer.py, unlit and lit.

Scene loading, camera navigation, the per-eye sample count, render_frame
and get_camera_data behave as in the JAX package (the reference C ABI,
libEyeRenderer3/libEyeRenderer.h:30-120).  The device is a keyword that
defaults to the card: EyeRenderer(device=...) renders there and nowhere
else.  Each frame draws its angles from a torch.Generator on that device,
seeded from (config.base_seed, the eye's frame counter) as the JAX package
keys its frames (fold_in(PRNGKey(base_seed), rng_frame)).

set_lighting(True) turns on GGX direct light with shadow rays from the
point lights of set_lights (by default the reference's four, placed around
the scene's bounds when a scene is set); each lit frame is audited for
hits outside their memoised shadow shafts, and a leak at or above
config.shadow_leak_tolerance replans the leaking groups with guaranteed
bounds.

What this slice of the port refuses, loudly: the raw-sample projection, a
non-zero render size (display projections), non-compound cameras and
.blend scenes (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np
import torch

from compound_ray_tpu_torch.cameras.types import Camera, CompoundEyeCamera
from compound_ray_tpu_torch.config import get_config
from compound_ray_tpu_torch.eye.pipeline import (
    canonical_device,
    mark_shadow_unsound,
    render_means,
)
from compound_ray_tpu_torch.scene.flat import FlatScene, load_scene
from compound_ray_tpu_torch.trace.lighting import default_lights
from compound_ray_tpu_torch.trace.shade import miss_id


def frame_seed(base_seed: int, frame: int) -> int:
    """Generator seed for frame `frame` of an eye: one 64-bit seed per
    (base_seed, frame) pair."""
    return ((int(base_seed) & 0xFFFFFFFF) << 32) | (int(frame) & 0xFFFFFFFF)


class EyeRenderer:
    """Compound-eye renderer on one torch device."""

    def __init__(self, verbose: bool = True, *, device="cuda"):
        """`verbose` first and on by default, as in
        compound_ray_tpu/api/renderer.py:84; the device is keyword-only and defaults to the card.  Where torch sees
        no CUDA device, the default raises: it never falls back to the
        CPU, which a caller asks for with device="cpu"."""
        self.device = canonical_device(device)
        self.verbose = bool(verbose)
        self.lighting = False  # params.lighting (libEyeRenderer.cpp:127)
        self._lights: Optional[np.ndarray] = None
        self._shadow_audit_warned = set()
        # the last lit frame's shadow audit [leaked, hits, per-group leaks]
        self.last_shadow_audit: Optional[np.ndarray] = None
        self.scene = None
        self.width = 0
        self.height = 0
        self._current_camera = 0
        self._device_means: Optional[torch.Tensor] = None
        self._camera_data: Optional[np.ndarray] = None
        self.frame_times_ms: List[float] = []

    @property
    def scene(self) -> Optional[FlatScene]:
        return self._scene

    @scene.setter
    def scene(self, scene: Optional[FlatScene]) -> None:
        """A new scene gets the reference's four default lights around its
        bounds (compound_ray_tpu/api/renderer.py:133)."""
        self._scene = scene
        if scene is not None:
            self._lights = default_lights(scene.aabb_min, scene.aabb_max)

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[PyEye] {msg}")

    def load_gltf_scene(self, filepath: str, root_transform=None) -> None:
        if filepath.endswith(".blend"):
            raise NotImplementedError(
                ".blend scenes are not ported yet (ROADMAP.md queue 1, API "
                "surface); export the scene to glTF")
        self.scene = load_scene(filepath, root_transform)
        self._current_camera = 0
        self._log(f"Loaded scene '{filepath}' "
                  f"({self.scene.num_triangles} triangles, "
                  f"{len(self.scene.cameras)} cameras).")

    def set_render_size(self, w: int, h: int) -> None:
        if int(w) * int(h) != 0:
            raise NotImplementedError(
                "display projections are not ported yet (ROADMAP.md queue "
                "1, API surface): keep the render size 0 x 0 and read "
                "get_camera_data")
        self.width, self.height = int(w), int(h)

    def set_lighting(self, enabled: bool) -> None:
        """Toggle GGX direct light with shadow rays (params.lighting;
        compound_ray_tpu/api/renderer.py:160)."""
        self.lighting = bool(enabled)

    def set_lights(self, lights) -> None:
        """Replace the point lights with an (L >= 1, 7) array of rows [r, g,
        b, intensity, x, y, z] (compound_ray_tpu/api/renderer.py:164).  The
        shadow plan is memoised per light set, so a new set replans once."""
        arr = np.ascontiguousarray(np.asarray(lights, np.float32))
        if arr.ndim != 2 or arr.shape[1] != 7 or arr.shape[0] < 1:
            raise ValueError(
                "lights must be an (L>=1, 7) array: [r, g, b, intensity, "
                "x, y, z] per row")
        self._lights = arr

    def get_lights(self) -> np.ndarray:
        """A copy of the active (L, 7) light array."""
        if self._lights is None:
            raise RuntimeError("no scene loaded (lights are created at load)")
        return np.array(self._lights)

    # ------------------------------------------------------------ cameras
    def get_camera_count(self) -> int:
        return len(self.scene.cameras) if self.scene else 0

    def current_camera(self) -> Camera:
        if self.scene is None or not self.scene.cameras:
            raise RuntimeError("no cameras (load a scene with cameras)")
        return self.scene.cameras[self._current_camera]

    def next_camera(self) -> None:
        self._current_camera = (self._current_camera + 1) % max(
            1, self.get_camera_count())

    def goto_camera(self, index: int) -> None:
        self._current_camera = int(index) % max(1, self.get_camera_count())

    def is_compound_eye_active(self) -> bool:
        return (self.scene is not None and bool(self.scene.cameras)
                and isinstance(self.current_camera(), CompoundEyeCamera))

    def set_current_eye_samples_per_ommatidium(self, s: int) -> None:
        if self.is_compound_eye_active():
            self.current_camera().set_samples_per_ommatidium(s)

    # ------------------------------------------------------------- render
    def render_frame(self) -> float:
        """Render one frame of the active compound eye; returns wall
        milliseconds including the device sync (renderFrame,
        libEyeRenderer.cpp:279-293)."""
        if self.scene is None:
            raise RuntimeError("renderFrame: no scene loaded")
        cam = self.current_camera()
        if not isinstance(cam, CompoundEyeCamera):
            raise NotImplementedError(
                f"camera {cam.name!r} is not a compound eye: real cameras "
                "are not ported yet (ROADMAP.md queue 1, API surface)")
        if cam.projection == "raw_ommatidial_samples":
            raise NotImplementedError(
                "raw_ommatidial_samples is not ported yet (ROADMAP.md queue "
                "1, API surface)")
        t0 = time.perf_counter()
        generator = torch.Generator(device=self.device)
        generator.manual_seed(frame_seed(get_config().base_seed,
                                         cam.rng_frame))
        lit = self.lighting and self._lights is not None
        out = render_means(
            self.scene, self.scene.device_triangles(self.device),
            cam.ommatidia, np.asarray(cam.position, np.float32),
            np.asarray(cam.local_space, np.float32), generator,
            cam.samples_per_ommatidium, miss_id(self.scene.background_shader),
            lights=self._lights if lit else None, shadow_audit=lit)
        audit = None
        if lit:
            out, audit = out
        self._device_means = out
        self._camera_data = None
        cam.rng_frame += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if audit is not None:
            self.last_shadow_audit = audit.cpu().numpy()
            self._check_shadow_audit(self.last_shadow_audit)
        ms = (time.perf_counter() - t0) * 1000.0
        self._note_frame_time(ms)
        self._log(f"Rendered frame in {ms}ms.")
        return ms

    def _note_frame_time(self, ms: float) -> None:
        """Append a frame's wall time to frame_times_ms; past 10,000 entries
        the oldest 5000 go (compound_ray_tpu/api/renderer.py:327-329), so a
        closed loop of any length holds a bounded list."""
        self.frame_times_ms.append(ms)
        if len(self.frame_times_ms) > 10000:
            del self.frame_times_ms[:5000]

    def _check_shadow_audit(self, audit) -> None:
        """Act on a lit frame's shadow-shaft audit [leaked, hits, per-group
        leaks] (compound_ray_tpu/api/renderer.py:402): hits outside their
        group's memoised shaft saw only shaft-local occluders.  At or above
        config.shadow_leak_tolerance the leaking groups (the whole scene
        for an audit without the per-group tail) replan with guaranteed
        bounds (mark_shadow_unsound); below it the leak only warns.  Warns
        once per decade of the leak fraction."""
        a = np.asarray(audit)
        leaked, total = int(a[0]), int(a[1])
        if leaked <= 0 or total <= 0:
            return
        frac = leaked / total
        tol = get_config().shadow_leak_tolerance
        replanned = False
        if frac >= tol:
            groups = np.nonzero(a[2:])[0] if a.shape[0] > 2 else None
            replanned = mark_shadow_unsound(self.scene, leak_groups=groups,
                                            device=self.device)
        decade = int(math.floor(math.log10(max(frac, 1e-12))))
        if decade not in self._shadow_audit_warned:
            self._shadow_audit_warned.add(decade)
            if replanned:
                tail = ("Future lit frames replan with guaranteed "
                        "candidate-extent shadow bounds.")
            elif frac < tol:
                tail = (f"Bounded error ~{frac:.2g} x local light term is "
                        f"under shadow_leak_tolerance; advisory only.")
            else:
                tail = "Those groups already have guaranteed bounds."
            print(f"[PyEye] warning: {leaked}/{total} lit samples "
                  f"({100.0 * frac:.3g}%) hit outside their memoised shadow "
                  f"shaft; their shadow rays saw only shaft-local occluders "
                  f"(partial light leak). {tail}")

    def get_camera_data(self) -> np.ndarray:
        """Per-ommatidium mean radiance (N, 3) float32, NaN rows zeroed
        (libEyeRenderer.cpp:457-484)."""
        if not self.is_compound_eye_active():
            raise RuntimeError(
                "getCameraData is implemented only for compound eye cameras")
        if self._camera_data is None:
            if self._device_means is None:
                raise RuntimeError("render a frame first")
            data = self._device_means.cpu().numpy().astype(np.float32)
            data[np.isnan(data[:, 0])] = 0.0
            self._camera_data = data
        return self._camera_data
