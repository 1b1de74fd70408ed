"""EyeRenderer on PyTorch: the compound-eye API of
compound_ray_tpu/api/renderer.py.

Method for method the reference C ABI (libEyeRenderer3/libEyeRenderer.h:
30-120) in snake_case; the camelCase ctypes shim is
compound_ray_tpu_torch.api.shim.  The device is a keyword that defaults to
the card: EyeRenderer(device=...) renders there and nowhere else.  Each
frame draws its angles from a torch.Generator on that device, seeded from
(config.base_seed, the eye's frame counter) as the JAX package keys its
frames (fold_in(PRNGKey(base_seed), rng_frame)).

Per frame of a compound eye (renderFrame -> launchFrame,
libEyeRenderer.cpp:174-244): the per-ommatidium means, or the raw samples
and their mean under raw_ommatidial_samples; then, when the non-compound
pipeline is required and the render size is not 0, the eye's projection
into the (H, W, 4) uint8 display buffer on the device, copied to the host
on first read (get_frame_pointer, save_frame_as).

set_lighting(True) turns on GGX direct light with shadow rays from the
point lights of set_lights (by default the reference's four, placed around
the scene's bounds when a scene is set); each lit frame is audited for
hits outside their memoised shadow shafts, and a leak at or above
config.shadow_leak_tolerance replans the leaking groups with guaranteed
bounds.  An unsynced frame (render_frame(sync=False)) keeps its audit on
the device until the next sync().

A real camera (perspective, panoramic or orthographic) at a non-zero
render size renders its (H, W, 4) image: unlit on a scene of at least
config.min_triangles_for_culling triangles through the tile-culled K2 image
(cameras/fast_image.py), otherwise, and always lit, through the
brute-force oracle (cameras/raygen.py).  config.backend = "naive" renders
every compound frame through the oracle (eye/render.py) as well; raw
samples with lighting on always take it.

render_frames_pipelined(n) on a compound eye (not raw samples, backend
"auto" or "pallas") renders a burst: one plan, n frames stacked into one
K1 launch or one frame core each (eye/pipeline.py render_means_frames),
one sync.  render_batch_poses folds B poses into the ommatidium axis and
renders them as one frame.

load_gltf_scene reads glTF (scene/flat.py) and, by its extension, a
.blend file (scene/blend.py) with its cameras and compound-eye markup.
"""

from __future__ import annotations

import math
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from compound_ray_tpu_torch.cameras.fast_image import render_camera_image_fast
from compound_ray_tpu_torch.cameras.raygen import render_camera_image
from compound_ray_tpu_torch.cameras.types import (
    Camera,
    CompoundEyeCamera,
    OrthographicCamera,
    PanoramicCamera,
    PerspectiveCamera,
)
from compound_ray_tpu_torch.config import get_config
from compound_ray_tpu_torch.eye.pipeline import (
    canonical_device,
    mark_shadow_unsound,
    render_means,
    render_means_frames,
    render_samples,
)
from compound_ray_tpu_torch.eye.render import (
    render_compound_means,
    render_compound_samples,
)
from compound_ray_tpu_torch.projection.project import project_frame
from compound_ray_tpu_torch.scene.flat import FlatScene, load_scene
from compound_ray_tpu_torch.trace.lighting import default_lights
from compound_ray_tpu_torch.trace.shade import miss_id

_SHADER_PREFIX = "__raygen__compound_projection_"


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
        # the last checked lit frame's shadow audit [leaked, hits, per-group]
        self.last_shadow_audit: Optional[np.ndarray] = None
        # an unsynced lit frame's audit, checked at the next sync()
        self._pending_shadow_audit: Optional[torch.Tensor] = None
        self.scene = None
        self.width = 0
        self.height = 0
        self.require_noncompound_pipeline = True
        self._current_camera = 0
        self._device_means: Optional[torch.Tensor] = None
        self._raw_samples: Optional[torch.Tensor] = None
        self._camera_data: Optional[np.ndarray] = None
        self._device_frame: Optional[torch.Tensor] = None  # (H, W, 4) uint8
        self._frame_buffer: Optional[np.ndarray] = None  # its host copy
        self.frame_times_ms: List[float] = []
        self._profiler = None
        self._profile_dir: Optional[str] = None

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

    # ------------------------------------------------------------ config
    def set_verbosity(self, v: bool) -> None:
        self.verbose = bool(v)

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[PyEye] {msg}")

    def load_gltf_scene(self, filepath: str, root_transform=None) -> None:
        if filepath.endswith(".blend"):
            # direct Blender-file extraction (compound_ray_tpu_torch.scene
            # .blend): geometry, materials, and the cameras with the
            # compound-eye markup the glTF exporter would carry as extras
            from compound_ray_tpu_torch.scene.blend import load_blend_scene

            self.scene = load_blend_scene(filepath)
        else:
            self.scene = load_scene(filepath, root_transform)
        self._current_camera = 0
        self._log(f"Loaded scene '{filepath}' "
                  f"({self.scene.num_triangles} triangles, "
                  f"{len(self.scene.cameras)} cameras).")

    def stop(self) -> None:
        """Drop the scene and every buffer, on the host and the device
        (compound_ray_tpu/api/renderer.py:138)."""
        self._log("Cleaning eye renderer resources.")
        self.scene = None
        self._frame_buffer = None
        self._device_frame = None
        self._camera_data = None
        self._raw_samples = None
        self._device_means = None
        self._pending_shadow_audit = None

    def set_render_size(self, w: int, h: int) -> None:
        self.width = int(w)
        self.height = int(h)
        self._frame_buffer = np.zeros((self.height, self.width, 4), np.uint8)

    def set_require_noncompound_pipeline(self, require: bool) -> None:
        self.require_noncompound_pipeline = bool(require)

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

    # ------------------------------------------------------------- render
    def render_frame(self, sync: bool = True) -> float:
        """Render one frame; returns wall milliseconds (renderFrame,
        libEyeRenderer.cpp:279-293; compound_ray_tpu/api/renderer.py:191).

        sync=False queues the frame on the device without waiting for it:
        consecutive frames then run back to back and one sync() covers
        them (render_frames_pipelined).  Outputs stay on the device either
        way; get_camera_data and get_frame_pointer copy them on first read."""
        if self.scene is None:
            raise RuntimeError("renderFrame: no scene loaded")
        if not self.scene.cameras:
            raise RuntimeError("renderFrame: the scene has no cameras")
        t0 = time.perf_counter()
        cam = self.current_camera()
        if isinstance(cam, CompoundEyeCamera):
            self._render_compound(cam)
        elif self._display():
            # the kind and its parameter (compound_ray_tpu/api/renderer.py:
            # 294-315); an unknown camera type renders as a pinhole
            if isinstance(cam, PerspectiveCamera):
                kind, param = "pinhole", cam.scale
            elif isinstance(cam, PanoramicCamera):
                kind, param = "panoramic", [cam.start_radius]
            elif isinstance(cam, OrthographicCamera):
                kind, param = "orthographic", cam.scale
            else:
                kind, param = "pinhole", [10.0, 10.0, 1.0]
            self._device_frame = self._render_camera_frame(
                kind, cam, np.asarray(param, np.float32))
            self._frame_buffer = None
        if sync:
            self.sync()
        ms = (time.perf_counter() - t0) * 1000.0
        self._note_frame_time(ms)
        self._log(f"Rendered frame in {ms}ms.")
        return ms

    def _generator(self, frame: int) -> torch.Generator:
        """The generator of an eye's frame `frame` on the device."""
        generator = torch.Generator(device=self.device)
        generator.manual_seed(frame_seed(get_config().base_seed, frame))
        return generator

    def _frame_args(self, omms: np.ndarray, pos, ls, generator,
                    samples: int) -> tuple:
        """render_means' positional arguments for an eye on the scene
        (render_means_frames' with a list of generators)."""
        return (self.scene, self.scene.device_triangles(self.device), omms,
                np.asarray(pos, np.float32), np.asarray(ls, np.float32),
                generator, samples, miss_id(self.scene.background_shader))

    def _lit(self) -> bool:
        return self.lighting and self._lights is not None

    def _render_means(self, args) -> torch.Tensor:
        """(N, 3) means of one frame on the device
        (compound_ray_tpu/api/renderer.py:644-704): the oracle under
        backend="naive", else the packed frame; a lit one keeps its shadow
        audit for the next sync()."""
        lit = self._lit()
        if get_config().backend == "naive":
            return self._oracle(render_compound_means, args, lit)
        out = render_means(*args, lights=self._lights if lit else None,
                           shadow_audit=lit)
        if lit:
            out, self._pending_shadow_audit = out
        return out

    def _display(self) -> bool:
        """True when a frame is drawn into the display buffer."""
        return self.require_noncompound_pipeline and (
            self.width * self.height > 0)

    def _render_compound(self, cam: CompoundEyeCamera) -> None:
        """Queue one compound-eye frame: means or raw samples, then the
        projection into the display buffer
        (compound_ray_tpu/api/renderer.py:238-279)."""
        args = self._frame_args(cam.ommatidia, cam.position, cam.local_space,
                                self._generator(cam.rng_frame),
                                cam.samples_per_ommatidium)
        if cam.projection == "raw_ommatidial_samples":
            # the packed pipeline renders unlit samples; lit ones and every
            # frame under backend="naive" take the oracle
            # (compound_ray_tpu/api/renderer.py:609-642)
            lit = self._lit()
            if lit or get_config().backend == "naive":
                raw = self._oracle(render_compound_samples, args, lit)
            else:
                raw = render_samples(*args)
            self._end_frames(cam, raw.mean(dim=0), raw, 1)
        else:
            self._end_frames(cam, self._render_means(args), None, 1)

    def _end_frames(self, cam: CompoundEyeCamera, means, raw, n: int) -> None:
        """Keep the last of n queued frames' means (and raw samples),
        advance the eye's frame count by n and, when displayed, project
        the frame into the display buffer on the device."""
        self._device_means, self._raw_samples = means, raw
        self._camera_data = None
        cam.rng_frame += n
        if not self._display():
            return
        _, omm_pos, omm_dir = cam.device_ommatidia(self.device)
        self._device_frame = project_frame(
            cam.projection, self._device_means, self._raw_samples, omm_pos,
            omm_dir, self.width, self.height)
        self._frame_buffer = None

    def _oracle(self, fn, args, lit: bool) -> torch.Tensor:
        """fn (render_compound_samples or render_compound_means) on the
        arguments of a compound frame: the brute-force oracle on the
        renderer's device, lit when `lit`."""
        _, scene_dev, omms, pos, ls, generator, samples, background = args
        return fn(scene_dev, omms, pos, ls, generator, samples, background,
                  lit, self._lights if lit else None)

    def _render_camera_frame(self, kind: str, cam: Camera,
                             param: np.ndarray) -> torch.Tensor:
        """A real camera's (H, W, 4) uint8 image
        (compound_ray_tpu/api/renderer.py:584-607): the tile-culled K2 image
        when the backend is "auto" (or "pallas"), lighting is off and the
        scene has at least min_triangles_for_culling triangles; otherwise
        the brute-force oracle, lit or unlit."""
        cfg = get_config()
        scene_dev = self.scene.device_triangles(self.device)
        background = miss_id(self.scene.background_shader)
        pos = np.asarray(cam.position, np.float32)
        ls = np.asarray(cam.local_space, np.float32)
        if (cfg.backend in ("auto", "pallas") and not self.lighting
                and self.scene.num_triangles >= cfg.min_triangles_for_culling):
            return render_camera_image_fast(
                self.scene, scene_dev, kind, pos, ls, param, self.width,
                self.height, background)
        lit = self.lighting and self._lights is not None
        return render_camera_image(
            scene_dev, kind, pos, ls, param, self.width, self.height,
            background, lit, self._lights if lit else None)

    def sync(self) -> None:
        """Wait for every queued frame, then act on the last unsynced lit
        frame's shadow audit (compound_ray_tpu/api/renderer.py:333-362)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        audit, self._pending_shadow_audit = self._pending_shadow_audit, None
        if audit is not None:
            self.last_shadow_audit = audit.cpu().numpy()
            self._check_shadow_audit(self.last_shadow_audit)

    def render_frames_pipelined(self, n: int) -> float:
        """Render n frames with no sync between them and one at the end;
        returns the total wall milliseconds
        (compound_ray_tpu/api/renderer.py:452).  The frames draw the same
        angles as n render_frame() calls and leave the same camera data and
        display buffer.

        On the burst route (_burst_route) the n frames are one burst: one
        plan at the pose, the frames stacked into one frame core (one K1
        launch) or one frame core each (render_means_frames); only the last
        frame's means are kept and projected.  As in the JAX package, a
        burst records no per-frame time in frame_times_ms and does not
        audit its lit frames against their shadow shafts.  Elsewhere (raw
        samples, backend="naive", a real camera) it renders n unsynced
        frames."""
        t0 = time.perf_counter()
        if n > 0 and self._burst_route() is not None:
            cam = self.current_camera()
            gens = [self._generator(cam.rng_frame + f) for f in range(n)]
            args = self._frame_args(cam.ommatidia, cam.position,
                                    cam.local_space, gens,
                                    cam.samples_per_ommatidium)
            means = render_means_frames(
                *args, lights=self._lights if self._lit() else None)
            self._end_frames(cam, means[-1], None, n)
        else:
            for _ in range(n):
                self.render_frame(sync=False)
        self.sync()
        return (time.perf_counter() - t0) * 1000.0

    def _scan_frames_ok(self) -> bool:
        """True when render_frames_pipelined renders a burst."""
        return self._burst_route() is not None

    def _burst_route(self) -> Optional[str]:
        """The burst render_frames_pipelined takes
        (compound_ray_tpu/api/renderer.py:537): "pallas" for a compound
        eye that is not raw_ommatidial_samples under backend "auto" or
        "pallas", else None (frame by frame).  There is no "sharded"
        burst: the port renders on one device."""
        if self.scene is None or not self.scene.cameras:
            return None
        cam = self.current_camera()
        if (not isinstance(cam, CompoundEyeCamera)
                or cam.projection == "raw_ommatidial_samples"):
            return None
        return "pallas" if get_config().backend in ("auto", "pallas") else None

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

    # ------------------------------------------------------ observability
    def start_profile(self, log_dir: str) -> None:
        """Begin a torch.profiler trace of the host and, on the card, the
        device; stop_profile writes it as a Chrome trace into log_dir."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=acts)
        self._profiler.start()
        self._profile_dir = log_dir

    def stop_profile(self) -> str:
        """End the trace; returns the path of the Chrome trace written."""
        if self._profiler is None:
            raise RuntimeError("no profile running (call start_profile)")
        self._profiler.stop()
        os.makedirs(self._profile_dir, exist_ok=True)
        path = os.path.join(self._profile_dir, "trace.json")
        self._profiler.export_chrome_trace(path)
        self._log(f"Profile written to {path}")
        self._profiler = self._profile_dir = None
        return path

    def frame_time_stats(self) -> dict:
        """Summary of renderFrame wall times (ms) since startup."""
        if not self.frame_times_ms:
            return {"count": 0}
        a = np.asarray(self.frame_times_ms)
        return {
            "count": int(a.size),
            "mean_ms": float(a.mean()),
            "median_ms": float(np.median(a)),
            "p95_ms": float(np.percentile(a, 95)),
            "min_ms": float(a.min()),
            "max_ms": float(a.max()),
        }

    # ------------------------------------------------------- frame buffer
    def save_frame_as(self, path: str) -> None:
        """Write the display buffer as binary PPM; buffer row 0 is the bottom
        scanline, so rows are flipped like sutil::displayBufferFile."""
        frame = self.get_frame_pointer()
        h, w = frame.shape[:2]
        with open(path, "wb") as f:
            f.write(f"P6\n{w} {h}\n255\n".encode())
            f.write(np.ascontiguousarray(frame[::-1, :, :3]).tobytes())
        self._log(f"Saved render as '{path}'")

    def get_frame_pointer(self) -> np.ndarray:
        """The (H, W, 4) uint8 display buffer on the host, copied from the
        device on first read after a frame."""
        self._log("Retrieving frame pointer...")
        if self._frame_buffer is None:
            if self._device_frame is not None:
                self._frame_buffer = self._device_frame.cpu().numpy()
            else:
                self._frame_buffer = np.zeros((self.height, self.width, 4),
                                              np.uint8)
        return self._frame_buffer

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

    def previous_camera(self) -> None:
        self._current_camera = (self._current_camera - 1) % max(
            1, self.get_camera_count())

    def get_current_camera_index(self) -> int:
        return self._current_camera

    def get_current_camera_name(self) -> str:
        return self.current_camera().name

    def goto_camera(self, index: int) -> None:
        self._current_camera = int(index) % max(1, self.get_camera_count())

    def goto_camera_by_name(self, name: str) -> bool:
        """Resets to camera 0 then cycles (libEyeRenderer.cpp:358-368)."""
        self.goto_camera(0)
        for _ in range(self.get_camera_count()):
            if self.get_current_camera_name() == name:
                return True
            self.next_camera()
        return False

    def set_camera_position(self, x, y, z) -> None:
        self.current_camera().set_position((x, y, z))

    def get_camera_position(self) -> Tuple[float, float, float]:
        return tuple(float(v) for v in self.current_camera().position)

    def set_camera_local_space(self, lxx, lxy, lxz, lyx, lyy, lyz, lzx, lzy,
                               lzz) -> None:
        self.current_camera().set_local_space(
            (lxx, lxy, lxz), (lyx, lyy, lyz), (lzx, lzy, lzz))

    def rotate_camera_around(self, angle, x, y, z) -> None:
        self.current_camera().rotate_around(angle, (x, y, z))

    def rotate_camera_locally_around(self, angle, x, y, z) -> None:
        self.current_camera().rotate_locally_around(angle, (x, y, z))

    def translate_camera(self, x, y, z) -> None:
        self.current_camera().move((x, y, z))

    def translate_camera_locally(self, x, y, z) -> None:
        self.current_camera().move_locally((x, y, z))

    def translate_cameras_locally(self, x, y, z) -> None:
        for _ in range(self.get_camera_count()):
            self.current_camera().move_locally((x, y, z))
            self.next_camera()

    def rotate_cameras_around(self, angle, x, y, z) -> None:
        for _ in range(self.get_camera_count()):
            self.current_camera().rotate_around(angle, (x, y, z))
            self.next_camera()

    def rotate_cameras_locally_around(self, angle, x, y, z) -> None:
        for _ in range(self.get_camera_count()):
            self.current_camera().rotate_locally_around(angle, (x, y, z))
            self.next_camera()

    def reset_camera_pose(self) -> None:
        self.current_camera().reset_pose()

    def set_camera_pose(self, px, py, pz, rx, ry, rz) -> None:
        self.current_camera().set_pose(px, py, pz, rx, ry, rz)

    def set_camera_pose_matrix(self, m) -> None:
        self.current_camera().set_pose_matrix(np.asarray(m, np.float64))

    # --------------------------------------------------- compound controls
    def is_compound_eye_active(self) -> bool:
        return (self.scene is not None and bool(self.scene.cameras)
                and isinstance(self.current_camera(), CompoundEyeCamera))

    def get_eye_data_path(self) -> str:
        if self.is_compound_eye_active():
            return self.scene.eye_data_path
        return ""

    def get_current_eye_data_path(self) -> str:
        if self.is_compound_eye_active():
            return self.current_camera().eye_data_path
        return ""

    def set_current_eye_samples_per_ommatidium(self, s: int) -> None:
        if self.is_compound_eye_active():
            self.current_camera().set_samples_per_ommatidium(s)

    def get_current_eye_samples_per_ommatidium(self) -> int:
        if self.is_compound_eye_active():
            return self.current_camera().samples_per_ommatidium
        return -1

    def change_current_eye_samples_per_ommatidium_by(self, s: int) -> None:
        if self.is_compound_eye_active():
            self.current_camera().change_samples_per_ommatidium_by(s)

    def get_current_eye_ommatidial_count(self) -> int:
        if self.is_compound_eye_active():
            return self.current_camera().ommatidial_count
        return 0

    def set_ommatidia(self, omms) -> None:
        if self.is_compound_eye_active():
            self.current_camera().set_ommatidia(omms)

    def set_current_eye_shader_name(self, name: str) -> None:
        if self.is_compound_eye_active():
            if name.startswith(_SHADER_PREFIX):
                name = name[len(_SHADER_PREFIX):]
            self.current_camera().set_projection(name)

    def render_batch_poses(self, poses) -> np.ndarray:
        """(B, N, 3) means of the current compound eye at B poses in one
        frame (compound_ray_tpu/api/renderer.py:864).  `poses` holds
        (position (3,), rotation (3,)) pairs with set_camera_pose's
        rotation semantics, or (position, local space (3, 3)) pairs.  Each
        pose's ommatidia go to world space and the B eyes fold into the
        ommatidium axis of one eye, rendered at the identity pose with the
        generator of the eye's next frame (rng_frame advances by 1).  NaN
        rows are zeroed, as get_camera_data zeroes them."""
        if not self.is_compound_eye_active():
            raise RuntimeError("render_batch_poses needs a compound eye")
        cam = self.current_camera()
        base = cam.ommatidia  # (N, 8)
        n = base.shape[0]
        b = len(poses)
        pos_all = np.empty((b, 3), np.float64)
        ls_all = np.empty((b, 3, 3), np.float64)
        for i, (pos, rot) in enumerate(poses):
            probe = PerspectiveCamera("pose-probe")
            if np.asarray(rot).shape == (3, 3):
                probe.set_position(pos)
                probe.local_space = np.asarray(rot, np.float64)
            else:
                probe.set_pose(*pos, *rot)
            pos_all[i] = probe.position
            ls_all[i] = probe.local_space
        all_omms = np.broadcast_to(base[None], (b, n, base.shape[1])).copy()
        all_omms[:, :, 0:3] = (np.einsum("nc,bcd->bnd", base[:, 0:3], ls_all)
                               + pos_all[:, None, :])
        all_omms[:, :, 3:6] = np.einsum("nc,bcd->bnd", base[:, 3:6], ls_all)
        all_omms = all_omms.reshape(b * n, base.shape[1]).astype(np.float32)
        means = self._render_means(self._frame_args(
            all_omms, np.zeros(3), np.eye(3), self._generator(cam.rng_frame),
            cam.samples_per_ommatidium))
        cam.rng_frame += 1
        out = means.cpu().numpy().astype(np.float32)
        out[np.isnan(out[:, 0])] = 0.0
        return out.reshape(b, n, 3)

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

    # ------------------------------------------------------- scene queries
    def is_inside_hit_geometry(self, x, y, z, name: str) -> bool:
        for hb in self._loaded_scene().hitboxes:
            if hb.name == name:
                return hb.contains((x, y, z))
        self._log(f'WARNING: No hitbox with the given name "{name}" is '
                  f'present.')
        return False

    def _loaded_scene(self) -> FlatScene:
        if self.scene is None:
            raise RuntimeError("no scene loaded (call loadGlTFscene first)")
        return self.scene

    @staticmethod
    def _hitbox_world_aabb(hb) -> Tuple[np.ndarray, np.ndarray]:
        omin, omax = hb.object_aabb_min, hb.object_aabb_max
        corners = np.array(
            [[x, y, z] for x in (omin[0], omax[0])
             for y in (omin[1], omax[1]) for z in (omin[2], omax[2])])
        wc = corners @ hb.transform[:3, :3].T + hb.transform[:3, 3]
        return wc.min(axis=0), wc.max(axis=0)

    def _geometry_bounds(self, name: str, side: int) -> np.ndarray:
        """World AABB corner of the named hitbox, else of every mesh record
        of that name: a multi-primitive glTF mesh stores one record per
        primitive, and the reference reports the whole mesh's AABB
        (MulticamScene.cpp:449-461).  side 0 is the minimum, 1 the
        maximum; zeros when nothing has the name."""
        scene = self._loaded_scene()
        for hb in scene.hitboxes:
            if hb.name == name:
                return self._hitbox_world_aabb(hb)[side]
        recs = [rec for rec in scene.mesh_records if rec.name == name]
        if not recs:
            return np.zeros(3)
        if side:
            return np.max(np.asarray([r.world_aabb_max for r in recs],
                                     np.float64), axis=0)
        return np.min(np.asarray([r.world_aabb_min for r in recs],
                                 np.float64), axis=0)

    def get_geometry_max_bounds(self, name: str) -> np.ndarray:
        return self._geometry_bounds(name, 1)

    def get_geometry_min_bounds(self, name: str) -> np.ndarray:
        return self._geometry_bounds(name, 0)
