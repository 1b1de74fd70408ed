"""ctypes-compatible shim: a drop-in stand-in for CDLL("libEyeRenderer3.so")
over the port's EyeRenderer (compound_ray_tpu/api/shim.py in torch).

The reference is consumed from Python by loading a shared object and calling
~40 camelCase C functions on it (python-examples/eyeRendererHelperFunctions.py
:40-71).  `load_eye_renderer()` returns an object with the same surface:
every function attribute accepts the same arguments (raw Python values or
ctypes wrappers), honours `.argtypes` / `.restype` assignment the way the
helper's configureFunctions does, and returns ctypes-faithful values (bytes
for c_char_p, numpy ndpointer views, ...).  Scripts written against the
reference run unchanged on the port.

Deliberate fixes over the reference (SURVEY.md §7 'fix' list):
  * loadGlTFscene takes just the path (the C signature's Matrix4x4-by-value
    argument is never passed by any ctypes caller)
  * displayFrame() exists as a no-op hook (primary-example.py:44 calls it but
    the reference never exported it)
  * multicamAlloc is optional — the renderer auto-initialises
"""

from __future__ import annotations

import ctypes
from typing import Any, Optional

import numpy as np

from compound_ray_tpu_torch.api.renderer import EyeRenderer
from compound_ray_tpu_torch.scene.eye_io import ommatidia_to_array


def _unwrap(v: Any) -> Any:
    if isinstance(v, ctypes._SimpleCData):  # c_float, c_char_p value objects
        v = v.value
    if isinstance(v, bytes):
        return v.decode("utf-8")
    return v


class _ShimFunc:
    """Callable attribute mimicking a ctypes foreign function."""

    def __init__(self, fn, name: str):
        self._fn = fn
        self.__name__ = name
        self.argtypes = None  # assignable, ignored (the shim type-checks itself)
        self.restype = None

    def __call__(self, *args):
        out = self._fn(*args)
        rt = self.restype
        if rt is None:
            return out
        if rt is ctypes.c_char_p:
            if out is None:
                return b""
            return out.encode("utf-8") if isinstance(out, str) else out
        if rt in (ctypes.c_double, ctypes.c_float):
            return float(out)
        if rt in (ctypes.c_int, ctypes.c_size_t, ctypes.c_uint, ctypes.c_long):
            return int(out)
        if rt is ctypes.c_bool:
            return bool(out)
        # numpy.ctypeslib ndpointer types are classes with _shape_/_dtype_
        shape = getattr(rt, "_shape_", None)
        dtype = getattr(rt, "_dtype_", None)
        if shape is not None and isinstance(out, np.ndarray):
            return np.ascontiguousarray(out, dtype=dtype).reshape(shape)
        return out


class EyeRendererShim:
    """The libEyeRenderer3 C ABI surface over the port's renderer."""

    def __init__(self, renderer: Optional[EyeRenderer] = None):
        self._r = renderer or EyeRenderer()
        for name in dir(self):
            if name.startswith("_impl_"):
                setattr(self, name[len("_impl_"):],
                        _ShimFunc(getattr(self, name), name[len("_impl_"):]))

    @property
    def renderer(self) -> EyeRenderer:
        return self._r

    # -- allocation ------------------------------------------------------------
    def _impl_multicamAlloc(self):
        return None

    def _impl_multicamDealloc(self):
        self._r.stop()

    # -- configuration ---------------------------------------------------------
    def _impl_setVerbosity(self, v):
        self._r.set_verbosity(bool(_unwrap(v)))

    def _impl_loadGlTFscene(self, filepath, *_ignored_root_transform):
        self._r.load_gltf_scene(_unwrap(filepath))

    def _impl_stop(self):
        self._r.stop()

    def _impl_setRenderSize(self, w, h):
        self._r.set_render_size(int(_unwrap(w)), int(_unwrap(h)))

    def _impl_renderFrame(self):
        return self._r.render_frame()

    def _impl_saveFrameAs(self, ppm_filename):
        self._r.save_frame_as(_unwrap(ppm_filename))

    def _impl_getFramePointer(self):
        return self._r.get_frame_pointer()

    def _impl_setRequireNoncompoundPipeline(self, require):
        self._r.set_require_noncompound_pipeline(bool(_unwrap(require)))

    def _impl_displayFrame(self):
        return None  # GUI hook; the CLI backend has no window

    # -- camera control ----------------------------------------------------------
    def _impl_getCameraCount(self):
        return self._r.get_camera_count()

    def _impl_nextCamera(self):
        self._r.next_camera()

    def _impl_previousCamera(self):
        self._r.previous_camera()

    def _impl_getCurrentCameraIndex(self):
        return self._r.get_current_camera_index()

    def _impl_getCurrentCameraName(self):
        return self._r.get_current_camera_name()

    def _impl_gotoCamera(self, index):
        self._r.goto_camera(int(_unwrap(index)))

    def _impl_gotoCameraByName(self, name):
        return self._r.goto_camera_by_name(_unwrap(name))

    def _impl_setCameraPosition(self, x, y, z):
        self._r.set_camera_position(*(float(_unwrap(a)) for a in (x, y, z)))

    def _impl_getCameraPosition(self):
        return np.asarray(self._r.get_camera_position(), np.float64).reshape(3, 1)

    def _impl_setCameraLocalSpace(self, *vals):
        self._r.set_camera_local_space(*(float(_unwrap(v)) for v in vals))

    def _impl_rotateCameraAround(self, angle, x, y, z):
        self._r.rotate_camera_around(*(float(_unwrap(a)) for a in (angle, x, y, z)))

    def _impl_rotateCameraLocallyAround(self, angle, x, y, z):
        self._r.rotate_camera_locally_around(
            *(float(_unwrap(a)) for a in (angle, x, y, z))
        )

    def _impl_translateCamera(self, x, y, z):
        self._r.translate_camera(*(float(_unwrap(a)) for a in (x, y, z)))

    def _impl_translateCameraLocally(self, x, y, z):
        self._r.translate_camera_locally(*(float(_unwrap(a)) for a in (x, y, z)))

    def _impl_translateCamerasLocally(self, x, y, z):
        self._r.translate_cameras_locally(*(float(_unwrap(a)) for a in (x, y, z)))

    def _impl_rotateCamerasAround(self, angle, x, y, z):
        self._r.rotate_cameras_around(*(float(_unwrap(a)) for a in (angle, x, y, z)))

    def _impl_rotateCamerasLocallyAround(self, angle, x, y, z):
        self._r.rotate_cameras_locally_around(
            *(float(_unwrap(a)) for a in (angle, x, y, z))
        )

    def _impl_resetCameraPose(self):
        self._r.reset_camera_pose()

    def _impl_setCameraPose(self, *vals):
        self._r.set_camera_pose(*(float(_unwrap(v)) for v in vals))

    def _impl_setCameraPoseMatrix(self, m):
        self._r.set_camera_pose_matrix(np.asarray(m, np.float64).reshape(4, 4))

    # -- compound controls -------------------------------------------------------
    def _impl_isCompoundEyeActive(self):
        return self._r.is_compound_eye_active()

    def _impl_setCurrentEyeSamplesPerOmmatidium(self, s):
        self._r.set_current_eye_samples_per_ommatidium(int(_unwrap(s)))

    def _impl_getCurrentEyeSamplesPerOmmatidium(self):
        return self._r.get_current_eye_samples_per_ommatidium()

    def _impl_changeCurrentEyeSamplesPerOmmatidiumBy(self, s):
        self._r.change_current_eye_samples_per_ommatidium_by(int(_unwrap(s)))

    def _impl_getCurrentEyeOmmatidialCount(self):
        return self._r.get_current_eye_ommatidial_count()

    def _impl_setOmmatidia(self, omms, count=None):
        # accepts a ctypes array of c_ommatidiumPacket, a numpy (N,8) array,
        # or a list of Ommatidium objects
        if isinstance(omms, np.ndarray):
            # honor count like the reference C ABI (and the ctypes branch
            # below): scripts reuse one oversized buffer and pass the live
            # record count — taking every row would add stale ommatidia
            arr = (omms[: int(_unwrap(count))] if count is not None
                   else omms)
        elif hasattr(omms, "_length_"):  # ctypes array
            n = int(_unwrap(count)) if count is not None else omms._length_
            arr = np.zeros((n, 8), np.float32)
            for i in range(n):
                p = omms[i]
                arr[i] = [p.posX, p.posY, p.posZ, p.dirX, p.dirY, p.dirZ,
                          p.acceptanceAngle, p.focalpointOffset]
        else:
            arr = ommatidia_to_array(list(omms))
        self._r.set_ommatidia(arr)

    def _impl_getCurrentEyeDataPath(self):
        return self._r.get_current_eye_data_path()

    def _impl_getEyeDataPath(self):
        return self._r.get_eye_data_path()

    def _impl_setCurrentEyeShaderName(self, name):
        self._r.set_current_eye_shader_name(_unwrap(name))

    def _impl_getCameraData(self):
        return self._r.get_camera_data()

    # -- scene queries -----------------------------------------------------------
    def _impl_isInsideHitGeometry(self, x, y, z, name):
        return self._r.is_inside_hit_geometry(
            float(_unwrap(x)), float(_unwrap(y)), float(_unwrap(z)), _unwrap(name)
        )

    def _impl_getGeometryMaxBounds(self, name):
        v = self._r.get_geometry_max_bounds(_unwrap(name))
        return _CFloat3(v)

    def _impl_getGeometryMinBounds(self, name):
        v = self._r.get_geometry_min_bounds(_unwrap(name))
        return _CFloat3(v)


class _CFloat3:
    """Mimics the helper's c_float3 return (x/y/z fields + toNumpy)."""

    def __init__(self, v):
        self.x, self.y, self.z = (float(a) for a in v)

    def toNumpy(self):
        return np.asarray([self.x, self.y, self.z])


def load_eye_renderer(_path: str = "", verbose: bool = True, *,
                      device="cuda") -> EyeRendererShim:
    """Drop-in replacement for ctypes.CDLL('libEyeRenderer3.so'); renders on
    `device` (the card unless the caller asks for another)."""
    return EyeRendererShim(EyeRenderer(verbose=verbose, device=device))
