"""Drop-in equivalent of python-examples/eyeRendererHelperFunctions.py.

Scripts that `import eyeRendererHelperFunctions as eyeTools` can instead
`from compound_ray_tpu_torch import eye_tools as eyeTools` (or add this
module to their path under that name) — every public helper keeps its
reference name and semantics (eyeRendererHelperFunctions.py:1-202).  A copy
of compound_ray_tpu/eye_tools.py over the port's scene/eye_io.py.

Provenance: this module deliberately MIRRORS the reference helper's public
surface (names, camelCase signatures, record attributes) — that is its whole
purpose — but the implementations are this repo's own: file IO delegates to
compound_ray_tpu_torch.scene.eye_io (which adds legacy 7-field handling the
reference lacks) and the map re-projection / icosphere constructions are
vectorised numpy rather than the reference's per-pixel Python loops.
"""

from __future__ import annotations

import math
from ctypes import Structure, c_float

import numpy as np


class c_float3(Structure):
    _fields_ = [("x", c_float), ("y", c_float), ("z", c_float)]

    def toNumpy(self):
        return np.asarray([self.x, self.y, self.z])


class Ommatidium:
    """Reference-compatible record (attribute names match the helper)."""

    def __init__(self, position, direction, acceptanceAngle, focalpointOffset):
        self.position = position
        self.direction = direction
        self.acceptanceAngle = acceptanceAngle
        self.focalpointOffset = focalpointOffset

    def getSolidAngle(self):
        """Solid angle (steradians) of the acceptance cone."""
        return 2.0 * math.pi * (1.0 - math.cos(self.acceptanceAngle / 2.0))

    def copy(self):
        return Ommatidium(
            self.position.copy(), self.direction.copy(),
            self.acceptanceAngle, self.focalpointOffset,
        )


class c_ommatidiumPacket(Structure):
    _fields_ = [
        ("posX", c_float), ("posY", c_float), ("posZ", c_float),
        ("dirX", c_float), ("dirY", c_float), ("dirZ", c_float),
        ("acceptanceAngle", c_float), ("focalpointOffset", c_float),
    ]


def configureFunctions(eyeRenderer):
    """No-op compatible configuration: the shim self-describes its types, but
    we still set the restypes the reference helper sets so downstream code
    relying on them behaves identically."""
    import ctypes
    from numpy.ctypeslib import ndpointer

    eyeRenderer.renderFrame.restype = ctypes.c_double
    eyeRenderer.getCameraCount.restype = ctypes.c_size_t
    eyeRenderer.getCurrentCameraIndex.restype = ctypes.c_size_t
    eyeRenderer.getCurrentCameraName.restype = ctypes.c_char_p
    eyeRenderer.gotoCameraByName.restype = ctypes.c_bool
    eyeRenderer.isCompoundEyeActive.restype = ctypes.c_bool
    eyeRenderer.getCurrentEyeSamplesPerOmmatidium.restype = ctypes.c_int
    eyeRenderer.getCurrentEyeOmmatidialCount.restype = ctypes.c_size_t
    eyeRenderer.getCurrentEyeDataPath.restype = ctypes.c_char_p
    eyeRenderer.isInsideHitGeometry.restype = ctypes.c_bool


def setCameraLocalSpace(eyeRenderer, npMatrix):
    newX = npMatrix[:, 0]
    newY = npMatrix[:, 1]
    newZ = npMatrix[:, 2]
    eyeRenderer.setCameraLocalSpace(*newX, *newY, *newZ)


def setRenderSize(eyeRenderer, width, height):
    """Update render size (frame pointer shape follows automatically)."""
    eyeRenderer.setRenderSize(width, height)
    from numpy.ctypeslib import ndpointer
    from ctypes import c_ubyte

    eyeRenderer.getFramePointer.restype = ndpointer(
        dtype=c_ubyte, shape=(height, width, 4)
    )


def setOmmatidiaFromPacketList(eyeRenderer, packetList):
    ommCount = len(packetList)
    c_omm_array_type = c_ommatidiumPacket * ommCount
    c_ommArray = c_omm_array_type(*packetList)
    eyeRenderer.setOmmatidia(c_ommArray, ommCount)


def setOmmatidiaFromOmmatidiumList(eyeRenderer, ommList):
    packetList = [
        c_ommatidiumPacket(
            *[float(n) for n in o.position],
            *[float(n) for n in o.direction],
            o.acceptanceAngle, o.focalpointOffset,
        )
        for o in ommList
    ]
    setOmmatidiaFromPacketList(eyeRenderer, packetList)


def gotoFirstCompoundEye(eyeRenderer):
    camCount = eyeRenderer.getCameraCount()
    for i in range(camCount):
        eyeRenderer.gotoCamera(int(i))
        if eyeRenderer.isCompoundEyeActive():
            print("Found compound eye:", eyeRenderer.getCurrentCameraName())
            print("\twith compound data at:", eyeRenderer.getCurrentEyeDataPath())
            print("\twith this many ommatidia:",
                  eyeRenderer.getCurrentEyeOmmatidialCount())
            return
    raise Exception("Error: Could not find compound eye in provided GlTF scene.")


def gotoFirstRegularCamera(eyeRenderer):
    camCount = eyeRenderer.getCameraCount()
    for i in range(camCount):
        eyeRenderer.gotoCamera(int(i))
        if not eyeRenderer.isCompoundEyeActive():
            print("Found regular camera:", eyeRenderer.getCurrentCameraName())
            return
    raise Exception("Error: Could not find compound eye in provided GlTF scene.")


def readEyeFile(path):
    """Reads a .eye file into reference-style Ommatidium records.

    Delegates to scene.eye_io, so the legacy 7-field format is accepted
    here too."""
    from compound_ray_tpu_torch.scene import eye_io

    return [
        Ommatidium(
            np.asarray(o.position, dtype=np.float64),
            np.asarray(o.direction, dtype=np.float64),
            float(o.acceptance_angle),
            float(o.focal_point_offset),
        )
        for o in eye_io.read_eye_file(path)
    ]


def saveEyeFile(path, omms):
    with open(path, "w") as eyeFile:
        for omm in omms:
            eyeFile.write(
                "{:0.10f} {:0.10f} {:0.10f} {:0.10f} {:0.10f} {:0.10f} {:0.10f} {:0.10f}\n".format(
                    omm.position[0], omm.position[1], omm.position[2],
                    omm.direction[0], omm.direction[1], omm.direction[2],
                    omm.acceptanceAngle, omm.focalpointOffset,
                )
            )


def decodeProjectionMapID(RGBAquadlet):
    r = RGBAquadlet[0] << 24
    g = RGBAquadlet[1] << 16
    b = RGBAquadlet[2] << 8
    a = RGBAquadlet[3]
    return r | g | b | a


def getProjectionImageUsingMap(vector, idMap, pjWidth, pjHeight):
    """Re-project a per-ommatidium vector through an _ids projection map.

    idMap is the (H, W, 4) RGBA image produced by an `_ids` projection
    shader; each pixel's quadlet base-256-decodes to an ommatidium index
    (the bit layout asserted exactly in tests/test_projection.py).
    Vectorised: one decode + one gather instead of a per-pixel loop."""
    quad = np.asarray(idMap[:pjHeight, :pjWidth, :4], dtype=np.uint32)
    ids = (quad[..., 0] << 24) | (quad[..., 1] << 16) | (quad[..., 2] << 8) \
        | quad[..., 3]
    output = np.zeros((pjWidth, pjHeight), dtype=np.uint8)
    output[:pjHeight, :pjWidth] = np.asarray(vector)[ids].astype(np.uint8)
    return output


def getIcoOmmatidia():
    """12 equidistant ommatidia on an icosphere, 1 steradian each.

    Same point set as the reference helper; built by scene.eye_io's
    vectorised icosahedron construction."""
    from compound_ray_tpu_torch.scene import eye_io

    return [
        Ommatidium(
            np.zeros(3), np.asarray(o.direction, dtype=np.float64),
            float(o.acceptance_angle), 0.0,
        )
        for o in eye_io.icosphere_eye()
    ]
