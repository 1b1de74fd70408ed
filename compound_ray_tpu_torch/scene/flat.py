"""FlatScene: glTF -> flat world-space device arrays.

A numpy copy of compound_ray_tpu/scene/flat.py whose device upload
(FlatScene.device_triangles) gives torch tensors on a stated device.

The replacement for the reference's MulticamScene + OptiX GAS/IAS
(libEyeRenderer3/MulticamScene.cpp:665-904, 1229-1596).  Instead of per-mesh
device buffers behind an instance hierarchy, every triangle is baked into
world space at load time and stored in structure-of-arrays form: the renderer
consumes a single triangle soup, which the kernels can tile without pointer
chasing.  Instance transforms therefore cost nothing per ray, and the accel
structure (compound_ray_tpu_torch.accel) is built over world-space primitives.

Semantics preserved from the reference loader:
  * node transform = parent * matrix * T * R * S   (MulticamScene.cpp:207-239)
  * camera axes   = node_xform applied to +x / +y / -z (right/up/forward,
    MulticamScene.cpp:249-262)
  * camera kinds: orthographic, extras 'panoramic', extras 'compound-eye'
    (+ compound-structure/.eye path resolution, compound-projection), default
    perspective with yfov (MulticamScene.cpp:269-390)
  * meshes whose *mesh* extras contain hitbox=true become CPU hitbox meshes
    (MulticamScene.cpp:392-409)
  * vertex colours COLOR_0 in vec3/vec4 x float/ubyte/ushort
    (MulticamScene.cpp:489-649, decode rules of cuda/LocalGeometry.h:106-171)
  * scene extras 'background-shader' selects the miss program
    (MulticamScene.cpp:691-705)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from compound_ray_tpu_torch.cameras.types import (
    Camera,
    CompoundEyeCamera,
    OrthographicCamera,
    PanoramicCamera,
    PerspectiveCamera,
)
from compound_ray_tpu_torch.scene.eye_io import read_eye_file, resolve_eye_path
from compound_ray_tpu_torch.scene.gltf import (
    GLTFDocument,
    extra_is_true,
    load_gltf,
    node_local_matrix,
)

_TRIANGLES_MODE = 4  # glTF primitive.mode TRIANGLES (implicit default)


@dataclass
class HitboxMesh:
    """CPU-side hitbox mesh for point-in-mesh queries
    (sutil/hitscanprocessing.{h,cpp})."""

    name: str
    transform: np.ndarray  # (4,4) world transform
    triangles: np.ndarray  # (n, 3, 3) object-space vertices
    object_aabb_min: np.ndarray
    object_aabb_max: np.ndarray

    def contains(self, world_point) -> bool:
        """Ray-parity point-in-mesh test (hitscanprocessing.cpp:20-86).

        Casts a +x ray in object space from just outside the AABB and counts
        triangle crossings at x <= point.x (the numpy path of
        compound_ray_tpu/scene/flat.py:63).
        """
        inv = np.linalg.inv(self.transform)
        p = inv @ np.array([*world_point, 1.0])
        obj = p[:3]
        start = obj.copy()
        start[0] = self.object_aabb_min[0] - 1.0
        ray_dir = obj - start
        n = np.linalg.norm(ray_dir)
        if n == 0:
            return False
        ray_dir = ray_dir / n

        tri = self.triangles  # (n,3,3)
        p0, p1, p2 = tri[:, 0], tri[:, 1], tri[:, 2]
        normal = np.cross(p1 - p0, p2 - p0)
        nl = np.linalg.norm(normal, axis=1, keepdims=True)
        nl[nl == 0] = 1.0
        normal = normal / nl
        denom = normal @ ray_dir
        valid = denom != 0
        dist = np.where(
            valid, np.einsum("ij,ij->i", p0 - start, normal) / np.where(valid, denom, 1.0), 0.0
        )
        hit = start + dist[:, None] * ray_dir
        valid &= (dist != 0) & (dist >= 0) & (hit[:, 0] <= obj[0])
        for a, b in ((p0, p1), (p1, p2), (p2, p0)):
            cp = np.cross(b - a, hit - a)
            valid &= np.einsum("ij,ij->i", normal, cp) >= 0
        return int(np.count_nonzero(valid)) % 2 == 1


@dataclass
class MeshRecord:
    """Named mesh bounds for getGeometryMin/MaxBounds queries."""

    name: str
    world_aabb_min: np.ndarray
    world_aabb_max: np.ndarray


@dataclass
class FlatScene:
    """World-space triangle soup + materials + textures + cameras."""

    # triangle soup, all (N, ...) float32 / int32, world space
    v0: np.ndarray  # (N,3) first vertex
    e1: np.ndarray  # (N,3) v1 - v0
    e2: np.ndarray  # (N,3) v2 - v0
    n0: np.ndarray  # (N,3) per-corner normals (inverse-transpose transformed,
    n1: np.ndarray  #        deliberately unnormalised: interpolation then a
    n2: np.ndarray  #        single normalise matches the reference's order)
    has_normals: np.ndarray  # (N,) bool
    uv0: np.ndarray  # (N,2)
    uv1: np.ndarray
    uv2: np.ndarray
    has_uv: np.ndarray  # (N,) bool
    c0: np.ndarray  # (N,4) vertex colours (0-1 floats)
    c1: np.ndarray
    c2: np.ndarray
    has_color: np.ndarray  # (N,) bool
    mat_id: np.ndarray  # (N,) int32, -1 = none

    # material table
    mat_base_color: np.ndarray  # (M,4)
    mat_metallic: np.ndarray  # (M,)
    mat_roughness: np.ndarray  # (M,)
    mat_tex: np.ndarray  # (M,) int32 texture index or -1
    # mat_mr_tex / mat_normal_tex ((M,) int32 or -1) live in the defaults
    # block below: older construction sites may omit them

    # texture atlas (all texels of all textures concatenated row-major)
    tex_data: np.ndarray  # (P,4) float32 0-1
    tex_offset: np.ndarray  # (T,) int32 texel offset
    tex_width: np.ndarray  # (T,) int32
    tex_height: np.ndarray  # (T,) int32
    tex_wrap_s: np.ndarray  # (T,) int32: 0 repeat, 1 clamp, 2 mirror
    tex_wrap_t: np.ndarray
    tex_filter: np.ndarray  # (T,) int32: 0 nearest, 1 linear

    background_shader: str  # miss program name, e.g. "default_background"
    cameras: List[Camera]
    hitboxes: List[HitboxMesh]
    mesh_records: List[MeshRecord]
    aabb_min: np.ndarray
    aabb_max: np.ndarray
    source_path: str = ""
    eye_data_path: str = ""  # last compound eye path loaded (scene.eye_data_path)
    # lit-path texture modulation slots (shaders.cu:831-852): glTF
    # metallicRoughnessTexture / normalTexture indices, -1 = none
    mat_mr_tex: Optional[np.ndarray] = None  # (M,) int32
    mat_normal_tex: Optional[np.ndarray] = None  # (M,) int32

    _device_cache: Optional[Dict[str, Any]] = field(default=None, repr=False)
    _device_cache_on: Optional[Any] = field(default=None, repr=False)
    _accel_cache: Optional[Any] = field(default=None, repr=False)

    def __post_init__(self):
        if self.mat_mr_tex is None:
            self.mat_mr_tex = np.full(self.mat_tex.shape, -1, np.int32)
        if self.mat_normal_tex is None:
            self.mat_normal_tex = np.full(self.mat_tex.shape, -1, np.int32)

    @property
    def num_triangles(self) -> int:
        return int(self.v0.shape[0])

    @property
    def has_any_texture(self) -> bool:
        return bool(self.tex_offset.size) and bool((self.mat_tex >= 0).any())

    def aabb_center(self) -> np.ndarray:
        return (self.aabb_min + self.aabb_max) / 2.0

    def aabb_max_extent(self) -> float:
        return float(np.max(self.aabb_max - self.aabb_min))

    def device_triangles(self, device) -> Dict[str, Any]:
        """The triangle soup + tables as a dict of tensors on `device`
        (compound_ray_tpu/scene/flat.py:195).  Cached per device; a caller
        that edits the arrays resets `_device_cache` to None."""
        device = torch.device(device)
        if self._device_cache is None or self._device_cache_on != device:

            def dev(x):
                return torch.as_tensor(np.ascontiguousarray(x), device=device)

            self._device_cache_on = device
            self._device_cache = {
                "v0": dev(self.v0), "e1": dev(self.e1), "e2": dev(self.e2),
                "n0": dev(self.n0), "n1": dev(self.n1), "n2": dev(self.n2),
                "has_normals": dev(self.has_normals),
                "uv0": dev(self.uv0), "uv1": dev(self.uv1), "uv2": dev(self.uv2),
                "has_uv": dev(self.has_uv),
                "c0": dev(self.c0), "c1": dev(self.c1), "c2": dev(self.c2),
                "has_color": dev(self.has_color),
                "mat_id": dev(self.mat_id),
                "mat_base_color": dev(self.mat_base_color),
                "mat_metallic": dev(self.mat_metallic),
                "mat_roughness": dev(self.mat_roughness),
                "mat_tex": dev(self.mat_tex),
                "tex_data": dev(self.tex_data),
                "tex_offset": dev(self.tex_offset),
                "tex_width": dev(self.tex_width),
                "tex_height": dev(self.tex_height),
                "tex_wrap_s": dev(self.tex_wrap_s),
                "tex_wrap_t": dev(self.tex_wrap_t),
                "tex_filter": dev(self.tex_filter),
            }
            # present only when some material references a metallic-
            # roughness or normal texture: the lit epilogue gates its
            # material-texture modulation on these keys, as the JAX package
            # does (compound_ray_tpu/scene/flat.py:223-230)
            if (self.mat_mr_tex >= 0).any() or (self.mat_normal_tex >= 0).any():
                self._device_cache["mat_mr_tex"] = dev(self.mat_mr_tex)
                self._device_cache["mat_normal_tex"] = dev(
                    self.mat_normal_tex)
        return self._device_cache


def _force_unit_range(doc: GLTFDocument, accessor_idx: int) -> np.ndarray:
    """Decode an accessor, scaling integer component types to [0,1] the way the
    reference's device decode does for vertex colours regardless of the
    accessor `normalized` flag (cuda/LocalGeometry.h:112-135)."""
    acc = doc.json["accessors"][accessor_idx]
    arr = doc.accessor(accessor_idx).astype(np.float32)
    comp = acc["componentType"]
    if not acc.get("normalized"):
        if comp == 5121:
            arr = arr / 255.0
        elif comp == 5123:
            arr = arr / 65535.0
    return arr


_GL_CLAMP_TO_EDGE = 33071
_GL_MIRRORED_REPEAT = 33648
_GL_NEAREST = 9728


def _wrap_code(gl_mode: Optional[int]) -> int:
    if gl_mode == _GL_CLAMP_TO_EDGE:
        return 1
    if gl_mode == _GL_MIRRORED_REPEAT:
        return 2
    return 0  # repeat (cudaAddressModeWrap default, MulticamScene.cpp:981-987)


class _Builder:
    def __init__(self, doc: GLTFDocument, source_path: str):
        self.doc = doc
        self.source_path = source_path
        self.tri_chunks: List[Dict[str, np.ndarray]] = []
        self.cameras: List[Camera] = []
        self.hitboxes: List[HitboxMesh] = []
        self.mesh_records: List[MeshRecord] = []
        self.eye_data_path = ""
        # materials
        self.mat_base_color: List[np.ndarray] = []
        self.mat_metallic: List[float] = []
        self.mat_roughness: List[float] = []
        self.mat_tex: List[int] = []
        self.mat_mr_tex: List[int] = []
        self.mat_normal_tex: List[int] = []
        self._build_materials()
        self._build_textures()

    # ---- materials / textures --------------------------------------------------
    def _build_materials(self) -> None:
        for mat in self.doc.materials:
            pbr = mat.get("pbrMetallicRoughness", {})
            self.mat_base_color.append(
                np.array(pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0]), np.float32)
            )
            self.mat_metallic.append(float(pbr.get("metallicFactor", 1.0)))
            self.mat_roughness.append(float(pbr.get("roughnessFactor", 1.0)))
            bct = pbr.get("baseColorTexture")
            self.mat_tex.append(int(bct["index"]) if bct else -1)
            # lit-path modulation textures (shaders.cu:838-845, 848-852)
            mrt = pbr.get("metallicRoughnessTexture")
            self.mat_mr_tex.append(int(mrt["index"]) if mrt else -1)
            nt = mat.get("normalTexture")
            self.mat_normal_tex.append(int(nt["index"]) if nt else -1)
        if not self.mat_base_color:  # always at least one slot so gathers are safe
            self.mat_base_color.append(np.array([1, 1, 1, 1], np.float32))
            self.mat_metallic.append(1.0)
            self.mat_roughness.append(1.0)
            self.mat_tex.append(-1)
            self.mat_mr_tex.append(-1)
            self.mat_normal_tex.append(-1)

    def _build_textures(self) -> None:
        textures = self.doc.json.get("textures", [])
        samplers = self.doc.json.get("samplers", [])
        datas, offs, ws, hs, wss, wts, flt = [], [], [], [], [], [], []
        offset = 0
        # MR / normal maps carry DATA, not colour: glTF stores them linear,
        # so the sRGB linearization below must skip them.  A texture used
        # both as base colour and as a data map (pathological) stays
        # colour-linearized.
        data_tex = ({t for t in self.mat_mr_tex if t >= 0}
                    | {t for t in self.mat_normal_tex if t >= 0}) \
            - {t for t in self.mat_tex if t >= 0}
        for ti, tex in enumerate(textures):
            img = self.doc.image(tex["source"])
            h, w = img.data.shape[:2]
            rgba = img.data.astype(np.float32) / 255.0
            # glTF base-color texels are sRGB-encoded: linearize (gamma 2.2)
            # at load so shading happens in linear radiance, symmetric with
            # the vertex-colour path (shade.py linearize).  This matches the
            # reference's committed golden renders; its CURRENT shaders.cu
            # samples raw (MulticamScene.cpp:996 "TODO: glTF assumes sRGB
            # for base_color -- handle in shader" + shaders.cu:805-809),
            # which double-brightens textures — conformance vs the goldens
            # (tools/conformance_report.py) pins the linearized behaviour.
            if ti not in data_tex:
                rgba[..., :3] = np.power(rgba[..., :3], 2.2)
            datas.append(rgba.reshape(-1, 4))
            offs.append(offset)
            ws.append(w)
            hs.append(h)
            offset += h * w
            samp = samplers[tex["sampler"]] if "sampler" in tex else {}
            wss.append(_wrap_code(samp.get("wrapS")))
            wts.append(_wrap_code(samp.get("wrapT")))
            flt.append(0 if samp.get("magFilter") == _GL_NEAREST else 1)
        self.tex_data = (
            np.concatenate(datas, axis=0) if datas else np.zeros((1, 4), np.float32)
        )
        self.tex_offset = np.array(offs, np.int32)
        self.tex_width = np.array(ws, np.int32)
        self.tex_height = np.array(hs, np.int32)
        self.tex_wrap_s = np.array(wss, np.int32)
        self.tex_wrap_t = np.array(wts, np.int32)
        self.tex_filter = np.array(flt, np.int32)

    # ---- node traversal --------------------------------------------------------
    def process_node(self, node_idx: int, parent: np.ndarray) -> None:
        node = self.doc.nodes[node_idx]
        xform = parent @ node_local_matrix(node)
        cam_idx = node.get("camera", -1)
        mesh_idx = node.get("mesh", -1)
        if cam_idx != -1:
            self._process_camera(self.doc.cameras[cam_idx], xform)
        elif mesh_idx != -1:
            mesh = self.doc.meshes[mesh_idx]
            if extra_is_true(mesh.get("extras"), "hitbox"):
                self._process_hitbox(mesh, xform)
            else:
                self._process_mesh(mesh, xform)
        elif node.get("children"):
            for child in node["children"]:
                self.process_node(child, xform)
            return
        # Note: reference treats camera/mesh/children as exclusive branches
        # (MulticamScene.cpp:241-655); a camera or mesh node's children are
        # not traversed there, and we mirror that.

    def _process_camera(self, cam: dict, xform: np.ndarray) -> None:
        right = (xform @ np.array([1.0, 0, 0, 0]))[:3]
        up = (xform @ np.array([0.0, 1, 0, 0]))[:3]
        forward = (xform @ np.array([0.0, 0, -1, 0]))[:3]
        eye = (xform @ np.array([0.0, 0, 0, 1]))[:3]
        extras = cam.get("extras") or {}
        name = cam.get("name", f"camera{len(self.cameras)}")

        if cam.get("type") == "orthographic":
            ortho = cam.get("orthographic", {})
            c: Camera = OrthographicCamera(name)
            c.set_xy_scale(ortho.get("xmag", 1.0), ortho.get("ymag", 1.0))
        elif extra_is_true(extras, "panoramic"):
            c = PanoramicCamera(name)
        elif extra_is_true(extras, "compound-eye"):
            eye_path = extras.get("compound-structure", "")
            projection = extras.get("compound-projection", "")
            if not eye_path or not projection:
                return  # reference logs an error and skips (MulticamScene.cpp:310-319)
            resolved = resolve_eye_path(eye_path, os.path.dirname(self.source_path))
            if resolved is None:
                self.eye_data_path = os.path.join(
                    os.path.dirname(self.source_path), eye_path
                )
                return
            omms = read_eye_file(resolved)
            if not omms:
                return
            self.eye_data_path = resolved
            c = CompoundEyeCamera(name, projection, omms, eye_data_path=resolved)
        else:
            persp = cam.get("perspective", {})
            pc = PerspectiveCamera(name)
            pc.set_y_fov(np.degrees(persp.get("yfov", 0.8)))
            c = pc
        c.set_position(eye)
        c.set_local_space(right, up, forward)
        self.cameras.append(c)

    def _process_hitbox(self, mesh: dict, xform: np.ndarray) -> None:
        tris = []
        for prim in mesh.get("primitives", []):
            if prim.get("mode", _TRIANGLES_MODE) != _TRIANGLES_MODE:
                continue
            pos = self.doc.accessor(prim["attributes"]["POSITION"]).astype(np.float64)
            if "indices" in prim:
                idx = self.doc.accessor(prim["indices"]).astype(np.int64).reshape(-1)
            else:
                idx = np.arange(len(pos), dtype=np.int64)
            tris.append(pos[idx].reshape(-1, 3, 3))
        if not tris:
            return
        tri = np.concatenate(tris, axis=0)
        self.hitboxes.append(
            HitboxMesh(
                name=mesh.get("name", ""),
                transform=xform.copy(),
                triangles=tri,
                object_aabb_min=tri.reshape(-1, 3).min(axis=0),
                object_aabb_max=tri.reshape(-1, 3).max(axis=0),
            )
        )

    def _process_mesh(self, mesh: dict, xform: np.ndarray) -> None:
        m3 = xform[:3, :3]
        # inverse-transpose for normals (OptiX object->world normal transform)
        try:
            nmat = np.linalg.inv(m3).T
        except np.linalg.LinAlgError:
            nmat = m3
        for prim in mesh.get("primitives", []):
            if prim.get("mode", _TRIANGLES_MODE) != _TRIANGLES_MODE:
                continue
            attrs = prim["attributes"]
            pos = self.doc.accessor(attrs["POSITION"]).astype(np.float64)
            if "indices" in prim:
                idx = self.doc.accessor(prim["indices"]).astype(np.int64).reshape(-1)
            else:
                idx = np.arange(len(pos), dtype=np.int64)
            idx = idx.reshape(-1, 3)
            ntri = idx.shape[0]
            world = pos @ m3.T + xform[:3, 3]
            p0, p1, p2 = world[idx[:, 0]], world[idx[:, 1]], world[idx[:, 2]]

            chunk: Dict[str, np.ndarray] = {
                "v0": p0.astype(np.float32),
                "e1": (p1 - p0).astype(np.float32),
                "e2": (p2 - p0).astype(np.float32),
                "mat_id": np.full(ntri, prim.get("material", -1), np.int32),
            }

            if "NORMAL" in attrs:
                nrm = self.doc.accessor(attrs["NORMAL"]).astype(np.float64) @ nmat.T
                chunk["n0"] = nrm[idx[:, 0]].astype(np.float32)
                chunk["n1"] = nrm[idx[:, 1]].astype(np.float32)
                chunk["n2"] = nrm[idx[:, 2]].astype(np.float32)
                chunk["has_normals"] = np.ones(ntri, bool)
            else:
                z = np.zeros((ntri, 3), np.float32)
                chunk.update(n0=z, n1=z.copy(), n2=z.copy(),
                             has_normals=np.zeros(ntri, bool))

            if "TEXCOORD_0" in attrs:
                uv = self.doc.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                chunk["uv0"] = uv[idx[:, 0]]
                chunk["uv1"] = uv[idx[:, 1]]
                chunk["uv2"] = uv[idx[:, 2]]
                chunk["has_uv"] = np.ones(ntri, bool)
            else:
                # no texcoords: reference falls back to UV = barycentrics
                # via corner UVs (0,0) (0,1) (1,0)  (LocalGeometry.h:98-104)
                chunk["uv0"] = np.zeros((ntri, 2), np.float32)
                chunk["uv1"] = np.tile([0.0, 1.0], (ntri, 1)).astype(np.float32)
                chunk["uv2"] = np.tile([1.0, 0.0], (ntri, 1)).astype(np.float32)
                chunk["has_uv"] = np.zeros(ntri, bool)

            if "COLOR_0" in attrs:
                col = _force_unit_range(self.doc, attrs["COLOR_0"])
                if col.shape[1] == 3:
                    col = np.concatenate(
                        [col, np.ones((len(col), 1), np.float32)], axis=1
                    )
                chunk["c0"] = col[idx[:, 0]]
                chunk["c1"] = col[idx[:, 1]]
                chunk["c2"] = col[idx[:, 2]]
                chunk["has_color"] = np.ones(ntri, bool)
            else:
                z4 = np.zeros((ntri, 4), np.float32)
                chunk.update(c0=z4, c1=z4.copy(), c2=z4.copy(),
                             has_color=np.zeros(ntri, bool))

            self.tri_chunks.append(chunk)

            # named bounds record (accessor min/max transformed, like
            # mesh->world_aabb in MulticamScene.cpp:449-461)
            acc = self.doc.json["accessors"][attrs["POSITION"]]
            if "minValues" in acc and "maxValues" in acc:
                omin = np.array(acc["minValues"], np.float64)
                omax = np.array(acc["maxValues"], np.float64)
            else:
                omin, omax = pos.min(axis=0), pos.max(axis=0)
            corners = np.array(
                [[x, y, z] for x in (omin[0], omax[0])
                 for y in (omin[1], omax[1]) for z in (omin[2], omax[2])]
            )
            wc = corners @ m3.T + xform[:3, 3]
            self.mesh_records.append(
                MeshRecord(
                    name=mesh.get("name", ""),
                    world_aabb_min=wc.min(axis=0),
                    world_aabb_max=wc.max(axis=0),
                )
            )

    # ---- assembly ---------------------------------------------------------------
    def build(self) -> FlatScene:
        keys = ["v0", "e1", "e2", "n0", "n1", "n2", "has_normals",
                "uv0", "uv1", "uv2", "has_uv", "c0", "c1", "c2",
                "has_color", "mat_id"]
        merged: Dict[str, np.ndarray] = {}
        if self.tri_chunks:
            for k in keys:
                merged[k] = np.concatenate([c[k] for c in self.tri_chunks], axis=0)
        else:
            merged = {
                "v0": np.zeros((0, 3), np.float32),
                "e1": np.zeros((0, 3), np.float32),
                "e2": np.zeros((0, 3), np.float32),
                "n0": np.zeros((0, 3), np.float32),
                "n1": np.zeros((0, 3), np.float32),
                "n2": np.zeros((0, 3), np.float32),
                "has_normals": np.zeros(0, bool),
                "uv0": np.zeros((0, 2), np.float32),
                "uv1": np.zeros((0, 2), np.float32),
                "uv2": np.zeros((0, 2), np.float32),
                "has_uv": np.zeros(0, bool),
                "c0": np.zeros((0, 4), np.float32),
                "c1": np.zeros((0, 4), np.float32),
                "c2": np.zeros((0, 4), np.float32),
                "has_color": np.zeros(0, bool),
                "mat_id": np.zeros(0, np.int32),
            }
        if self.mesh_records:
            aabb_min = np.min([r.world_aabb_min for r in self.mesh_records], axis=0)
            aabb_max = np.max([r.world_aabb_max for r in self.mesh_records], axis=0)
        else:
            aabb_min = np.zeros(3)
            aabb_max = np.zeros(3)

        scene_extras = {}
        scenes = self.doc.scenes
        if scenes:
            scene_extras = scenes[self.doc.json.get("scene", 0)].get("extras") or {}
        background = scene_extras.get("background-shader", "default_background")

        return FlatScene(
            **merged,
            mat_base_color=np.stack(self.mat_base_color),
            mat_metallic=np.array(self.mat_metallic, np.float32),
            mat_roughness=np.array(self.mat_roughness, np.float32),
            mat_tex=np.array(self.mat_tex, np.int32),
            mat_mr_tex=np.array(self.mat_mr_tex, np.int32),
            mat_normal_tex=np.array(self.mat_normal_tex, np.int32),
            tex_data=self.tex_data,
            tex_offset=self.tex_offset,
            tex_width=self.tex_width,
            tex_height=self.tex_height,
            tex_wrap_s=self.tex_wrap_s,
            tex_wrap_t=self.tex_wrap_t,
            tex_filter=self.tex_filter,
            background_shader=background,
            cameras=self.cameras,
            hitboxes=self.hitboxes,
            mesh_records=self.mesh_records,
            aabb_min=aabb_min,
            aabb_max=aabb_max,
            source_path=self.source_path,
            eye_data_path=self.eye_data_path,
        )


def load_scene(path: str, root_transform: Optional[np.ndarray] = None) -> FlatScene:
    """Load a glTF scene into a FlatScene.

    `root_transform` is the optional 4x4 world transform applied to every root
    node (the reference's loadGlTFscene Matrix4x4 argument; ctypes callers
    never pass one, so identity is the default here — fixing the signature
    mismatch noted in SURVEY.md §7).
    """
    doc = load_gltf(path)
    builder = _Builder(doc, os.path.abspath(path))
    root = np.eye(4) if root_transform is None else np.asarray(root_transform, np.float64)
    for node_idx in doc.default_scene.get("nodes", []):
        builder.process_node(node_idx, root)
    return builder.build()


def build_scene_from_arrays(
    vertices: np.ndarray,
    faces: np.ndarray,
    base_color: Tuple[float, float, float] = (0.8, 0.8, 0.8),
    vertex_colors: Optional[np.ndarray] = None,
    background_shader: str = "default_background",
    name: str = "procedural",
) -> FlatScene:
    """Build a FlatScene directly from a vertex/face soup (tests, benchmarks)."""
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)
    p0, p1, p2 = (vertices[faces[:, i]] for i in range(3))
    n = len(faces)
    has_color = vertex_colors is not None
    if has_color:
        vc = np.asarray(vertex_colors, np.float32)
        if vc.shape[1] == 3:
            vc = np.concatenate([vc, np.ones((len(vc), 1), np.float32)], axis=1)
        c0, c1, c2 = vc[faces[:, 0]], vc[faces[:, 1]], vc[faces[:, 2]]
    else:
        c0 = c1 = c2 = np.zeros((n, 4), np.float32)
    z3 = np.zeros((n, 3), np.float32)
    aabb_min = vertices.min(axis=0) if len(vertices) else np.zeros(3)
    aabb_max = vertices.max(axis=0) if len(vertices) else np.zeros(3)
    return FlatScene(
        v0=p0.astype(np.float32),
        e1=(p1 - p0).astype(np.float32),
        e2=(p2 - p0).astype(np.float32),
        n0=z3, n1=z3.copy(), n2=z3.copy(),
        has_normals=np.zeros(n, bool),
        uv0=np.zeros((n, 2), np.float32),
        uv1=np.tile([0.0, 1.0], (n, 1)).astype(np.float32),
        uv2=np.tile([1.0, 0.0], (n, 1)).astype(np.float32),
        has_uv=np.zeros(n, bool),
        c0=c0, c1=c1, c2=c2,
        has_color=np.full(n, has_color, bool),
        mat_id=np.zeros(n, np.int32),
        mat_base_color=np.array([[base_color[0], base_color[1], base_color[2], 1.0]], np.float32),
        mat_metallic=np.array([0.0], np.float32),
        mat_roughness=np.array([0.5], np.float32),
        mat_tex=np.array([-1], np.int32),
        tex_data=np.zeros((1, 4), np.float32),
        tex_offset=np.zeros(0, np.int32),
        tex_width=np.zeros(0, np.int32),
        tex_height=np.zeros(0, np.int32),
        tex_wrap_s=np.zeros(0, np.int32),
        tex_wrap_t=np.zeros(0, np.int32),
        tex_filter=np.zeros(0, np.int32),
        background_shader=background_shader,
        cameras=[],
        hitboxes=[],
        mesh_records=[MeshRecord(name, aabb_min, aabb_max)],
        aabb_min=aabb_min,
        aabb_max=aabb_max,
        source_path=f"<{name}>",
    )


def subdivide_large_triangles(scene: FlatScene, max_diag: float,
                              max_rounds: int = 4) -> FlatScene:
    """Split triangles whose AABB diagonal exceeds `max_diag` into 4 children
    (edge midpoints), repeatedly.

    Rendering semantics are EXACTLY preserved: positions and all per-corner
    attributes (normals, uvs, colours) interpolate linearly, so barycentric
    shading of the children reproduces the parent.  Used by the accel layer:
    fan-triangulated n-gons (e.g. cylinder caps) otherwise produce triangles
    as large as the whole scene, which no spatial clustering can bound.
    """
    import dataclasses

    arrays = {k: np.asarray(getattr(scene, k)) for k in (
        "v0", "e1", "e2", "n0", "n1", "n2", "has_normals",
        "uv0", "uv1", "uv2", "has_uv", "c0", "c1", "c2", "has_color",
        "mat_id",
    )}

    for _ in range(max_rounds):
        v0, e1, e2 = arrays["v0"], arrays["e1"], arrays["e2"]
        p0, p1, p2 = v0, v0 + e1, v0 + e2
        mins = np.minimum(np.minimum(p0, p1), p2)
        maxs = np.maximum(np.maximum(p0, p1), p2)
        big = np.linalg.norm(maxs - mins, axis=1) > max_diag
        if not big.any():
            break
        keep = {k: v[~big] for k, v in arrays.items()}

        def corners(base):  # (a, b, c) per-corner attribute triples
            return (arrays[base + "0"][big], arrays[base + "1"][big],
                    arrays[base + "2"][big])

        a, b, c = p0[big], p1[big], p2[big]
        mab, mac, mbc = (a + b) / 2, (a + c) / 2, (b + c) / 2
        new_tris = [
            (a, mab, mac), (mab, b, mbc), (mac, mbc, c), (mab, mbc, mac),
        ]
        out = {k: [v] for k, v in keep.items()}
        for (ta, tb, tc) in new_tris:
            out["v0"].append(ta.astype(np.float32))
            out["e1"].append((tb - ta).astype(np.float32))
            out["e2"].append((tc - ta).astype(np.float32))
        for base in ("n", "uv", "c"):
            ca, cb, cc = corners(base)
            m_ab, m_ac, m_bc = (ca + cb) / 2, (ca + cc) / 2, (cb + cc) / 2
            for (qa, qb, qc) in [(ca, m_ab, m_ac), (m_ab, cb, m_bc),
                                 (m_ac, m_bc, cc), (m_ab, m_bc, m_ac)]:
                out[base + "0"].append(qa)
                out[base + "1"].append(qb)
                out[base + "2"].append(qc)
        for flag in ("has_normals", "has_uv", "has_color", "mat_id"):
            for _i in range(4):
                out[flag].append(arrays[flag][big])
        arrays = {k: np.concatenate(v) for k, v in out.items()}

    new_scene = dataclasses.replace(
        scene, **{k: arrays[k] for k in arrays},
    )
    new_scene._device_cache = None
    new_scene._accel_cache = None
    return new_scene
