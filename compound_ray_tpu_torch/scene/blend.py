"""Minimal .blend mesh extractor (Blender 2.8x/2.9x, plain or gzipped).

A copy of compound_ray_tpu/scene/blend.py (struct, gzip and numpy only):
the port carries its own host modules because importing any part of the
JAX package imports JAX.  Two changes: a NULL pointer resolves to no block (the JAX module
resolves it to the ENDB block, whose old pointer is 0, so a mesh with no
UV layer fails there), and Pillow is imported only where a mesh takes an
image texture, so an untextured load needs no Pillow.

The reference ships its benchmark scenes (the ofstad arena, the test scene)
only as .blend files plus a Blender-export workflow (data/blend-files/).
This module reads the geometry straight out of the .blend so those scenes
can be rendered and benchmarked without Blender: it walks the file-block
list, parses the embedded SDNA (the file's own struct catalogue), and pulls
`Object` world matrices + `Mesh` vertex/loop/polygon arrays, fan-
triangulating polygons into the FlatScene soup.  Materials contribute their
diffuse r/g/b as flat base colours.

Scope: geometry + flat material colours/textures AND cameras.  Camera
objects carry the reference's compound-eye markup as Blender custom
properties (ID properties on the Camera datablock: "compound-eye",
"compound-projection", "compound-structure", "panoramic" — the same
key/value strings the glTF exporter writes into camera `extras`, which
MulticamScene.cpp:241-319 consumes), so a .blend loads with the same
camera set its glTF export would have.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class _Block:
    code: str
    sdna: int
    count: int
    data: bytes
    old_ptr: int


class BlendFile:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:2] == b"\x1f\x8b":  # gzip-compressed blend
            import gzip

            raw = gzip.decompress(raw)
        if not raw.startswith(b"BLENDER"):
            raise ValueError("not a .blend file")
        self.ptr_size = 8 if raw[7:8] == b"-" else 4
        self.little = raw[8:9] == b"v"
        if not self.little or self.ptr_size != 8:
            raise NotImplementedError("only 64-bit little-endian .blend files")
        self.blocks: List[_Block] = []
        self.by_ptr: Dict[int, _Block] = {}
        off = 12
        n = len(raw)
        while off + 24 <= n:
            code = raw[off:off + 4].rstrip(b"\0").decode("ascii", "replace")
            size, = struct.unpack_from("<I", raw, off + 4)
            old_ptr, = struct.unpack_from("<Q", raw, off + 8)
            sdna, count = struct.unpack_from("<II", raw, off + 16)
            data = raw[off + 24 : off + 24 + size]
            b = _Block(code, sdna, count, data, old_ptr)
            self.blocks.append(b)
            if old_ptr:  # NULL names no block (ENDB's old pointer is 0)
                self.by_ptr[old_ptr] = b
            off += 24 + size
            if code == "ENDB":
                break
        self._parse_dna()

    # ---- SDNA ------------------------------------------------------------------
    def _parse_dna(self) -> None:
        dna_block = next((b for b in self.blocks if b.code == "DNA1"), None)
        if dna_block is None:  # truncated/corrupt file: no struct catalogue
            raise ValueError("truncated .blend: no DNA1 block")
        dna = dna_block.data
        o = 0
        assert dna[o:o + 4] == b"SDNA"
        o += 4
        assert dna[o:o + 4] == b"NAME"
        o += 4
        n_names, = struct.unpack_from("<I", dna, o)
        o += 4
        names = []
        for _ in range(n_names):
            end = dna.index(b"\0", o)
            names.append(dna[o:end].decode())
            o = end + 1
        o = (o + 3) & ~3
        assert dna[o:o + 4] == b"TYPE"
        o += 4
        n_types, = struct.unpack_from("<I", dna, o)
        o += 4
        types = []
        for _ in range(n_types):
            end = dna.index(b"\0", o)
            types.append(dna[o:end].decode())
            o = end + 1
        o = (o + 3) & ~3
        assert dna[o:o + 4] == b"TLEN"
        o += 4
        tlens = list(struct.unpack_from(f"<{n_types}H", dna, o))
        o += 2 * n_types
        o = (o + 3) & ~3
        assert dna[o:o + 4] == b"STRC"
        o += 4
        n_structs, = struct.unpack_from("<I", dna, o)
        o += 4
        structs = []
        for _ in range(n_structs):
            t, nf = struct.unpack_from("<HH", dna, o)
            o += 4
            fields = []
            for _ in range(nf):
                ft, fn = struct.unpack_from("<HH", dna, o)
                o += 4
                fields.append((ft, fn))
            structs.append((t, fields))
        self.names = names
        self.types = types
        self.tlens = tlens
        self.structs = structs
        self.struct_by_type: Dict[str, int] = {
            types[t]: i for i, (t, _) in enumerate(structs)
        }

    def _field_size(self, type_idx: int, name: str) -> int:
        if name.startswith("*"):
            base = self.ptr_size
        elif name.startswith("("):  # function pointer
            base = self.ptr_size
        else:
            base = self.tlens[type_idx]
        mult = 1
        while "[" in name:
            i = name.index("[")
            j = name.index("]", i)
            mult *= int(name[i + 1 : j])
            name = name[:i] + name[j + 1 :]
        return base * mult

    def layout(self, struct_name: str) -> Dict[str, Tuple[int, str, int]]:
        """field bare-name -> (offset, type_name, byte_size)."""
        idx = self.struct_by_type[struct_name]
        t, fields = self.structs[idx]
        out = {}
        off = 0
        for ft, fn in fields:
            raw_name = self.names[fn]
            size = self._field_size(ft, raw_name)
            bare = raw_name.lstrip("*(").split("[")[0].rstrip(")")
            out[bare] = (off, self.types[ft], size, raw_name)
            off += size
        return out

    # ---- typed readers ---------------------------------------------------------
    def read_ptr(self, data: bytes, off: int) -> int:
        return struct.unpack_from("<Q", data, off)[0]



def _object_name(fb: BlendFile, data: bytes, lay_ob, lay_id) -> str:
    id_off = lay_ob["id"][0]
    name_off, _, name_size, _ = lay_id["name"]
    raw = data[id_off + name_off : id_off + name_off + name_size]
    return raw.split(b"\0", 1)[0][2:].decode("utf-8", "replace")  # strip "OB"


def load_blend_meshes(path: str):
    """Extract (name, world_matrix(4,4), verts(V,3), faces(F,3), color(3),
    face_uvs(F,3,2) or None, image_name or None) per mesh object.
    image_name is the Image datablock referenced by the material's node
    tree (e.g. "ofstad_patterning") — the texture the glTF exporter would
    bake into the material."""
    fb = BlendFile(path)
    lay_ob = fb.layout("Object")
    lay_id = fb.layout("ID")
    lay_me = fb.layout("Mesh")
    lay_mvert = fb.layout("MVert")
    lay_mpoly = fb.layout("MPoly")
    lay_mloop = fb.layout("MLoop")
    lay_mat = fb.layout("Material") if "Material" in fb.struct_by_type else None
    lay_mluv = (fb.layout("MLoopUV")
                if "MLoopUV" in fb.struct_by_type else None)

    mvert_size = fb.tlens[fb.structs[fb.struct_by_type["MVert"]][0]]
    mpoly_size = fb.tlens[fb.structs[fb.struct_by_type["MPoly"]][0]]
    mloop_size = fb.tlens[fb.structs[fb.struct_by_type["MLoop"]][0]]
    mluv_size = (fb.tlens[fb.structs[fb.struct_by_type["MLoopUV"]][0]]
                 if lay_mluv else 0)

    out = []
    for b in fb.blocks:
        if b.code != "OB":
            continue
        ob_type = struct.unpack_from("<h", b.data, lay_ob["type"][0])[0]
        if ob_type != 1:  # OB_MESH
            continue
        name = _object_name(fb, b.data, lay_ob, lay_id)
        m_off = lay_ob["obmat"][0]
        obmat = np.frombuffer(b.data, np.float32, 16, m_off).reshape(4, 4).T
        data_ptr = fb.read_ptr(b.data, lay_ob["data"][0])
        me = fb.by_ptr.get(data_ptr)
        if me is None:
            continue
        md = me.data
        totvert = struct.unpack_from("<i", md, lay_me["totvert"][0])[0]
        totpoly = struct.unpack_from("<i", md, lay_me["totpoly"][0])[0]
        totloop = struct.unpack_from("<i", md, lay_me["totloop"][0])[0]
        if totvert == 0 or totpoly == 0:
            continue
        vb = fb.by_ptr.get(fb.read_ptr(md, lay_me["mvert"][0]))
        pb = fb.by_ptr.get(fb.read_ptr(md, lay_me["mpoly"][0]))
        lb = fb.by_ptr.get(fb.read_ptr(md, lay_me["mloop"][0]))
        if not (vb and pb and lb):
            continue

        def bulk_field(buf, count, stride, off, nbytes, dtype):
            # fixed-stride bulk decode (one numpy pass, not one
            # frombuffer/unpack call per element — interpreter-bound on
            # million-vertex meshes): slice the field bytes out of the
            # (count, stride) row view, then reinterpret
            raw = np.frombuffer(buf, np.uint8, count * stride)
            rows = raw.reshape(count, stride)[:, off:off + nbytes]
            return np.ascontiguousarray(rows).view(dtype)

        co_off = lay_mvert["co"][0]
        verts = bulk_field(vb.data, totvert, mvert_size, co_off, 12,
                           np.float32)
        loop_v_off = lay_mloop["v"][0]
        loops = bulk_field(lb.data, totloop, mloop_size, loop_v_off, 4,
                           np.int32).ravel().astype(np.int64)
        # optional per-loop UVs
        uvs = None
        if lay_mluv and "mloopuv" in lay_me:
            ub = fb.by_ptr.get(fb.read_ptr(md, lay_me["mloopuv"][0]))
            if ub is not None:
                uv_off = lay_mluv["uv"][0]
                uvs = bulk_field(ub.data, totloop, mluv_size, uv_off, 8,
                                 np.float32)
                # Blender UV origin is bottom-left; glTF's is top-left —
                # exporters flip V, and the texture pipeline here follows
                # the glTF convention (image row 0 at v=0)
                uvs = np.stack([uvs[:, 0], 1.0 - uvs[:, 1]], axis=-1)

        ls_off = lay_mpoly["loopstart"][0]
        tl_off = lay_mpoly["totloop"][0]
        lstarts = bulk_field(pb.data, totpoly, mpoly_size, ls_off, 4,
                             np.int32).ravel()
        ltots = bulk_field(pb.data, totpoly, mpoly_size, tl_off, 4,
                           np.int32).ravel()
        if totpoly and ltots.min() >= 3 and np.all(ltots == ltots[0]):
            # uniform polygon size (all-tri / all-quad meshes — the common
            # case): vectorised fan triangulation, SAME face order as the
            # sequential loop (poly-major, fan-corner-minor)
            t = int(ltots[0])
            k = np.arange(1, t - 1)
            ka = lstarts[:, None] + k[None, :]  # (P, t-2)
            i0 = np.broadcast_to(loops[lstarts][:, None], ka.shape)
            faces = np.stack([i0, loops[ka], loops[ka + 1]],
                             axis=-1).reshape(-1, 3)
            if uvs is not None:
                u0 = np.broadcast_to(uvs[lstarts][:, None, :],
                                     ka.shape + (2,))
                face_uvs = np.stack([u0, uvs[ka], uvs[ka + 1]],
                                    axis=2).reshape(-1, 3, 2)
            else:
                face_uvs = None
        else:  # mixed polygon sizes: sequential fan (bulk-decoded fields)
            faces = []
            face_uvs = [] if uvs is not None else None
            for i in range(totpoly):
                lstart = int(lstarts[i])
                ltot = int(ltots[i])
                poly = loops[lstart : lstart + ltot]
                for k in range(1, ltot - 1):  # fan triangulation
                    faces.append((poly[0], poly[k], poly[k + 1]))
                    if face_uvs is not None:
                        face_uvs.append((uvs[lstart], uvs[lstart + k],
                                         uvs[lstart + k + 1]))
            faces = np.array(faces, np.int64)
            face_uvs = (np.asarray(face_uvs, np.float32)
                        if face_uvs is not None else None)
        faces = faces.astype(np.int64)

        # meshes without a material export with the glTF DEFAULT material:
        # baseColorFactor (1,1,1) white — not Blender's 0.8 viewport gray
        # (the ofstad arena's floor/ceiling cube has no material and its
        # reference renders are white)
        color = np.array([1.0, 1.0, 1.0])
        image_name = None
        if lay_mat is not None and "mat" in lay_me:
            matarr = fb.by_ptr.get(fb.read_ptr(md, lay_me["mat"][0]))
            if matarr is not None and len(matarr.data) >= 8:
                mat_block = fb.by_ptr.get(fb.read_ptr(matarr.data, 0))
                if mat_block is not None and "r" in lay_mat:
                    r = struct.unpack_from("<f", mat_block.data, lay_mat["r"][0])[0]
                    g = struct.unpack_from("<f", mat_block.data, lay_mat["g"][0])[0]
                    bl = struct.unpack_from("<f", mat_block.data, lay_mat["b"][0])[0]
                    color = np.array([r, g, bl])
                    node_c = _node_base_color(fb, mat_block, lay_mat)
                    if node_c is not None:
                        color = node_c
                    image_name = _node_image_name(fb, mat_block, lay_mat)
        out.append((name, obmat, verts, faces, color, face_uvs, image_name))
    return out


def _walk_nodes(fb: BlendFile, mat_block, lay_mat):
    if ("use_nodes" not in lay_mat or "nodetree" not in lay_mat
            or not mat_block.data[lay_mat["use_nodes"][0]]):
        return
    tree = fb.by_ptr.get(fb.read_ptr(mat_block.data, lay_mat["nodetree"][0]))
    if tree is None or "bNode" not in fb.struct_by_type:
        return
    lay_tree = fb.layout("bNodeTree")
    lay_node = fb.layout("bNode")
    node_ptr = fb.read_ptr(tree.data, lay_tree["nodes"][0])
    while node_ptr:
        node = fb.by_ptr.get(node_ptr)
        if node is None:
            return
        idname = node.data[
            lay_node["idname"][0]:lay_node["idname"][0] + 64
        ].split(b"\0", 1)[0]
        yield idname, node, lay_node
        node_ptr = fb.read_ptr(node.data, lay_node["next"][0])


def _node_image_name(fb: BlendFile, mat_block, lay_mat):
    """Name of the Image datablock the material's TexImage node uses
    (without Blender's 'IM' id prefix), or None."""
    try:
        for idname, node, lay_node in _walk_nodes(fb, mat_block, lay_mat):
            if idname != b"ShaderNodeTexImage" or "id" not in lay_node:
                continue
            img = fb.by_ptr.get(fb.read_ptr(node.data, lay_node["id"][0]))
            if img is None:
                return None
            lay_img = fb.layout("Image")
            lay_idd = fb.layout("ID")
            off = lay_img["id"][0] + lay_idd["name"][0]
            raw = img.data[off:off + 66].split(b"\0", 1)[0]
            return raw[2:].decode("utf-8", "replace")
    except Exception:
        return None
    return None


def _node_base_color(fb: BlendFile, mat_block, lay_mat):
    """Principled-BSDF base colour from the material's node tree.

    Blender >= 2.8 materials are node-based: the legacy Material.r/g/b
    fields keep their untouched 0.8-gray default while the colour the
    glTF exporter writes as baseColorFactor lives in the Principled node's
    "Base Color" input socket (bNodeSocketValueRGBA).  Walks
    Material.nodetree -> nodes listbase -> inputs listbase; returns None
    when anything along the chain is absent."""
    try:
        for idname, node, lay_node in _walk_nodes(fb, mat_block, lay_mat):
            if idname != b"ShaderNodeBsdfPrincipled":
                continue
            lay_sock = fb.layout("bNodeSocket")
            sock_ptr = fb.read_ptr(node.data, lay_node["inputs"][0])
            while sock_ptr:
                sock = fb.by_ptr.get(sock_ptr)
                if sock is None:
                    return None
                sname = sock.data[
                    lay_sock["name"][0]:lay_sock["name"][0] + 64
                ].split(b"\0", 1)[0]
                if sname == b"Base Color":
                    val = fb.by_ptr.get(fb.read_ptr(
                        sock.data, lay_sock["default_value"][0]
                    ))
                    if val is None or len(val.data) < 12:
                        return None
                    return np.frombuffer(val.data, np.float32, 3)
                sock_ptr = fb.read_ptr(sock.data, lay_sock["next"][0])
            return None
    except Exception:
        return None
    return None


# ---- cameras -----------------------------------------------------------

# IDProperty.type values (Blender DNA_ID.h)
_IDP_STRING, _IDP_INT, _IDP_FLOAT, _IDP_GROUP, _IDP_DOUBLE = 0, 1, 2, 6, 8


def _id_properties(fb: BlendFile, data: bytes, id_off: int,
                   lay_id) -> Dict[str, object]:
    """Flat dict of an ID datablock's custom properties (the root
    IDP_GROUP's direct children; `_RNA_UI` metadata skipped).  These are
    exactly the key/value pairs the glTF exporter emits as `extras`."""
    out: Dict[str, object] = {}
    if "properties" not in lay_id or "IDProperty" not in fb.struct_by_type:
        return out
    root_ptr = fb.read_ptr(data, id_off + lay_id["properties"][0])
    # NULL must not hit by_ptr: the ENDB sentinel block has old_ptr == 0
    root = fb.by_ptr.get(root_ptr) if root_ptr else None
    if root is None:
        return out
    lay_idp = fb.layout("IDProperty")
    lay_idpd = fb.layout("IDPropertyData")
    d_off = lay_idp["data"][0]
    ptr = fb.read_ptr(root.data, d_off + lay_idpd["group"][0])  # ListBase.first
    while ptr:
        blk = fb.by_ptr.get(ptr)
        if blk is None:
            break
        d = blk.data
        t = d[lay_idp["type"][0]]
        name = d[lay_idp["name"][0]:lay_idp["name"][0] + 64].split(
            b"\0", 1)[0].decode("utf-8", "replace")
        if name != "_RNA_UI":
            if t == _IDP_STRING:
                sb = fb.by_ptr.get(fb.read_ptr(d, d_off + lay_idpd["pointer"][0]))
                ln = struct.unpack_from("<i", d, lay_idp["len"][0])[0]
                if sb is not None:
                    out[name] = sb.data[:max(0, ln - 1)].decode(
                        "utf-8", "replace")
            elif t == _IDP_INT:
                out[name] = struct.unpack_from(
                    "<i", d, d_off + lay_idpd["val"][0])[0]
            elif t == _IDP_FLOAT:
                out[name] = struct.unpack_from(
                    "<f", d, d_off + lay_idpd["val"][0])[0]
            elif t == _IDP_DOUBLE:
                out[name] = struct.unpack_from(
                    "<d", d, d_off + lay_idpd["val"][0])[0]
        ptr = fb.read_ptr(d, lay_idp["next"][0])
    return out


def _render_aspect(fb: BlendFile) -> float:
    """Render aspect ratio (xsch*xasp)/(ysch*yasp) from the first Scene
    block — the aspect the glTF exporter bakes into camera yfov."""
    try:
        lay_sc = fb.layout("Scene")
        lay_rd = fb.layout("RenderData")
        for b in fb.blocks:
            if b.code != "SC":
                continue
            r = lay_sc["r"][0]
            xsch, = struct.unpack_from("<i", b.data, r + lay_rd["xsch"][0])
            ysch, = struct.unpack_from("<i", b.data, r + lay_rd["ysch"][0])
            xasp, = struct.unpack_from("<f", b.data, r + lay_rd["xasp"][0])
            yasp, = struct.unpack_from("<f", b.data, r + lay_rd["yasp"][0])
            if xsch > 0 and ysch > 0 and xasp > 0 and yasp > 0:
                return (xsch * xasp) / (ysch * yasp)
    except Exception:
        pass
    return 16.0 / 9.0


def load_blend_cameras(path: str) -> List[dict]:
    """Extract camera objects: name, world matrix, lens parameters, and the
    custom-property `extras` dict (compound-eye markup lives on the Camera
    DATABLOCK, not the object — matching where Blender's UI adds custom
    properties in the reference's authoring workflow)."""
    fb = BlendFile(path)
    lay_ob = fb.layout("Object")
    lay_id = fb.layout("ID")
    lay_ca = fb.layout("Camera")
    aspect = _render_aspect(fb)
    out = []
    for b in fb.blocks:
        if b.code != "OB":
            continue
        ob_type = struct.unpack_from("<h", b.data, lay_ob["type"][0])[0]
        if ob_type != 11:  # OB_CAMERA
            continue
        name = _object_name(fb, b.data, lay_ob, lay_id)
        obmat = np.frombuffer(
            b.data, np.float32, 16, lay_ob["obmat"][0]).reshape(4, 4).T
        ca = fb.by_ptr.get(fb.read_ptr(b.data, lay_ob["data"][0]))
        if ca is None:
            continue
        ca_id_off = lay_ca["id"][0] if "id" in lay_ca else 0
        extras = _id_properties(fb, ca.data, ca_id_off, lay_id)
        # object-level custom properties override datablock ones if present
        extras.update(_id_properties(fb, b.data, lay_ob["id"][0], lay_id))

        def _f(key, default=0.0):
            if key in lay_ca:
                return struct.unpack_from("<f", ca.data, lay_ca[key][0])[0]
            return default

        cam = {
            "name": name,
            "obmat": obmat,
            "extras": extras,
            "aspect": aspect,
            "lens": _f("lens", 50.0),
            "sensor_x": _f("sensor_x", 36.0),
            "sensor_y": _f("sensor_y", 24.0),
            "ortho_scale": _f("ortho_scale", 6.0),
            "type": ca.data[lay_ca["type"][0]] if "type" in lay_ca else 0,
            "sensor_fit": (ca.data[lay_ca["sensor_fit"][0]]
                           if "sensor_fit" in lay_ca else 0),
        }
        out.append(cam)
    return out


def _resolve_blend_eye_path(eye_path: str, blend_dir: str):
    """resolve_eye_path semantics (absolute/cwd, then the .blend's dir),
    plus the export-layout fallbacks a .blend needs: the reference keeps
    .eye files in a sibling `eyes/` directory of `blend-files/`, and some
    blends carry authoring-machine absolute paths — fall back to the
    basename under ../ and ../eyes/."""
    import os

    from compound_ray_tpu_torch.scene.eye_io import resolve_eye_path

    found = resolve_eye_path(eye_path, blend_dir)
    if found is not None:
        return found
    base = os.path.basename(eye_path.replace("\\", "/"))
    for cand in (
        os.path.join(blend_dir, "..", eye_path),
        os.path.join(blend_dir, "..", "eyes", base),
        os.path.join(blend_dir, "eyes", base),
    ):
        if os.path.isfile(cand):
            return os.path.normpath(cand)
    return None


def _build_blend_cameras(scene, path: str, y_up: bool) -> None:
    """Append Camera objects for the .blend's camera objects, mirroring the
    glTF loader's extras handling (scene/flat.py _process_camera)."""
    import os

    blend_dir = os.path.dirname(os.path.abspath(path))
    for cd in load_blend_cameras(path):
        try:
            _append_blend_camera(scene, cd, blend_dir, y_up)
        except Exception as e:
            # one camera's bad markup / unreadable .eye must not sink the
            # others — mirror MulticamScene.cpp:310-319 (log + skip)
            print(f"[PyEye] skipping .blend camera "
                  f"{cd.get('name', '?')!r}: {e!r}")


def _append_blend_camera(scene, cd, blend_dir: str, y_up: bool) -> None:
    import os

    from compound_ray_tpu_torch.cameras.types import (
        CompoundEyeCamera,
        OrthographicCamera,
        PanoramicCamera,
        PerspectiveCamera,
    )
    from compound_ray_tpu_torch.scene.eye_io import read_eye_file
    from compound_ray_tpu_torch.scene.gltf import extra_is_true

    m = cd["obmat"].astype(np.float64)
    right, up, back, eye = m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3]
    forward = -back
    if y_up:  # Blender Z-up -> glTF Y-up: (x, y, z) -> (x, z, -y)
        def cvt(v):
            return np.array([v[0], v[2], -v[1]])
        right, up, forward, eye = cvt(right), cvt(up), cvt(forward), cvt(eye)
    extras = cd["extras"]
    if cd["type"] == 1:  # CAM_ORTHO
        # the 2.8-era exporter the reference data was produced with
        # writes xmag = ymag = ortho_scale verbatim (test-scene.gltf
        # ortho-camera: 16.0143 both axes for ortho_scale 16.0143);
        # mirror that so .blend loads match the shipped exports
        c = OrthographicCamera(cd["name"])
        c.set_xy_scale(cd["ortho_scale"], cd["ortho_scale"])
    elif extra_is_true(extras, "panoramic"):
        c = PanoramicCamera(cd["name"])
    elif extra_is_true(extras, "compound-eye"):
        eye_path = str(extras.get("compound-structure", ""))
        projection = str(extras.get("compound-projection", ""))
        if not eye_path or not projection:
            return  # matches MulticamScene.cpp:310-319 (log + skip)
        resolved = _resolve_blend_eye_path(eye_path, blend_dir)
        if resolved is None:
            scene.eye_data_path = os.path.join(blend_dir, eye_path)
            return
        omms = read_eye_file(resolved)
        if not omms:
            return
        scene.eye_data_path = resolved
        c = CompoundEyeCamera(cd["name"], projection, omms,
                              eye_data_path=resolved)
    else:
        # glTF exporter yfov.  Which sensor dimension governs the vertical
        # axis follows Blender's BKE_camera_sensor_size: VERTICAL fit ->
        # sensor_y; AUTO fits sensor_x to the LARGER render dimension, so
        # portrait AUTO puts sensor_x on the vertical axis; otherwise
        # (HORIZONTAL, landscape AUTO) sensor_x is horizontal and the
        # render aspect bakes in (yfov = 2*atan(sensor_x/(2*lens*aspect))).
        c = PerspectiveCamera(cd["name"])
        if cd["sensor_fit"] == 2:  # VERTICAL
            yfov = 2.0 * np.arctan(cd["sensor_y"] / (2.0 * cd["lens"]))
        elif cd["sensor_fit"] == 0 and cd["aspect"] < 1.0:  # AUTO portrait
            yfov = 2.0 * np.arctan(cd["sensor_x"] / (2.0 * cd["lens"]))
        else:
            yfov = 2.0 * np.arctan(
                cd["sensor_x"] / (2.0 * cd["lens"] * cd["aspect"]))
        c.set_y_fov(float(np.degrees(yfov)))
    c.set_position(eye)
    c.set_local_space(right, up, forward)
    scene.cameras.append(c)


def load_blend_scene(path: str, background: str = "simple_sky",
                     y_up: bool = True,
                     textures: Optional[Dict[str, str]] = None,
                     cameras: bool = True):
    """FlatScene from a .blend (geometry + material colours + cameras).

    `y_up` applies the glTF exporter's axis conversion (Blender Z-up ->
    Y-up: (x, y, z) -> (x, z, -y)) so .blend extractions line up with the
    reference's exported scenes.  `textures` maps mesh names OR material
    image-datablock names (e.g. "ofstad_patterning") to image paths;
    meshes with extracted UVs get that image as their base-colour texture
    (e.g. the ofstad arena's patterning jpg).
    """
    from compound_ray_tpu_torch.scene.flat import build_scene_from_arrays

    meshes = load_blend_meshes(path)
    if not meshes:
        raise ValueError(f"no mesh objects found in {path}")
    all_v, all_f, all_c = [], [], []
    off = 0
    for name, obmat, verts, faces, color, _uvs, _img in meshes:
        world = verts @ obmat[:3, :3].T + obmat[:3, 3]
        if y_up:
            world = np.stack(
                [world[:, 0], world[:, 2], -world[:, 1]], axis=1
            )
        all_v.append(world)
        all_f.append(faces + off)
        all_c.append(np.tile(np.append(color, 1.0).astype(np.float32),
                             (len(world), 1)))
        off += len(world)
    scene = build_scene_from_arrays(
        np.concatenate(all_v), np.concatenate(all_f),
        vertex_colors=np.concatenate(all_c),
        background_shader=background,
        name=path.split("/")[-1],
    )
    scene.source_path = path

    # ALWAYS route colours through per-mesh materials (raw, like a glTF
    # export's baseColorFactor): the vertex-colour fallback built above is
    # linear data that trace/shade.py would pow-2.2 a SECOND time,
    # double-darkening every untextured load (0.8 gray -> 0.8^2.2 = 0.61).
    # _apply_textures zeroes has_color and builds mat_base_color whether
    # or not any texture is supplied.
    _apply_textures(scene, meshes, textures or {})
    if cameras:
        try:
            _build_blend_cameras(scene, path, y_up)
        except Exception as e:  # camera markup must not sink the geometry
            print(f"[PyEye] .blend camera extraction failed: {e!r}")
    return scene


def _apply_textures(scene, meshes, textures: Dict[str, str]) -> None:
    """Attach per-mesh base-colour textures using the extracted loop UVs."""
    tri_uv0, tri_uv1, tri_uv2, tri_mat = [], [], [], []
    datas, offs, ws, hs = [], [], [], []
    mats_rgb = []
    mat_tex = []
    texel_off = 0
    for name, _m, _v, faces, color, uvs, img_name in meshes:
        n = len(faces)
        mat_idx = len(mats_rgb)
        mats_rgb.append(np.append(color, 1.0))
        tex_key = name if name in textures else img_name
        if tex_key in textures and uvs is not None:
            from PIL import Image

            img = np.asarray(
                Image.open(textures[tex_key]).convert("RGBA"), np.uint8
            ).astype(np.float32) / 255.0
            # sRGB -> linear, same contract as FlatScene._build_textures
            img[..., :3] = np.power(img[..., :3], 2.2)
            h, w = img.shape[:2]
            datas.append(img.reshape(-1, 4))
            offs.append(texel_off)
            ws.append(w)
            hs.append(h)
            texel_off += h * w
            mat_tex.append(len(offs) - 1)
            tri_uv0.append(uvs[:, 0])
            tri_uv1.append(uvs[:, 1])
            tri_uv2.append(uvs[:, 2])
        else:
            mat_tex.append(-1)
            z = np.zeros((n, 2), np.float32)
            tri_uv0.append(z)
            tri_uv1.append(z)
            tri_uv2.append(z)
        tri_mat.append(np.full(n, mat_idx, np.int32))

    scene.uv0 = np.concatenate(tri_uv0)
    scene.uv1 = np.concatenate(tri_uv1)
    scene.uv2 = np.concatenate(tri_uv2)
    scene.has_uv = np.ones(scene.num_triangles, bool)
    scene.mat_id = np.concatenate(tri_mat)
    scene.mat_base_color = np.stack(mats_rgb).astype(np.float32)
    scene.mat_metallic = np.zeros(len(mats_rgb), np.float32)
    scene.mat_roughness = np.full(len(mats_rgb), 0.5, np.float32)
    scene.mat_tex = np.asarray(mat_tex, np.int32)
    # .blend extraction carries no MR / normal-map textures
    scene.mat_mr_tex = np.full(len(mats_rgb), -1, np.int32)
    scene.mat_normal_tex = np.full(len(mats_rgb), -1, np.int32)
    # with per-mesh materials in place, untextured meshes take their colour
    # from the MATERIAL (raw, like a glTF export's baseColorFactor —
    # Blender stores material colours linear already), not from the baked
    # vertex colours (which the shading path would pow-2.2 a second time).
    # This also selects the flat 10-column attr layout instead of the full
    # 24-column corner-interpolation one (trace/pallas_tracer.py).
    scene.has_color = np.zeros_like(scene.has_color)
    if datas:
        scene.tex_data = np.concatenate(datas)
        scene.tex_offset = np.asarray(offs, np.int32)
        scene.tex_width = np.asarray(ws, np.int32)
        scene.tex_height = np.asarray(hs, np.int32)
        scene.tex_wrap_s = np.zeros(len(offs), np.int32)
        scene.tex_wrap_t = np.zeros(len(offs), np.int32)
        scene.tex_filter = np.ones(len(offs), np.int32)
    scene._device_cache = None
    scene._accel_cache = None
