"""Port vs JAX: the rest of the numpy host layer.

- scene/flat.py subdivide_large_triangles: the JAX accel test
  (tests/test_accel.py::test_subdivide_large_triangles_preserves_shading)
  on the port's oracle (trace/intersect.py, trace/shade.py), and the
  port's subdivided scene equal to the JAX one, array for array.
- scene/gltf.py and scene/flat.py: the 8 cases of
  tests/test_gltf_robustness.py that need no reference file, each loaded
  by both packages, whose scenes must be equal (exact: the same numpy
  code reads the same bytes).
- The RNG conformance cases of tests/test_statistics.py on the port's
  EyeRenderer(device="cpu") and its per-frame torch.Generator, with the
  JAX test's thresholds.
"""

import base64
import json
import struct

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from compound_ray_tpu import testing as jtesting  # noqa: E402
from compound_ray_tpu.scene import flat as JF  # noqa: E402
from compound_ray_tpu.scene import gltf as JG  # noqa: E402
from compound_ray_tpu_torch import EyeRenderer  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera  # noqa: E402
from compound_ray_tpu_torch.scene import flat as TF  # noqa: E402
from compound_ray_tpu_torch.scene import gltf as TG  # noqa: E402
from compound_ray_tpu_torch.trace.intersect import intersect_rays  # noqa: E402
from compound_ray_tpu_torch.trace.shade import shade_rays  # noqa: E402

SUB_FIELDS = ("v0", "e1", "e2", "n0", "n1", "n2", "has_normals", "uv0",
              "uv1", "uv2", "has_uv", "c0", "c1", "c2", "has_color",
              "mat_id")
SCENE_FIELDS = SUB_FIELDS + (
    "mat_base_color", "mat_metallic", "mat_roughness", "mat_tex",
    "mat_mr_tex", "mat_normal_tex", "tex_data", "tex_offset", "tex_width",
    "tex_height", "tex_wrap_s", "tex_wrap_t", "tex_filter", "aabb_min",
    "aabb_max")


def _assert_equal(got, want, fields):
    for k in fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)


# -- subdivide_large_triangles


def test_subdivide_large_triangles_preserves_shading():
    """Subdivision is render-exact: same hits, same interpolated
    attributes (barycentric interpolation is affine); the JAX test's rays
    and tolerances on the port's oracle."""
    scene = ttesting.make_box_scene()
    sub = TF.subdivide_large_triangles(scene, 3.0)
    assert sub.num_triangles > scene.num_triangles
    d1, d2 = scene.device_triangles("cpu"), sub.device_triangles("cpu")
    rng = np.random.default_rng(0)
    o = torch.tensor(rng.uniform(-8, 8, (64, 3)), dtype=torch.float32)
    dr = torch.tensor(rng.normal(size=(64, 3)), dtype=torch.float32)
    h1 = intersect_rays(o, dr, d1["v0"], d1["e1"], d1["e2"], 0.0, 1e16)
    h2 = intersect_rays(o, dr, d2["v0"], d2["e1"], d2["e2"], 0.0, 1e16)
    np.testing.assert_array_equal(h1["hit"].numpy(), h2["hit"].numpy())
    assert h1["hit"].any()
    hit = h1["hit"].numpy()
    np.testing.assert_allclose(h1["t"].numpy()[hit], h2["t"].numpy()[hit],
                               rtol=1e-4)
    r1 = shade_rays(d1, dr, h1, background=2).numpy()
    r2 = shade_rays(d2, dr, h2, background=2).numpy()
    np.testing.assert_allclose(r1, r2, atol=1e-5)


@pytest.mark.parametrize("max_diag,rounds", [(3.0, 4), (1.0, 2), (50.0, 4)])
def test_subdivide_large_triangles_matches_jax(max_diag, rounds):
    """The port's subdivided scene equals the JAX one, array for array."""
    got = TF.subdivide_large_triangles(ttesting.make_box_scene(), max_diag,
                                       max_rounds=rounds)
    want = JF.subdivide_large_triangles(jtesting.make_box_scene(), max_diag,
                                        max_rounds=rounds)
    assert got.num_triangles == want.num_triangles
    _assert_equal(got, want, SCENE_FIELDS)
    assert got._device_cache is None and got._accel_cache is None


# -- tests/test_gltf_robustness.py on both loaders


def _tri_gltf_json(buffer_uri=None, byte_stride=None):
    """Single-triangle glTF with optional strided positions (the JAX
    test's fixture)."""
    if byte_stride:
        pad = byte_stride - 12
        raw = b"".join(
            struct.pack("<fff", *v) + b"\0" * pad
            for v in [(0, 0, 0), (1, 0, 0), (0, 1, 0)]
        )
    else:
        raw = struct.pack("<9f", 0, 0, 0, 1, 0, 0, 0, 1, 0)
    idx = struct.pack("<3H", 0, 1, 2)
    blob = raw + idx
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "name": "tri"}],
        "meshes": [{"name": "tri", "primitives": [{
            "attributes": {"POSITION": 0}, "indices": 1}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3", "min": [0, 0, 0], "max": [1, 1, 0]},
            {"bufferView": 1, "componentType": 5123, "count": 3,
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(raw),
             **({"byteStride": byte_stride} if byte_stride else {})},
            {"buffer": 0, "byteOffset": len(raw), "byteLength": len(idx)},
        ],
        "buffers": [{"byteLength": len(blob),
                     **({"uri": buffer_uri} if buffer_uri else {})}],
    }
    return doc, blob


def _data_uri(blob: bytes) -> str:
    return ("data:application/octet-stream;base64,"
            + base64.b64encode(blob).decode())


def _png_data_uri(rgba_2x2):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.asarray(rgba_2x2, np.uint8), "RGBA").save(buf, "PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _both(path):
    """(port scene, JAX scene) of one file, which must be equal."""
    got, want = TF.load_scene(path), JF.load_scene(path)
    _assert_equal(got, want, SCENE_FIELDS)
    assert got.num_triangles == want.num_triangles
    return got


def _write_gltf(tmp_path, doc):
    p = tmp_path / "t.gltf"
    p.write_text(json.dumps(doc))
    return str(p)


def test_data_uri_buffer(tmp_path):
    doc, blob = _tri_gltf_json()
    doc["buffers"][0]["uri"] = _data_uri(blob)
    scene = _both(_write_gltf(tmp_path, doc))
    assert scene.num_triangles == 1
    np.testing.assert_allclose(scene.v0[0], [0, 0, 0])


def test_external_bin_buffer(tmp_path):
    doc, blob = _tri_gltf_json(buffer_uri="t.bin")
    (tmp_path / "t.bin").write_bytes(blob)
    assert _both(_write_gltf(tmp_path, doc)).num_triangles == 1


def test_glb_container(tmp_path):
    doc, blob = _tri_gltf_json()  # bufferless uri -> GLB BIN chunk
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    bin_chunk = blob + b"\0" * ((-len(blob)) % 4)
    glb = (
        struct.pack("<III", 0x46546C67, 2,
                    12 + 8 + len(js) + 8 + len(bin_chunk))
        + struct.pack("<II", len(js), 0x4E4F534A) + js
        + struct.pack("<II", len(bin_chunk), 0x004E4942) + bin_chunk
    )
    p = tmp_path / "t.glb"
    p.write_bytes(glb)
    scene = _both(str(p))
    assert scene.num_triangles == 1
    np.testing.assert_allclose(scene.e1[0], [1, 0, 0])


def test_strided_positions(tmp_path):
    doc, blob = _tri_gltf_json(byte_stride=16)
    doc["buffers"][0]["uri"] = _data_uri(blob)
    scene = _both(_write_gltf(tmp_path, doc))
    assert scene.num_triangles == 1
    np.testing.assert_allclose(scene.e2[0], [0, 1, 0])


def test_normalized_ubyte_colors(tmp_path):
    doc, blob = _tri_gltf_json()
    colors = struct.pack("<12B", 255, 0, 0, 255, 0, 255, 0, 255, 0, 0, 255,
                         255)
    full = blob + colors
    doc["bufferViews"].append(
        {"buffer": 0, "byteOffset": len(blob), "byteLength": len(colors)})
    doc["accessors"].append(
        {"bufferView": 2, "componentType": 5121, "count": 3, "type": "VEC4",
         "normalized": True})
    doc["meshes"][0]["primitives"][0]["attributes"]["COLOR_0"] = 2
    doc["buffers"][0]["byteLength"] = len(full)
    doc["buffers"][0]["uri"] = _data_uri(full)
    scene = _both(_write_gltf(tmp_path, doc))
    assert scene.has_color.all()
    np.testing.assert_allclose(scene.c0[0], [1, 0, 0, 1])
    np.testing.assert_allclose(scene.c1[0], [0, 1, 0, 1])


def test_missing_file_raises():
    for load in (TG.load_gltf, JG.load_gltf):
        with pytest.raises(FileNotFoundError):
            load("/nonexistent/path.gltf")


def test_mr_and_normal_texture_slots(tmp_path):
    """metallicRoughnessTexture / normalTexture load into mat_mr_tex /
    mat_normal_tex, and skip the sRGB linearisation of base colours."""
    doc, blob = _tri_gltf_json()
    doc["buffers"][0]["uri"] = _data_uri(blob)
    half = np.full((2, 2, 4), [128, 128, 128, 255], np.uint8)
    doc["images"] = [{"uri": _png_data_uri(half)} for _ in range(3)]
    doc["textures"] = [{"source": i} for i in range(3)]
    doc["materials"] = [{
        "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "metallicRoughnessTexture": {"index": 1},
            "metallicFactor": 0.9,
            "roughnessFactor": 0.4,
        },
        "normalTexture": {"index": 2},
    }]
    doc["meshes"][0]["primitives"][0]["material"] = 0
    scene = _both(_write_gltf(tmp_path, doc))
    np.testing.assert_array_equal(scene.mat_tex, [0])
    np.testing.assert_array_equal(scene.mat_mr_tex, [1])
    np.testing.assert_array_equal(scene.mat_normal_tex, [2])
    t0, t1, t2 = (scene.tex_data[scene.tex_offset[i]] for i in range(3))
    np.testing.assert_allclose(t0[:3], (128 / 255) ** 2.2, atol=1e-4)
    np.testing.assert_allclose(t1[:3], 128 / 255, atol=1e-4)
    np.testing.assert_allclose(t2[:3], 128 / 255, atol=1e-4)
    dev = scene.device_triangles("cpu")
    assert "mat_mr_tex" in dev and "mat_normal_tex" in dev


def test_sparse_position_accessor(tmp_path):
    """A sparse POSITION accessor substitutes vertex 2 (glTF 2.0
    3.6.2.4)."""
    doc, blob = _tri_gltf_json()
    ids = struct.pack("<H", 2)
    vals = struct.pack("<fff", 0.0, 2.0, 0.0)
    off = len(blob)
    blob = blob + ids + b"\0\0" + vals  # 2B pad aligns values to 4
    doc["bufferViews"] += [
        {"buffer": 0, "byteOffset": off, "byteLength": 2},
        {"buffer": 0, "byteOffset": off + 4, "byteLength": 12},
    ]
    doc["accessors"][0]["sparse"] = {
        "count": 1,
        "indices": {"bufferView": 2, "componentType": 5123},
        "values": {"bufferView": 3},
    }
    doc["buffers"][0]["byteLength"] = len(blob)
    doc["buffers"][0]["uri"] = _data_uri(blob)
    scene = _both(_write_gltf(tmp_path, doc))
    assert scene.num_triangles == 1
    np.testing.assert_allclose(scene.v0[0] + scene.e2[0], [0, 2, 0])
    np.testing.assert_allclose(scene.v0[0], [0, 0, 0])
    np.testing.assert_allclose(scene.v0[0] + scene.e1[0], [1, 0, 0])


# -- tests/test_statistics.py on the port's per-frame generator


@pytest.fixture(scope="module")
def renderer():
    r = EyeRenderer(verbose=False, device="cpu")
    r.scene = ttesting.make_box_scene(background="simple_sky")
    cam = CompoundEyeCamera(
        "eye", "single_dimension_fast",
        ttesting.make_sphere_eye(24, acceptance_deg=25.0))
    r.scene.cameras.append(cam)
    cam.set_position((2.0, 1.5, 0.0))  # near the cube: edges in view
    return r


def _sd_at(renderer, samples, repeat=24):
    renderer.set_current_eye_samples_per_ommatidium(samples)
    stack = []
    for _ in range(repeat):
        renderer.render_frame()
        stack.append(renderer.get_camera_data().copy())
    return np.stack(stack).std(axis=0).mean()


def test_variance_falls_as_inverse_sqrt_n(renderer):
    sd1 = _sd_at(renderer, 1)
    sd4 = _sd_at(renderer, 4)
    sd16 = _sd_at(renderer, 16)
    assert sd1 > 0.01  # real sampling noise present
    # ratios ~2x per 4x samples, generous tolerance for 24-repeat estimates
    assert 1.3 < sd1 / sd4 < 3.2, (sd1, sd4)
    assert 1.3 < sd4 / sd16 < 3.2, (sd4, sd16)


def test_mean_is_stable_across_frames(renderer):
    """Two 64-sample renders agree far better than two 1-sample ones."""
    renderer.set_current_eye_samples_per_ommatidium(64)
    renderer.render_frame()
    a = renderer.get_camera_data().copy()
    renderer.render_frame()
    b = renderer.get_camera_data().copy()
    assert np.abs(a - b).mean() < 0.05


def test_frames_decorrelate(renderer):
    renderer.set_current_eye_samples_per_ommatidium(1)
    renderer.render_frame()
    a = renderer.get_camera_data().copy()
    renderer.render_frame()
    b = renderer.get_camera_data().copy()
    assert not np.array_equal(a, b)
