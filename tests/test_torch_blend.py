"""Port vs JAX: .blend loading (scene/blend.py) on files the tests write.

The repo holds no .blend file, so compound_ray_tpu_torch.testing.write_blend
writes them: the inverse of the loader, from mesh tuples and camera dicts
as load_blend_meshes and load_blend_cameras return them.  Both packages'
loaders read the same bytes (plain and gzipped) to equal meshes, cameras
and scenes (exact: both are the same numpy code), and the port's loader
gives back what was written (f32 rounding where the file stores f32).
The JAX tests of tests/test_blend_cameras.py that need no reference file
are mirrored on the port; those that read the reference's files are
mirrored on written ones (truncated, gzipped, untextured colours).
"""

import dataclasses
import gzip
import os

import numpy as np
import pytest

pytest.importorskip("jax")

from compound_ray_tpu import config as jcfg  # noqa: E402
from compound_ray_tpu.api.renderer import EyeRenderer as JaxRenderer  # noqa: E402
from compound_ray_tpu.scene import blend as JB  # noqa: E402
from compound_ray_tpu_torch import EyeRenderer  # noqa: E402
from compound_ray_tpu_torch import config as tcfg  # noqa: E402
from compound_ray_tpu_torch import load_eye_renderer  # noqa: E402
from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.scene import blend as TB  # noqa: E402
from compound_ray_tpu_torch.scene.eye_io import write_eye_file  # noqa: E402

ATOL = 2e-4  # frame means, port vs JAX (tests/test_torch_frame.py)
F32 = 1e-6  # what the file stores in f32, relative to values of order 1-10
SCENE_FIELDS = ("v0", "e1", "e2", "n0", "n1", "n2", "has_normals", "uv0",
                "uv1", "uv2", "has_uv", "c0", "c1", "c2", "has_color",
                "mat_id", "mat_base_color", "mat_metallic", "mat_roughness",
                "mat_tex", "mat_mr_tex", "mat_normal_tex", "tex_data",
                "tex_offset", "tex_width", "tex_height", "tex_wrap_s",
                "tex_wrap_t", "tex_filter", "aabb_min", "aabb_max")


def _f32(x):
    return float(np.float32(x))


def _obmat(rng, scale=1.0):
    """A rotation about a random axis, a scale and a translation."""
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
    m = np.eye(4)
    m[:3, :3] = rot * scale
    m[:3, 3] = rng.uniform(-3, 3, 3)
    return m.astype(np.float32)


def _meshes(seed=0, with_uvs=True):
    """Four mesh objects from `seed`: a box of quads under a rotated,
    scaled object matrix with an image texture; a fan of a triangle, a quad
    and a pentagon (mixed polygon sizes) sharing that image; a box with no
    material (the loader reads white); and a box of triangles with a plain
    colour.  UVs on every mesh when with_uvs (the JAX loader needs a UV
    layer, see test_null_pointers_name_no_block)."""
    rng = np.random.default_rng(seed)
    v, tri = ttesting.box_mesh((0, 0, 0), rng.uniform(0.5, 2.0, 3))
    quads = np.array(ttesting._BOX_QUADS)
    mixed_v = rng.uniform(-1, 1, (8, 3))
    mixed = [[0, 1, 2], [0, 2, 3, 4], [3, 4, 5, 6, 7]]

    def uv(n):
        return rng.uniform(0, 1, (n, 2)) if with_uvs else None

    def per_poly(polys):
        return None if not with_uvs else [uv(len(p)) for p in polys]

    return [
        ("Arena", _obmat(rng, 2.0), v, quads, rng.uniform(0, 1, 3),
         None if not with_uvs else uv(24).reshape(6, 4, 2), "pattern"),
        ("Fan", _obmat(rng), mixed_v, mixed, rng.uniform(0, 1, 3),
         per_poly(mixed), "pattern"),
        ("Plain", _obmat(rng), v * 0.5, quads, None,
         None if not with_uvs else uv(24).reshape(6, 4, 2), None),
        ("Tris", _obmat(rng), v + 3.0, tri, rng.uniform(0, 1, 3),
         None if not with_uvs else uv(36).reshape(12, 3, 2), None),
    ]


def _cameras(eye_rel="eyes/small.eye"):
    """Perspective cameras under each sensor fit, a panoramic and an
    orthographic one, a compound eye whose .eye is a relative path and one
    whose path resolves nowhere."""
    pos = (1.0, 2.0, 5.0)
    out = [ttesting.blend_camera(f"persp-fit{fit}", pos, lens=_f32(35.5),
                                 sensor_x=_f32(36.0), sensor_y=_f32(24.0),
                                 sensor_fit=fit) for fit in (0, 1, 2)]
    out += [
        ttesting.blend_camera("pano", pos, {"panoramic": "true"}),
        ttesting.blend_camera("ortho", pos, type=1,
                              ortho_scale=_f32(16.0143)),
        ttesting.blend_camera("eye", (0.5, 1.0, 0.0), {
            "compound-eye": "true",
            "compound-projection": "spherical_orientationwise",
            "compound-structure": eye_rel, "sample-count": 7,
            "weight": 0.375}),
        ttesting.blend_camera("lost-eye", pos, {
            "compound-eye": "true",
            "compound-projection": "single_dimension_fast",
            "compound-structure": "nowhere/missing.eye"}),
    ]
    return out


def _texture(path):
    from PIL import Image

    img = (np.arange(4 * 4 * 4).reshape(4, 4, 4) * 4).astype(np.uint8)
    Image.fromarray(img, "RGBA").save(path)
    return path


def _write(tmp_path, name="scene.blend", gz=False, size=(640, 480),
           **kw):
    os.makedirs(tmp_path / "eyes", exist_ok=True)
    write_eye_file(str(tmp_path / "eyes" / "small.eye"),
                   ttesting.make_sphere_eye(12, acceptance_deg=3.0))
    return ttesting.write_blend(
        str(tmp_path / name), kw.get("meshes", _meshes()),
        kw.get("cameras", _cameras()), render_size=size, gzip=gz)


def _assert_meshes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[6] == w[6]
        for a, b in zip(g[1:6], w[1:6]):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


def _assert_cameras_equal(got, want):
    assert [type(c).__name__ for c in got] == [type(c).__name__ for c in want]
    for g, w in zip(got, want):
        assert g.name == w.name
        np.testing.assert_array_equal(g.position, w.position)
        np.testing.assert_array_equal(g.local_space, w.local_space)
        for attr in ("scale", "projection", "eye_data_path"):
            assert (getattr(g, attr, None) is None) == (
                getattr(w, attr, None) is None)
        if getattr(w, "scale", None) is not None:
            np.testing.assert_array_equal(np.asarray(g.scale),
                                          np.asarray(w.scale))
        if hasattr(w, "projection"):
            assert g.projection == w.projection
            np.testing.assert_array_equal(g.ommatidia, w.ommatidia)


def _assert_scenes_equal(got, want):
    for k in SCENE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(want, k)), err_msg=k)
    assert got.background_shader == want.background_shader
    assert got.eye_data_path == want.eye_data_path
    _assert_cameras_equal(got.cameras, want.cameras)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_meshes_and_cameras_match_jax(tmp_path, gz):
    path = _write(tmp_path, gz=gz)
    _assert_meshes_equal(TB.load_blend_meshes(path),
                         JB.load_blend_meshes(path))
    got, want = TB.load_blend_cameras(path), JB.load_blend_cameras(path)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("textured", [False, True],
                         ids=["untextured", "textured"])
@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_scene_matches_jax(tmp_path, gz, textured):
    path = _write(tmp_path, gz=gz)
    tex = {"pattern": _texture(str(tmp_path / "p.png"))} if textured else {}
    got = TB.load_blend_scene(path, textures=tex)
    want = JB.load_blend_scene(path, textures=tex)
    _assert_scenes_equal(got, want)
    assert got.has_any_texture == textured
    # every camera loads but the one whose .eye resolves nowhere
    assert [c.name for c in got.cameras] == [
        "persp-fit0", "persp-fit1", "persp-fit2", "pano", "ortho", "eye"]
    # the last compound camera's path, resolved or not (as the JAX loader)
    assert got.eye_data_path.endswith(os.path.join("nowhere", "missing.eye"))


def test_renderer_and_shim_load_blend_as_jax(tmp_path, capsys):
    """EyeRenderer.load_gltf_scene and the shim's loadGlTFscene dispatch a
    .blend (plain and gzipped) to the loader, as the JAX renderer does."""
    from ctypes import c_char_p

    for gz in (False, True):
        path = _write(tmp_path, name=f"s{int(gz)}.blend", gz=gz)
        jr = JaxRenderer(verbose=False)
        jr.load_gltf_scene(path)
        tr = EyeRenderer(verbose=False, device="cpu")
        tr.load_gltf_scene(path)
        _assert_scenes_equal(tr.scene, jr.scene)
        np.testing.assert_allclose(tr.get_lights(), np.asarray(jr._lights),
                                   rtol=1e-6)
        shim = load_eye_renderer(verbose=False, device="cpu")
        shim.loadGlTFscene(c_char_p(path.encode()))
        _assert_scenes_equal(shim.renderer.scene, jr.scene)
        assert shim.getCameraCount() == 6
    assert "skipping" not in capsys.readouterr().out


def test_blend_frame_matches_jax_end_to_end(tmp_path, monkeypatch):
    """The slice as a whole: both renderers load one written .blend
    (make_big_scene's boxes, its compound eye of 1e-6 rad ommatidia by a
    relative .eye path) and render its eye: means within ATOL, each
    package with its own RNG (every sample of an ommatidium is one ray)."""
    old = jcfg.get_config()
    jcfg.set_config(dataclasses.replace(
        old, farfield="off", sky_split=False, affine_rays=False,
        backend="pallas"))
    monkeypatch.setattr(tcfg, "_global_config",
                        tcfg.RenderConfig(farfield="off"))
    try:
        os.makedirs(tmp_path / "eyes")
        write_eye_file(str(tmp_path / "eyes" / "e.eye"),
                       ttesting.make_sphere_eye(24, np.degrees(1e-6)))
        # zero UVs: the JAX loader needs a UV layer on every mesh
        meshes = [m[:5] + (np.zeros((6, 4, 2)),) + m[6:]
                  for m in ttesting.big_scene_blend_meshes(40, seed=5)]
        path = ttesting.write_blend(str(tmp_path / "b.blend"), meshes, [
            ttesting.blend_camera("insect-eye-spherical-projector",
                                  (0.0, 3.5, 0.0), {
                                      "compound-eye": "true",
                                      "compound-projection":
                                      "single_dimension_fast",
                                      "compound-structure": "eyes/e.eye"})])
        means = []
        for r in (JaxRenderer(verbose=False),
                  EyeRenderer(verbose=False, device="cpu")):
            r.load_gltf_scene(path)
            r.goto_camera_by_name("insect-eye-spherical-projector")
            r.set_current_eye_samples_per_ommatidium(16)
            r.render_frame()
            means.append(np.array(r.get_camera_data()))
    finally:
        jcfg.set_config(old)
    got, want = means[1], means[0]
    assert got.shape == (24, 3) and np.isfinite(got).all()
    assert np.ptp(got) > 0.05, "the eye must see more than one colour"
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_write_then_load_gives_back_the_meshes(tmp_path):
    """load(write(x)) == x on the loader's own form (triangles, per-corner
    UVs), a mesh without UVs and without material included."""
    rng = np.random.default_rng(3)
    meshes = []
    for i, (name, obmat, verts, faces, colour, uvs, img) in enumerate(
            _meshes(seed=3)):
        tri = TB.load_blend_meshes(ttesting.write_blend(
            str(tmp_path / f"m{i}.blend"),
            [(name, obmat, verts, faces, colour, uvs, img)]))[0]
        meshes.append(tri)
    meshes.append(("Bare", np.eye(4, dtype=np.float32),
                   rng.uniform(-1, 1, (5, 3)).astype(np.float32),
                   np.array([[0, 1, 2], [2, 3, 4]], np.int64),
                   np.ones(3), None, None))
    path = ttesting.write_blend(str(tmp_path / "all.blend"), meshes)
    got = TB.load_blend_meshes(path)
    assert len(got) == len(meshes)
    for g, w in zip(got, meshes):
        assert g[0] == w[0] and g[6] == w[6]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_array_equal(g[3], w[3])
        np.testing.assert_allclose(g[4], w[4], rtol=F32)
        if w[5] is None:
            assert g[5] is None
        else:  # V is flipped into the file and back (1 - v in f32)
            np.testing.assert_allclose(g[5], w[5], atol=F32)


def test_polygons_fan_triangulate_in_order(tmp_path):
    """A quad box and a mixed fan load as the fan triangulation
    poly-major, corner-minor, with each triangle's corner UVs."""
    meshes = _meshes(seed=4)
    got = TB.load_blend_meshes(_write(tmp_path, meshes=meshes, cameras=()))
    for g, (_, _, _, faces, _, uvs, _) in zip(got, meshes):
        want_f, want_uv = [], []
        for p, u in zip(faces, uvs):
            for k in range(1, len(p) - 1):
                want_f.append((p[0], p[k], p[k + 1]))
                want_uv.append((u[0], u[k], u[k + 1]))
        np.testing.assert_array_equal(g[3], np.array(want_f))
        np.testing.assert_allclose(g[5], np.array(want_uv), atol=F32)


def test_write_then_load_gives_back_the_cameras(tmp_path):
    """load_blend_cameras(write(x)) == x, the aspect from the render
    size."""
    cams = _cameras()
    for cd in cams:
        cd["obmat"] = np.asarray(cd["obmat"], np.float32)
    path = _write(tmp_path, size=(480, 640), cameras=cams)
    got = TB.load_blend_cameras(path)
    assert len(got) == len(cams)
    for g, w in zip(got, cams):
        assert g["aspect"] == 480 / 640
        for k, v in w.items():
            np.testing.assert_array_equal(g[k], v, err_msg=k)


def test_null_pointers_name_no_block(tmp_path):
    """The port's one change to the loader: a NULL pointer resolves to no
    block.  The JAX loader resolves it to the ENDB block (old pointer 0),
    so a mesh with no UV layer fails there; the port loads it."""
    path = ttesting.write_blend(str(tmp_path / "bare.blend"),
                                _meshes(seed=1, with_uvs=False))
    with pytest.raises(ValueError):
        JB.load_blend_meshes(path)
    got = TB.load_blend_meshes(path)
    assert [m[5] for m in got] == [None] * 4
    assert TB.load_blend_scene(path).num_triangles == 12 + 6 + 12 + 12


# -- tests/test_blend_cameras.py on the port, on written files


def test_garbage_file_raises_cleanly(tmp_path):
    p = tmp_path / "junk.blend"
    p.write_bytes(b"definitely not a blender file" * 10)
    with pytest.raises(ValueError, match="not a .blend"):
        TB.load_blend_scene(str(p))


def test_truncated_blend_raises_cleanly(tmp_path):
    whole = open(_write(tmp_path), "rb").read()
    p = tmp_path / "trunc.blend"
    p.write_bytes(whole[: len(whole) // 2])  # header + some blocks, no DNA1
    for loader in (TB.load_blend_scene, JB.load_blend_scene):
        with pytest.raises(ValueError, match="DNA1|no mesh"):
            loader(str(p))


def test_gzipped_blend_loads(tmp_path):
    """Blender's 'compress' gzips the whole file; the loader inflates.
    Moved away from its eyes/ directory, the compound cameras skip (their
    .eye paths resolve nowhere) and the panoramic one needs no file."""
    cams = [c for c in _cameras() if c["name"] in ("eye", "pano")]
    src = _write(tmp_path, cameras=cams)
    other = tmp_path / "elsewhere" / "deeper"
    other.mkdir(parents=True)
    p = other / "gz.blend"
    p.write_bytes(gzip.compress(open(src, "rb").read()))
    scene = TB.load_blend_scene(str(p))
    assert scene.num_triangles > 0
    assert [type(c).__name__ for c in scene.cameras] == ["PanoramicCamera"]


def _fake_cd(**over):
    cd = {
        "name": "p", "obmat": np.eye(4), "extras": {}, "aspect": 16 / 9,
        "lens": 50.0, "sensor_x": 36.0, "sensor_y": 24.0,
        "ortho_scale": 6.0, "type": 0, "sensor_fit": 0,
    }
    cd.update(over)
    return cd


class _CamScene:
    def __init__(self):
        self.cameras = []


@pytest.mark.parametrize("fit,aspect,sensor,div_aspect", [
    (2, 16 / 9, 24.0, False),   # VERTICAL: sensor_y vertical, any aspect
    (2, 9 / 16, 24.0, False),
    (0, 9 / 16, 36.0, False),   # AUTO portrait: sensor_x IS the vertical
    (0, 16 / 9, 36.0, True),    # AUTO landscape: sensor_x horizontal
    (1, 16 / 9, 36.0, True),    # HORIZONTAL: always horizontal
    (1, 9 / 16, 36.0, True),
])
def test_perspective_yfov_sensor_fit(fit, aspect, sensor, div_aspect):
    """yfov per Blender's BKE_camera_sensor_size (the JAX test's cases)."""
    scene = _CamScene()
    TB._append_blend_camera(
        scene, _fake_cd(sensor_fit=fit, aspect=aspect), "/tmp", True)
    (cam,) = scene.cameras
    denom = 2.0 * 50.0 * (aspect if div_aspect else 1.0)
    # set_y_fov bakes tan(yfov/2)*scale_z into scale[1] (types.py:116)
    expect = (sensor / denom) * cam.scale[2]
    np.testing.assert_allclose(cam.scale[1], expect, rtol=1e-6)


def test_bad_camera_markup_skips_only_that_camera(tmp_path, monkeypatch,
                                                  capsys):
    """One camera whose .eye file is corrupt does not sink the others
    (MulticamScene.cpp:310-319 skip semantics)."""
    bad_eye = tmp_path / "bad.eye"
    bad_eye.write_text("not an eye file at all\n")
    cds = [
        _fake_cd(name="broken", extras={
            "compound-eye": "true",
            "compound-projection": "spherical_orientationwise",
            "compound-structure": str(bad_eye)}),
        _fake_cd(name="survivor"),
    ]
    monkeypatch.setattr(TB, "load_blend_cameras", lambda path: cds)
    scene = _CamScene()
    TB._build_blend_cameras(scene, str(tmp_path / "x.blend"), True)
    assert [c.name for c in scene.cameras] == ["survivor"]
    assert "skipping .blend camera 'broken'" in capsys.readouterr().out


def test_untextured_blend_routes_colors_through_materials(tmp_path):
    """An untextured .blend load carries its material colours raw in
    mat_base_color (like a glTF baseColorFactor), never as vertex colours,
    which trace/shade.py would pow-2.2 a second time."""
    meshes = _meshes(seed=2)
    scene = TB.load_blend_scene(_write(tmp_path, meshes=meshes),
                                cameras=False)
    assert not scene.has_color.any()
    assert scene.mat_base_color.shape == (4, 4)
    assert scene.mat_base_color[:, :3].max() <= 1.0
    np.testing.assert_allclose(scene.mat_base_color[2], [1, 1, 1, 1])
    np.testing.assert_allclose(scene.mat_base_color[0, :3], meshes[0][4],
                               rtol=F32)
    assert scene.mat_id.shape[0] == scene.num_triangles
    assert np.all(scene.mat_tex == -1)
