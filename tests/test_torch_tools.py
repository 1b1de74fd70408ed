"""Port: the eye tools (compound_ray_tpu_torch/tools/), tests/test_tools.py
on the port, on the CPU; and relax_gradient against the JAX package's on
the same points (max abs 1e-5 over 40 steps: both run in f32, and the sums
of the gradient are ordered differently).  A relaxation of closely spaced
points is chaotic (a 1/d^3 weight), so only a short run can agree."""

import math

import numpy as np
import pytest

from compound_ray_tpu_torch.scene.eye_io import read_eye_file
from compound_ray_tpu_torch.tools.eye_generator import (
    generate_equidistant_eye,
    generate_grid_eye,
    generate_sinewave_droplet_eye,
    riesz_energy,
)
from compound_ray_tpu_torch.tools.eye_transforms import adjust_acceptance, rescale, split
from compound_ray_tpu_torch.tools.eye_visualiser import eye_to_svg
from compound_ray_tpu_torch.testing import make_sphere_eye


def test_generator_relaxation_reduces_energy():
    rng = np.random.default_rng(0)
    from compound_ray_tpu_torch.tools.eye_generator import (
        _sphere_random,
        relax_gradient,
    )

    pts = _sphere_random(64, rng)
    e0 = riesz_energy(pts)
    relaxed = relax_gradient(pts, iterations=300, device="cpu")
    e1 = riesz_energy(relaxed)
    assert e1 < e0
    # all points stay on the unit sphere
    np.testing.assert_allclose(np.linalg.norm(relaxed, axis=1), 1.0, atol=1e-5)
    # nearest-neighbour spacing much more uniform after relaxation
    def nn_spacing(p):
        d = np.linalg.norm(p[:, None] - p[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        return d.min(axis=1)

    assert nn_spacing(relaxed).std() < nn_spacing(pts).std()


def test_generator_eye_output(tmp_path):
    omms = generate_equidistant_eye(32, acceptance_deg=3.0, radius=0.2,
                                    iterations=100, device="cpu")
    assert len(omms) == 32
    for o in omms:
        assert np.isclose(np.linalg.norm(o.position), 0.2, atol=1e-5)
        assert np.isclose(o.acceptance_angle, math.radians(3.0))
    from compound_ray_tpu_torch.tools.eye_generator import main

    out = str(tmp_path / "gen.eye")
    main([out, "-n", "16", "-i", "50", "--device", "cpu"])
    assert len(read_eye_file(out)) == 16


def test_generator_horizontally_acute():
    omms = generate_equidistant_eye(64, acceptance_deg=2.0, iterations=50,
                                    horizontally_acute=2.0, device="cpu")
    accs = np.array([o.acceptance_angle for o in omms])
    ys = np.array([abs(o.direction[1]) for o in omms])
    # polar ommatidia get wider acceptance than equatorial ones
    assert accs[ys.argmax()] > accs[ys.argmin()]


def test_generator_grid_eye():
    omms = generate_grid_eye(16)
    assert len(omms) == 16
    pos = np.stack([o.position for o in omms])
    # planar y=0 grid, unit separation (SinesGenerator.cpp:15-24)
    assert np.all(pos[:, 1] == 0.0)
    assert {tuple(p) for p in pos[:, [0, 2]]} == {
        (float(i), float(o)) for i in range(4) for o in range(4)
    }
    for o in omms:
        np.testing.assert_allclose(o.direction, [0.0, 1.0, 0.0])


def test_generator_sinewave_droplet():
    omms = generate_sinewave_droplet_eye(64, wavelength=3.0, iterations=100,
                                         seed=1)
    assert len(omms) == 64
    pos = np.stack([o.position for o in omms])
    dirs = np.stack([o.direction for o in omms])
    # points lie ON the droplet surface y = sin(w r + t)
    r = np.linalg.norm(pos[:, [0, 2]], axis=1)
    np.testing.assert_allclose(pos[:, 1], np.sin(3.0 * r), atol=1e-6)
    # unit normals with the analytic slope: n_xz ∝ -w cos(w r) p_xz / r
    np.testing.assert_allclose(np.linalg.norm(dirs, axis=1), 1.0, atol=1e-6)
    slope = -3.0 * np.cos(3.0 * r) / r
    expect = np.stack([slope * pos[:, 0], np.ones(64), slope * pos[:, 2]],
                      axis=-1)
    expect /= np.linalg.norm(expect, axis=1, keepdims=True)
    np.testing.assert_allclose(dirs, expect, atol=1e-5)
    # relaxation spreads points: no two closer than a tenth of the mean gap
    d2 = np.sum((pos[None] - pos[:, None]) ** 2, axis=-1) + np.eye(64)
    assert np.sqrt(d2.min()) > 0.01


def test_rescale():
    omms = make_sphere_eye(20, radius=0.5)
    out = rescale(omms, 0.1)
    radii = [np.linalg.norm(o.position) for o in out]
    assert np.isclose(np.mean(radii), 0.1, rtol=1e-6)


def test_split():
    omms = make_sphere_eye(40, radius=0.1)
    out = split(omms, distance=1.0, overlap=0.0)
    # without overlap every ommatidium lands in exactly one half
    assert len(out) >= len(omms)
    xs = np.array([o.position[0] for o in out])
    assert (np.abs(xs) > 0.5).all()  # all shifted away from the midline


def test_adjust_acceptance():
    omms = make_sphere_eye(40)
    out = adjust_acceptance(omms)
    for o in out:
        assert 0.0 < o.acceptance_angle < math.pi


def test_svg_visualiser(tmp_path):
    omms = make_sphere_eye(30)
    svg = eye_to_svg(omms)
    assert svg.startswith("<svg")
    assert svg.count("<line") > 5  # front-facing subset drawn
    full = eye_to_svg(omms, show_back_facing=True)
    assert full.count("<line") == 30


def test_minimum_sample_rate_finder_smoke():
    from compound_ray_tpu_torch.api.renderer import EyeRenderer
    from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera
    from compound_ray_tpu_torch.scene.eye_io import icosphere_eye
    from compound_ray_tpu_torch.testing import make_box_scene
    from compound_ray_tpu_torch.tools.minimum_sample_rate_finder import (
        find_minimum_samples,
        variance_of_repeated_renders,
    )

    r = EyeRenderer(verbose=False, device="cpu")
    r.scene = make_box_scene(background="white")
    r.scene.cameras.append(
        CompoundEyeCamera("eye", "single_dimension_fast", icosphere_eye())
    )
    from compound_ray_tpu_torch.trace.lighting import default_lights

    r._lights = default_lights(r.scene.aabb_min, r.scene.aabb_max)
    r.set_render_size(12, 1)
    var = variance_of_repeated_renders(r, 2, 4)
    assert var.shape == (12,)
    min_s, sds = find_minimum_samples(r, cutoff_percent=0.5, repeat=3,
                                      max_samples=8)
    assert min_s >= 1
    assert len(sds) >= 1


def test_variance_mapper_grid():
    from compound_ray_tpu_torch.api.renderer import EyeRenderer
    from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera
    from compound_ray_tpu_torch.scene.eye_io import icosphere_eye
    from compound_ray_tpu_torch.testing import make_box_scene
    from compound_ray_tpu_torch.tools.variance_mapper import (
        map_variance_over_grid,
        per_ommatidium_sd,
    )

    r = EyeRenderer(verbose=False, device="cpu")
    r.scene = make_box_scene(background="default_background")
    r.scene.cameras.append(
        CompoundEyeCamera("eye", "single_dimension_fast", icosphere_eye())
    )
    from compound_ray_tpu_torch.trace.lighting import default_lights

    r._lights = default_lights(r.scene.aabb_min, r.scene.aabb_max)
    sd = per_ommatidium_sd(r, samples=2, repeat=4)
    assert sd.shape == (12,)
    # repeated renders must carry DIFFERENT jitter (advancing per-eye RNG
    # stream): a dead stream would zero every sd
    assert sd.max() > 0.0
    vmap = map_variance_over_grid(
        r, [(0.0, 0.0, 0.0), (0.1, 0.0, 0.0)], samples=2, repeat=3
    )
    assert vmap.shape == (2, 12)
    assert np.all(np.isfinite(vmap))


def test_obj_centerer(tmp_path):
    from compound_ray_tpu_torch.tools.obj_centerer import center_obj

    p = tmp_path / "m.obj"
    p.write_text("v 1 1 1\nv 3 1 1\nv 1 3 1\nv 1 1 3\nf 1 2 3\n")
    out = tmp_path / "c.obj"
    center_obj(str(p), str(out))
    verts = [l for l in out.read_text().splitlines() if l.startswith("v ")]
    arr = np.array([[float(x) for x in v.split()[1:4]] for v in verts])
    center = (arr.min(axis=0) + arr.max(axis=0)) / 2
    np.testing.assert_allclose(center, 0.0, atol=1e-6)


def test_relax_gradient_matches_jax():
    pytest.importorskip("jax")
    from compound_ray_tpu.tools import eye_generator as jgen
    from compound_ray_tpu_torch.tools.eye_generator import relax_gradient

    pts = _sphere_points(64, seed=0)
    want = jgen.relax_gradient(pts, iterations=40)
    got = relax_gradient(pts, iterations=40, device="cpu")
    assert got.dtype == np.float32 and got.shape == (64, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _sphere_points(n, seed):
    from compound_ray_tpu_torch.tools.eye_generator import _sphere_random

    return _sphere_random(n, np.random.default_rng(seed))


def test_tool_mains(tmp_path):
    """eye_transforms, eye_visualiser and obj_centerer through main()."""
    from compound_ray_tpu_torch.scene.eye_io import write_eye_file
    from compound_ray_tpu_torch.tools import (
        eye_transforms,
        eye_visualiser,
        obj_centerer,
    )

    eye = tmp_path / "e.eye"
    write_eye_file(str(eye), make_sphere_eye(20, radius=0.5))
    eye_transforms.main(["rescale", str(eye), "0.1"])
    assert len(read_eye_file(str(tmp_path / "e-avgRadius-0.1.eye"))) == 20
    eye_transforms.main(["adjust-acceptance", str(eye)])
    assert len(read_eye_file(str(tmp_path / "e-adjusted.eye"))) == 20
    svg = tmp_path / "e.svg"
    eye_visualiser.main(["-f", str(eye), "-o", str(svg), "-b"])
    assert svg.read_text().count("<line") == 20
    obj = tmp_path / "m.obj"
    obj.write_text("v 1 1 1\nv 3 1 1\nv 1 3 1\nf 1 2 3\n")
    obj_centerer.main([str(obj)])
    assert (tmp_path / "m-centered.obj").read_text().startswith("v -1.0")


# -- parity with the JAX package's tools on the same inputs -------------------
# The numpy tools are copies, so their outputs must be equal, not close.


def _eyes(n, seed=3):
    """The same eye as the port's and the JAX package's Ommatidium lists."""
    from compound_ray_tpu.scene import eye_io as jio
    from compound_ray_tpu_torch.scene import eye_io as tio

    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = d * rng.uniform(0.05, 0.5, (n, 1)) + [0.01, 0.0, -0.02]
    acc = rng.uniform(0.01, 0.1, n)
    return ([tio.Ommatidium(p.copy(), q.copy(), float(a), 0.0)
             for p, q, a in zip(pos, d, acc)],
            [jio.Ommatidium(p.copy(), q.copy(), float(a), 0.0)
             for p, q, a in zip(pos, d, acc)])


def _fields(omms):
    """(N, 8) float64 [position, direction, acceptance, focal offset]."""
    return np.array([[*o.position, *o.direction, o.acceptance_angle,
                      o.focal_point_offset] for o in omms], np.float64)


@pytest.mark.parametrize("transform, args", [
    ("rescale", (0.1,)), ("split", (1.0, 0.0)), ("split", (0.5, 0.3)),
    ("adjust_acceptance", ())])
def test_eye_transforms_match_jax(transform, args):
    pytest.importorskip("jax")
    from compound_ray_tpu.tools import eye_transforms as jtr
    from compound_ray_tpu_torch.tools import eye_transforms as ttr

    ours, theirs = _eyes(40)
    got = _fields(getattr(ttr, transform)(ours, *args))
    want = _fields(getattr(jtr, transform)(theirs, *args))
    assert got.shape == want.shape and len(got) >= 40
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"show_back_facing": True},
                                {"yaw": 30.0, "pitch": -20.0}])
def test_eye_to_svg_matches_jax(kw):
    pytest.importorskip("jax")
    from compound_ray_tpu.tools.eye_visualiser import eye_to_svg as jsvg

    ours, theirs = _eyes(30)
    svg = eye_to_svg(ours, **kw)
    assert svg == jsvg(theirs, **kw) and svg.count("<line") > 5


def test_numpy_eyes_match_jax():
    """The grid, sinewave-droplet and random-move eyes from the same seeds."""
    pytest.importorskip("jax")
    from compound_ray_tpu.tools import eye_generator as jgen
    from compound_ray_tpu_torch.tools import eye_generator as tgen

    np.testing.assert_array_equal(_fields(tgen.generate_grid_eye(16, 3.0)),
                                  _fields(jgen.generate_grid_eye(16, 3.0)))
    kw = dict(wavelength=3.0, iterations=40, seed=1)
    np.testing.assert_array_equal(
        _fields(tgen.generate_sinewave_droplet_eye(36, **kw)),
        _fields(jgen.generate_sinewave_droplet_eye(36, **kw)))
    kw = dict(acceptance_deg=2.0, method="random_move", seed=5)
    np.testing.assert_array_equal(
        _fields(tgen.generate_equidistant_eye(24, **kw)),
        _fields(jgen.generate_equidistant_eye(24, **kw)))


def test_equidistant_eye_matches_jax():
    """The gradient mode end to end, within relax_gradient's 1e-5."""
    pytest.importorskip("jax")
    from compound_ray_tpu.tools import eye_generator as jgen
    from compound_ray_tpu_torch.tools import eye_generator as tgen

    kw = dict(acceptance_deg=2.0, radius=0.2, iterations=40,
              horizontally_acute=2.0)
    got = _fields(tgen.generate_equidistant_eye(48, device="cpu", **kw))
    want = _fields(jgen.generate_equidistant_eye(48, **kw))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_obj_centerer_matches_jax(tmp_path):
    pytest.importorskip("jax")
    from compound_ray_tpu.tools.obj_centerer import center_obj as jcenter
    from compound_ray_tpu_torch.tools.obj_centerer import center_obj

    src = tmp_path / "m.obj"
    src.write_text("# a mesh\nv 1 1.5 1\nv 3 1 -1\nv 1 3 1 0.5\n"
                   "vn 0 1 0\nvt 0.5 0.5\nf 1/1/1 2/1/1 3/1/1\n")
    center_obj(str(src), str(tmp_path / "ours.obj"))
    jcenter(str(src), str(tmp_path / "theirs.obj"))
    got = (tmp_path / "ours.obj").read_text()
    assert got == (tmp_path / "theirs.obj").read_text()
    assert "vn 0 1 0" in got and "f 1/1/1" in got
