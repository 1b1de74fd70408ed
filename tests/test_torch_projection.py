"""The port's compound projections (compound_ray_tpu_torch.projection)
against the JAX package's on the same numpy inputs, on the CPU.

The cases of tests/test_projection.py on the port, then each of the eight
projections against JAX project_frame at 64 x 32 with 40 ommatidia: index
maps and _ids frames equal but at near-ties (the two winners' angles within
1e-6 rad), colours within 1 (the gamma pow may round apart by an ulp).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from compound_ray_tpu.projection import project as JPR  # noqa: E402
from compound_ray_tpu.trace.shade import make_color as jax_make_color  # noqa: E402
from compound_ray_tpu_torch.projection import project as PR  # noqa: E402
from compound_ray_tpu_torch.projection import (  # noqa: E402
    PROJECTIONS,
    decode_projection_map_id,
    project_frame,
    voronoi_index_map,
)
from compound_ray_tpu_torch.scene.eye_io import ommatidia_to_array  # noqa: E402
from compound_ray_tpu_torch.testing import (  # noqa: E402
    make_sphere_eye,
    voronoi_agreement,
)
from compound_ray_tpu_torch.trace.shade import make_color  # noqa: E402

NEAR_TIE_RAD = 1e-6


def _eye_arrays(n=50):
    arr = ommatidia_to_array(make_sphere_eye(n))
    means = torch.tensor(np.linspace(0, 1, n * 3).reshape(n, 3),
                         dtype=torch.float32)
    samples = means[None].repeat(4, 1, 1)
    return arr, means, samples


def _project(name, arr, means, samples, w, h):
    return project_frame(name, means, samples, torch.tensor(arr[:, 0:3]),
                         torch.tensor(arr[:, 3:6]), w, h).numpy()


def test_single_dimension_fast_layout():
    arr, means, samples = _eye_arrays(50)
    frame = _project("single_dimension_fast", arr, means, samples, 50, 4)
    assert frame.shape == (4, 50, 4)
    assert frame[0].any()  # row 0 written, the other rows zero
    assert not frame[1:].any()
    np.testing.assert_array_equal(frame[0], make_color(means).numpy())


def test_single_dimension_scaling():
    arr, means, samples = _eye_arrays(10)
    frame = _project("single_dimension", arr, means, samples, 20, 3)
    # ommatidiumIndex = x * N / W: pixels 0, 1 -> omm 0; 2, 3 -> omm 1 ...
    assert (frame[0, 0] == frame[0, 1]).all()
    assert (frame[0] == frame[2]).all()  # every row identical


def test_raw_samples_layout():
    arr, means, samples = _eye_arrays(8)
    frame = _project("raw_ommatidial_samples", arr, means, samples, 8, 4)
    np.testing.assert_array_equal(frame, make_color(samples).numpy())


def test_voronoi_ids_roundtrip():
    arr, means, samples = _eye_arrays(300)
    frame = _project("spherical_orientationwise_ids", arr, means, samples,
                     64, 32)
    ids = {decode_projection_map_id(frame[y, x])
           for y in range(32) for x in range(64)}
    assert all(0 <= i < 300 for i in ids)
    assert len(ids) > 50  # many cells visible on a full sphere


def test_voronoi_map_is_nearest():
    arr, _, _ = _eye_arrays(40)
    d = arr[:, 3:6]
    idx = voronoi_index_map(torch.tensor(d), 16, 8).numpy()
    sphere = PR._pixel_sphere_dirs(16, 8, "cpu").numpy()
    for (y, x) in [(0, 0), (3, 7), (7, 15)]:
        cos = (sphere[y, x] @ d.T) / (
            np.linalg.norm(d, axis=1) * np.linalg.norm(sphere[y, x]))
        ang = np.arccos(np.clip(cos, -1, 1))
        assert idx[y, x] == int(np.argmin(ang))


def test_split_projection_sides():
    arr = ommatidia_to_array(make_sphere_eye(60))
    idx = voronoi_index_map(torch.tensor(arr[:, 3:6]), 32, 16, split=True,
                            positions_x=torch.tensor(arr[:, 0])).numpy()
    pos_x = arr[:, 0]
    # left-half pixels (uv.x < 0.5) map to omms with pos.x < 0 (or omm 0)
    for i in np.unique(idx[:, :16]):
        assert pos_x[i] < 0 or i == 0
    for i in np.unique(idx[:, 16:]):
        assert pos_x[i] > 0 or i == 0


def test_voronoi_chunked_matches_monolithic():
    """The chunked ommatidium axis equals one chunk but at razor-thin
    Voronoi-boundary ties."""
    rng = np.random.default_rng(0)
    refs = rng.normal(size=(700, 3)).astype(np.float32)
    px = torch.tensor(refs[:, 0])
    w = h = 96
    mono = voronoi_index_map(torch.tensor(refs), w, h, True, px,
                             chunk_elems=1 << 62).numpy()
    for chunk_elems in (w * h * 97, w * h * 256):  # 8 and 3 chunks
        chunked = voronoi_index_map(torch.tensor(refs), w, h, True, px,
                                    chunk_elems=chunk_elems).numpy()
        agree, gap = voronoi_agreement(chunked, mono, refs, w, h)
        assert agree > 1 - 1e-4 and gap < 1e-4


def test_voronoi_default_budget_is_single_chunk():
    # 400 x 400 display x 3000 omms and the 640 x 480 x 1000 card check fit
    # one chunk, as in the JAX package
    assert PR._VORONOI_CHUNK_ELEMS == JPR._VORONOI_CHUNK_ELEMS
    assert 400 * 400 * 3000 <= PR._VORONOI_CHUNK_ELEMS
    assert 640 * 480 * 1000 <= PR._VORONOI_CHUNK_ELEMS


def test_make_color_matches_jax():
    rng = np.random.default_rng(3)
    rgb = rng.uniform(-0.2, 1.2, size=(4096, 3)).astype(np.float32)
    rgb[:3] = [[0.0, 1.0, 0.5], [np.nan, 0.0, 0.0], [-1.0, 2.0, 1e-7]]
    rgb[0, 0] = 0.0
    got = make_color(torch.tensor(rgb)).numpy()
    want = np.asarray(jax_make_color(jnp.asarray(rgb)))
    assert got.dtype == np.uint8 and got.shape == (4096, 4)
    ok = ~np.isnan(rgb).any(axis=1)
    diff = np.abs(got[ok].astype(int) - want[ok].astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.999
    assert (got[:, 3] == 255).all()


def _index_map(vmap, to_array, name, arr, w, h):
    """The index map a spherical projection reads, by either package."""
    refs = arr[:, 0:3] if "positionwise" in name else arr[:, 3:6]
    return np.asarray(vmap(to_array(refs), w, h, split="split" in name,
                           positions_x=to_array(arr[:, 0])))


@pytest.mark.parametrize("name", PROJECTIONS)
def test_project_frame_matches_jax(name):
    """64 x 32 with 40 ommatidia, means in [-0.2, 1.2] (clamped), 5 raw
    samples each."""
    w, h, n = 64, 32, 40
    arr = ommatidia_to_array(make_sphere_eye(n))
    rng = np.random.default_rng(7)
    samples = rng.uniform(-0.2, 1.2, size=(5, n, 3)).astype(np.float32)
    means = samples.mean(axis=0)
    got = project_frame(name, torch.tensor(means), torch.tensor(samples),
                        torch.tensor(arr[:, 0:3]), torch.tensor(arr[:, 3:6]),
                        w, h).numpy()
    want = np.asarray(JPR.project_frame(
        name, jnp.asarray(means), jnp.asarray(samples),
        jnp.asarray(arr[:, 0:3]), jnp.asarray(arr[:, 3:6]), w, h))
    assert got.shape == want.shape == (h, w, 4) and got.dtype == np.uint8
    same = np.ones((h, w), bool)
    if name.startswith("spherical"):
        gi = _index_map(voronoi_index_map, torch.tensor, name, arr, w, h)
        wi = _index_map(JPR.voronoi_index_map, jnp.asarray, name, arr, w, h)
        refs = arr[:, 0:3] if "positionwise" in name else arr[:, 3:6]
        agree, gap = voronoi_agreement(gi, wi, refs, w, h)
        assert agree >= 0.999 and gap < NEAR_TIE_RAD
        same = gi == wi
    if name.endswith("_ids"):
        np.testing.assert_array_equal(got[same], want[same])
    else:
        diff = np.abs(got[same].astype(int) - want[same].astype(int))
        assert diff.max() <= 1
