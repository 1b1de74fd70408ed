"""The port's eight examples (compound_ray_tpu_torch/examples/) on the CPU.

Each example's main runs with --device cpu on a small .blend that the test
writes (make_big_scene's boxes, a 16-ommatidium eye by a relative .eye
path, a panoramic and a perspective camera), at 1-8 samples and 1-2
epochs, and each writes the files, names and formats of the JAX example
(examples/*.py).  position_estimation's MLP is held to the JAX example's:
its forward pass and one SGD step on the L1 loss, from the JAX init_mlp
weights carried over (atol 1e-5).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.examples import (  # noqa: E402
    alias_quantified_experiment,
    alias_viewpoint_experiment,
    heterogeneous_demonstration,
    overview_images,
    plot_speed_test,
    position_estimation,
    primary_example,
    speed_test,
)
from compound_ray_tpu_torch.scene.eye_io import (  # noqa: E402
    read_eye_file,
    write_eye_file,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_OMM = 16
EYE = "insect-eye-spherical-projector"


@pytest.fixture
def scene(tmp_path, monkeypatch):
    """A small written .blend with its eye; the examples write into the
    test's directory."""
    monkeypatch.chdir(tmp_path)
    path = ttesting.write_big_scene_blend(
        str(tmp_path), n_boxes=12, seed=0, n_omm=N_OMM, accept_deg=5.0,
        camera_pos=(0.0, 3.0, 40.0))
    return path


def _ppm(path):
    """(width, height) of a binary PPM, checking its size."""
    data = open(path, "rb").read()
    magic, w, h, maxval = data.split(maxsplit=4)[:4]
    assert magic == b"P6" and maxval == b"255"
    w, h = int(w), int(h)
    assert len(data) >= w * h * 3
    return w, h


def test_primary_example(scene, monkeypatch, tmp_path):
    monkeypatch.setenv("CR_SCENE", scene)
    primary_example.main(["--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "test-images"))
    # four cameras, the compound one again at 100 samples
    assert names == ["test-image-0-100samples.ppm", "test-image-0.ppm",
                     "test-image-1.ppm", "test-image-2.ppm",
                     "test-image-3.ppm"]
    for n in names:
        assert _ppm(tmp_path / "test-images" / n) == (200, 200)


def test_speed_test_writes_its_result_files(scene, tmp_path):
    write_eye_file(str(tmp_path / "e.eye"), ttesting.make_sphere_eye(N_OMM))
    means = speed_test.main(["-f", scene, "-e", str(tmp_path / "e.eye"),
                             "-s", "1", "4", "-n", "2", "-w", "0",
                             "--device", "cpu"])
    assert len(means) == 2 and all(m > 0 for m in means)
    base = "cpu-natural-frame-rendertime"
    avg = np.loadtxt(f"{base}-averages-(1-4-rays,2-samples).txt")
    fps = np.loadtxt(f"{base}-average-FPSs-(1-4-rays,2-samples).txt")
    np.testing.assert_allclose(avg, means, rtol=1e-6)
    np.testing.assert_allclose(fps, 1000.0 / np.asarray(means), rtol=1e-6)
    assert speed_test.device_label("cpu") == "cpu"

    # plot_speed_test's parser on those files, then its plot
    (label, xs, times, rays), = plot_speed_test.read_results(
        [f"{base}-averages-(1-4-rays,2-samples).txt"], ommatidia=N_OMM,
        samples=[1, 4])
    assert label == "cpu-natural"
    np.testing.assert_array_equal(xs, [1, 4])
    np.testing.assert_allclose(rays, N_OMM * xs / (avg / 1000.0))
    pytest.importorskip("matplotlib")
    plot_speed_test.main([f"{base}-averages-(1-4-rays,2-samples).txt",
                          "-n", str(N_OMM), "-o", "plot.png"])
    assert open("plot.png", "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_speed_test_falls_back_to_the_sphere_eye(scene):
    """Without the .eye file, the JAX example's fallback eye
    (make_sphere_eye(1000, 2.6 degrees)), and the label the caller gives."""
    speed_test.main(["-f", scene, "-e", "absent.eye", "-s", "1", "-n", "1",
                     "-w", "0", "-l", "run", "--device", "cpu"])
    assert os.path.isfile("run-frame-rendertime-averages-(1-1-rays,1-samples)"
                          ".txt")


def test_alias_quantified_experiment(scene, tmp_path):
    avg = alias_quantified_experiment.main(["-f", scene, "-m", "2", "-n", "3",
                                            "--device", "cpu"])
    vec = tmp_path / "output" / "vector-data"
    for idx in range(2):
        var = np.loadtxt(vec / f"variance-{idx}-samples.txt", delimiter=",")
        sd = np.loadtxt(vec / f"sd-{idx}-samples.txt", delimiter=",")
        np.testing.assert_allclose(sd, np.sqrt(var))
    got = np.loadtxt(vec / "avgPerImagePerSteradianSd(0-2samples).txt",
                     delimiter=",")
    np.testing.assert_allclose(got, avg)
    assert np.isfinite(avg).all() and (avg >= 0).all()


def test_alias_viewpoint_experiment(scene, tmp_path):
    combined = alias_viewpoint_experiment.main(
        ["-f", scene, "-c", EYE, "-W", "16", "-H", "8", "-s", "4", "-o",
         "sweep/out.ppm", "--device", "cpu"])
    assert _ppm(tmp_path / "sweep" / "out.ppm") == (16, 8)
    assert combined.shape == (8, 16, 3) and combined.max() > 0


def test_heterogeneous_demonstration(scene, tmp_path):
    heterogeneous_demonstration.main(["-f", scene, "-s", "1", "-W", "8",
                                      "-H", "4", "--device", "cpu"])
    for name in ("homogeneous-omms-small", "homogeneous-omms-big",
                 "heterogeneous-omms"):
        for suffix in [f"-{i}" for i in range(5)] + [""]:
            assert _ppm(tmp_path / f"{name}{suffix}.ppm") == (8, 4)
    eye = heterogeneous_demonstration.variable_acceptance_eye(n=8)
    base = ttesting.make_sphere_eye(8, acceptance_deg=2.6)
    for o, b in zip(eye, base):
        scale = 1.0 + 3.0 * abs(float(b.direction[1]))
        assert np.isclose(o.acceptance_angle, b.acceptance_angle * scale)


def test_overview_images(scene, tmp_path):
    written = overview_images.main(["-f", scene, "-W", "16", "-H", "8",
                                    "-s", "2", "-o", "ov", "--device",
                                    "cpu"])
    assert [os.path.basename(p) for p in written] == [
        f"00-{EYE}.ppm", "01-regular-panoramic.ppm", "02-perspective.ppm",
        "03-orthographic.ppm"]
    for p in written:
        assert _ppm(p) == (16, 8)
    assert len(read_eye_file(str(tmp_path / "eyes" / f"sphere-{N_OMM}.eye"))
               ) == N_OMM


def test_position_estimation(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    train, test = position_estimation.main(
        ["-n", "50", "-o", "8", "-s", "2", "-e", "2", "--out", "pe.npz",
         "--device", "cpu"])
    res = np.load("pe.npz")
    np.testing.assert_allclose(res["train"], train)
    np.testing.assert_allclose(res["test"], test)
    assert res["train"].shape == res["test"].shape == (2,)
    assert np.isfinite(res["train"]).all() and np.isfinite(res["test"]).all()


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_position_estimation",
        os.path.join(REPO, "examples", "position_estimation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mlp_forward_and_sgd_step_match_jax():
    """The port's MLP with the JAX init_mlp weights carried over: forward
    within 1e-5 of the JAX forward, and one SGD step on the same batch
    within 1e-5 of optax.sgd's."""
    import jax
    import jax.numpy as jnp
    import optax

    jx = _jax_example()
    rng = np.random.default_rng(0)
    feats = 48
    params = jax.tree_util.tree_map(
        np.asarray, jx.init_mlp(jax.random.PRNGKey(3), feats))
    xb = rng.uniform(0, 1, (32, feats)).astype(np.float32)
    yb = rng.uniform(-30, 30, (32, 3)).astype(np.float32)
    model = position_estimation.mlp_params_from_jax(
        position_estimation.MLP(feats, torch.Generator().manual_seed(0)),
        params)
    got = model(torch.as_tensor(xb)).detach().numpy()
    want = np.asarray(jx.forward(params, jnp.asarray(xb)))
    np.testing.assert_allclose(got, want, atol=1e-5)

    opt = optax.sgd(1e-3)

    def loss_fn(p):
        return jnp.mean(jnp.abs(jx.forward(p, xb) - yb))

    jloss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = opt.update(grads, opt.init(params))
    stepped = optax.apply_updates(params, updates)
    tloss = position_estimation.step(
        model, torch.optim.SGD(model.parameters(), lr=1e-3),
        torch.as_tensor(xb), torch.as_tensor(yb))
    assert abs(tloss - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))
    for name in ("fc1", "fc2", "fc3"):
        fc = getattr(model, name)
        np.testing.assert_allclose(fc.weight.detach().numpy().T,
                                   np.asarray(stepped[name]["w"]), atol=1e-5)
        np.testing.assert_allclose(fc.bias.detach().numpy(),
                                   np.asarray(stepped[name]["b"]), atol=1e-5)


def test_mlp_init_is_he_normal_from_its_generator():
    """He-normal weights (sd sqrt(2 / fan-in)) and zero biases, the same
    from the same generator seed."""
    a = position_estimation.MLP(400, torch.Generator().manual_seed(1))
    b = position_estimation.MLP(400, torch.Generator().manual_seed(1))
    for fa, fb, n_in in ((a.fc1, b.fc1, 400), (a.fc2, b.fc2, 1000),
                         (a.fc3, b.fc3, 256)):
        assert torch.equal(fa.weight, fb.weight)
        assert not fa.bias.any()
        if fa.weight.numel() > 10000:
            sd = float(fa.weight.detach().std())
            assert abs(sd - (2.0 / n_in) ** 0.5) < 0.05 * sd


def test_examples_default_to_the_card(tmp_path, monkeypatch):
    """Each rendering example's --device defaults to the card, which a
    host without one refuses (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    monkeypatch.chdir(tmp_path)
    with pytest.raises((RuntimeError, AssertionError)):
        overview_images.main(["-f", "x.blend"])
