"""Position-estimation toy experiment
(python-examples/position-estimation-toy-experiment/) on the port
(examples/position_estimation.py).

The reference renders compound-eye views at random arena poses, then trains
an MLP (features -> 1000 -> 256 -> 3, ReLU, L1 loss, SGD:
position-estimator-file-based.py:178-203) to regress the camera position
from the view: a scientific end-to-end check, since wrong views make the
learning curves diverge.  Here the views come from the port's compound
pipeline and the estimator is a torch nn.Module with the JAX example's
architecture, He-normal initialisation, L1 loss, split, batch, learning
rate and batch order; both run in one process on --device.

    python -m compound_ray_tpu_torch.examples.position_estimation
"""

import argparse

import numpy as np
import torch
from torch import nn

from compound_ray_tpu_torch.api.renderer import EyeRenderer
from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera
from compound_ray_tpu_torch.examples import add_device_argument
from compound_ray_tpu_torch.testing import make_big_scene, make_sphere_eye


def generate_views(renderer, n_views, bounds_lo, bounds_hi, samples, seed=0):
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for i in range(n_views):
        pos = rng.uniform(bounds_lo, bounds_hi)
        yaw = rng.uniform(0, 2 * np.pi)
        renderer.set_camera_pose(pos[0], pos[1], pos[2], 0.0, yaw, 0.0)
        renderer.render_frame()
        view = renderer.get_camera_data().reshape(-1)  # (n_omms*3,)
        xs.append(view)
        ys.append(pos)
        if (i + 1) % 50 == 0:
            print(f"  generated {i + 1}/{n_views} views")
    return np.stack(xs).astype(np.float32), np.stack(ys).astype(np.float32)


class MLP(nn.Module):
    """features -> 1000 -> 256 -> 3 with ReLU (the JAX example's init_mlp
    and forward); He-normal weights and zero biases drawn from
    `generator`."""

    def __init__(self, feature_size: int, generator: torch.Generator):
        super().__init__()
        self.fc1 = nn.Linear(feature_size, 1000)
        self.fc2 = nn.Linear(1000, 256)
        self.fc3 = nn.Linear(256, 3)
        with torch.no_grad():
            for fc in (self.fc1, self.fc2, self.fc3):
                n_in = fc.in_features
                fc.weight.copy_(torch.randn(
                    fc.weight.shape, generator=generator,
                    device=generator.device) * (2.0 / n_in) ** 0.5)
                fc.bias.zero_()

    def forward(self, x):
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return self.fc3(x)


def mlp_params_from_jax(model: MLP, params) -> MLP:
    """Load the JAX example's init_mlp dict ({"fc1": {"w": (in, out), "b":
    (out,)}, ...}, as numpy arrays) into `model`: the weight carry-over
    that holds the port's forward pass and updates to the JAX ones."""
    with torch.no_grad():
        for name in ("fc1", "fc2", "fc3"):
            fc = getattr(model, name)
            fc.weight.copy_(torch.tensor(
                np.asarray(params[name]["w"], np.float32).T))
            fc.bias.copy_(torch.tensor(
                np.asarray(params[name]["b"], np.float32)))
    return model


def l1_loss(model, xb, yb):
    return torch.mean(torch.abs(model(xb) - yb))


def step(model, opt, xb, yb) -> float:
    """One SGD step on the L1 loss of (xb, yb); returns the loss before."""
    opt.zero_grad()
    loss = l1_loss(model, xb, yb)
    loss.backward()
    opt.step()
    return loss.item()


def train(xs, ys, epochs=50, batch=32, lr=1e-3, seed=0, device="cuda"):
    n = len(xs)
    split = int(0.8 * n)
    xs_t = torch.as_tensor(xs, device=device)
    ys_t = torch.as_tensor(ys, device=device)
    x_tr, y_tr = xs_t[:split], ys_t[:split]
    x_te, y_te = xs_t[split:], ys_t[split:]

    gen = torch.Generator(device="cpu").manual_seed(seed)
    model = MLP(xs.shape[1], gen).to(device)
    opt = torch.optim.SGD(model.parameters(), lr=lr)

    rng = np.random.default_rng(seed)
    train_curve, test_curve = [], []
    for epoch in range(epochs):
        order = rng.permutation(split)
        losses = []
        for b0 in range(0, split - batch + 1, batch):
            idx = torch.as_tensor(order[b0:b0 + batch], device=device)
            losses.append(step(model, opt, x_tr[idx], y_tr[idx]))
        tr = float(np.mean(losses))
        with torch.no_grad():
            te = float(l1_loss(model, x_te, y_te))
        train_curve.append(tr)
        test_curve.append(te)
        print(f"epoch {epoch + 1}: train L1 {tr:.4f}, test L1 {te:.4f}")
    return model, train_curve, test_curve


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--views", type=int, default=300)
    ap.add_argument("-o", "--ommatidia", type=int, default=200)
    ap.add_argument("-s", "--samples", type=int, default=8)
    ap.add_argument("-e", "--epochs", type=int, default=50)
    ap.add_argument("--out", default="position-estimation-results.npz")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    print("Building arena scene + eye...")
    r = EyeRenderer(verbose=False, device=args.device)
    r.scene = make_big_scene(n_boxes=100, seed=7)  # sets the default lights
    cam = CompoundEyeCamera(
        "bee-eye", "single_dimension_fast",
        make_sphere_eye(args.ommatidia, acceptance_deg=5.0),
    )
    r.scene.cameras.append(cam)
    r.set_current_eye_samples_per_ommatidium(args.samples)

    lo = np.array([-30.0, 1.0, -30.0])
    hi = np.array([30.0, 8.0, 30.0])
    print(f"Generating {args.views} views...")
    xs, ys = generate_views(r, args.views, lo, hi, args.samples)

    print("Training estimator...")
    _, train_curve, test_curve = train(xs, ys, epochs=args.epochs,
                                       device=args.device)
    np.savez(args.out, train=np.asarray(train_curve),
             test=np.asarray(test_curve))
    print(f"Saved learning curves to {args.out}; "
          f"final test L1 {test_curve[-1]:.4f} "
          f"(arena span ~{float(np.linalg.norm(hi - lo)):.1f})")
    return train_curve, test_curve


if __name__ == "__main__":
    main()
