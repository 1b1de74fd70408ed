"""Equidistant eye synthesis by Riesz s-energy minimisation (eyeGenerator/;
compound_ray_tpu/tools/eye_generator.py in torch).

    python -m compound_ray_tpu_torch.tools.eye_generator out.eye -n 1000
    python -m compound_ray_tpu_torch.tools.eye_generator out.eye -n 64 --device cpu

The reference relaxes N random points on the unit sphere with a
random-move + backtrack search until the per-point energy variance falls
under a cap (EquilibriumGenerator.cpp:60-120, SphericalCoordinate.cpp:25-73).
The gradient mode minimises the same Riesz s-energy

    E = sum_{i != j} 1 / |p_i - p_j|^s

by projected gradient descent in f32 torch on an explicit device (the card
by default), with its hand-written gradient, so no autograd runs.  A
`random_move` mode reproduces the reference's stochastic search in numpy;
the grid and sinewave-droplet eyes are numpy too.

Output: `.eye` rows in the current 8-field format (the reference's generator
still writes the legacy 7-field format, eyeGenerator/main.cpp:78).
"""

from __future__ import annotations

import argparse
import math
from typing import List, Optional

import numpy as np

import torch

from compound_ray_tpu_torch.scene.eye_io import Ommatidium, write_eye_file


def _sphere_random(n: int, rng: np.random.Generator) -> np.ndarray:
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def riesz_energy(points: np.ndarray, s: float = 1.0) -> float:
    d = np.linalg.norm(points[:, None, :] - points[None, :, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    return float(np.sum(1.0 / d**s) / 2.0)


def relax_gradient(
    points: np.ndarray,
    s: float = 1.0,
    iterations: int = 2000,
    lr: float = 5e-4,
    *,
    device="cuda",
) -> np.ndarray:
    """Projected gradient descent on the Riesz energy, in f32 on `device`
    (compound_ray_tpu/tools/eye_generator.py:41-66): each step moves every
    point along sum_j s (p_i - p_j) / |p_i - p_j|^(s + 2), the descent
    direction of E, then back onto the sphere, with a cosine-decayed step.
    Returns the (N, 3) float32 points on the host."""
    p = torch.as_tensor(np.asarray(points, np.float32), device=device)
    self_pair = torch.eye(p.shape[0], dtype=torch.bool, device=p.device)
    for i in range(iterations):
        lr_i = lr * (0.5 + 0.5 * math.cos(math.pi * i / iterations))
        diff = p[:, None, :] - p[None, :, :]
        d2 = torch.where(self_pair, torch.inf, (diff * diff).sum(dim=-1))
        w = s / torch.pow(d2, (s + 2.0) / 2.0)
        p = p + lr_i * (w[:, :, None] * diff).sum(dim=1)
        p = p / torch.linalg.norm(p, dim=1, keepdim=True)
    return p.cpu().numpy()


def relax_random_move(
    points: np.ndarray,
    s: float = 1.0,
    step_size: float = 1e-4,
    variance_cap: float = 1.10,
    proximity: int = 12,
    max_iterations: int = 200,
    seed: int = 42,
) -> np.ndarray:
    """The reference's stochastic relaxation: random move + backtrack on the
    proximity-truncated energy, until energy variance < cap."""
    rng = np.random.default_rng(seed)
    p = points.copy()
    n = len(p)

    def point_energy(i):
        d = np.linalg.norm(p - p[i], axis=1)
        d[i] = np.inf
        nearest = np.sort(d)[:proximity]
        return float(np.sum(1.0 / nearest**s))

    energy_var = 1.0
    avg_energy = 0.0
    for _ in range(max_iterations):
        order = rng.permutation(n)
        s_e = 0.0
        s_var = 0.0
        for i in order:
            e0 = point_energy(i)
            s_e += e0
            s_var += (e0 - avg_energy) ** 2
            old = p[i].copy()
            move = rng.normal(size=3) * step_size * energy_var
            p[i] = p[i] + move
            p[i] /= np.linalg.norm(p[i])
            if point_energy(i) > e0:
                p[i] = old  # backtrack
        avg_energy = s_e / n
        energy_var = s_var / n
        if energy_var <= variance_cap:
            break
    return p


def generate_equidistant_eye(
    n: int,
    acceptance_deg: float = 2.6,
    radius: float = 0.1,
    focal_offset: float = 0.0,
    method: str = "gradient",
    iterations: int = 2000,
    seed: int = 42,
    horizontally_acute: Optional[float] = None,
    device="cuda",
) -> List[Ommatidium]:
    """Relaxed equidistant eye; the gradient mode relaxes on `device`.

    `horizontally_acute`: optional per-ommatidium acceptance-angle scaling
    toward the horizontal band (the reference's variableDegree eyes): the
    acceptance angle is multiplied by lerp(1, horizontally_acute, |dir.y|).
    """
    rng = np.random.default_rng(seed)
    pts = _sphere_random(n, rng)
    if method == "gradient":
        pts = relax_gradient(pts, iterations=iterations,
                             device=device)
    elif method == "random_move":
        pts = relax_random_move(pts)
    else:
        raise ValueError(f"unknown method {method!r}")
    base = math.radians(acceptance_deg)
    out = []
    for d in pts:
        acc = base
        if horizontally_acute is not None:
            acc = base * (1.0 + (horizontally_acute - 1.0) * abs(float(d[1])))
        out.append(Ommatidium(d * radius, d.copy(), acc, focal_offset))
    return out


def generate_grid_eye(
    n: int,
    acceptance_deg: float = 2.6,
    separation: float = 1.0,
    focal_offset: float = 0.0,
) -> List[Ommatidium]:
    """Planar size x size grid looking straight up — the reference's
    SinesGenerator layout (eyeGenerator/SinesGenerator.cpp:15-24: positions
    (i, o, 0) at unit separation, z-up there; y-up here to match the .eye
    convention)."""
    size = int(math.sqrt(n))
    xs, zs = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    pos = np.stack([xs.ravel() * separation,
                    np.zeros(size * size),
                    zs.ravel() * separation], axis=-1)
    up = np.array([0.0, 1.0, 0.0])
    acc = math.radians(acceptance_deg)
    return [Ommatidium(p, up.copy(), acc, focal_offset) for p in pos]


def generate_sinewave_droplet_eye(
    n: int,
    acceptance_deg: float = 2.6,
    wavelength: float = 1.0,
    amplitude: float = 1.0,
    time: float = 0.0,
    scale: float = 1.0,
    focal_offset: float = 0.0,
    iterations: int = 800,
    seed: int = 42,
) -> List[Ommatidium]:
    """Eye on a radial sinewave "droplet" surface, ommatidia relaxed to
    even spacing on the base square and oriented along the exact surface
    normal.

    The reference's SinewaveDropletCoordinate
    (eyeGenerator/SinewaveDropletCoordinate.cpp:33-60) maps relaxed 2-D
    points p onto y = sin(w*|p| + t) and estimates the normal by finite
    differencing a second nearby point ("horrible quick hack" per its own
    comment); here the normal is analytic: for S(x,z) = (x, A sin(w r + t),
    z) with r = |(x,z)|, n ∝ (-A w cos(w r + t) x/r, 1, -A w cos(w r + t)
    z/r)."""
    rng = np.random.default_rng(seed)
    # stratified start (no coincident points) + radial rescale instead of a
    # hard clamp at the bounds: corner-clamping can stack points exactly on
    # top of each other, where the symmetric repulsion deadlocks at zero
    side = int(math.ceil(math.sqrt(n)))
    cells = np.stack(np.meshgrid(np.arange(side), np.arange(side),
                                 indexing="ij"), -1).reshape(-1, 2)[:n]
    p = (cells + rng.uniform(0.2, 0.8, size=(n, 2))) / side - 0.5
    lr = 0.05 / n
    max_step = 0.25 / math.sqrt(n)  # fraction of the mean point spacing
    for _ in range(iterations):
        d = p[:, None, :] - p[None, :, :]
        r2 = np.maximum(np.sum(d * d, axis=-1), 1e-6) + np.eye(n)
        f = d / (r2 ** 1.5)[..., None]
        # CAP the step: near-coincident pairs otherwise produce forces that
        # overshoot the whole domain and scatter points chaotically into
        # the bound clamp.  Tiny thermal jitter breaks exact-coincidence
        # deadlocks (coincident points repel each other with force zero).
        step = np.clip(lr * np.sum(f, axis=1), -max_step, max_step)
        p = p + step + rng.normal(scale=1e-4, size=p.shape)
        p = np.clip(p, -0.5, 0.5)
    xz = p * scale
    r = np.maximum(np.linalg.norm(xz, axis=-1), 1e-9)
    phase = wavelength * r + time
    y = amplitude * np.sin(phase)
    dydr = amplitude * wavelength * np.cos(phase)
    nx = -dydr * xz[:, 0] / r
    nz = -dydr * xz[:, 1] / r
    normal = np.stack([nx, np.ones(n), nz], axis=-1)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    acc = math.radians(acceptance_deg)
    return [
        Ommatidium(np.array([xz[i, 0], y[i], xz[i, 1]]), normal[i], acc,
                   focal_offset)
        for i in range(n)
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description="Generate a relaxed .eye file")
    ap.add_argument("output")
    ap.add_argument("-n", "--count", type=int, default=1000)
    ap.add_argument("-a", "--acceptance-deg", type=float, default=2.6)
    ap.add_argument("-r", "--radius", type=float, default=0.1)
    ap.add_argument("-f", "--focal-offset", type=float, default=0.0)
    ap.add_argument("-m", "--method",
                    choices=("gradient", "random_move", "grid",
                             "sinewave_droplet"),
                    default="gradient")
    ap.add_argument("-i", "--iterations", type=int, default=2000)
    ap.add_argument("--horizontally-acute", type=float, default=None)
    ap.add_argument("--wavelength", type=float, default=1.0)
    ap.add_argument("--amplitude", type=float, default=1.0)
    ap.add_argument("--time", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the gradient mode (default: cuda)")
    args = ap.parse_args(argv)
    if args.method == "grid":
        omms = generate_grid_eye(args.count, args.acceptance_deg,
                                 focal_offset=args.focal_offset)
    elif args.method == "sinewave_droplet":
        omms = generate_sinewave_droplet_eye(
            args.count, args.acceptance_deg, args.wavelength,
            args.amplitude, args.time, focal_offset=args.focal_offset,
            seed=args.seed,
        )
    else:
        omms = generate_equidistant_eye(
            args.count, args.acceptance_deg, args.radius, args.focal_offset,
            args.method, args.iterations, args.seed, args.horizontally_acute,
            device=args.device,
        )
    write_eye_file(args.output, omms)
    print(f"Wrote {len(omms)} ommatidia to {args.output}")


if __name__ == "__main__":
    main()
