"""Minimum sample-rate finder (data/tools/minimumSampleRateFinder.py).

Protocol (reference :25-291): swap the scene's compound eye for the
12-ommatidium icosphere eye, search camera poses (random restarts + local
refinement standing in for the reference's genetic algorithm) for the pose
of maximum frame-to-frame visual variance, then ramp samples/ommatidium
until the maximum per-ommatidium standard deviation of repeated renders
falls below cutoff_percent of the colour-space diagonal.

Works against the EyeRenderer API directly (or the ctypes shim).

On the port's EyeRenderer (compound_ray_tpu/tools/
minimum_sample_rate_finder.py): `run` and `main` render on --device,
the card by default.

    python -m compound_ray_tpu_torch.tools.minimum_sample_rate_finder -f scene.gltf
"""

from __future__ import annotations

import argparse
import math
from typing import Optional, Tuple

import numpy as np

from compound_ray_tpu_torch.api.renderer import EyeRenderer
from compound_ray_tpu_torch.scene.eye_io import icosphere_eye, ommatidia_to_array


def variance_of_repeated_renders(
    renderer: EyeRenderer, samples_per_omm: int, repeat: int
) -> np.ndarray:
    """Per-ommatidium variance of `repeat` renders at the given sample rate,
    over uint8 frame rows (the reference's magnitude-squared statistic)."""
    renderer.set_current_eye_samples_per_ommatidium(samples_per_omm)
    frames = []
    for _ in range(repeat):
        renderer.render_frame()
        frames.append(renderer.get_frame_pointer()[0, :, :3].astype(np.float64))
    stack = np.stack(frames)  # (repeat, n_omms, 3)
    diff = stack - stack.mean(axis=0)
    mag2 = np.sum(diff * diff, axis=-1)
    return np.sum(mag2, axis=0) / max(repeat - 1, 1)


def find_max_variance_pose(
    renderer: EyeRenderer,
    bounds_min,
    bounds_max,
    n_candidates: int = 20,
    repeat: int = 4,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Random search for the pose of maximum render variance."""
    rng = np.random.default_rng(seed)
    best = (-1.0, None, None)
    for _ in range(n_candidates):
        pos = rng.uniform(bounds_min, bounds_max)
        rot = rng.uniform(0, 2 * math.pi, 3)
        renderer.set_camera_pose(*pos, *rot)
        var = variance_of_repeated_renders(renderer, 1, repeat)
        spread = float(np.sqrt(var.max()))
        if spread > best[0]:
            best = (spread, pos, rot)
    return best[1], best[2], best[0]


def find_minimum_samples(
    renderer: EyeRenderer,
    cutoff_percent: float = 0.01,
    repeat: int = 8,
    max_samples: int = 10000,
) -> Tuple[int, list]:
    """Ramp samples/omm until max per-ommatidium sigma < cutoff."""
    sd_limit = cutoff_percent * np.linalg.norm([255.0] * 3)
    sds = []
    s = 1
    while s <= max_samples:
        var = variance_of_repeated_renders(renderer, s, repeat)
        max_sd = float(np.sqrt(var.max()))
        sds.append((s, max_sd))
        if max_sd < sd_limit:
            return s, sds
        s = s + 1 if s < 8 else int(s * 1.5)
    return max_samples, sds


def run(
    gltf_path: str,
    cutoff_percent: float = 0.01,
    n_candidates: int = 10,
    repeat: int = 6,
    verbose: bool = True,
    bounds: Optional[Tuple] = None,
    device="cuda",
):
    r = EyeRenderer(verbose=False, device=device)
    r.load_gltf_scene(gltf_path)
    # find a compound eye
    found = False
    for i in range(r.get_camera_count()):
        r.goto_camera(i)
        if r.is_compound_eye_active():
            found = True
            break
    if not found:
        raise RuntimeError("no compound eye in scene")

    # swap in the icosphere eye, fast vector projection
    ico = ommatidia_to_array(icosphere_eye())
    r.set_ommatidia(ico)
    r.set_current_eye_shader_name("single_dimension_fast")
    n = r.get_current_eye_ommatidial_count()
    r.set_render_size(n, 1)

    if bounds is None:
        bounds = (r.scene.aabb_min, r.scene.aabb_max)
    pos, rot, spread = find_max_variance_pose(
        r, bounds[0], bounds[1], n_candidates, repeat
    )
    if verbose:
        print(f"Highest deviation found: {spread}")
    r.set_camera_pose(*pos, *rot)
    min_samples, sds = find_minimum_samples(r, cutoff_percent, repeat)
    if verbose:
        for s, sd in sds:
            print(f"Standard deviation at {s} samples/ommatidium: {sd}")
        print(f"Suggested minimum samples is {min_samples} samples per steradian, "
              f"with a maximal sd of {sds[-1][1]}.")
    return min_samples, sds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-f", "--file", required=True, help="glTF scene path")
    ap.add_argument("-c", "--cutoff-percent", type=float, default=0.01)
    ap.add_argument("-n", "--candidates", type=int, default=10)
    ap.add_argument("-r", "--repeat", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    args = ap.parse_args(argv)
    return run(args.file, args.cutoff_percent, args.candidates, args.repeat,
               device=args.device)


if __name__ == "__main__":
    main()
