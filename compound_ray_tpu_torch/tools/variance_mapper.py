"""Per-ommatidium sampling-variance mapping (data/tools/varianceMapper.py).

Renders the current compound eye repeatedly at a given sample rate over a
grid of poses and records the per-ommatidium standard deviation — the
statistical self-test the reference uses to validate RNG/averaging
(SURVEY.md §4: alias-demonstration/quantified-experiment.py:85-138).

On the port's EyeRenderer (compound_ray_tpu/tools/variance_mapper.py):
`main` renders on --device, the card by default.

    python -m compound_ray_tpu_torch.tools.variance_mapper -f scene.gltf -g 2
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np

from compound_ray_tpu_torch.api.renderer import EyeRenderer


def camera_data_stack(renderer: EyeRenderer, repeat: int) -> np.ndarray:
    """(repeat, N, 3) float32 stack of getCameraData over repeated renders."""
    out = []
    for _ in range(repeat):
        renderer.render_frame()
        out.append(renderer.get_camera_data().copy())
    return np.stack(out)


def per_ommatidium_sd(renderer: EyeRenderer, samples: int, repeat: int) -> np.ndarray:
    renderer.set_current_eye_samples_per_ommatidium(samples)
    stack = camera_data_stack(renderer, repeat)
    return stack.std(axis=0).max(axis=-1)  # (N,) worst channel sd


def map_variance_over_grid(
    renderer: EyeRenderer,
    positions: List[Tuple[float, float, float]],
    samples: int = 32,
    repeat: int = 8,
) -> np.ndarray:
    """(P, N) per-position per-ommatidium sd map."""
    rows = []
    for pos in positions:
        renderer.set_camera_position(*pos)
        rows.append(per_ommatidium_sd(renderer, samples, repeat))
    return np.stack(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-f", "--file", required=True)
    ap.add_argument("-s", "--samples", type=int, default=32)
    ap.add_argument("-r", "--repeat", type=int, default=8)
    ap.add_argument("-g", "--grid", type=int, default=3,
                    help="grid points per axis across the scene AABB")
    ap.add_argument("-o", "--output", default="variance_map.npy")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    args = ap.parse_args(argv)

    r = EyeRenderer(verbose=False, device=args.device)
    r.load_gltf_scene(args.file)
    for i in range(r.get_camera_count()):
        r.goto_camera(i)
        if r.is_compound_eye_active():
            break
    lo, hi = r.scene.aabb_min, r.scene.aabb_max
    axes = [np.linspace(lo[d], hi[d], args.grid) for d in range(3)]
    positions = [(x, y, z) for x in axes[0] for y in axes[1] for z in axes[2]]
    vmap = map_variance_over_grid(r, positions, args.samples, args.repeat)
    np.save(args.output, vmap)
    print(f"Wrote {args.output}: shape {vmap.shape}, "
          f"max sd {vmap.max():.4f}, mean sd {vmap.mean():.4f}")
    return vmap


if __name__ == "__main__":
    main()
