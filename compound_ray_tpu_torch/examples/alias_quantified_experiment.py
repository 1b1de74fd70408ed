"""Sampling-noise quantification (alias-demonstration/quantified-experiment.py)
on the port (examples/alias_quantified_experiment.py).

Renders a compound eye `spread_samples` times at each samples/ommatidium
setting, computes the per-ommatidium variance and standard deviation of
the repeated renders (the statistic at reference :85-138), and writes the
variance curves and, where matplotlib is installed, a plot.  This doubles
as the RNG check: the sd should fall like 1/sqrt(samples).

    python -m compound_ray_tpu_torch.examples.alias_quantified_experiment -f scene.blend
"""

import argparse
import os

import numpy as np

from compound_ray_tpu_torch.api.renderer import EyeRenderer
from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera
from compound_ray_tpu_torch.examples import add_device_argument, reference_data
from compound_ray_tpu_torch.scene.eye_io import icosphere_eye


def run(scene_path, max_samples=16, spread_samples=200, out_dir="output",
        device="cuda"):
    os.makedirs(f"{out_dir}/vector-data", exist_ok=True)
    r = EyeRenderer(verbose=False, device=device)
    r.load_gltf_scene(scene_path)
    cam = CompoundEyeCamera("alias-eye", "single_dimension_fast",
                            icosphere_eye())
    r.scene.cameras.append(cam)
    r.goto_camera(len(r.scene.cameras) - 1)
    # place the eye near (not inside) the scene geometry so ommatidia see
    # edges and depth variation: the source of sampling variance
    c = r.scene.aabb_center()
    ext = r.scene.aabb_max_extent()
    cam.set_position((c[0] + 0.25 * ext, c[1] + 0.15 * ext, c[2]))
    n = r.get_current_eye_ommatidial_count()
    r.set_render_size(n, 1)

    per_steradian = np.array([1.0 / o.solid_angle() for o in icosphere_eye()])
    avg_sd = np.zeros(max_samples)
    for idx, samples in enumerate(range(1, max_samples + 1)):
        r.set_current_eye_samples_per_ommatidium(samples)
        stack = []
        for _ in range(spread_samples):
            r.render_frame()
            stack.append(r.get_frame_pointer()[0, :, :3].astype(np.float64))
        stack = np.stack(stack)  # (spread, n, 3)
        mean_img = stack.mean(axis=0)
        diff = stack - mean_img
        var = np.sum(np.sum(diff * diff, axis=-1), axis=0) / (spread_samples - 1)
        sd = np.sqrt(var)
        np.savetxt(f"{out_dir}/vector-data/variance-{idx}-samples.txt", var,
                   delimiter=",")
        np.savetxt(f"{out_dir}/vector-data/sd-{idx}-samples.txt", sd,
                   delimiter=",")
        avg_sd[idx] = np.mean(sd * per_steradian)
        print(f"samples={samples}: mean per-steradian sd {avg_sd[idx]:.4f}")

    np.savetxt(f"{out_dir}/vector-data/avgPerImagePerSteradianSd"
               f"(0-{max_samples}samples).txt", avg_sd, delimiter=",")
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        xs = np.arange(1, max_samples + 1)
        fig, ax = plt.subplots()
        ax.plot(xs, avg_sd, marker="o")
        ax.plot(xs, avg_sd[0] / np.sqrt(xs), "--",
                label="1/sqrt(n) reference")
        ax.set(xlabel="samples per ommatidium",
               ylabel="avg per-steradian standard deviation",
               title="Sampling noise vs samples per ommatidium")
        ax.legend()
        ax.grid()
        fig.savefig(f"{out_dir}/sd-per-sample-count.png", dpi=120)
    except Exception as e:  # matplotlib optional, as in the JAX example
        print("plot skipped:", e)
    return avg_sd


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-f", "--file",
                    default=reference_data("test-scene/test-scene.gltf"))
    ap.add_argument("-m", "--max-samples", type=int, default=16)
    ap.add_argument("-n", "--spread-samples", type=int, default=200)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    return run(args.file, args.max_samples, args.spread_samples,
               device=args.device)


if __name__ == "__main__":
    main()
