"""Frame-rate sweep (python-examples/speedTest.py + speed-test/speedTest.py)
on the port (examples/speed_test.py).

Protocol (reference speed-test/speedTest.py:80-134): switch to a compound
eye, load a 1000-ommatidium equidistant eye (or, where the .eye file is
absent, make_sphere_eye(1000, 2.6 degrees)), single_dimension_fast shader,
render size (ommatidia x 1), warm up, then average frame time over N frames
at each samples-per-ommatidium setting.  Writes the same result files:
`<label>-frame-rendertime-averages-(...).txt` with one mean frame time (ms)
per line, plus an FPS variant.  The label defaults to the device's name
(the card's, or "cpu") and the default scene's.

    python -m compound_ray_tpu_torch.examples.speed_test -f scene.blend
"""

import argparse
import os
import time

import numpy as np
import torch

from compound_ray_tpu_torch.api.renderer import EyeRenderer
from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera
from compound_ray_tpu_torch.examples import add_device_argument, reference_data
from compound_ray_tpu_torch.scene.eye_io import read_eye_file
from compound_ray_tpu_torch.testing import make_sphere_eye


def device_label(device) -> str:
    """The device's name for result files: the card's (spaces as
    underscores), or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device).replace(" ", "_")


def run_sweep(scene_path, eye_path, samples_list, frames, warmup_s, label,
              device="cuda"):
    r = EyeRenderer(verbose=False, device=device)
    r.load_gltf_scene(scene_path)

    if eye_path and os.path.isfile(eye_path):
        omms = read_eye_file(eye_path)
    else:
        omms = make_sphere_eye(1000, acceptance_deg=2.6)
    cam = CompoundEyeCamera("speed-eye", "single_dimension_fast", omms)
    r.scene.cameras.append(cam)
    r.goto_camera(len(r.scene.cameras) - 1)
    center = r.scene.aabb_center()
    cam.set_position((center[0], center[1] + 1.0, center[2]))
    n = r.get_current_eye_ommatidial_count()
    r.set_render_size(n, 1)

    # warm-up (kernel builds + plans)
    t0 = time.time()
    while time.time() - t0 < warmup_s:
        r.render_frame()

    means, fps = [], []
    for s in samples_list:
        r.set_current_eye_samples_per_ommatidium(s)
        r.render_frame()  # shape-change warmup
        times = [r.render_frame() for _ in range(frames)]
        m = float(np.mean(times))
        means.append(m)
        fps.append(1000.0 / m)
        print(f"samples={s}: {m:.3f} ms/frame, {1000.0/m:.1f} FPS, "
              f"{n * s / (m / 1000.0):.3e} rays/s")

    lo, hi = samples_list[0], samples_list[-1]
    base = f"{label}-frame-rendertime"
    np.savetxt(f"{base}-averages-({lo}-{hi}-rays,{frames}-samples).txt",
               np.asarray(means))
    np.savetxt(f"{base}-average-FPSs-({lo}-{hi}-rays,{frames}-samples).txt",
               np.asarray(fps))
    return means


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-f", "--file",
                    default=reference_data("natural-standin-sky.gltf"))
    ap.add_argument("-e", "--eye",
                    default=reference_data("eyes/1000-equidistant.eye"))
    ap.add_argument("-s", "--samples", type=int, nargs="+",
                    default=[1, 10, 100, 1000, 3200])
    ap.add_argument("-n", "--frames", type=int, default=50)
    ap.add_argument("-w", "--warmup", type=float, default=10.0)
    ap.add_argument("-l", "--label", default=None,
                    help="result-file label (default: <device name>-natural)")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    label = args.label or f"{device_label(args.device)}-natural"
    return run_sweep(args.file, args.eye, args.samples, args.frames,
                     args.warmup, label, device=args.device)


if __name__ == "__main__":
    main()
