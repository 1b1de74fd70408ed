"""Aliased-to-unaliased sweep image
(alias-demonstration/viewpoint-experiment.py) on the port
(examples/alias_viewpoint_experiment.py).

Renders the spherical compound projection once per samples-per-ommatidium
setting (1..segments) and stitches column i of the i-sample render into
one PPM: the sampling noise anneals from left (1 sample, aliased) to right
(many samples, converged), the reference's qualitative companion to the
quantified variance experiment (reference :47-65).

    python -m compound_ray_tpu_torch.examples.alias_viewpoint_experiment -f scene.blend
"""

import argparse
import os

import numpy as np

from compound_ray_tpu_torch.api.renderer import EyeRenderer
from compound_ray_tpu_torch.examples import add_device_argument, reference_data


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-f", "--file",
                    default=reference_data("natural-standin-sky.gltf"))
    ap.add_argument("-c", "--camera", default="insect-eye-spherical-projector")
    ap.add_argument("-W", "--width", type=int, default=700)
    ap.add_argument("-H", "--height", type=int, default=300)
    ap.add_argument("-s", "--segments", type=int, default=700,
                    help="number of sample settings (and image columns used)")
    ap.add_argument("-o", "--out",
                    default="artifacts/alias-viewpoint-sweep.ppm")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    r = EyeRenderer(verbose=False, device=args.device)
    r.load_gltf_scene(args.file)
    r.set_render_size(args.width, args.height)
    r.goto_camera_by_name(args.camera)

    seg_w = args.width // args.segments
    combined = np.zeros((args.height, args.width, 3), np.uint8)
    for idx in range(args.segments):
        r.set_current_eye_samples_per_ommatidium(idx + 1)
        r.render_frame()
        frame = r.get_frame_pointer()[::-1, :, :3]  # flip: row 0 = top
        x0 = idx * seg_w
        combined[:, x0:x0 + seg_w, :] = frame[:, x0:x0 + seg_w, :]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    h, w = combined.shape[:2]
    with open(args.out, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(combined).tobytes())
    print(f"wrote {args.out} ({args.segments} sample settings)")
    r.stop()
    return combined


if __name__ == "__main__":
    main()
