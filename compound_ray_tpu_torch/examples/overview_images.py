"""Render overview images from every camera in a scene
(python-examples/overview-images workflow) on the port
(examples/overview_images.py): one PPM per camera, with compound eyes
rendered through their configured projection at a chosen sample rate.

    python -m compound_ray_tpu_torch.examples.overview_images -f scene.blend
"""

import argparse
import os

from compound_ray_tpu_torch.api.renderer import EyeRenderer
from compound_ray_tpu_torch.examples import add_device_argument


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-f", "--file", required=True)
    ap.add_argument("-W", "--width", type=int, default=512)
    ap.add_argument("-H", "--height", type=int, default=256)
    ap.add_argument("-s", "--samples", type=int, default=64)
    ap.add_argument("-o", "--out-dir", default="overview-images")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    r = EyeRenderer(verbose=False, device=args.device)
    r.load_gltf_scene(args.file)
    r.set_render_size(args.width, args.height)
    written = []
    for i in range(r.get_camera_count()):
        r.goto_camera(i)
        name = r.get_current_camera_name()
        if r.is_compound_eye_active():
            r.set_current_eye_samples_per_ommatidium(args.samples)
        ms = r.render_frame()
        out = os.path.join(args.out_dir, f"{i:02d}-{name}.ppm")
        r.save_frame_as(out)
        written.append(out)
        print(f"{name}: {ms:.1f} ms -> {out}")
    return written


if __name__ == "__main__":
    main()
