"""Heterogeneous acceptance-angle demonstration
(heterogeneous-demonstration/demonstration.py) on the port
(examples/heterogeneous_demonstration.py).

Renders one scene through three eyes (homogeneous small acceptance,
homogeneous large, and per-ommatidium variable, "horizontally acute") and
saves spherical-projection PPMs for visual comparison, the reference's
golden-image workflow (SURVEY.md section 4).

    python -m compound_ray_tpu_torch.examples.heterogeneous_demonstration -f scene.blend
"""

import argparse
import os

from compound_ray_tpu_torch.api.renderer import EyeRenderer
from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera
from compound_ray_tpu_torch.examples import add_device_argument, reference_data
from compound_ray_tpu_torch.scene.eye_io import Ommatidium, read_eye_file
from compound_ray_tpu_torch.testing import make_sphere_eye


def variable_acceptance_eye(n=1000, base_deg=2.6, factor=4.0):
    """Acceptance angle grows toward the poles (vertical |dir.y|)."""
    omms = make_sphere_eye(n, acceptance_deg=base_deg)
    out = []
    for o in omms:
        scale = 1.0 + (factor - 1.0) * abs(float(o.direction[1]))
        out.append(Ommatidium(o.position, o.direction,
                              o.acceptance_angle * scale, o.focal_point_offset))
    return out


def render_eye(renderer, omms, name, samples, width, height, n_frames=5):
    cam = renderer.current_camera()
    cam.set_ommatidia(omms)
    renderer.set_current_eye_samples_per_ommatidium(samples)
    renderer.set_render_size(width, height)
    for i in range(n_frames):
        renderer.render_frame()
        renderer.save_frame_as(f"{name}-{i}.ppm")
    renderer.render_frame()
    renderer.save_frame_as(f"{name}.ppm")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-f", "--file",
                    default=reference_data("natural-standin-sky.gltf"))
    ap.add_argument("-s", "--samples", type=int, default=32)
    ap.add_argument("-W", "--width", type=int, default=256)
    ap.add_argument("-H", "--height", type=int, default=128)
    ap.add_argument("-e", "--variable-eye", default=None,
                    help=".eye file with per-ommatidium acceptance angles")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    r = EyeRenderer(verbose=False, device=args.device)
    r.load_gltf_scene(args.file)
    cam = CompoundEyeCamera(
        "het-eye", "spherical_orientationwise", make_sphere_eye(1000)
    )
    r.scene.cameras.append(cam)
    r.goto_camera(len(r.scene.cameras) - 1)

    render_eye(r, make_sphere_eye(1000, acceptance_deg=1.0),
               "homogeneous-omms-small", args.samples, args.width, args.height)
    render_eye(r, make_sphere_eye(1000, acceptance_deg=8.0),
               "homogeneous-omms-big", args.samples, args.width, args.height)
    if args.variable_eye and os.path.isfile(args.variable_eye):
        var_eye = read_eye_file(args.variable_eye)
    else:
        var_eye = variable_acceptance_eye()
    render_eye(r, var_eye, "heterogeneous-omms",
               args.samples, args.width, args.height)
    print("Wrote homogeneous/heterogeneous PPM sets.")


if __name__ == "__main__":
    main()
