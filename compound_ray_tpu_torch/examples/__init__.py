"""The repository's eight examples (examples/*.py) on the port, each run as

    python -m compound_ray_tpu_torch.examples.primary_example
    python -m compound_ray_tpu_torch.examples.speed_test -f scene.blend
    python -m compound_ray_tpu_torch.examples.plot_speed_test *.txt
    python -m compound_ray_tpu_torch.examples.alias_quantified_experiment -f scene.blend
    python -m compound_ray_tpu_torch.examples.alias_viewpoint_experiment -f scene.blend
    python -m compound_ray_tpu_torch.examples.heterogeneous_demonstration -f scene.blend
    python -m compound_ray_tpu_torch.examples.overview_images -f scene.blend
    python -m compound_ray_tpu_torch.examples.position_estimation

with the JAX examples' arguments, defaults, file names and output formats.
Every example that renders takes --device, the card by default (a host
without one raises, as EyeRenderer does).  The scenes and eyes the JAX
examples name by default sit in a CompoundRay checkout's data directory:
here under $CR_REFERENCE_DATA (default reference/data).  Scenes may be
glTF or .blend.
"""

from __future__ import annotations

import os


def reference_data(rel: str) -> str:
    """`rel` under the reference data directory ($CR_REFERENCE_DATA)."""
    return os.path.join(os.environ.get("CR_REFERENCE_DATA", "reference/data"),
                        rel)


def add_device_argument(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: the card)")
