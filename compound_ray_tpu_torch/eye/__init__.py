from compound_ray_tpu_torch.eye.pipeline import render_means
from compound_ray_tpu_torch.eye.render import (
    render_compound_means,
    render_compound_samples,
)
from compound_ray_tpu_torch.eye.sampling import ommatidial_rays

__all__ = ["ommatidial_rays", "render_compound_means",
           "render_compound_samples", "render_means"]
