from compound_ray_tpu_torch.parallel.sharding import (
    make_eye_mesh,
    render_means_sharded_packed,
    render_samples_sharded_packed,
)

__all__ = [
    "make_eye_mesh",
    "render_means_sharded_packed",
    "render_samples_sharded_packed",
]
