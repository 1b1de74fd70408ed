from compound_ray_tpu_torch.trace.cluster_tracer import (
    cluster_tracer_reference,
    run_tracer_kernel,
)
from compound_ray_tpu_torch.trace.intersect import intersect_rays
from compound_ray_tpu_torch.trace.mm_tracer import (
    packed_tracer_reference,
    run_packed_tracer,
)
from compound_ray_tpu_torch.trace.shade import make_color, shade_rays

__all__ = ["cluster_tracer_reference", "intersect_rays", "make_color",
           "packed_tracer_reference", "run_packed_tracer",
           "run_tracer_kernel", "shade_rays"]
