from compound_ray_tpu_torch.trace.cluster_tracer import (
    cluster_tracer_reference,
    run_tracer_kernel,
)
from compound_ray_tpu_torch.trace.mm_tracer import (
    packed_tracer_reference,
    run_packed_tracer,
)

__all__ = ["cluster_tracer_reference", "packed_tracer_reference",
           "run_packed_tracer", "run_tracer_kernel"]
