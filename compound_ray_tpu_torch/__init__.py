"""CompoundRay on PyTorch and CUDA: the port of compound_ray_tpu.

The compound-eye frame (EyeRenderer.render_frame: unlit with or without the
far-field radiance cache, or lit with GGX light and shadow rays; raw
samples; the eight compound projections into a display buffer) and the
real cameras' images (perspective, panoramic, orthographic) run on one
torch device, through EyeRenderer or its libEyeRenderer3-shaped ctypes shim
(load_eye_renderer).  Its three tracers are CUDA kernels written for Hopper
and built with nvcc at first use: K1 closest hit (csrc/packed_tracer.cu),
K2 the cluster-shortlist closest hit of the far-field cache and the camera
image (csrc/cluster_tracer.cu) and K3 the shadow rays' any-hit occlusion
(csrc/rows_occlusion.cu); a fourth, the per-triangle cone refine, plans
each pose's payload (csrc/refine_mask.cu).  The brute-force oracle (trace/intersect.py,
eye/render.py, cameras/raygen.py) is plain torch on every device.  On CPU
tensors the same contracts run as plain torch.  The kernel-measurement
tools (compound_ray_tpu_torch.tools) add the probes of K1's row step
(csrc/probe_step.cu) and the skinny-K dot bench (csrc/microbench_k.cu).
The package imports torch and numpy, never JAX or the JAX package.
"""

__version__ = "0.1.0"

from compound_ray_tpu_torch.api.renderer import EyeRenderer
from compound_ray_tpu_torch.api.shim import load_eye_renderer
from compound_ray_tpu_torch.trace.cluster_tracer import (
    cluster_tracer_reference,
    run_tracer_kernel,
)
from compound_ray_tpu_torch.trace.mm_tracer import (
    packed_tracer_reference,
    rows_occlusion_reference,
    run_packed_tracer,
    run_rows_occlusion,
)

__all__ = ["EyeRenderer", "cluster_tracer_reference", "load_eye_renderer",
           "packed_tracer_reference", "rows_occlusion_reference",
           "run_packed_tracer", "run_rows_occlusion", "run_tracer_kernel"]
