"""Chip check of the PyTorch/CUDA port (compound_ray_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main path, EyeRenderer.render_frame, at the reference
speed-test size: make_big_scene(n_boxes=2000, seed=0) (24,012 triangles,
256 clusters), a 1000-ommatidium sphere eye at 2.6 degrees, the bench pose
(last camera at the scene AABB centre + 1 in y; bench.py), with the
far-field cache off (100 and 3200 samples per ommatidium), on (3200
samples: a 1024 x 512 cache rendered by K2), on with the sky split (3200
samples), and lit (3200 samples, the four default lights: K1 and the
shadow rays on K3); then the kernel-measurement tools' path, the probes
(K4, K5, and K1 for real_bary) and the skinny-K dot bench (K6), at the
tools' full sizes; then the API surface through the ctypes shim at 640 x
480 (raw samples, the eight projections, pipelined frames); then the real
cameras at 640 x 480 and the brute-force oracle; then bursts, pose
batches, the eye tools and the viewer; then the bench scene written as a
.blend and the eight examples on it; then the sharded path over ranks;
then the render modes (affine rays, the sphere refine, backend "xla");
then the planning refine at the pose sweep's shapes; then the unlit
shading and the ray generation kernels at the benchmark's three steady
unlit cells' shapes; then the far-field cache's cull and shortlist at
the meadow's and the natural field's.
Phases, each failing loudly:
  1. a CUDA device is required; print the card's name and power limit;
  2. build K1 (csrc/packed_tracer.cu), K2 (csrc/cluster_tracer.cu), K3
     (csrc/rows_occlusion.cu), K4 and K5 (csrc/probe_step.cu) and K6
     (csrc/microbench_k.cu), the planning refine (csrc/refine_mask.cu),
     the unlit shading (csrc/shade_means.cu), ray generation
     (csrc/ray_features.cu) and the cache's cull and shortlist
     (csrc/cache_cull.cu) with nvcc for sm_90a, one process per source,
     started together;
  3. K1 against its torch twin at the frames' real shapes (the dense pack
     and the near-clusters pack of the cache frame), and K3 against its
     twin on the first lit frame's own shadow table and rays, which the
     frame hands over with live_feats 4; each with its rays per thread, K3
     with its pair tests, the tests its warps issue and their lane
     efficiency;
  4. K2 against its torch twin at the bench cache's real shapes, bit for
     bit with the early exit on and off, with the pair tests it walks;
  5. the four paths through EyeRenderer(device="cuda"), with the launch
     counts set to 0 before each and read after it;
  6. each path's frame against a reference: the twin-rendered frames, the
     direct frame for the cache, the dense cache frame for the sky split,
     the unlit frame for the lit one, and small scenes on the card against
     the CPU;
  7. K4 and K5 against their twin in every mode at the probe tool's shape,
     then the K1 step split they give (every K4 mode, K5 and K1 timed alike,
     with the probe's rays per thread and what ptxas said of each instance);
     K6 against its twin at each swept (K, N, precision) with 4000 steps,
     and one batched torch.matmul over the same bf16 products as a
     yardstick; then both tools' main() with the launch counts set to 0 before and
     read after;
  8. the API surface through the ctypes shim (load_eye_renderer) on the
     bench eye at 640 x 480, counted as a path: raw samples (K1) against
     the K1 twin and their mean against the means frame, the eight
     projections on the card against the CPU, render_frames_pipelined
     against synced frames, the frame buffer and PPM, and the host syncs
     one unsynced frame issues;
  9. real cameras and the oracle: a perspective (60 degrees of y field of
     view), a panoramic and an orthographic camera on the bench scene at
     640 x 480 through the shim, counted as a path (the tile-culled image,
     one K2 launch per frame), each against the brute-force oracle's image
     on the card; K2 against its twin on the pinhole image's own inputs,
     bit for bit, with its pair tests; each kind on the card against the
     CPU at 64 x 48, and the lit pinhole through the oracle; the packed lit
     frame (K1, K3) against the oracle on the canopy scene and the bench
     eye; lit raw samples through the oracle at 100 samples against their
     means frame; the oracle's time at its chosen ray chunk and at 512; and
     the host syncs of one unsynced pinhole frame;
 10. bursts, pose batches, the eye tools and the viewer, counted as a path:
     render_frames_pipelined at 1 x 256, 100 x 10 and lit 100 x 10 samples
     x frames (stacked: one K1 launch, K3 once when lit) and 3200 x 10
     (scanned), each against as many render_frame() calls (bit-equal or
     within BURST_ATOL), timed against the synced frames and the per-frame
     loop, with its launches and host syncs (the path's launches must be
     exactly those of its sections), and, after the path, a stacked
     burst's K1 on its own inputs against the twin and against the
     single-frame layout;
     render_batch_poses over 20 poses at 100 samples against synced
     set-pose frames and the unsynced pose stream, the batch of a 1e-5
     degree copy of the eye against its frames, the device memory after
     50 more batches (held to the pack store's byte bound and the eye
     plans' copies), one 100-pose batch with its pack's bytes and peak
     memory, and steady frames at the bench pose served from the store;
     relax_gradient on the card against the CPU, the variance mapper and
     the sample-rate finder on the card, and five viewer ticks with keys
     held;
 11. the bench scene written as a .blend (one object per box under its
     own object matrix, a node material each; the bench eye by a relative
     .eye path, a panoramic, a perspective and an orthographic camera) and
     gzipped, counted as a path: loaded through the shim's loadGlTFscene,
     its compound eye's frames at 100 and 3200 samples with the far field
     off and "auto", lit, its three cameras at 640 x 480, the gzipped
     file's frame, and each of the eight examples' main on it (their
     defaults but for EXAMPLE_ARGS); after the path, its triangles against
     make_big_scene's, each frame against its twin-rendered frame, the lit
     frame against the unlit one, each camera against the oracle, and K3
     against its twin on the .blend's first lit frame;
 12. the sharded path (parallel/sharding.py): A, a world of one NCCL rank
     in this process, whose (1, 1) mesh frame at 3200 samples must equal
     render_means bit for bit, counted as a path; B, four gloo ranks of
     this script (--shard-rank; NCCL rejects two ranks on one card)
     sharing the card on a (2, 2) mesh, each an EyeRenderer at backend
     "auto" that must take the "sharded" route: frames at 3200 samples
     with the far field off, on (K2) and lit (K3 on the shard-major shadow
     table), raw samples at 100 and 100 x 10 bursts, their launches added
     to the kernel table; every rank's results bit-equal, rank 0's against
     the dense frames of this process on the same seeds (2e-6 unlit, 2e-5
     lit and raw samples), each burst frame against its sequential sharded
     frame, K3 against its twin on each shard's block of the table, the
     frames' and the collectives' times;
 13. the render modes on a fresh bench renderer: K1's 8-feature affine
     form against its twin at 3200 samples (far field off and on, the
     16-feature thresholds); counted as a path, affine_rays at 3200
     samples with the far field off (standard and affine frames in turns),
     on (the first builds the cache), lit and raw, an affine 128 x 10
     burst (each affine frame launching the 8-feature K1, never the
     16-feature one), refine_mode "sphere" and "exact" frames, and
     backend "xla" at 100 and 3200 samples (no kernel); after the path,
     affine against standard frames (2e-3, mean 2e-5; lit 5e-5), raw
     samples (> 99.9 % within 2e-3), the burst against its frames, an
     affine (2, 2) mesh plan's shard cores against the dense affine frame
     (2e-5), sphere against exact (2e-5 on a 1e-5 degree copy of the eye;
     the jittered rule at 2.6 degrees) with both packs' rows, and "xla"
     at 100 samples against the oracle on its generator (1e-5);
 14. the planning refine (csrc/refine_mask.cu) at the natural-1000 pose
     sweep's shapes (testing.natural_sweep: 100 samples, two ommatidia a
     group, the exact refine): counted as a path, REFINE_VIEWS new sweep
     poses through render_frame, each view's refine launches equal to the
     chunks of its one planning pass (1 at one chunk); then at the
     configuration's pose and REFINE_POSES seeded sweep poses, chunk by
     chunk as the pack calls it: row counts and keys bit-equal to the
     twin, each pose's kernel time and the twin's (CUDA events), the bound
     (REFINE_*_OPS, slot tables read once), and each pose's one-pass plan
     (it measures its widths and packs) through the kernel and through
     the twin;
 15. the unlit shading and means (csrc/shade_means.cu) at the shapes of
     the benchmark's steady cells ofstad-1000.steady-s3200,
     natural-1000.steady-s3200 and natural-acute-10k.steady-s320, each
     built from its configuration and traffic files by the benchmark's
     own generators and system (the arena exists only there): a counted
     path of SHADE_FRAMES frames through render_frame (one shading, one
     ray generation and one K1 launch a frame), the last frame's shading
     inputs through the kernel and the twin (max 1e-4, mean 1e-6), the
     kernel's device time (torch.profiler), its wrapper's and the twin's
     (CUDA events), and its bytes bound; then the ray generation kernel
     (csrc/ray_features.cu) on the last frame's angles: rays and origins
     bit-equal to the twin, its device time over SHADE_REPS launches, its
     wrapper's and the twin's, and its bytes bound;
 16. the far-field cache's cull and shortlist (csrc/cache_cull.cu) on the
     cache inputs of the meadow cell (its configuration's pose: 8,192
     tiles, ~7,150 clusters past D) and of natural-1000 (the steady cells'
     cache): counts, ids and dmin bit-equal to the twin, the kernel's
     device time (torch.profiler, over CULL_REPS launches), its wrapper's
     (with the per-cluster terms) and the twin's (CUDA events), and its
     bound.
Every counted path reports the refine's, the shading's, ray generation's
and the cull's launches with the kernels'; every cache build of a counted
path launches the cull once, nothing else does; the lit path's first
frame (and
a frame after a corrective replan) refines, its other frames never; every
unlit means frame of paths a-c launches the shading kernel once, lit
frames never; every frame core and shadow probe of a counted path
launches the ray generation kernel once (_RayUsers), and in phase 10 and
phase 12 B's sections each K1 launch follows one.
The last lines are the kernel table (each kernel's launches, error, time,
plain time and bound; the refine's launches are its sweep path's, the
shading's those of every counted path; a
kernel timed under its bound fails the run), the card and {"ok": true,
"device": ...}.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from compound_ray_tpu_torch.tools import time_ms

N_BOXES = 2000
N_OMM = 1000
ACCEPT_DEG = 2.6
SAMPLES = (100, 3200)
WARMUP, TIMED = 3, 5
SLOT_AGREE = 0.999  # kernel vs twin: winners equal on this share of live rays
T_RTOL = 1e-5  # kernel vs twin: t where the winners agree
MEANS_ATOL = 2e-4  # frame means, kernels vs twins and card vs CPU
# cache vs direct frame and sky vs dense frame, mean abs over the means
# (the bound of tests/test_pallas_tracer.py:219-220)
CACHE_MEAN_ABS = 0.02
K1_REPLACES = "compound_ray_tpu/trace/mm_tracer.py:1078"
K1_SOURCE = "compound_ray_tpu_torch/csrc/packed_tracer.cu"
K2_REPLACES = "compound_ray_tpu/trace/pallas_tracer.py:420"
K2_SOURCE = "compound_ray_tpu_torch/csrc/cluster_tracer.cu"
K3_REPLACES = "compound_ray_tpu/trace/mm_tracer.py:970"
K3_SOURCE = "compound_ray_tpu_torch/csrc/rows_occlusion.cu"
# K3 vs twin: decisions equal on this share of live shadow rays (the kernel
# sums in the twin's order without FMAs, so 100 % is expected)
K3_AGREE = 0.9999
# the rays each thread of K1, K3 and the probes holds, as
# csrc/packed_tracer.cu (kRaysPerThread), csrc/rows_occlusion.cu (one per
# thread) and csrc/probe_step.cu (kRaysPerThread) fix them
K1_RAYS_PER_THREAD = 2
K3_RAYS_PER_THREAD = 1
K45_RAYS_PER_THREAD = 2
K4_REPLACES = "tools/probe_step.py:141"
K5_REPLACES = "tools/probe_step.py:216"
K45_SOURCE = "compound_ray_tpu_torch/csrc/probe_step.cu"
PROBE_REPS = 20  # timed launches of each probe entry of the step split
K6_REPLACES = "tools/microbench_k.py:59"
K6_SOURCE = "compound_ray_tpu_torch/csrc/microbench_k.cu"
# phase 14: the planning refine, which replaces no Pallas kernel (XLA fused
# the eager chain); it runs at the natural-1000 pose sweep's shapes: a
# counted path of REFINE_VIEWS sweep views through render_frame, then the
# checks and times at the configuration's pose and REFINE_POSES seeded
# poses of the sweep's region
REFINE_REPLACES = ("no Pallas counterpart (XLA-fused chain at "
                   "compound_ray_tpu/eye/pipeline.py:486)")
REFINE_SOURCE = "compound_ray_tpu_torch/csrc/refine_mask.cu"
# phase 15: the frame core's unlit shading and means, which replaces no
# Pallas kernel (XLA fused the eager chain); it runs at the shapes of the
# benchmark's three steady unlit cells, built by the benchmark's own
# scene, eye and system code from its configuration and traffic files
SHADE_REPLACES = ("no Pallas counterpart (XLA-fused shading at "
                  "compound_ray_tpu/eye/pipeline.py:1191-1545)")
SHADE_SOURCE = "compound_ray_tpu_torch/csrc/shade_means.cu"
SHADE_CELLS = (("ofstad-1000", "steady-s3200"),
               ("natural-1000", "steady-s3200"),
               ("natural-acute-10k", "steady-s320"))
SHADE_FRAMES = 8  # the counted path's frames per cell
SHADE_REPS = 20
SHADE_SEED = 2**31 + 19
SHADE_MAX_ABS, SHADE_MEAN_ABS = 1e-4, 1e-6
# phase 15 too: the frame core's ray generation, which replaces no Pallas
# kernel (XLA fused the eager chain), at the same cells' shapes: rays and
# origins bit-equal to the twin's
RAYGEN_REPLACES = ("no Pallas counterpart (XLA-fused ray generation at "
                   "compound_ray_tpu/eye/pipeline.py:1036-1100)")
RAYGEN_SOURCE = "compound_ray_tpu_torch/csrc/ray_features.cu"
# phase 16: the far-field cache's cull and shortlist, which replaces no
# Pallas kernel (XLA fused the cull, jnp.argsort sorted), on the cache
# inputs of the meadow's and natural-1000's configuration poses
CULL_REPLACES = ("no Pallas counterpart (XLA-fused cull and jnp.argsort at "
                 "compound_ray_tpu/eye/pipeline.py:3093-3151)")
CULL_SOURCE = "compound_ray_tpu_torch/csrc/cache_cull.cu"
CULL_CELLS = ("meadow-1000", "natural-1000")
CULL_REPS = 20
# operations a sub-sphere test needs, counted from the twin's arithmetic
# (an acos counts one): three products, two sums, the scale by 1 / d, the
# clamp's two compares, the acos, half + beta, the compare and the or
CULL_SUB_OPS = 12
REFINE_POSES = 8
REFINE_VIEWS = 16
REFINE_SAMPLES = 100
REFINE_REPS = 20
# operations the refine needs, counted from the kernel's arithmetic (an
# acos, asin, square root, reciprocal square root or division counts one):
# the apex-to-centre distance of every member (9), the rest of one sphere
# test per (group, slot) pair (16), and one triangle test (303) per pair
# whose sphere test some member passes
REFINE_DIST_OPS = 9
REFINE_SPHERE_OPS = 16
REFINE_TRIANGLE_OPS = 303
# bytes per slot of the refine's tables: centre (3), radius, triangle (9)
REFINE_SLOT_BYTES = 13 * 4
# K6 vs twin: max error over the sum of |terms| of each output element; both
# round the operands alike ("default": to bf16) and sum in f32
K6_REL = 1e-5
K6_ENTRY = (16, 512, "default")  # the (K, N, precision) of K6's table entry
# phase 8: the display size, raw frames timed, pipelined frames, and the
# thresholds: raw mean vs means frame, Voronoi maps card vs CPU (share of
# equal pixels, and the angle gap of a pixel that differs), colours
DISPLAY_W, DISPLAY_H = 640, 480
RAW_TIMED = 3
PIPELINED = 10
RAW_MEAN_ATOL = 1e-5
VORONOI_AGREE = 0.999
NEAR_TIE_RAD = 1e-6
COLOUR_ATOL = 1
# phase 9: the real cameras' pose (tests/test_fast_image.py:46-49), the
# timed frames per camera, the image-vs-oracle rule of
# tests/test_fast_image.py:36-37 (share of pixels with a channel off by more
# than 2), the card-vs-CPU size, the packed lit frame vs the oracle (canopy
# scene: atol; bench eye: share of ommatidia over the atol), and the lit
# raw samples' count and mean tolerance
CAM_POS = (0.0, 3.0, 40.0)
CAM_TIMED = 3
IMAGE_OFF_SHARE = 0.01
SMALL_W, SMALL_H = 64, 48
LIT_ORACLE_ATOL = 2e-3
LIT_ORACLE_SHARE = 0.01
RAW_LIT_SAMPLES = 100
# phase 10: the bursts as (samples, frames, lit) (bench.py:449-464 for 1 x
# 256; 3200 x 10 goes scanned, the others stacked), the pose batch of
# bench.py:130-180 (N_POSES poses uniform +-0.5 around the bench pose at
# POSE_SAMPLES samples), the batches of the memory check, and the checks: a
# burst's last means against as many render_frame() calls, bit-equal or
# within BURST_ATOL with K1's per-ray results bit-equal at the burst's and
# the frames' layouts; the pose batch on a 1e-5 degree copy of the eye
# against sequential frames (MEANS_ATOL); relax_gradient on the card
# against the CPU over RELAX_STEPS steps from RELAX_POINTS well-spaced
# points (a relaxation is chaotic where points crowd, so only a short run
# can agree); the viewer's ticks
BURSTS = ((1, 256, False), (100, 10, False), (100, 10, True),
          (3200, 10, False))
BURST_ATOL = 1e-6
N_POSES = 20
POSE_SAMPLES = 100
MEMORY_BATCHES = 50
GA_POSES = 100  # one GA-size batch (compound_ray_tpu/api/renderer.py:881)
STEADY_FRAMES = 3
RELAX_POINTS, RELAX_STEPS, RELAX_ATOL = 1000, 10, 1e-5
VIEWER_TICKS = 5
# phase 11: the bench scene as a .blend (one object per box), its frames
# timed per setting, the coordinates' f32 rounding (4 ulps at |x| <= 52),
# and the examples' arguments where their defaults do not fit the phase
# (speed_test's warm-up, the repeated renders of alias_quantified and the
# sample settings of alias_viewpoint)
BLEND_TIMED = 3
BLEND_VERTEX_ATOL = 2.5e-5
SPEED_SAMPLES = (1, 10, 100, 1000, 3200)  # speed_test's default sweep
EXAMPLE_ARGS = {
    "primary_example": [],
    "speed_test": ["-s", *map(str, SPEED_SAMPLES), "-w", "1"],
    "plot_speed_test": None,  # its parser (the card has no matplotlib)
    "alias_quantified_experiment": ["-n", "50"],
    "alias_viewpoint_experiment": ["-s", "70"],
    "heterogeneous_demonstration": [],
    "overview_images": [],
    "position_estimation": [],
}
# phase 12: the sharded path.  Four gloo ranks share the one card (NCCL
# rejects two ranks on one device) on the (2, 2) mesh that
# pick_sample_parallel(3200, 4) gives, each with its deadline; the frames
# timed per setting after the first and warm-up frames; raw samples and
# the burst as (samples, frames); and the thresholds of
# tests/test_sharding.py:116 (unlit) and :156 (lit, and raw samples)
SHARD_RANKS = 4
SHARD_RANK_TIMEOUT_S = 300
SHARD_WARMUP, SHARD_TIMED = 2, 5
SHARD_RAW_SAMPLES = 100
SHARD_BURST = (100, 10)
SHARD_UNLIT_ATOL = 2e-6
SHARD_LIT_ATOL = 2e-5
# phase 13: the render modes.  Affine frames against standard frames on one
# seed (tests/test_affine_rays.py:73-88, :197-213: max abs, and mean abs;
# raw samples: the share within the max abs, :91-107); the affine burst as
# (samples, frames): 128 samples is the least at which a group holds one
# ommatidium (at 100 the groups hold two and the flag renders the
# 16-feature frame), and 128 x 10 stacks; the sharded check's mesh and its
# tolerance (:174-194); the sphere refine's gate on a 1e-5 degree copy of
# the bench eye (tests/test_exact_refine.py:74-82) and on the bench eye
# the jittered rule (:104-116: mean abs, max abs); the culled backend's
# samples against the oracle (tests/test_accel.py:80-117) and timed
MODES_TIMED = 3
AFFINE_ATOL, AFFINE_MEAN, AFFINE_LIT_MEAN = 2e-3, 2e-5, 5e-5
AFFINE_RAW_SHARE = 0.999
AFFINE_BURST = (128, 10)
AFFINE_MESH = {"omm": 2, "sample": 2}
AFFINE_SHARD_ATOL = 2e-5
REFINE_ATOL = 2e-5
REFINE_JITTER_MEAN, REFINE_JITTER_ATOL = 1e-3, 0.06
XLA_SAMPLES = (100, 3200)
XLA_ATOL = 1e-5
SOURCES = (("packed_tracer", K1_SOURCE), ("cluster_tracer", K2_SOURCE),
           ("rows_occlusion", K3_SOURCE), ("probe_step", K45_SOURCE),
           ("microbench_k", K6_SOURCE), ("refine_mask", REFINE_SOURCE),
           ("shade_means", SHADE_SOURCE), ("ray_features", RAYGEN_SOURCE),
           ("cache_cull", CULL_SOURCE))
# bounds: NVIDIA's H100 SXM data sheet (dense): f32 outside the tensor cores,
# bf16 on them, and device memory
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(flop: float, nbytes: int, peak: float = PEAK_F32) -> dict:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory rate, and which."""
    ops_ms, bytes_ms = flop / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                flop=flop, bytes=nbytes)


def _set_config(**kw):
    from compound_ray_tpu_torch import config

    config.set_config(config.RenderConfig(**kw))


def _bench_renderer(device):
    from compound_ray_tpu_torch import EyeRenderer
    from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera
    from compound_ray_tpu_torch.testing import make_big_scene, make_sphere_eye

    r = EyeRenderer(verbose=False, device=device)
    r.scene = make_big_scene(n_boxes=N_BOXES, seed=0)
    cam = CompoundEyeCamera("bench-eye", "single_dimension_fast",
                            make_sphere_eye(N_OMM, acceptance_deg=ACCEPT_DEG))
    r.scene.cameras.append(cam)
    r.goto_camera(len(r.scene.cameras) - 1)
    c = r.scene.aabb_center()
    cam.set_position((float(c[0]), float(c[1]) + 1.0, float(c[2])))
    return r, cam


def _pose(cam):
    pos = np.asarray(cam.position, np.float32)
    ls = np.asarray(cam.local_space, np.float32)
    return pos, ls, (pos.tobytes(), ls.tobytes())


def build_kernels():
    """Phase 2: the nine sources through nvcc at once; prints what ptxas
    says."""
    from compound_ray_tpu_torch.trace import _build

    t0 = time.perf_counter()
    paths = _build.build_many([name for name, _ in SOURCES])
    _build.packed_tracer_lib()
    _build.cluster_tracer_lib()
    _build.rows_occlusion_lib()
    _build.probe_step_lib()
    _build.microbench_k_lib()
    _build.refine_mask_lib()
    _build.shade_means_lib()
    _build.ray_features_lib()
    _build.cache_cull_lib()
    wall = time.perf_counter() - t0
    for name, src in SOURCES:
        secs, log = _build.build_info[name]
        print(f"phase 2: {name} built from {src} with nvcc for sm_90a in "
              f"{secs:.2f} s ({wall:.2f} s for all with load): "
              f"{paths[name]}")
        for line in log.splitlines():
            if "Compiling entry function" in line:  # the mangled name
                print(f"  ptxas: {line.split(chr(39))[1]}")
            elif "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")


def kernel_vs_twin(r, cam, samples: int, farfield: str, timed: bool,
                   affine: bool = False):
    """Phase 3: K1 and packed_tracer_reference on the same (row_counts,
    packed_mm, rays) of the bench frame, with the pack the frame uses
    under `farfield`; with `affine` (phase 13) the affine pack and rays
    on K1's 8-feature form.  Returns a result dict."""
    from compound_ray_tpu_torch.config import get_config
    from compound_ray_tpu_torch.eye import pipeline as P
    from compound_ray_tpu_torch.eye.sampling import sample_angles_ns
    from compound_ray_tpu_torch.testing import hit_agreement
    from compound_ray_tpu_torch.trace.attrs import KERNEL_LEAF
    from compound_ray_tpu_torch.trace.mm_tracer import (
        AFFINE_LIVE,
        packed_tracer_reference,
        run_packed_tracer,
    )
    from compound_ray_tpu_torch.trace.shade import miss_id

    _set_config(farfield=farfield, affine_rays=affine)
    dev = r.device
    omms = cam.ommatidia
    splan = P.scene_plan(r.scene, dev)
    eplan = P.eye_plan(omms, samples)
    omms_p, _ = eplan.device_arrays(omms, dev)
    pos_np, ls_np, sig = _pose(cam)
    pos, ls = torch.as_tensor(pos_np, device=dev), torch.as_tensor(ls_np,
                                                                   device=dev)
    near, _, sphere = P._farfield_plan(
        splan, eplan, r.scene.device_triangles(dev), omms, pos_np, ls_np,
        samples, miss_id(r.scene.background_shader), get_config())
    d = 0.0 if sphere is None else sphere[1]
    rc, pmm, kcand, rmax = P._packed_plan(splan, eplan, omms_p, pos, ls,
                                          sig, samples, near_mask=near,
                                          d_thresh=d, affine=affine)
    gen = torch.Generator(device=dev).manual_seed(12345)
    splay, spin = sample_angles_ns(gen, omms_p[:, 6] / P.FWHM_SD_RATIO,
                                   samples)
    rays, _ = P.run_ray_features(omms_p, pos, ls, splay, spin,
                                 samples=samples, ng=eplan.ng, g=eplan.g,
                                 nrb=eplan.nrb, rb_size=eplan.rb_size,
                                 affine=affine)
    kw = dict(ng=eplan.ng, nrb=eplan.nrb, rb_size=eplan.rb_size, rmax=rmax,
              ray_feats=rays.shape[0])
    got = run_packed_tracer(rc, pmm, rays, **kw)
    ref = packed_tracer_reference(rc, pmm, rays, **kw)
    agree, max_abs, max_rel = hit_agreement(ref, got, rc, eplan.rg_pad)
    res = dict(samples=samples, farfield=farfield, affine=affine,
               cache=near is not None,
               rays_per_thread=K1_RAYS_PER_THREAD,
               shape=dict(ng=eplan.ng, rmax=rmax, kcand=kcand,
                          rays=rays.shape[1]),
               live_groups=int((rc > 0).sum().item()),
               payload_rows=int(rc.sum().item()),
               slot_agree=agree, max_abs_err=max_abs, max_rel_err=max_rel)
    # 4 products of `terms` FMAs per (ray, slot) of every live payload row
    # of the ray's group (40 FMAs; affine: 16); beside it the bound of the
    # products the kernel's staged test needs on these inputs
    terms = AFFINE_LIVE if affine else 10
    nbytes = _nbytes(rc, pmm, rays, got)
    res.update(pairs=int(rc.clamp(0, rmax).sum().item()) * eplan.nrb
               * eplan.rb_size * KERNEL_LEAF,
               products=_k1_products(rc, pmm, rays, kw, terms))
    res.update(_bound(8.0 * terms * res["pairs"], nbytes))
    res["staged_bound_ms"] = _bound(2.0 * terms * res["products"],
                                    nbytes)["bound_ms"]
    if timed:
        res["ms"] = time_ms(lambda: run_packed_tracer(rc, pmm, rays, **kw),
                            reps=20, warmup=3)
        res["plain_ms"] = time_ms(
            lambda: packed_tracer_reference(rc, pmm, rays, **kw),
            reps=3, warmup=1)
    if not (agree >= SLOT_AGREE and max_rel <= T_RTOL):
        raise AssertionError(f"K1 disagrees with its twin: {res}")
    return res


def _k1_products(rc, pmm, rays, kw, terms: int = 10) -> int:
    """The `terms`-term products K1 needs on these inputs (10, or 4 in the
    affine form): den and w1 for each (ray, slot) of each live payload row
    of the ray's group, w2 and tnum where k1_keep_first holds (counted per
    pair, from f32 products of the same inputs)."""
    from compound_ray_tpu_torch.trace.attrs import KERNEL_LEAF as leaf
    from compound_ray_tpu_torch.trace.mm_tracer import k1_keep_first

    ng, rmax, rg = kw["ng"], kw["rmax"], kw["nrb"] * kw["rb_size"]
    feats = rays[:terms].reshape(terms, ng, rg)
    cnt = rc.clamp(0, rmax)
    row_ix = torch.arange(rmax, device=rc.device)
    kept = 0
    chunk = max(1, (1 << 26) // (rmax * rg * leaf))
    for g0 in range(0, ng, chunk):
        g1 = min(ng, g0 + chunk)
        pm = pmm[g0:g1, :, :terms]
        w1, den = (torch.einsum("fgr,gjfc->gjrc", feats[:, g0:g1],
                                pm[..., b * leaf:(b + 1) * leaf])
                   for b in (0, 2))
        live = (row_ix < cnt[g0:g1, None])[:, :, None, None]
        kept += int((k1_keep_first(w1, den) & live).sum().item())
    return 2 * int(cnt.sum().item()) * rg * leaf + 2 * kept


def _k2_pair_tests(c, ref) -> int:
    """The (ray, slot) tests K2 must make on these inputs with the early
    exit, counted from below: a 128-ray batch walks its group's whole
    shortlist when one of its rays misses (+inf never exits), else at least
    up to the shortlist position of its last winner."""
    from compound_ray_tpu_torch.trace.attrs import KERNEL_LEAF
    from compound_ray_tpu_torch.trace.cluster_tracer import BATCH_RAYS

    dev = ref.device
    ng, kmax = c.kw["ng"], c.kw["kmax"]
    rg = c.kw["nrb"] * c.kw["rb_size"]
    n_cl = c.payload.shape[0]
    cnt = c.counts.clamp(0, kmax).long()
    p_ix = torch.arange(c.ids.shape[1], device=dev).expand(ng, -1)
    valid = p_ix < cnt[:, None]
    ids = torch.where(valid, c.ids.long().clamp(0, n_cl - 1), n_cl)
    pos = torch.full((ng, n_cl + 1), -1, dtype=torch.long, device=dev)
    pos.scatter_(1, ids, torch.where(valid, p_ix, -1))
    hit = torch.isfinite(ref[:, 0])
    g_of_ray = torch.arange(ref.shape[0], device=dev) // rg
    wpos = torch.where(hit, pos[g_of_ray, ref[:, 3].long().clamp(0, n_cl)],
                       -1)
    nb = ref.shape[0] // BATCH_RAYS
    cnt_b = cnt.repeat_interleave(rg // BATCH_RAYS)
    walked = torch.where((~hit).reshape(nb, BATCH_RAYS).any(1), cnt_b,
                         wpos.reshape(nb, BATCH_RAYS).amax(1) + 1)
    return int(walked.clamp(max=cnt_b).sum().item()) * BATCH_RAYS * KERNEL_LEAF


def k2_vs_twin(r, cam):
    """Phase 4: K2 and cluster_tracer_reference on the bench frame's own
    cache inputs (testing.cache_trace_inputs as _farfield_plan builds them:
    every cluster that reaches past D, from t = D, CACHE_SUPERSAMPLE rays
    a side per pixel: 8192 tiles of 256 rays at width 1024 and 2 x 2, KP
    256) with the early exit on,
    as _render_cache traces them, and with it off: every row of a live
    tile must equal the twin's bit for bit (the kernel rounds each product
    and sum as the twin does).  Counts the (ray, lane) pair tests three
    ways: from below (the bound's), as the 128-ray batches walk their
    shortlists (the twin counts the clusters each batch walks), and with
    no early exit.  Also the frame's whole cache build timed on the same
    arguments."""
    from compound_ray_tpu_torch import testing
    from compound_ray_tpu_torch.config import get_config
    from compound_ray_tpu_torch.eye import pipeline as P
    from compound_ray_tpu_torch.trace.attrs import KERNEL_LEAF
    from compound_ray_tpu_torch.trace.cluster_tracer import (
        BATCH_RAYS,
        _cluster_tracer_twin,
        cluster_tracer_reference,
        run_tracer_kernel,
    )
    from compound_ray_tpu_torch.trace.shade import miss_id

    _set_config()
    width = get_config().farfield_cache_width
    pos_np, _, _ = _pose(cam)
    c = testing.cache_trace_inputs(r.scene, cam.ommatidia, pos_np, r.device,
                                   width)
    args = (c.counts, c.ids, c.dmin, c.payload, c.rays)
    got = run_tracer_kernel(*args, early_exit=True, **c.kw)
    ref, walked = _cluster_tracer_twin(*args, early_exit=True, **c.kw,
                                       count_walked=True)
    agree, max_abs, max_rel = testing.cluster_hit_agreement(
        ref, got, c.counts, c.kw["rb_size"])
    live = torch.repeat_interleave(c.counts > 0, c.kw["rb_size"])
    rows_differ = int((got[live] != ref[live]).any(dim=1).sum().item())
    got_full = run_tracer_kernel(*args, early_exit=False, **c.kw)
    ref_full = cluster_tracer_reference(*args, early_exit=False, **c.kw)
    rows_differ_full = int((got_full[live] != ref_full[live]).any(dim=1)
                           .sum().item())
    del got_full, ref_full
    pair = BATCH_RAYS * KERNEL_LEAF  # pair tests per walked cluster
    res = dict(shape=dict(tiles=c.kw["ng"], kp=int(c.ids.shape[1]),
                          kmax=c.kw["kmax"], rays=int(c.rays.shape[0])),
               clusters=int(c.far.sum()),
               live_tiles=int((c.counts > 0).sum().item()),
               mean_shortlist=float(c.counts.float().mean().item()),
               hit_share=float(torch.isfinite(ref[live, 0]).float().mean()
                               .item()),
               winner_agree=agree, max_abs_err=max_abs, max_rel_err=max_rel,
               rows_differ=rows_differ,
               rows_differ_no_early_exit=rows_differ_full,
               pair_tests_from_below=_k2_pair_tests(c, ref),
               pair_tests_walked=int(walked.sum().item()) * pair,
               pair_tests_no_early_exit=int(
                   c.counts.clamp(0, c.kw["kmax"]).sum().item())
               * walked.shape[1] * pair)
    # 18 FMAs per (ray, slot): w1, w2 (6 terms each), den and o . n (3 each)
    nbytes = _nbytes(*args, got)
    res.update(_bound(36.0 * res["pair_tests_from_below"], nbytes))
    res["walked_bound_ms"] = _bound(36.0 * res["pair_tests_walked"],
                                    nbytes)["bound_ms"]
    res["ms"] = time_ms(lambda: run_tracer_kernel(*args, early_exit=True,
                                                  **c.kw),
                        reps=20, warmup=3)
    res["ms_no_early_exit"] = time_ms(
        lambda: run_tracer_kernel(*args, early_exit=False, **c.kw),
        reps=5, warmup=1)
    res["plain_ms"] = time_ms(
        lambda: cluster_tracer_reference(*args, early_exit=True, **c.kw),
        reps=2, warmup=1)
    res["ns_per_walked_pair_test"] = (res["ms"] * 1e6
                                      / max(res["pair_tests_walked"], 1))
    res["ns_per_pair_test_no_early_exit"] = (
        res["ms_no_early_exit"] * 1e6
        / max(res["pair_tests_no_early_exit"], 1))
    splan = P.scene_plan(r.scene, r.device)
    _, center_np, d = P._farfield_split(splan, cam.ommatidia, pos_np,
                                        np.eye(3),
                                        get_config().farfield_tolerance)
    res["cache_build_ms"] = time_ms(lambda: P.build_equirect_quads(
        P._render_cache(
            splan.payload, splan.attr_table,
            r.scene.device_triangles(r.device), splan.quad_table,
            splan.half_center, splan.half_radius, width=width,
            background=miss_id(r.scene.background_shader),
            textured=splan.textured, tex_only=splan.tex_only,
            **P._frame_cache_args(splan, center_np, d))), reps=5, warmup=1)
    if rows_differ or rows_differ_full:
        raise AssertionError(f"K2 differs from its twin: {res}")
    return res


def _check_means(means, what, lit: bool = False):
    """Finite (N, 3) means in [0, 1]; lit means only >= 0, since GGX adds
    unclamped light."""
    if means.shape != (N_OMM, 3) or not np.isfinite(means).all():
        raise AssertionError(f"bad means: {what}")
    if means.min() < 0.0 or (not lit and means.max() > 1.0 + 1e-5):
        raise AssertionError(
            f"means out of {'[0, inf)' if lit else '[0, 1]'} ({what}): "
            f"{means.min()} .. {means.max()}")


def frames(r, samples: int, first_builds_cache: bool = False):
    """WARMUP + TIMED frames at `samples` (one more first frame when it
    builds the cache), each of which must launch K1 exactly once and K2
    once in a cache-building first frame and never otherwise.  Returns a
    dict of CUDA-event and wall frame times, the first frame's, and the
    peak MB since the first frame."""
    from compound_ray_tpu_torch.trace import cluster_tracer, mm_tracer

    r.set_current_eye_samples_per_ommatidium(samples)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = dict(frame_ms=[], wall_ms=[])
    n_first = 1 if first_builds_cache else 0
    for i in range(n_first + WARMUP + TIMED):
        k1, k2 = mm_tracer.launches, cluster_tracer.launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        wall = r.render_frame()
        end.record()
        torch.cuda.synchronize()
        dk1 = mm_tracer.launches - k1
        dk2 = cluster_tracer.launches - k2
        want_k2 = 1 if i < n_first else 0
        if dk1 != 1 or dk2 != want_k2:
            raise AssertionError(
                f"frame {i} at {samples} samples launched K1 {dk1} and K2 "
                f"{dk2} times, not 1 and {want_k2}")
        _check_means(r.get_camera_data(), f"frame {i} at {samples} samples")
        if i < n_first:
            out["first_frame_ms"] = start.elapsed_time(end)
            out["first_wall_ms"] = wall
        elif i >= n_first + WARMUP:
            out["frame_ms"].append(start.elapsed_time(end))
            out["wall_ms"].append(wall)
    out["peak_mb"] = torch.cuda.max_memory_allocated() / 2**20
    return out


def _report(tag, res):
    first = ""
    if "first_frame_ms" in res:
        first = (f"first frame (builds the cache) {res['first_frame_ms']:.3f}"
                 f" ms; ")
    print(f"phase 5: {tag}: {first}frame ms (CUDA events) {res['frame_ms']},"
          f" mean {np.mean(res['frame_ms']):.3f}; render_frame wall ms "
          f"{[round(w, 3) for w in res['wall_ms']]}; peak memory "
          f"{res['peak_mb']:.1f} MB")


def _counters() -> dict:
    """{kernel: (module, name of its launch count)} for K1 (k1a: its
    8-feature affine form) to K6, the planning refine, the unlit shading,
    ray generation and the cache's cull."""
    from compound_ray_tpu_torch.eye import pipeline
    from compound_ray_tpu_torch.tools import microbench_k, probe_step
    from compound_ray_tpu_torch.trace import cluster_tracer, mm_tracer

    return {"k1": (mm_tracer, "launches"),
            "k1a": (mm_tracer, "affine_launches"),
            "k2": (cluster_tracer, "launches"),
            "k3": (mm_tracer, "occlusion_launches"),
            "k4": (probe_step, "probe_launches"),
            "k5": (probe_step, "probe3d_launches"),
            "k6": (microbench_k, "dot_bench_launches"),
            "refine": (pipeline, "refine_launches"),
            "shade": (pipeline, "shade_launches"),
            "raygen": (pipeline, "raygen_launches"),
            "cull": (pipeline, "cache_cull_launches")}


class _RayUsers:
    """While open, counts the calls of the functions that generate rays
    (pipeline._trace_shade_angles, also as parallel/sharding.py imported
    it, and the shadow plan's pipeline._shadow_probe): each must launch
    the ray generation kernel exactly once."""

    def __enter__(self):
        from compound_ray_tpu_torch.eye import pipeline
        from compound_ray_tpu_torch.parallel import sharding

        self.calls = 0
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in (
            (pipeline, "_trace_shade_angles"),
            (sharding, "_trace_shade_angles"),
            (pipeline, "_shadow_probe"))]

        def counted(fn):
            def call(*a, **k):
                self.calls += 1
                return fn(*a, **k)
            return call

        for mod, name, fn in self.saved:
            setattr(mod, name, counted(fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def _path(r, name, run, phase: int = 5):
    """Run one main path with every launch count set to 0 just before it;
    returns (its result, {kernel: launches in the path}).  Every frame
    core and shadow probe of the path must generate its rays in one
    launch of the ray generation kernel, and every cache build on the card
    (pipeline._render_cache on CUDA tensors) must cull in one launch."""
    from compound_ray_tpu_torch.eye import pipeline

    counters = _counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    render_cache, devices = pipeline._render_cache, []

    def counted(payload, *a, **k):
        devices.append(payload.device.type)
        return render_cache(payload, *a, **k)

    pipeline._render_cache = counted
    try:
        with _RayUsers() as users:
            res = run()
    finally:
        pipeline._render_cache = render_cache
    builds = devices.count("cuda")
    n = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    print(f"phase {phase}: {name}: launches " + ", ".join(
        f"{k.upper()} {v}" for k, v in n.items())
        + f" (frame cores and shadow probes {users.calls}, cache builds "
        f"{builds})")
    if n["raygen"] != users.calls:
        raise AssertionError(f"{name}: {n['raygen']} ray generation "
                             f"launches for {users.calls} frame cores and "
                             f"shadow probes")
    if n["cull"] != builds:
        raise AssertionError(f"{name}: {n['cull']} cull launches for "
                             f"{builds} cache builds")
    return res, n


def _render_out(r, cam, seed_frame: int, **kw):
    """render_means of the bench eye with the generator of `seed_frame`."""
    from compound_ray_tpu_torch.api.renderer import frame_seed
    from compound_ray_tpu_torch.config import get_config
    from compound_ray_tpu_torch.eye.pipeline import render_means
    from compound_ray_tpu_torch.trace.shade import miss_id

    gen = torch.Generator(device=r.device)
    gen.manual_seed(frame_seed(get_config().base_seed, seed_frame))
    pos, ls, _ = _pose(cam)
    return render_means(
        r.scene, r.scene.device_triangles(r.device), cam.ommatidia, pos, ls,
        gen, cam.samples_per_ommatidium,
        miss_id(r.scene.background_shader), **kw)


def _render(r, cam, seed_frame: int, **kw):
    """_render_out's means on the host."""
    return _render_out(r, cam, seed_frame, **kw).cpu().numpy()


def lit_k3_vs_twin(r, cam, samples: int):
    """Phase 3: the first lit frame at the bench pose (default lights, the
    shadow plan built anew and timed), with K3's inputs recorded as the
    frame hands them over; then K3 and rows_occlusion_reference on them.
    Returns a result dict."""
    from compound_ray_tpu_torch.eye import pipeline as P
    from compound_ray_tpu_torch.trace.mm_tracer import (
        _row_ranges,
        _rows_occlusion_twin,
        rows_occlusion_reference,
        run_rows_occlusion,
    )

    _set_config()
    r.set_current_eye_samples_per_ommatidium(samples)
    splan = P.scene_plan(r.scene, r.device)
    splan.shadow_store.clear()
    seen, plan_ms = [], []
    plan = P._shadow_plan

    def timed_plan(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plan(*a, **k)
        torch.cuda.synchronize()
        plan_ms.append((time.perf_counter() - t0) * 1000.0)
        return out

    def record(*a, **k):
        seen.append((a, k))
        return run_rows_occlusion(*a, **k)

    P._shadow_plan = timed_plan
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        means, audit = _render_out(r, cam, cam.rng_frame,
                                   lights=r.get_lights(), shadow_audit=True,
                                   shadow_tracer=record)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1000.0
    finally:
        P._shadow_plan = plan
    (args, kw), = seen
    if kw.get("live_feats") != P.SHADOW_LIVE_FEATS:
        raise AssertionError(f"the lit frame called K3 with {kw}, not "
                             f"live_feats={P.SHADOW_LIVE_FEATS}")
    r2v, flag, flat_rows, rays = args
    counts = next(iter(splan.shadow_store.values()))[0]
    got = run_rows_occlusion(*args, **kw)
    ref, work = _rows_occlusion_twin(*args, **kw, count_tests=True)
    tests, issued = work["pair_tests"], work["warp_issued"]
    # the features not zero in both rows and rays (4 of the shadow plan's 8)
    feats = int(((flat_rows.abs().amax((0, 2)) > 0)
                 & (rays.abs().amax(1) > 0)).sum().item())
    _, vg_rows = _row_ranges(r2v, flag, rays.shape[1] // (kw["nrb"]
                                                          * kw["rb_size"]))
    live = torch.repeat_interleave(vg_rows > 0, kw["nrb"] * kw["rb_size"])
    differ = int((got[0, live] != ref[0, live]).sum().item())
    n_live = int(live.sum().item())
    res = dict(
        samples=samples, first_lit_frame_ms=first_ms,
        shadow_plan_build_ms=plan_ms[0],
        shape=dict(tb=int(flat_rows.shape[0]),
                   feats=int(flat_rows.shape[1]), nonzero_feats=feats,
                   rays=int(rays.shape[1]),
                   virtual_groups=int(vg_rows.shape[0]), **kw),
        rays_per_thread=K3_RAYS_PER_THREAD,
        live_rows=int(counts.sum().item()),
        rows_per_light=[int(x) for x in counts.sum(dim=1).tolist()],
        zero_row_groups_per_light=[int(x) for x in
                                   (counts == 0).sum(dim=1).tolist()],
        max_rows_per_group=int(counts.max().item()),
        live_rays=n_live, decisions_differ=differ,
        decision_agree=1.0 - differ / max(n_live, 1),
        occluded_share=float(ref[0, live].mean().item()),
        max_abs_err=float((got - ref).abs().max().item()),
        first_frame_audit=[int(x) for x in audit[:2].tolist()],
        first_frame_means_max=float(means.max().item()), pair_tests=tests,
        products=work["products"],
        warp_issued_tests=issued, lane_efficiency=tests / max(issued, 1))
    # 2 flop per term of the four 128-slot dots of each pair test, over the
    # features that are not zero in both rows and rays; beside it the bound
    # of the products the kernel's staged tests need on these inputs
    nbytes = _nbytes(r2v, flag, flat_rows, rays, got)
    res.update(_bound(8.0 * feats * tests, nbytes))
    res["staged_bound_ms"] = _bound(2.0 * feats * work["products"],
                                    nbytes)["bound_ms"]
    res["ms"] = time_ms(lambda: run_rows_occlusion(*args, **kw), reps=20,
                        warmup=3)
    res["plain_ms"] = time_ms(lambda: rows_occlusion_reference(*args, **kw),
                              reps=1, warmup=0)
    if not res["decision_agree"] >= K3_AGREE:
        raise AssertionError(f"K3 disagrees with its twin: {res}")
    return res


def lit_frames(r):
    """The lit path through EyeRenderer.render_frame: the first frame at
    the pose builds the shadow plan (K1 twice: the probe and the frame; K3
    once; the refine on its chunks), every later frame launches K1 and K3
    once, K2 never and the refine only where a corrective replan left it
    a shadow plan to build; a frame after a corrective replan probes
    again.  Returns the CUDA-event frame
    times, the first frame's, the audit totals over the timed frames, the
    corrective replans and the peak MB."""
    from compound_ray_tpu_torch.eye import pipeline as P
    from compound_ray_tpu_torch.trace import cluster_tracer, mm_tracer

    splan = P.scene_plan(r.scene, r.device)
    splan.shadow_store.clear()
    r.set_lighting(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = dict(frame_ms=[], wall_ms=[], audit_leaked=0, audit_hits=0,
               replans=0, refines=[])
    for i in range(1 + WARMUP + TIMED):
        builds = not splan.shadow_store
        probes = builds and not splan.shadow_sound_all
        k1, k2 = mm_tracer.launches, cluster_tracer.launches
        k3, refines = mm_tracer.occlusion_launches, P.refine_launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        wall = r.render_frame()
        end.record()
        torch.cuda.synchronize()
        got = (mm_tracer.launches - k1, cluster_tracer.launches - k2,
               mm_tracer.occlusion_launches - k3)
        want = (2 if probes else 1, 0, 1)
        if got != want:
            raise AssertionError(f"lit frame {i} launched K1, K2, K3 {got} "
                                 f"times, not {want}")
        refines = P.refine_launches - refines
        if (refines > 0) != builds:
            raise AssertionError(
                f"lit frame {i} launched the refine {refines} times, "
                f"{'building' if builds else 'serving'} its shadow plan")
        out["refines"].append(refines)
        if i > 0 and probes:
            out["replans"] += 1
        _check_means(r.get_camera_data(), f"lit frame {i}", lit=True)
        if i == 0:
            out["first_frame_ms"] = start.elapsed_time(end)
            out["first_wall_ms"] = wall
        elif i >= 1 + WARMUP:
            out["frame_ms"].append(start.elapsed_time(end))
            out["wall_ms"].append(wall)
            out["audit_leaked"] += int(r.last_shadow_audit[0])
            out["audit_hits"] += int(r.last_shadow_audit[1])
    out["peak_mb"] = torch.cuda.max_memory_allocated() / 2**20
    out["unsound_groups"] = len(splan.shadow_unsound_groups)
    out["sound_all"] = splan.shadow_sound_all
    return out


def lit_checks(r, cam):
    """Phase 6: the renderer's last lit frame (rendered again from its
    seed, so a corrective replan after it cannot split the two) against
    the unlit frame (farfield="off") and the frame through the K1 and K3
    twins on the same shadow plan, all with the same generator seed."""
    from compound_ray_tpu_torch.eye import pipeline as P
    from compound_ray_tpu_torch.trace.mm_tracer import (
        packed_tracer_reference,
        rows_occlusion_reference,
    )

    seed = cam.rng_frame - 1
    splan = P.scene_plan(r.scene, r.device)
    replan_pending = not splan.shadow_store
    lit = _render(r, cam, seed, lights=r.get_lights())
    if not replan_pending and not np.array_equal(lit, r.get_camera_data()):
        raise AssertionError("the renderer's lit frame is not reproduced "
                             "from its seed")
    _set_config(farfield="off")
    unlit = _render(r, cam, seed)
    _set_config()
    low = float((lit - (unlit - 1e-6)).min())
    brighter = float((lit > unlit).mean())
    twin = _render(r, cam, seed, lights=r.get_lights(),
                   tracer=packed_tracer_reference,
                   shadow_tracer=rows_occlusion_reference)
    err = float(np.abs(twin - lit).max())
    res = dict(min_lit_minus_unlit=low + 1e-6, brighter_share=brighter,
               twin_max_abs=err, lit_max=float(lit.max()))
    if low < 0.0:
        raise AssertionError(f"lit < unlit - 1e-6: {res}")
    if not err <= MEANS_ATOL:
        raise AssertionError(f"lit frame vs twin frame: {res}")
    return res


def small_lit_card_vs_cpu(device):
    """Phase 6: the canopy scene's lit frame from the same numpy angles on
    the card (K1, K3) and on the CPU (the twins)."""
    from compound_ray_tpu_torch import testing
    from compound_ray_tpu_torch.scene.eye_io import ommatidia_to_array
    from compound_ray_tpu_torch.trace.lighting import default_lights

    out = []
    for dev in (torch.device(device), torch.device("cpu")):
        scene = testing.make_canopy_scene()
        omms = ommatidia_to_array(testing.canopy_eye(2.0))
        f = testing.frame_pack(scene, omms, 128, (0.0, 0.0, 0.0), dev,
                               seed=5)
        out.append(testing.lit_frame_means(
            scene, f, default_lights(scene.aabb_min, scene.aabb_max)))
    err = float(np.abs(out[0] - out[1]).max())
    if not err <= MEANS_ATOL:
        raise AssertionError(f"small lit scene, card vs CPU: max abs {err}")
    return err


def frame_vs_twins(r, cam, cache: bool):
    """Phase 6: the renderer's last frame against the same frame (same
    generator seed) rendered through the twins (K1's and the shading's) on
    the card.  With the cache
    on, the cache is rendered anew through K2's twin and dropped after."""
    from compound_ray_tpu_torch.eye import pipeline as P
    from compound_ray_tpu_torch.trace.cluster_tracer import (
        cluster_tracer_reference,
    )
    from compound_ray_tpu_torch.trace.mm_tracer import packed_tracer_reference

    splan = P.scene_plan(r.scene, r.device)
    splan.cache_store.clear()
    twin = _render(r, cam, cam.rng_frame - 1, tracer=packed_tracer_reference,
                   cache_tracer=cluster_tracer_reference,
                   shader=P.shade_means_reference)
    if cache and not splan.cache_store:
        raise AssertionError("the twin frame did not use the cache")
    splan.cache_store.clear()
    err = float(np.abs(twin - r.get_camera_data()).max())
    if not err <= MEANS_ATOL:
        raise AssertionError(f"frame vs twin frame: max abs {err}")
    return err


def small_card_vs_cpu(device, cache_width: int = 0, sky: bool = False):
    """Phase 6: a small scene traced on the card (K1, and K2 for the cache)
    and on the CPU (the twins) from the same numpy angles: the means must
    agree.  cache_width > 0: the 200-box scene with its far-field cache,
    where the sky split engages (15 of 64 groups have no near geometry)."""
    from compound_ray_tpu_torch import testing
    from compound_ray_tpu_torch.scene.eye_io import ommatidia_to_array

    out = []
    for dev in (torch.device(device), torch.device("cpu")):
        if cache_width:
            omms = ommatidia_to_array(testing.make_sphere_eye(64, 4.0))
            scene = testing.make_big_scene(200, seed=11)
            f = testing.frame_pack(scene, omms, 128, (0.0, 2.0, 0.0), dev,
                                   seed=5, cache_width=cache_width, sky=sky)
        else:
            omms = ommatidia_to_array(testing.make_sphere_eye(48, 6.0))
            scene = testing.make_mixed_flat_scene()
            f = testing.frame_pack(scene, omms, 96, (0.0, 5.0, 0.0), dev,
                                   seed=5)
        out.append(testing.frame_means(scene, f))
    err = float(np.abs(out[0] - out[1]).max())
    if not err <= MEANS_ATOL:
        raise AssertionError(f"small scene, card vs CPU: max abs {err}")
    return err


def sky_checks(r, cam, dense_cache_frame, live_groups: int):
    """Phase 6: the sky-split frame against the dense cache frame of the
    same seed, and the sky groups' values across two seeds.  When the split
    declines the pose (more than 90 % of the groups have near geometry:
    live_groups, from the cache frame's pack), says so and requires the
    frame to equal the dense one."""
    from compound_ray_tpu_torch.eye import pipeline as P

    splan = P.scene_plan(r.scene, r.device)
    seed = cam.rng_frame - 1
    split = _render(r, cam, seed)
    plans = list(splan.sky_store.values())
    if not plans:
        raise AssertionError("no sky plan was memoised at the bench pose")
    eplan = P.eye_plan(cam.ommatidia, cam.samples_per_ommatidium)
    if plans[-1] is None:
        print(f"phase 6: sky split declined at the bench pose: "
              f"{live_groups} of {eplan.ng} groups live, "
              f"{eplan.ng - live_groups} zero-row (the split needs at most "
              f"90 % live); the frame must equal the dense cache frame")
        if live_groups <= 0.9 * eplan.ng:
            raise AssertionError("the split declined a pose it should take")
        if not np.array_equal(split, dense_cache_frame):
            raise AssertionError("declined sky split differs from dense")
        return dict(declined=True, live_groups=live_groups,
                    zero_row_groups=eplan.ng - live_groups)
    scatter = plans[-1][3].cpu().numpy()
    live = np.unique(scatter[scatter < eplan.ng])
    sky_orig = eplan.perm[np.setdiff1d(np.arange(eplan.ng), live)]
    other = _render(r, cam, seed + 1000)
    diff = float(np.abs(split - dense_cache_frame).mean())
    res = dict(declined=False, live_groups=int(live.size),
               zero_row_groups=int(eplan.ng - live.size),
               compacted_groups=int(plans[-1][5]),
               mean_abs_vs_dense=diff)
    if not diff < CACHE_MEAN_ABS:
        raise AssertionError(f"sky split vs dense: mean abs {diff}")
    if sky_orig.size == 0 or not np.array_equal(split[sky_orig],
                                                other[sky_orig]):
        raise AssertionError("sky values differ across seeds")
    return res


def probe_vs_twins(dev):
    """Phase 7: K4 in every mode at rs 256, and dma_only and dot_cand at rs
    512 and 1024; K5 at copy_only, dma_only, dot_cand and dot_only (which
    must equal its dot_cand); each against probe_reference on the probe
    tool's inputs (1000 groups of 3072 rays).  copy_only and dma_only must
    be bit-equal, the dot modes agree on >= SLOT_AGREE of the rays within
    T_RTOL.  Then times K4 in every mode at rs 256, its dot_cand at rs 512
    and 1024, K5's dot_cand and K1 on the same inputs, PROBE_REPS launches
    each, with dma_only and dot_cand on a ragged three-row shape, and prints
    the K1 step split they give.  Returns the K4 and K5
    dot_cand entries.  (These launches come before the counted tools' run.)"""
    from compound_ray_tpu_torch.testing import probe_agreement
    from compound_ray_tpu_torch.tools import probe_step as PS
    from compound_ray_tpu_torch.trace.mm_tracer import run_packed_tracer

    ng, rb, rmax = PS.NG, PS.RB_SIZE, PS.RMAX
    rc, pmm, rays = (torch.as_tensor(x, device=dev)
                     for x in PS.make_inputs(ng, rb, rmax))
    rays3d = rays.reshape(16, ng, rb).permute(1, 0, 2).contiguous()
    cases = ([(m, 256, "2d") for m in PS.MODES]
             + [(m, rs, "2d") for rs in (512, 1024)
                for m in ("dma_only", "dot_cand")]
             + [(m, 256, "3d") for m in ("copy_only", "dma_only", "dot_cand",
                                          "dot_only")])
    twins, got3d, out = {}, {}, {}
    for mode, rs, layout in cases:
        ry = rays if layout == "2d" else rays3d
        if (mode, layout) not in twins:
            twins[mode, layout] = PS.probe_reference(rc, pmm, ry, ng, rb,
                                                     rmax, mode, layout)
        ref = twins[mode, layout]
        if layout == "2d":
            got = PS.run_probe(rc, pmm, rays, ng, rb, rmax, mode, rs)
        else:
            got = got3d[mode] = PS.run_probe3d(rc, pmm, rays3d, ng, rb, rmax,
                                               mode)
        if mode in ("copy_only", "dma_only"):
            ok = torch.equal(got, ref)
            agree, max_abs, max_rel = float(ok), 0.0 if ok else float(
                (got - ref).abs().max().item()), 0.0
        else:
            agree, max_abs, max_rel = probe_agreement(ref, got, rc, rb)
            ok = agree >= SLOT_AGREE and max_rel <= T_RTOL
        tag = f"K{4 if layout == '2d' else 5} {mode} rs {rs}"
        print(f"phase 7: {tag} vs twin: agree {agree:.6f}, max abs "
              f"{max_abs:.3e}, max rel {max_rel:.3e}")
        if not ok:
            raise AssertionError(f"{tag} disagrees with its twin")
        out[tag] = dict(max_abs_err=max_abs)
    if not torch.equal(got3d["dot_only"], got3d["dot_cand"]):
        raise AssertionError("K5 dot_only differs from its dot_cand")
    flop = 2.0 * 16 * 512 * rb * rc.clamp(0, rmax).sum().item()

    def timed(fn, ry, mode, *rs):
        return time_ms(lambda: fn(rc, pmm, ry, ng, rb, rmax, mode, *rs),
                       reps=PROBE_REPS, warmup=3)

    times = {mode: timed(PS.run_probe, rays, mode) for mode in PS.MODES}
    for rs in (512, 1024):
        times[f"dot_cand_rs{rs}"] = timed(PS.run_probe, rays, "dot_cand", rs)
    times["dot_cand_3d"] = timed(PS.run_probe3d, rays3d, "dot_cand")
    times["real_bary"] = time_ms(lambda: run_packed_tracer(
        rc, pmm, rays, ng=ng, nrb=1, rb_size=rb, rmax=rmax),
        reps=PROBE_REPS, warmup=3)
    # a ragged shape (rmax 3, 0 to 3 rows per group in turn): what a row
    # costs where a block stages several, beside the one-row shape's
    rc3, pmm3, _ = PS.make_inputs(ng, 1, 3, seed=1)  # the rays stay as above
    rc3[:] = np.arange(ng) % 4
    rc3, pmm3 = (torch.as_tensor(x, device=dev) for x in (rc3, pmm3))
    rows3 = int(rc3.sum().item())
    ragged = {mode: time_ms(lambda m=mode: PS.run_probe(
        rc3, pmm3, rays, ng, rb, 3, m), reps=PROBE_REPS, warmup=3)
        for mode in ("dma_only", "dot_cand")}
    res = {}
    for key, tag, ms, ry, layout in (
            ("k4", "K4 dot_cand rs 256", times["dot_cand"], rays, "2d"),
            ("k5", "K5 dot_cand rs 256", times["dot_cand_3d"], rays3d, "3d")):
        res[key] = dict(out[tag], ms=ms, **_bound(flop, _nbytes(
            rc, pmm, ry, twins["dot_cand", layout])))
        res[key]["plain_ms"] = time_ms(
            lambda y=ry, lay=layout: PS.probe_reference(
                rc, pmm, y, ng, rb, rmax, "dot_cand", lay), reps=3, warmup=1)
    print(f"phase 7: K4 / K5 dot_cand at {ng} x {rb}: {json.dumps(res)}")
    products = times["dot_only"] - times["dma_only"]
    split = {
        "times_ms": times,
        "staging_loop_sink_ms (dma - copy)":
            times["dma_only"] - times["copy_only"],
        "products_ms (dot - dma)": products,
        "cand_math_ms (cand - dot)": times["dot_cand"] - times["dot_only"],
        "k1_less_probe_ms (real_bary - cand)":
            times["real_bary"] - times["dot_cand"],
        "products_share_of_f32_peak": flop / PEAK_F32 * 1e3 / products,
        "ragged_rmax3_ms": ragged,
        "ragged_rows": rows3,
        "ragged_dot_cand_ms_per_1000_rows": ragged["dot_cand"] / rows3 * 1e3,
        "rays_per_thread": K45_RAYS_PER_THREAD,
        "reps": PROBE_REPS,
        "instances (mode, rs): registers, spill store + load bytes":
            _probe_instances(),
    }
    print(f"phase 7: K1 step split by the probes at {ng} x {rb}, rs 256: "
          f"{json.dumps(split)}")
    return res


def _probe_instances() -> dict:
    """What ptxas said of each probe_kernel<mode, rs> when the library was
    built (nvcc's log, kept beside it): {"mode rs": [registers, spill
    bytes]}."""
    import re

    from compound_ray_tpu_torch.tools import probe_step as PS
    from compound_ray_tpu_torch.trace import _build

    inst, cur, spill = {}, None, 0
    for line in _build.build_info["probe_step"][1].splitlines():
        m = re.search(r"probe_kernelILi(\d)ELi(\d+)EE", line)
        if m and "Compiling entry function" in line:
            cur = f"{PS.MODES[int(m.group(1))]} {m.group(2)}"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            inst[cur], cur = [int(m.group(1)), spill], None
    return inst


def dot_bench_vs_twins(dev):
    """Phase 7: K6 against dot_bench_reference at each swept (K, N,
    precision), 4000 steps, the error over the sum of |terms| <= K6_REL;
    returns the K6_ENTRY variant's entry, timed."""
    from compound_ray_tpu_torch.testing import dot_bench_scale
    from compound_ray_tpu_torch.tools import microbench_k as MB

    res = None
    for n in MB.NS:
        for k, prec in MB.SWEEP:
            ft, mm = MB.bench_inputs(k, n, dev)
            got = MB.run_dot_bench(ft, mm, prec, MB.N_STEPS)
            ref = MB.dot_bench_reference(ft, mm, prec, MB.N_STEPS)
            err = (got.double() - ref.double()).abs()
            rel = float((err / dot_bench_scale(ft, mm, prec,
                                               MB.N_STEPS)).max().item())
            print(f"phase 7: K6 K {k} N {n} {prec} vs twin: max abs "
                  f"{err.max().item():.3e}, max over sum |terms| {rel:.3e}")
            if not rel <= K6_REL:
                raise AssertionError(f"K6 (K {k}, N {n}, {prec}) disagrees "
                                     f"with its twin: {rel}")
            if (k, n, prec) == K6_ENTRY:
                peak = PEAK_BF16 if prec == "default" else PEAK_F32
                res = dict(max_abs_err=float(err.max().item()),
                           rel_to_scale=rel, **_bound(
                               2.0 * MB.RS * k * n * MB.N_STEPS,
                               _nbytes(ft, mm, got), peak))
                res["ms"] = time_ms(lambda: MB.run_dot_bench(
                    ft, mm, prec, MB.N_STEPS), reps=5, warmup=1)
                res["plain_ms"] = time_ms(lambda: MB.dot_bench_reference(
                    ft, mm, prec, MB.N_STEPS), reps=2, warmup=1)
                res["batched_matmul_ms"] = _k6_yardstick(ft, mm)
    print(f"phase 7: K6 at (K, N, precision) {K6_ENTRY}: {json.dumps(res)}")
    return res


def _k6_yardstick(ft, mm) -> float:
    """One batched torch.matmul over the same bf16 products as K6's
    "default" steps: ft^T against the (n_steps, K, N) stack of mm[j % 4].
    A yardstick, not the same function: it reads n_steps B matrices from
    device memory and writes every product, where K6 cycles four matrices
    held in shared memory and writes one sum."""
    from compound_ray_tpu_torch.tools import microbench_k as MB

    a = ft.t().to(torch.bfloat16).contiguous()
    stack = mm.to(torch.bfloat16)[
        torch.arange(MB.N_STEPS, device=mm.device) % MB.NROWS]
    ms = time_ms(lambda: torch.matmul(a, stack), reps=3, warmup=1)
    print(f"phase 7: K6 yardstick: one batched torch.matmul of "
          f"{tuple(a.shape)} bf16 against {tuple(stack.shape)} bf16: "
          f"{ms:.4f} ms (reads {MB.N_STEPS} B matrices from device memory "
          f"and writes every product; not the same function)")
    return ms


def tools_main():
    """The tools' path: probe_step's and microbench_k's main() at their full
    sizes on the card; each prints its table and writes its JSON under
    build/compound_ray_tpu_torch/."""
    from compound_ray_tpu_torch.tools import microbench_k, probe_step

    probe = probe_step.main([])
    micro = microbench_k.main([])
    for rec in (probe, micro):
        if rec["device"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"a tool ran on {rec['device']}")
    # a time under its bound means the compiler dropped work the kernel
    # must keep (the products no output reads)
    rays = probe["shape"]["rays"]
    under = [(key, ms) for key, ms in probe["times_ms"].items()
             if key.startswith("dot") and ms < _bound(
                 2.0 * 16 * 512 * rays, 0)["bound_ms"]]
    for rec in micro["dot_step"]:
        peak = PEAK_BF16 if rec["prec"] == "default" else PEAK_F32
        if rec["ms"] < _bound(2.0 * microbench_k.RS * rec["K"] * rec["N"]
                              * rec["n_steps"], 0, peak)["bound_ms"]:
            under.append((rec["K"], rec["N"], rec["prec"], rec["ms"]))
    if under:
        raise AssertionError(f"timed under their bound: {under}")
    return probe, micro


def _events_ms(fn):
    """(fn's result, CUDA-event ms around one call of fn)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _host_syncs(fn) -> list:
    """The synchronizing CUDA operations fn issues, as torch's sync debug
    mode reports them: one "file:line" of the Python caller each."""
    import os
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def projections_card_vs_cpu(means, raw, pos, dirs) -> dict:
    """Phase 8: the eight projections at DISPLAY_W x DISPLAY_H from the same
    means (and raw samples) on the card and on the CPU.  Each spherical
    projection's index maps equal on >= VORONOI_AGREE of the pixels with
    every differing pixel a near-tie (winners' angles within
    NEAR_TIE_RAD); frames equal where the maps agree, colours within
    COLOUR_ATOL.  Times each projection on the card (CUDA events, 5
    calls)."""
    from compound_ray_tpu_torch.projection import project as PR
    from compound_ray_tpu_torch.testing import voronoi_agreement

    w, h = DISPLAY_W, DISPLAY_H
    on = {"card": (means, raw, pos, dirs),
          "cpu": tuple(x.cpu() for x in (means, raw, pos, dirs))}
    out = {}
    for name in PR.PROJECTIONS:
        frames = {dev: PR.project_frame(name, *args, w, h).cpu().numpy()
                  for dev, args in on.items()}
        out[name] = dict(ms=time_ms(
            lambda n=name: PR.project_frame(n, *on["card"], w, h), reps=5,
            warmup=1))
        same = np.ones((h, w), bool)
        if name.startswith("spherical"):
            refs = 2 if "positionwise" in name else 3
            maps = [PR.voronoi_index_map(
                args[refs], w, h, split="split" in name,
                positions_x=args[2][:, 0]).cpu().numpy()
                for args in on.values()]
            agree, gap = voronoi_agreement(*maps, on["cpu"][refs].numpy(),
                                           w, h)
            out[name].update(map_agree=agree, max_tie_gap_rad=gap)
            if agree < VORONOI_AGREE or gap >= NEAR_TIE_RAD:
                raise AssertionError(f"{name}: card and CPU maps disagree "
                                     f"({agree}, gap {gap} rad)")
            same = maps[0] == maps[1]
        got, want = frames["card"], frames["cpu"]
        diff = int(np.abs(got[same].astype(int)
                          - want[same].astype(int)).max())
        out[name]["max_channel_diff"] = diff
        if got.shape != (h, w, 4) or diff > (0 if name.endswith("_ids")
                                             else COLOUR_ATOL):
            raise AssertionError(f"{name}: card vs CPU frame {got.shape}, "
                                 f"max channel difference {diff}")
    return out


def api_surface(r, cam, tmp):
    """Phase 8: the API surface through the shim's camelCase calls in
    primary_example.py's order (configureFunctions, setRenderSize,
    renderFrame, getFramePointer, saveFrameAs, setCurrentEyeSamplesPer-
    Ommatidium, stop) on the bench scene and eye at DISPLAY_W x DISPLAY_H:
    the raw frame (its samples against the K1 twin's, their mean against
    the means frame of the same seed, both with the far field off), the
    eight projections card vs CPU, render_frames_pipelined against as many
    synced frames, and the host syncs of one unsynced frame."""
    import os

    from compound_ray_tpu_torch import eye_tools as eyeTools
    from compound_ray_tpu_torch import load_eye_renderer
    from compound_ray_tpu_torch.api.renderer import frame_seed
    from compound_ray_tpu_torch.config import get_config
    from compound_ray_tpu_torch.eye.pipeline import render_samples
    from compound_ray_tpu_torch.trace.mm_tracer import packed_tracer_reference
    from compound_ray_tpu_torch.trace.shade import miss_id

    shim = load_eye_renderer(verbose=False)
    R = shim.renderer
    R.scene = r.scene  # the bench scene and its memoised plans
    eyeTools.configureFunctions(shim)
    if not shim.gotoCameraByName(cam.name.encode()):
        raise AssertionError("the bench eye is not in the scene")
    eyeTools.setRenderSize(shim, DISPLAY_W, DISPLAY_H)
    res = {}

    _set_config(farfield="off")
    shim.setCurrentEyeShaderName(b"raw_ommatidial_samples")
    shim.setCurrentEyeSamplesPerOmmatidium(SAMPLES[-1])
    res["first_raw_frame_ms"] = _events_ms(shim.renderFrame)[1]
    raw_mean0 = R._raw_samples.mean(dim=0)
    res["raw_frame_ms"] = [_events_ms(shim.renderFrame)[1]
                           for _ in range(RAW_TIMED)]
    frame, res["frame_pointer_copy_ms"] = _events_ms(shim.getFramePointer)
    if frame.shape != (DISPLAY_H, DISPLAY_W, 4) or not frame.any():
        raise AssertionError(f"raw frame buffer {frame.shape}")
    gen = torch.Generator(device=R.device)
    gen.manual_seed(frame_seed(get_config().base_seed, cam.rng_frame - 1))
    pos, ls, _ = _pose(cam)
    twin = render_samples(
        r.scene, r.scene.device_triangles(R.device), cam.ommatidia, pos, ls,
        gen, SAMPLES[-1], miss_id(r.scene.background_shader),
        tracer=packed_tracer_reference)
    raw = R._raw_samples
    res["raw_shape"] = list(raw.shape)
    res["raw_vs_twin_max_abs"] = float((raw - twin).abs().max().item())
    if (raw.shape != (SAMPLES[-1], N_OMM, 3)
            or not torch.isfinite(raw).all().item()
            or not res["raw_vs_twin_max_abs"] <= MEANS_ATOL):
        raise AssertionError(f"raw samples vs the twin's: {res}")
    ppm = os.path.join(tmp, "raw.ppm")
    shim.saveFrameAs(ppm.encode())
    header = f"P6\n{DISPLAY_W} {DISPLAY_H}\n255\n"
    if os.path.getsize(ppm) != len(header) + DISPLAY_W * DISPLAY_H * 3:
        raise AssertionError("saveFrameAs wrote a wrong size")

    shim.setCurrentEyeShaderName(
        b"__raygen__compound_projection_spherical_orientationwise")
    shim.setCurrentEyeSamplesPerOmmatidium(SAMPLES[-1])  # rewinds to seed 0
    shim.renderFrame()
    means = shim.getCameraData()
    _check_means(means, "the phase 8 means frame")
    res["raw_mean_vs_means_max_abs"] = float(np.abs(
        raw_mean0.cpu().numpy() - means).max())
    if not res["raw_mean_vs_means_max_abs"] <= RAW_MEAN_ATOL:
        raise AssertionError(f"raw mean vs means frame: {res}")
    if not shim.getFramePointer()[..., 3].all():
        raise AssertionError("the spherical frame left pixels unwritten")
    shim.saveFrameAs(os.path.join(tmp, "orientationwise.ppm").encode())
    _, omm_pos, omm_dir = cam.device_ommatidia(R.device)
    res["projections"] = projections_card_vs_cpu(R._device_means, raw,
                                                 omm_pos, omm_dir)
    _set_config()

    shim.setCurrentEyeSamplesPerOmmatidium(SAMPLES[-1])
    t0 = time.perf_counter()
    for _ in range(PIPELINED):
        shim.renderFrame()
    res["synced_total_ms"] = (time.perf_counter() - t0) * 1000.0
    synced = shim.getCameraData().copy()
    shim.setCurrentEyeSamplesPerOmmatidium(SAMPLES[-1])
    res["pipelined_total_ms"] = R.render_frames_pipelined(PIPELINED)
    if not np.array_equal(shim.getCameraData(), synced):
        raise AssertionError("pipelined frames differ from synced ones")
    res["host_syncs_unsynced_frame"] = _host_syncs(
        lambda: R.render_frame(sync=False))
    R.sync()
    shim.stop()
    if R.scene is not None or R._device_frame is not None:
        raise AssertionError("stop left the scene or the frame")
    return res


def _real_cameras(scene) -> list:
    """Phase 9: a perspective camera (60 degrees of y field of view at the
    display's aspect), a panoramic one (start radius 0) and an orthographic
    one (scale 30 x 20), all at CAM_POS looking along -z, appended to the
    scene; returns [(camera index, kind, camera, parameter)]."""
    from compound_ray_tpu_torch.cameras.types import (
        OrthographicCamera,
        PanoramicCamera,
        PerspectiveCamera,
    )

    persp = PerspectiveCamera("phase9-pinhole")
    persp.set_aspect_ratio(DISPLAY_W / DISPLAY_H)
    persp.set_y_fov(60.0)
    pano = PanoramicCamera("phase9-panoramic")
    pano.set_start_radius(0.0)
    ortho = OrthographicCamera("phase9-orthographic")
    ortho.set_xy_scale(30.0, 20.0)
    out = []
    for cam, kind, param in ((persp, "pinhole", persp.scale),
                             (pano, "panoramic", [pano.start_radius]),
                             (ortho, "orthographic", ortho.scale)):
        cam.set_position(CAM_POS)
        cam.set_local_space((1, 0, 0), (0, 1, 0), (0, 0, -1))
        scene.cameras.append(cam)
        out.append((len(scene.cameras) - 1, kind, cam,
                    np.asarray(param, np.float32)))
    return out


def camera_frames(r, cams) -> dict:
    """Phase 9's path: each real camera through the shim's camelCase calls
    (gotoCamera, setRenderSize, renderFrame, getFramePointer) on the bench
    scene at DISPLAY_W x DISPLAY_H, one frame to warm and CAM_TIMED timed
    (CUDA events around renderFrame, which ends in a sync); then the host
    syncs of one unsynced pinhole frame."""
    from compound_ray_tpu_torch import eye_tools as eyeTools
    from compound_ray_tpu_torch import load_eye_renderer

    shim = load_eye_renderer(verbose=False)
    R = shim.renderer
    R.scene = r.scene  # the bench scene and its memoised plans
    eyeTools.configureFunctions(shim)
    eyeTools.setRenderSize(shim, DISPLAY_W, DISPLAY_H)
    out = {}
    for idx, kind, _, _ in cams:
        shim.gotoCamera(idx)
        if shim.isCompoundEyeActive():
            raise AssertionError(f"camera {idx} is a compound eye")
        shim.renderFrame()
        ms = [_events_ms(shim.renderFrame)[1] for _ in range(CAM_TIMED)]
        out[kind] = dict(ms=ms, frame=shim.getFramePointer().copy())
    shim.gotoCamera(cams[0][0])
    out["host_syncs"] = _host_syncs(lambda: R.render_frame(sync=False))
    R.sync()
    out["n_frames"] = len(cams) * (1 + CAM_TIMED) + 1
    shim.stop()
    return out


def _off_share(got, want) -> float:
    """Share of pixels with any colour channel off by more than 2."""
    diff = np.abs(got[..., :3].astype(int) - want[..., :3].astype(int))
    return float((diff.max(axis=-1) > 2).mean())


def _card_vs_cpu(card, cpu, ties) -> dict:
    """Two uint8 images: the largest channel difference, and the pixels
    off by more than 1 that are not near-ties."""
    diff = np.abs(card.astype(int) - cpu.astype(int)).max(axis=-1)
    return dict(max_channel_diff=int(diff.max()),
                pixels_over_1=int((diff > 1).sum()),
                near_ties=int(ties.sum()),
                pixels_over_1_not_near_tie=int(((diff > 1) & ~ties).sum()))


def k2_at_image_shapes(scene, device, param) -> dict:
    """Phase 9: K2 and its twin on the pinhole image's own inputs at
    DISPLAY_W x DISPLAY_H (tiles of 256 rays, KP = kmax = 256, early exit
    on): every row bit-equal.  The pair tests from below, as the batches
    walk them and with no early exit, counted as phase 4 counts them; the
    bound at 18 FMA per pair test."""
    from compound_ray_tpu_torch import testing
    from compound_ray_tpu_torch.trace.attrs import KERNEL_LEAF
    from compound_ray_tpu_torch.trace.cluster_tracer import (
        BATCH_RAYS,
        _cluster_tracer_twin,
        cluster_tracer_reference,
        run_tracer_kernel,
    )

    c = testing.camera_trace_inputs(scene, "pinhole", CAM_POS,
                                    np.diag([1.0, 1.0, -1.0]), param,
                                    DISPLAY_W, DISPLAY_H, device)
    args = (c.counts, c.ids, c.dmin, c.payload, c.rays)
    got = run_tracer_kernel(*args, early_exit=True, **c.kw)
    ref, walked = _cluster_tracer_twin(*args, early_exit=True, **c.kw,
                                       count_walked=True)
    rows_differ = int((got != ref).any(dim=1).sum().item())
    pair = BATCH_RAYS * KERNEL_LEAF
    res = dict(shape=dict(tiles=c.kw["ng"], kp=int(c.ids.shape[1]),
                          kmax=c.kw["kmax"], rays=int(c.rays.shape[0])),
               live_tiles=int((c.counts > 0).sum().item()),
               mean_shortlist=float(c.counts.float().mean().item()),
               hit_share=float(torch.isfinite(ref[:, 0]).float().mean()
                               .item()),
               rows_differ=rows_differ,
               max_abs_err=float(torch.nan_to_num(
                   (got - ref).abs(), nan=0.0, posinf=0.0).max().item()),
               launches_per_image=1,
               pair_tests_from_below=_k2_pair_tests(c, ref),
               pair_tests_walked=int(walked.sum().item()) * pair,
               pair_tests_no_early_exit=int(
                   c.counts.clamp(0, c.kw["kmax"]).sum().item())
               * walked.shape[1] * pair)
    nbytes = _nbytes(*args, got)
    res.update(_bound(36.0 * res["pair_tests_from_below"], nbytes))
    res["walked_bound_ms"] = _bound(36.0 * res["pair_tests_walked"],
                                    nbytes)["bound_ms"]
    res["no_early_exit_bound_ms"] = _bound(
        36.0 * res["pair_tests_no_early_exit"], nbytes)["bound_ms"]
    res["ms"] = time_ms(lambda: run_tracer_kernel(*args, early_exit=True,
                                                  **c.kw),
                        reps=20, warmup=3)
    res["ms_no_early_exit"] = time_ms(
        lambda: run_tracer_kernel(*args, early_exit=False, **c.kw), reps=5,
        warmup=1)
    res["plain_ms"] = time_ms(
        lambda: cluster_tracer_reference(*args, early_exit=True, **c.kw),
        reps=1, warmup=0)
    if rows_differ:
        raise AssertionError(f"K2 differs from its twin at the image "
                             f"shapes: {res}")
    return res


def oracle_checks(r, cams, shots) -> dict:
    """Phase 9: each tile-culled frame against the oracle's image of the
    same camera on the card (under IMAGE_OFF_SHARE of pixels off by more
    than 2), the lit pinhole through the oracle (at least the unlit oracle
    image on every channel), the oracle's ray chunk, and each image's
    CUDA-event time."""
    from compound_ray_tpu_torch.cameras.raygen import (
        camera_rays,
        render_camera_image,
    )
    from compound_ray_tpu_torch.trace.intersect import (
        intersect_rays,
        oracle_ray_chunk,
    )
    from compound_ray_tpu_torch.trace.shade import miss_id

    dev = r.device
    sd = r.scene.device_triangles(dev)
    bg = miss_id(r.scene.background_shader)
    out = {}
    oracle = {}
    for _, kind, cam, param in cams:
        pos = np.asarray(cam.position, np.float32)
        ls = np.asarray(cam.local_space, np.float32)
        img, ms = _events_ms(lambda: render_camera_image(
            sd, kind, pos, ls, param, DISPLAY_W, DISPLAY_H, bg))
        oracle[kind] = img.cpu().numpy()
        share = _off_share(shots[kind]["frame"], oracle[kind])
        out[kind] = dict(fast_ms=shots[kind]["ms"], oracle_ms=ms,
                         off_share=share)
        if not share < IMAGE_OFF_SHARE or not shots[kind]["frame"][
                ..., :3].any():
            raise AssertionError(f"{kind}: tile-culled image vs oracle: "
                                 f"{out[kind]}")
    idx, kind, cam, param = cams[0]
    pos = np.asarray(cam.position, np.float32)
    ls = np.asarray(cam.local_space, np.float32)
    lights = r.get_lights()
    lit, ms = _events_ms(lambda: render_camera_image(
        sd, kind, pos, ls, param, DISPLAY_W, DISPLAY_H, bg, True, lights))
    lit = lit.cpu().numpy().astype(int)
    brighter = lit >= oracle[kind].astype(int)
    out["lit_pinhole"] = dict(oracle_ms=ms, lights=int(lights.shape[0]),
                              brighter_share=float(
                                  (lit > oracle[kind]).any(-1).mean()))
    if not brighter.all():
        raise AssertionError(f"lit pinhole under the unlit one: "
                             f"{out['lit_pinhole']}")
    # the oracle's sweep alone at the chunk its callers pass and at 512
    o, d, tmin = camera_rays(kind, torch.as_tensor(pos, device=dev),
                             torch.as_tensor(ls, device=dev),
                             torch.as_tensor(param, device=dev), DISPLAY_W,
                             DISPLAY_H)
    chunk = oracle_ray_chunk(dev)
    out["ray_chunk"] = chunk
    sweeps, winners = {}, {}
    for rc in (chunk, 512):
        hit, sweeps[rc] = _events_ms(lambda n=rc: intersect_rays(
            o.expand(d.shape), d, sd["v0"], sd["e1"], sd["e2"], tmin, 1e16,
            ray_chunk=n))
        winners[rc] = hit["tri_id"]
    if not torch.equal(winners[chunk], winners[512]):
        raise AssertionError("the oracle's winners depend on its ray chunk")
    out["sweep_ms"] = {f"ray_chunk {chunk}": sweeps[chunk],
                       "ray_chunk 512": sweeps[512]}
    out["pair_tests_per_image"] = DISPLAY_W * DISPLAY_H \
        * r.scene.num_triangles
    return out


def small_cameras_card_vs_cpu(r, cams) -> dict:
    """Phase 9: each kind at SMALL_W x SMALL_H on the card and on the CPU,
    tile-culled (K2 against its twin) and through the oracle, unlit; the
    lit pinhole through the oracle.  Channels within 1 but at near-ties
    (the two closest hits within 1e-6 relative in t).  The CPU renders a
    scene object of its own, so the card's memoised plans stay."""
    from compound_ray_tpu_torch import testing
    from compound_ray_tpu_torch.cameras.fast_image import (
        render_camera_image_fast,
    )
    from compound_ray_tpu_torch.cameras.raygen import render_camera_image
    from compound_ray_tpu_torch.trace.shade import miss_id

    cpu_scene = testing.make_big_scene(n_boxes=N_BOXES, seed=0)
    bg = miss_id(r.scene.background_shader)
    lights = r.get_lights()
    out = {}
    t0 = time.perf_counter()
    for _, kind, cam, param in cams:
        pos = np.asarray(cam.position, np.float32)
        ls = np.asarray(cam.local_space, np.float32)
        args = (kind, pos, ls, param, SMALL_W, SMALL_H, bg)
        img = {}
        for name, scene in (("card", r.scene), ("cpu", cpu_scene)):
            sd = scene.device_triangles(r.device if name == "card"
                                        else "cpu")
            img[name, "fast"] = render_camera_image_fast(scene, sd, *args)
            img[name, "oracle"] = render_camera_image(sd, *args)
            if kind == "pinhole":
                img[name, "lit"] = render_camera_image(sd, *args, True,
                                                       lights)
        ties = testing.camera_near_ties(r.scene, kind, pos, ls, param,
                                        SMALL_W, SMALL_H, r.device)
        for path in ("fast", "oracle", "lit"):
            if ("card", path) not in img:
                continue
            res = _card_vs_cpu(img["card", path].cpu().numpy(),
                               img["cpu", path].cpu().numpy(), ties)
            out[f"{kind} {path}"] = res
            if res["pixels_over_1_not_near_tie"]:
                raise AssertionError(f"{kind} {path} at {SMALL_W} x "
                                     f"{SMALL_H}: card vs CPU {res}")
    out["seconds"] = time.perf_counter() - t0
    return out


def packed_lit_vs_oracle(r, cam) -> dict:
    """Phase 9: the packed lit frame (render_means: K1, the shadow plan, K3)
    against the oracle (render_compound_means: shadow rays over the whole
    soup) with acceptance angles of 1e-6 rad, so that every sample of an
    ommatidium is the same ray and the two draws do not matter: the canopy
    scene's fan within LIT_ORACLE_ATOL, and the bench eye at the bench pose
    (1000 ommatidia, 2 samples, the default lights) with at most
    LIT_ORACLE_SHARE of its ommatidia over that."""
    from compound_ray_tpu_torch import testing
    from compound_ray_tpu_torch.eye.pipeline import render_means
    from compound_ray_tpu_torch.eye.render import render_compound_means
    from compound_ray_tpu_torch.scene.eye_io import ommatidia_to_array
    from compound_ray_tpu_torch.trace.lighting import default_lights
    from compound_ray_tpu_torch.trace.shade import miss_id

    tiny = float(np.degrees(1e-6))
    canopy = testing.make_canopy_scene()
    cases = (("canopy", canopy, ommatidia_to_array(testing.canopy_eye(tiny)),
              np.zeros(3, np.float32), np.eye(3, dtype=np.float32),
              default_lights(canopy.aabb_min, canopy.aabb_max)),
             ("bench eye", r.scene, ommatidia_to_array(
                 testing.make_sphere_eye(N_OMM, acceptance_deg=tiny)),
              np.asarray(cam.position, np.float32),
              np.asarray(cam.local_space, np.float32), r.get_lights()))
    out = {}
    for name, scene, omms, pos, ls, lights in cases:
        sd = scene.device_triangles(r.device)
        bg = miss_id(scene.background_shader)
        gen = torch.Generator(device=r.device).manual_seed(3)
        (ref, ms) = _events_ms(lambda: render_compound_means(
            sd, omms, pos, ls, gen, 2, bg, True, lights))
        got = render_means(scene, sd, omms, pos, ls,
                           torch.Generator(device=r.device).manual_seed(3),
                           2, bg, lights=lights)
        err = (got - ref).abs().amax(dim=1).cpu().numpy()
        res = dict(ommatidia=int(omms.shape[0]), max_abs=float(err.max()),
                   share_over_atol=float((err > LIT_ORACLE_ATOL).mean()),
                   oracle_ms=ms, oracle_max=float(ref.max().item()))
        out[name] = res
        bad = (res["max_abs"] > LIT_ORACLE_ATOL if name == "canopy"
               else res["share_over_atol"] > LIT_ORACLE_SHARE)
        if bad or not np.isfinite(err).all():
            raise AssertionError(f"packed lit vs oracle, {name}: {res}")
    return out


def lit_raw_samples(r, cam) -> dict:
    """Phase 9: raw samples with lighting on through the shim, which takes
    the oracle: RAW_LIT_SAMPLES samples of the bench eye, finite, and their
    mean against render_compound_means of the frame's generator seed within
    RAW_MEAN_ATOL."""
    from compound_ray_tpu_torch import load_eye_renderer
    from compound_ray_tpu_torch.api.renderer import frame_seed
    from compound_ray_tpu_torch.config import get_config
    from compound_ray_tpu_torch.eye.render import render_compound_means
    from compound_ray_tpu_torch.trace.shade import miss_id

    shim = load_eye_renderer(verbose=False)
    R = shim.renderer
    R.scene = r.scene
    if not shim.gotoCameraByName(cam.name.encode()):
        raise AssertionError("the bench eye is not in the scene")
    shim.setCurrentEyeShaderName(b"raw_ommatidial_samples")
    shim.setCurrentEyeSamplesPerOmmatidium(RAW_LIT_SAMPLES)
    R.set_lighting(True)
    ms = _events_ms(shim.renderFrame)[1]
    raw = R._raw_samples
    gen = torch.Generator(device=R.device)
    gen.manual_seed(frame_seed(get_config().base_seed, cam.rng_frame - 1))
    means = render_compound_means(
        r.scene.device_triangles(R.device), cam.ommatidia, cam.position,
        cam.local_space, gen, RAW_LIT_SAMPLES,
        miss_id(r.scene.background_shader), True, R.get_lights())
    res = dict(shape=list(raw.shape), frame_ms=ms,
               pair_tests=RAW_LIT_SAMPLES * N_OMM * r.scene.num_triangles
               * (1 + R.get_lights().shape[0]),
               mean_vs_means_max_abs=float(
                   (raw.mean(dim=0) - means).abs().max().item()),
               finite=bool(torch.isfinite(raw).all().item()))
    shim.stop()
    if (res["shape"] != [RAW_LIT_SAMPLES, N_OMM, 3] or not res["finite"]
            or not res["mean_vs_means_max_abs"] <= RAW_MEAN_ATOL):
        raise AssertionError(f"lit raw samples: {res}")
    return res


def real_cameras_phase(r, cam, card: str, count) -> dict:
    """Phase 9: the real cameras' path through the shim, counted by
    `count` (main's launch tally), then its checks; returns K2's entry at
    the image shapes."""
    t0 = time.perf_counter()
    cams = _real_cameras(r.scene)
    res_n = _path(r, "real cameras", lambda: camera_frames(r, cams), phase=9)
    shots, n = count(res_n)[0], res_n[1]
    if not (n["k2"] == shots["n_frames"] and n["k1"] == 0
            and n["k3"] == 0):
        raise AssertionError(f"the real-camera path launched {n}, not K2 "
                             f"{shots['n_frames']} times")
    checks = oracle_checks(r, cams, shots)
    print(f"phase 9: real cameras at {DISPLAY_W} x {DISPLAY_H} on the bench "
          f"scene ({r.scene.num_triangles} triangles), {card}: tile-culled "
          f"(K2) vs oracle image ms (CUDA events) and the share of pixels off "
          f"by more than 2 (< {IMAGE_OFF_SHARE}): {json.dumps(checks)}")
    k2i = k2_at_image_shapes(r.scene, r.device, cams[0][3])
    print(f"phase 9: K2 vs twin on the pinhole image's inputs ({card}): "
          f"{json.dumps(k2i)} (threshold: every row bit-equal)")
    print(f"phase 9: K2 at the image shapes: {k2i['ms']:.4f} ms per launch "
          f"(no early exit {k2i['ms_no_early_exit']:.4f}), "
          f"{k2i['launches_per_image']} launch per image; pair tests from "
          f"below {k2i['pair_tests_from_below']}, walked "
          f"{k2i['pair_tests_walked']}, no early exit "
          f"{k2i['pair_tests_no_early_exit']}; bound "
          f"{k2i['bound_ms']:.4f} ms from below, "
          f"{k2i['walked_bound_ms']:.4f} walked, "
          f"{k2i['no_early_exit_bound_ms']:.4f} with no early exit")
    small = small_cameras_card_vs_cpu(r, cams)
    print(f"phase 9: cameras at {SMALL_W} x {SMALL_H}, card vs CPU "
          f"(tile-culled, oracle; lit pinhole through the oracle): "
          f"{json.dumps(small)} (channels within 1 but at near-ties)")
    lit_cmp = packed_lit_vs_oracle(r, cam)
    print(f"phase 9: packed lit frame (K1, K3) vs the oracle, acceptance "
          f"1e-6 rad, 2 samples: {json.dumps(lit_cmp)} (canopy max abs <= "
          f"{LIT_ORACLE_ATOL}; bench eye share over it <= "
          f"{LIT_ORACLE_SHARE})")
    raw_lit = lit_raw_samples(r, cam)
    print(f"phase 9: lit raw samples through the oracle: "
          f"{json.dumps(raw_lit)} (mean vs means frame <= {RAW_MEAN_ATOL})")
    print(f"phase 9: host syncs of one steady-state pinhole "
          f"render_frame(sync=False): {len(shots['host_syncs'])} "
          f"{json.dumps(shots['host_syncs'])}")
    print(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return k2i


def _burst_layout_k1(calls, got_means, want_means, samples, n, g):
    """The burst's K1 launch (the last of `calls`, recorded as the burst
    made it) against its twin, and its per-ray results against K1 at the
    single-frame layout: frames 0 and n - 1 cut out of the stacked rays,
    padded as a frame pads its group's block, and traced alone must give
    the same t, u, v and slot on every live ray, bit for bit."""
    from compound_ray_tpu_torch.eye import pipeline as P
    from compound_ray_tpu_torch.testing import hit_agreement
    from compound_ray_tpu_torch.trace.mm_tracer import (
        packed_tracer_reference,
        run_packed_tracer,
    )

    rc, pmm, rays, kw, got = calls[-1]
    ng, rb2 = kw["ng"], kw["rb_size"]
    if kw["nrb"] != 1 or rb2 != P._ceil_to(g * n * samples, 256):
        raise AssertionError(f"the burst's K1 layout {kw} is not one block "
                             f"of {g} x {n} x {samples} rays per group")
    ref = packed_tracer_reference(rc, pmm, rays, **kw)
    agree, max_abs, max_rel = hit_agreement(ref, got, rc, rb2)
    rb = P._ceil_to(g * samples, 256)
    live = (rc > 0)[:, None, None]

    def frame_cols(x, f):  # (C, ng * rb2) -> frame f's (C, ng, g * S)
        c = x.shape[0]
        return (x.reshape(c, ng, rb2)[:, :, :g * n * samples]
                .reshape(c, ng, g, n, samples)[:, :, :, f]
                .reshape(c, ng, g * samples))

    layout_differ = 0
    for f in (0, n - 1):
        one = frame_cols(rays, f)
        one = torch.nn.functional.pad(one, (0, rb - g * samples),
                                      mode="replicate").reshape(16, ng * rb)
        out1 = run_packed_tracer(rc, pmm, one.contiguous(), ng=ng, nrb=1,
                                 rb_size=rb, rmax=kw["rmax"])
        a = frame_cols(got, f)[:4]
        b = out1.reshape(8, ng, rb)[:4, :, :g * samples]
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        layout_differ += int((~same.all(dim=0) & live[:, :, 0]).sum().item())
    diff = float(np.abs(got_means - want_means).max())
    res = dict(k1_shape=dict(ng=ng, rb_size=rb2, rmax=kw["rmax"],
                             rays=int(rays.shape[1])),
               k1_slot_agree=agree, k1_max_abs_err=max_abs,
               k1_max_rel_err=max_rel, k1_rays_differ_from_frame_layout=(
                   layout_differ),
               k1_ms=time_ms(lambda: run_packed_tracer(rc, pmm, rays, **kw),
                             reps=10, warmup=2),
               k1_frame_layout_ms=time_ms(
                   lambda: run_packed_tracer(rc, pmm, one.contiguous(),
                                             ng=ng, nrb=1, rb_size=rb,
                                             rmax=kw["rmax"]),
                   reps=10, warmup=2))
    if not (agree >= SLOT_AGREE and max_rel <= T_RTOL):
        raise AssertionError(f"K1 at the burst layout disagrees with its "
                             f"twin: {res}")
    if layout_differ or not (diff == 0.0 or diff <= BURST_ATOL):
        raise AssertionError(f"the burst differs from its frames: max abs "
                             f"{diff}, {res}")
    return res


def _settle_lit(r, n):
    """Lit: render passes of n synced frames until one leaves the shadow
    plan's corrective mode as it found it (at most 4), so a reference pass
    after it meets no replan."""
    from compound_ray_tpu_torch.eye import pipeline as P

    splan = P.scene_plan(r.scene, r.device)
    cam = r.current_camera()
    for _ in range(4):
        state = (splan.shadow_sound_all, len(splan.shadow_unsound_groups))
        cam.rng_frame = 0
        for _ in range(n):
            r.render_frame()
        if state == (splan.shadow_sound_all,
                     len(splan.shadow_unsound_groups)) and splan.shadow_store:
            return state
    raise AssertionError("the lit frames kept replanning their shadows")


def _tally(keys=("k1", "k2", "k3", "raygen")) -> dict:
    """The launch counts of `keys` (by default K1, K2, K3 and ray
    generation) now."""
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()
            if k in keys}


def _counted(sections: dict, name: str, fn):
    """fn()'s result; its K1, K2, K3 and ray generation launches go to
    sections[name]."""
    before = _tally()
    out = fn()
    sections[name] = {k: v - before[k] for k, v in _tally().items()}
    return out


def _sum_launches(parts) -> dict:
    return {k: sum(p[k] for p in parts)
            for k in ("k1", "k2", "k3", "raygen")}


def burst_case(r, cam, samples: int, n: int, lit: bool):
    """Phase 10: one burst at the bench pose.  n synced render_frame()
    calls from rng_frame 0 are the reference (after a warm-up frame, or
    settled passes when lit); then n render_frame(sync=False) calls and
    one sync (the per-frame loop), and render_frames_pipelined(n), each
    from rng_frame 0 and timed with CUDA events; the burst's host syncs
    and the timed burst's peak device memory.  Every launch of the case
    falls in one of its sections (res["launches"]), each burst's exactly
    one K1 stacked (K3 too when lit) or n scanned.  Returns (res, what
    _burst_layout_k1 takes for a stacked burst, else None): that check
    launches K1 itself, so it runs after the path."""
    from compound_ray_tpu_torch.eye import pipeline as P

    r.set_lighting(lit)
    r.set_current_eye_samples_per_ommatidium(samples)
    splan = P.scene_plan(r.scene, r.device)
    start, sections = _tally(), {}
    # the warm-up frame (lit: the settled passes) plans the pose at these
    # samples
    state = _counted(sections, "warm-up", lambda: _settle_lit(r, n) if lit
                     else r.render_frame())

    def from_zero(fn):
        cam.rng_frame = 0
        return _events_ms(fn)[1]

    def loop(sync):
        for _ in range(n):
            r.render_frame(sync=sync)
        r.sync()

    res = dict(samples=samples, frames=n, lit=lit,
               stacked=1 < n * samples <= P.STACK_BURST_MAX_SAMPLES)
    res["synced_ms_per_frame"] = _counted(
        sections, "synced frames", lambda: from_zero(lambda: loop(True))) / n
    want = r.get_camera_data().copy()
    if lit and state != (splan.shadow_sound_all,
                         len(splan.shadow_unsound_groups)):
        raise AssertionError("a lit reference frame replanned its shadows")
    res["loop_ms_per_frame"] = _counted(
        sections, "per-frame loop",
        lambda: from_zero(lambda: loop(False))) / n
    calls = []
    real = P.run_packed_tracer

    def record(row_counts, packed_mm, rays, **kw):
        out = real(row_counts, packed_mm, rays, **kw)
        calls.append((row_counts, packed_mm, rays, kw, out))
        return out

    P.run_packed_tracer = record
    try:
        res["first_burst_ms_per_frame"] = _counted(
            sections, "burst", lambda: from_zero(
                lambda: r.render_frames_pipelined(n))) / n
    finally:
        P.run_packed_tracer = real
    torch.cuda.reset_peak_memory_stats()
    res["burst_ms_per_frame"] = _counted(
        sections, "timed burst", lambda: from_zero(
            lambda: r.render_frames_pipelined(n))) / n
    res["burst_peak_mb"] = torch.cuda.max_memory_allocated() / 2**20
    got = r.get_camera_data().copy()
    _check_means(got, f"burst {samples} x {n}", lit=lit)
    if cam.rng_frame != n:
        raise AssertionError(f"the burst left rng_frame {cam.rng_frame}")
    diff = float(np.abs(got - want).max())
    res.update(bit_equal=bool(np.array_equal(got, want)), max_abs_diff=diff)
    cam.rng_frame = 0
    res["host_syncs_per_burst"] = _counted(
        sections, "host-sync burst",
        lambda: _host_syncs(lambda: r.render_frames_pipelined(n)))
    r.set_lighting(False)
    res["launches"] = sections
    total = {k: v - start[k] for k, v in _tally().items()}
    want_k1 = 1 if res["stacked"] else n
    burst = dict(k1=want_k1, k2=0, k3=want_k1 if lit else 0, raygen=want_k1)
    if (total != _sum_launches(sections.values())
            or sections["synced frames"] != sections["per-frame loop"]
            or any(sections[b] != burst for b in (
                "burst", "timed burst", "host-sync burst"))):
        raise AssertionError(f"the burst case launched {total}: {res}")
    if res["stacked"]:
        return res, (calls, got, want, samples, n,
                     P.eye_plan(cam.ommatidia, samples).g)
    if not diff <= BURST_ATOL:
        raise AssertionError(f"the scanned burst differs from its frames: "
                             f"{res}")
    return res, None


def pose_batch(r, cam) -> dict:
    """Phase 10: bench.py's pose sweep (N_POSES poses uniform +-0.5 around
    the bench pose, identity rotation, POSE_SAMPLES samples, warmed with 3
    other poses): render_batch_poses, the synced set-pose frames and the
    unsynced pose stream, each timed with CUDA events; the batch on a
    1e-5 degree copy of the bench eye against its sequential frames; the
    device memory after MEMORY_BATCHES more batches of new poses, which
    must stay within the pack store's byte bound and the eye plans'
    copies; one GA_POSES-pose batch with the bytes of its pack and its
    peak; and STEADY_FRAMES frames at the bench pose after it, which must
    pack nothing and launch K1 once each."""
    from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera
    from compound_ray_tpu_torch.config import get_config
    from compound_ray_tpu_torch.eye import pipeline as P
    from compound_ray_tpu_torch.testing import make_sphere_eye
    from compound_ray_tpu_torch.trace import mm_tracer

    splan = P.scene_plan(r.scene, r.device)
    # the packs the bench eye's steady frames left in the store (phases
    # 5-10 at 1, 100 and 3200 samples): (samples, cache, shape, MB)
    res = dict(bench_packs=[
        [k[1], bool(k[3]), list(v[1].shape),
         round(P._pack_nbytes(v) / 2**20, 1)]
        for k, v in splan.packed_store.items()])
    rng = np.random.default_rng(0)
    base = np.asarray(cam.position, np.float64)
    poses = base[None, :] + rng.uniform(-0.5, 0.5, (N_POSES, 3))
    poses2 = base[None, :] + rng.uniform(-0.5, 0.5, (N_POSES, 3))
    r.set_current_eye_samples_per_ommatidium(POSE_SAMPLES)
    for p in base[None, :] + np.random.default_rng(1).uniform(
            -0.5, 0.5, (3, 3)):
        cam.set_position(tuple(p))
        r.render_frame()
    batch = [(tuple(p), np.eye(3)) for p in poses]
    r.render_batch_poses(batch)  # the folded eye's plans
    k1 = mm_tracer.launches
    out, ms = _events_ms(lambda: r.render_batch_poses(batch))
    res.update(poses=N_POSES, samples=POSE_SAMPLES,
               batch_launches_k1=mm_tracer.launches - k1,
               batch_ms_per_pose=ms / N_POSES)
    if out.shape != (N_POSES, N_OMM, 3) or not np.isfinite(out).all():
        raise AssertionError(f"render_batch_poses gave {out.shape}")

    def sweep(ps, sync):
        for p in ps:
            cam.set_position(tuple(p))
            r.render_frame(sync=sync)
        r.sync()

    res["synced_ms_per_pose"] = _events_ms(lambda: sweep(poses, True))[1] \
        / N_POSES
    res["stream_ms_per_pose"] = _events_ms(lambda: sweep(poses2, False))[1] \
        / N_POSES
    cam.set_position(tuple(base))

    still = CompoundEyeCamera("bench-eye-1e-5", "single_dimension_fast",
                              make_sphere_eye(N_OMM, acceptance_deg=1e-5))
    r.scene.cameras.append(still)
    r.goto_camera(len(r.scene.cameras) - 1)
    still.set_samples_per_ommatidium(POSE_SAMPLES)
    got = r.render_batch_poses(batch)
    seq = []
    for p in poses:
        still.set_position(tuple(p))
        r.render_frame()
        seq.append(r.get_camera_data().copy())
    res["still_eye_batch_vs_sequential_max_abs"] = float(
        np.abs(got - np.stack(seq)).max())
    r.scene.cameras.pop()
    r.goto_camera(r.scene.cameras.index(cam))
    if not res["still_eye_batch_vs_sequential_max_abs"] <= MEANS_ATOL:
        raise AssertionError(f"the pose batch vs its frames: {res}")

    def held_mb():
        """(allocated, the pack LRU's tensors, the eye plans' device
        copies) in MB."""
        torch.cuda.synchronize()
        packs = sum(map(P._pack_nbytes, splan.packed_store.values()))
        eyes = sum(_nbytes(*t) for e in P._eye_plans.values()
                   for t in e._dev.values())
        return [round(x / 2**20, 1) for x in (
            torch.cuda.memory_allocated(), packs, eyes)]

    plans0, mem = len(P._eye_plans), {0: held_mb()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(1, MEMORY_BATCHES + 1):
        r.render_batch_poses([(tuple(p), np.eye(3)) for p in base[None, :]
                              + rng.uniform(-0.5, 0.5, (N_POSES, 3))])
        if i in (1, 4, 10, 25, MEMORY_BATCHES):
            mem[i] = held_mb()
    grown = mem[MEMORY_BATCHES][0] - mem[0][0]
    bound_mb = get_config().packed_store_bytes / 2**20
    if grown > bound_mb + mem[MEMORY_BATCHES][2]:
        raise AssertionError(f"{MEMORY_BATCHES} pose batches hold {grown} "
                             f"MB more, over the pack store's bound "
                             f"{bound_mb} MB and the eye plans' "
                             f"{mem[MEMORY_BATCHES][2]} MB")
    res.update(memory_batches=MEMORY_BATCHES,
               memory_batches_s=time.perf_counter() - t0,
               packed_store_bound_mb=bound_mb,
               mb_allocated_packs_eye_plans_after_batches=mem,
               memory_batches_peak_mb=round(
                   torch.cuda.max_memory_allocated() / 2**20, 1),
               device_mb_growth=mem[MEMORY_BATCHES][0] - mem[0][0],
               eye_plans_added=len(P._eye_plans) - plans0,
               eye_plans_held=len(P._eye_plans),
               packs_held=len(splan.packed_store))

    # one GA-size batch, with the bytes of the pack it builds
    built = []
    real = P._pack_fused

    def record(*a, **k):
        out = real(*a, **k)
        built.append(P._pack_nbytes(out))
        return out

    ga = [(tuple(p), np.eye(3)) for p in base[None, :]
          + rng.uniform(-0.5, 0.5, (GA_POSES, 3))]
    P._pack_fused = record
    torch.cuda.reset_peak_memory_stats()
    try:
        out, ms = _events_ms(lambda: r.render_batch_poses(ga))
        res["ga_peak_mb"] = round(torch.cuda.max_memory_allocated() / 2**20,
                                  1)
        res["ga_packs_mb"] = [round(b / 2**20, 1) for b in built]
        res.update(ga_poses=GA_POSES, ga_ms=ms, ga_ms_per_pose=ms / GA_POSES,
                   ga_held_mb=held_mb())
        if out.shape != (GA_POSES, N_OMM, 3) or not np.isfinite(out).all():
            raise AssertionError(f"the {GA_POSES}-pose batch gave "
                                 f"{out.shape}")
        # steady frames at the bench pose: one pack at most, then every
        # frame served from the store with one K1 launch
        cam.set_position(tuple(base))
        del built[:]
        r.render_frame()
        first = len(built)
        k1 = mm_tracer.launches
        for _ in range(STEADY_FRAMES):
            r.render_frame()
        res.update(steady_first_packs=first, steady_packs=len(built) - first,
                   steady_k1=mm_tracer.launches - k1)
    finally:
        P._pack_fused = real
    if not (res["steady_packs"] == 0 and res["steady_k1"] == STEADY_FRAMES
            and first <= 1):
        raise AssertionError(f"steady frames after the batches: {res}")
    return res


def tools_and_viewer() -> dict:
    """Phase 10: relax_gradient on the card against the CPU, the tool's
    default run on the card, the variance mapper's and the sample-rate
    finder's library calls on the card (the box scene and the 12-ommatidium
    icosphere eye, as tests/test_torch_tools.py), and VIEWER_TICKS viewer
    ticks with keys held, each with its frame."""
    from compound_ray_tpu_torch import EyeRenderer
    from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera
    from compound_ray_tpu_torch.gui.viewer import Viewer
    from compound_ray_tpu_torch.scene.eye_io import icosphere_eye
    from compound_ray_tpu_torch.testing import make_box_scene, make_sphere_eye
    from compound_ray_tpu_torch.tools import (
        eye_generator,
        minimum_sample_rate_finder,
        variance_mapper,
    )

    spread = np.stack([o.direction for o in make_sphere_eye(RELAX_POINTS)])
    spread /= np.linalg.norm(spread, axis=1, keepdims=True)
    card = eye_generator.relax_gradient(spread, iterations=RELAX_STEPS,
                                        device="cuda")
    cpu = eye_generator.relax_gradient(spread, iterations=RELAX_STEPS,
                                       device="cpu")
    res = dict(relax_card_vs_cpu_max_abs=float(np.abs(card - cpu).max()))
    start = eye_generator._sphere_random(RELAX_POINTS,
                                         np.random.default_rng(42))
    pts, res["relax_default_ms"] = _events_ms(
        lambda: eye_generator.relax_gradient(start, device="cuda"))
    res["relax_default_norm_err"] = float(np.abs(
        np.linalg.norm(pts, axis=1) - 1.0).max())
    if not (res["relax_card_vs_cpu_max_abs"] <= RELAX_ATOL
            and res["relax_default_norm_err"] <= 1e-5):
        raise AssertionError(f"relax_gradient: {res}")

    r = EyeRenderer(verbose=False, device="cuda")
    r.scene = make_box_scene(background="default_background")
    r.scene.cameras.append(CompoundEyeCamera(
        "eye", "single_dimension_fast", icosphere_eye()))
    r.set_render_size(12, 1)
    sd = variance_mapper.per_ommatidium_sd(r, samples=2, repeat=4)
    vmap = variance_mapper.map_variance_over_grid(
        r, [(0.0, 0.0, 0.0), (0.1, 0.0, 0.0)], samples=2, repeat=3)
    var = minimum_sample_rate_finder.variance_of_repeated_renders(r, 2, 4)
    min_s, sds = minimum_sample_rate_finder.find_minimum_samples(
        r, cutoff_percent=0.5, repeat=3, max_samples=8)
    res.update(variance_sd_max=float(sd.max()),
               variance_map_shape=list(vmap.shape), min_samples=min_s,
               sample_sds=sds)
    if not (sd.shape == (12,) and sd.max() > 0 and vmap.shape == (2, 12)
            and np.isfinite(vmap).all() and var.shape == (12,)
            and min_s >= 1 and sds):
        raise AssertionError(f"the variance tools: {res}")

    r = EyeRenderer(verbose=False, device="cuda")
    r.scene = make_box_scene(background="white")
    r.scene.cameras.append(CompoundEyeCamera(
        "eye", "spherical_orientationwise", make_sphere_eye(24)))
    v = Viewer(r, width=64, height=48)
    p0 = np.array(r.current_camera().position)
    for key in ("w", "a", "left", "up", "q"):
        v.handle_key(key)
    frames = []
    for _ in range(VIEWER_TICKS):
        v.tick()
        frames.append(v.frame())
    res["viewer_moved"] = float(np.linalg.norm(
        np.array(r.current_camera().position) - p0))
    if not (res["viewer_moved"] > 0 and all(
            f.shape == (48, 64, 3) and f.dtype == np.uint8 for f in frames)):
        raise AssertionError(f"the viewer: {res}")
    return res


def bursts_phase(r, cam, card: str, count) -> None:
    """Phase 10: the bursts, the pose batch, the tools and the viewer, as
    one path counted by `count` (main's launch tally), whose launches must
    be exactly those of its sections; then each stacked burst's K1 check,
    outside the path; prints each result with the card."""
    t0 = time.perf_counter()
    cam.set_projection("single_dimension_fast")  # phase 9 left raw samples
    r.set_lighting(False)
    sections = {}

    def run():
        cases = [burst_case(r, cam, *b) for b in BURSTS]
        for (res, _), b in zip(cases, BURSTS):
            sections["burst %d x %d%s" % (b[0], b[1], " lit" * b[2])] = (
                _sum_launches(res["launches"].values()))
        return (cases, _counted(sections, "pose batch",
                                lambda: pose_batch(r, cam)),
                _counted(sections, "tools and viewer", tools_and_viewer))

    res_n = _path(r, "bursts, pose batches, tools and viewer", run, phase=10)
    cases, batch, tools = count(res_n)[0]
    n = res_n[1]
    if not (n["k1"] > 0 and n["k3"] > 0 and n["k4"] == n["k5"] == n["k6"]
            == 0 and {k: n[k] for k in ("k1", "k2", "k3", "raygen")}
            == _sum_launches(sections.values())):
        raise AssertionError(f"phase 10 launched {n}, its sections "
                             f"{sections}")
    print(f"phase 10: launches by section: {json.dumps(sections)}")
    for (b, check) in cases:
        if check is not None:
            b.update(_burst_layout_k1(*check))
        print(f"phase 10: burst {b['samples']} samples x {b['frames']} "
              f"frames{' lit' if b['lit'] else ''} "
              f"({'stacked' if b['stacked'] else 'scanned'}), {card}: "
              f"{json.dumps(b)} (last means vs as many render_frame() calls "
              f"bit-equal or within {BURST_ATOL}; K1 winners >= "
              f"{SLOT_AGREE}, t rtol {T_RTOL})")
    print(f"phase 10: pose batch, {card}: {json.dumps(batch)} (1e-5 degree "
          f"eye: batch vs frames <= {MEANS_ATOL})")
    print(f"phase 10: tools and viewer, {card}: {json.dumps(tools)} "
          f"(relax_gradient card vs CPU <= {RELAX_ATOL})")
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")


def _camera_kind(cam):
    """(kind, parameter) of a real camera, as EyeRenderer.render_frame
    takes them."""
    from compound_ray_tpu_torch.cameras.types import (
        OrthographicCamera,
        PanoramicCamera,
    )

    if isinstance(cam, PanoramicCamera):
        return "panoramic", np.asarray([cam.start_radius], np.float32)
    if isinstance(cam, OrthographicCamera):
        return "orthographic", np.asarray(cam.scale, np.float32)
    return "pinhole", np.asarray(cam.scale, np.float32)


def blend_frames(r, sections) -> dict:
    """Phase 11's frames of the loaded .blend's compound eye at its pose:
    unlit at each of SAMPLES with the far field off and "auto", then lit
    (the first frame builds the shadow plan), a warm frame and
    BLEND_TIMED timed ones each (CUDA events); then each real camera
    through the shim's calls at DISPLAY_W x DISPLAY_H.  Records each
    setting's seed and last means for the checks after the path."""
    from compound_ray_tpu_torch.eye import pipeline as P

    cam = r.current_camera()
    splan = P.scene_plan(r.scene, r.device)
    out = {}

    def frames(key):
        first = _counted(sections, f"{key}, first",
                         lambda: _events_ms(r.render_frame)[1])
        return first, _counted(sections, key, lambda: [
            _events_ms(r.render_frame)[1] for _ in range(BLEND_TIMED)])

    for farfield in ("off", "auto"):
        _set_config(farfield=farfield)
        for s in SAMPLES:
            r.set_current_eye_samples_per_ommatidium(s)
            first, ms = frames(f"{s} samples, farfield {farfield}")
            means = r.get_camera_data().copy()
            _check_means(means, f".blend frame {s} {farfield}")
            out[f"{s} {farfield}"] = dict(
                first_ms=first, frame_ms=ms, seed=cam.rng_frame - 1,
                cache=bool(farfield == "auto" and splan.cache_store),
                means=means)
    _set_config()
    r.set_current_eye_samples_per_ommatidium(SAMPLES[-1])
    r.set_lighting(True)
    first, ms = frames(f"{SAMPLES[-1]} samples, lit")
    means = r.get_camera_data().copy()
    _check_means(means, ".blend lit frame", lit=True)
    out["lit"] = dict(first_ms=first, frame_ms=ms, seed=cam.rng_frame - 1,
                      means=means,
                      replan_pending=not splan.shadow_store)
    r.set_lighting(False)
    return out


def blend_cameras(shim) -> dict:
    """Phase 11: each real camera of the loaded .blend through the shim at
    DISPLAY_W x DISPLAY_H, a warm frame and BLEND_TIMED timed ones."""
    from compound_ray_tpu_torch import eye_tools as eyeTools

    eyeTools.configureFunctions(shim)
    eyeTools.setRenderSize(shim, DISPLAY_W, DISPLAY_H)
    out = {}
    for idx in range(shim.getCameraCount()):
        shim.gotoCamera(idx)
        if shim.isCompoundEyeActive():
            continue
        shim.renderFrame()
        ms = [_events_ms(shim.renderFrame)[1] for _ in range(BLEND_TIMED)]
        out[idx] = dict(ms=ms, frame=shim.getFramePointer().copy())
    eyeTools.setRenderSize(shim, 0, 0)
    return out


def run_examples(path: str, sections) -> dict:
    """Phase 11: each example's main on the .blend, in a scratch working
    directory, on its default device (the card), with EXAMPLE_ARGS; each
    example's wall time, launches and outputs."""
    import importlib
    import os
    import tempfile

    out = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        os.environ["CR_SCENE"] = path
        try:
            for name, args in EXAMPLE_ARGS.items():
                mod = importlib.import_module(
                    f"compound_ray_tpu_torch.examples.{name}")
                t0 = time.perf_counter()
                if args is None:
                    files = sorted(f for f in os.listdir(".") if
                                   "-frame-rendertime-averages-" in f)
                    ret = mod.read_results(files, ommatidia=N_OMM,
                                           samples=list(SPEED_SAMPLES))
                else:
                    file_args = [] if name in ("primary_example",
                                               "position_estimation") else [
                        "-f", path]
                    ret = _counted(sections, name,
                                   lambda: mod.main(file_args + args))
                res = dict(wall_s=time.perf_counter() - t0,
                           launches=sections.get(name))
                res.update(_example_outputs(name, ret))
                out[name] = res
        finally:
            os.chdir(cwd)
            del os.environ["CR_SCENE"]
    return out


def _example_outputs(name: str, ret) -> dict:
    """What an example wrote (in the working directory) and returned,
    checked: files present, PPM headers, finite numbers."""
    import glob

    def ppms(pattern):
        files = sorted(glob.glob(pattern))
        for f in files:
            if not open(f, "rb").read(2) == b"P6":
                raise AssertionError(f"{name}: {f} is not a PPM")
        return files

    res = {}
    if name == "primary_example":
        res["files"] = ppms("test-images/*.ppm")
    elif name == "speed_test":
        res["ms_per_frame"] = ret
        res["files"] = sorted(glob.glob("*-frame-rendertime-*.txt"))
    elif name == "plot_speed_test":
        (label, xs, times, rays), = ret
        res.update(label=label, rays_per_s=[float(x) for x in rays])
    elif name == "alias_quantified_experiment":
        res["avg_sd"] = [float(x) for x in ret]
        res["files"] = len(glob.glob("output/vector-data/*.txt"))
    elif name == "alias_viewpoint_experiment":
        res["files"] = ppms("artifacts/*.ppm")
        res["image_max"] = int(ret.max())
    elif name == "heterogeneous_demonstration":
        res["files"] = len(ppms("*omms*.ppm"))
    elif name == "overview_images":
        res["files"] = [f.split("/")[-1] for f in ppms("overview-images/*")]
    elif name == "position_estimation":
        train, test = ret
        res.update(final_train_l1=train[-1], final_test_l1=test[-1],
                   npz=sorted(np.load("position-estimation-results.npz")))
    numbers = [float(x) for k, v in res.items()
               if k not in ("files", "label", "npz") for x in np.ravel(v)]
    if not (res.get("files", 1) and np.isfinite(numbers).all()):
        raise AssertionError(f"{name}: {res}")
    return res


def blend_checks(r, cam, frames, shots) -> dict:
    """Phase 11's checks, after its path: each frame against the same
    frame (same seed) through the twins (K1's, the shading's, and K2's for
    the cache), the lit frame against the unlit one and the frame through
    the K1 and K3 twins, and each camera image against the oracle's."""
    from compound_ray_tpu_torch.cameras.raygen import render_camera_image
    from compound_ray_tpu_torch.eye import pipeline as P
    from compound_ray_tpu_torch.trace.cluster_tracer import (
        cluster_tracer_reference,
    )
    from compound_ray_tpu_torch.trace.mm_tracer import (
        packed_tracer_reference,
        rows_occlusion_reference,
    )
    from compound_ray_tpu_torch.trace.shade import miss_id

    splan = P.scene_plan(r.scene, r.device)
    out = {}
    lit = frames["lit"]
    for key, f in frames.items():
        if key == "lit":
            continue
        s, farfield = key.split()
        _set_config(farfield=farfield)
        r.set_current_eye_samples_per_ommatidium(int(s))
        splan.cache_store.clear()
        twin = _render(r, cam, f["seed"], tracer=packed_tracer_reference,
                       cache_tracer=cluster_tracer_reference,
                       shader=P.shade_means_reference)
        if f["cache"] != bool(splan.cache_store):
            raise AssertionError(f"{key}: the twin frame's cache differs")
        splan.cache_store.clear()
        out[key] = float(np.abs(twin - f["means"]).max())
    _set_config()
    # the lit frame again from its seed (a corrective replan after it would
    # change it), then through the K1 and K3 twins, and unlit
    r.set_current_eye_samples_per_ommatidium(SAMPLES[-1])
    again = _render(r, cam, lit["seed"], lights=r.get_lights())
    if not lit["replan_pending"] and not np.array_equal(again, lit["means"]):
        raise AssertionError("the .blend's lit frame is not reproduced")
    twin = _render(r, cam, lit["seed"], lights=r.get_lights(),
                   tracer=packed_tracer_reference,
                   shadow_tracer=rows_occlusion_reference)
    _set_config(farfield="off")
    unlit = _render(r, cam, lit["seed"])
    _set_config()
    out["lit"] = float(np.abs(twin - again).max())
    out["lit_minus_unlit_min"] = float((again - unlit).min())
    bad = {k: v for k, v in out.items() if k != "lit_minus_unlit_min"
           and not v <= MEANS_ATOL}
    if bad or out["lit_minus_unlit_min"] < -1e-6:
        raise AssertionError(f".blend frames vs twins: {out}")
    sd = r.scene.device_triangles(r.device)
    bg = miss_id(r.scene.background_shader)
    out["cameras"] = {}
    for idx, shot in shots.items():
        c = r.scene.cameras[idx]
        kind, param = _camera_kind(c)
        img, ms = _events_ms(lambda: render_camera_image(
            sd, kind, np.asarray(c.position, np.float32),
            np.asarray(c.local_space, np.float32), param, DISPLAY_W,
            DISPLAY_H, bg))
        share = _off_share(shot["frame"], img.cpu().numpy())
        out["cameras"][c.name] = dict(kind=kind, ms=shot["ms"],
                                      oracle_ms=ms, off_share=share)
        if not share < IMAGE_OFF_SHARE or not shot["frame"][..., :3].any():
            raise AssertionError(f"{c.name}: image vs oracle: {out}")
    return out


def blend_phase(card: str, count) -> None:
    """Phase 11: the bench scene written as a .blend (and gzipped) with its
    eye and cameras, loaded through the shim, its frames, lit frame and
    cameras, the gzipped file's frame and the eight examples, as one path
    counted by `count`, whose launches must be exactly those of its
    sections; then the checks and K3 against its twin on the .blend's own
    lit frame."""
    import tempfile
    from ctypes import c_char_p

    from compound_ray_tpu_torch import EyeRenderer, load_eye_renderer
    from compound_ray_tpu_torch.testing import (
        make_big_scene,
        write_big_scene_blend,
    )

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    path, gz = (write_big_scene_blend(
        tmp.name, N_BOXES, 0, N_OMM, ACCEPT_DEG, CAM_POS, gzip=z)
        for z in (False, True))
    write_s = time.perf_counter() - t0
    sections = {}
    state = {}

    def run():
        shim = load_eye_renderer(verbose=False)
        t = time.perf_counter()
        shim.loadGlTFscene(c_char_p(path.encode()))
        state["load_s"] = time.perf_counter() - t
        r = shim.renderer
        r.goto_camera_by_name("insect-eye-spherical-projector")
        state["frames"] = blend_frames(r, sections)
        state["shots"] = _counted(sections, "cameras",
                                  lambda: blend_cameras(shim))
        shim.gotoCamera(0)
        r.set_current_eye_samples_per_ommatidium(SAMPLES[0])
        _counted(sections, "gzip reference frame", r.render_frame)
        plain = r.get_camera_data().copy()
        rz = EyeRenderer(verbose=False)
        t = time.perf_counter()
        rz.load_gltf_scene(gz)
        state["gz_load_s"] = time.perf_counter() - t
        rz.goto_camera_by_name("insect-eye-spherical-projector")
        rz.set_current_eye_samples_per_ommatidium(SAMPLES[0])
        _counted(sections, "gzipped", rz.render_frame)
        state["gz_max_abs"] = float(np.abs(rz.get_camera_data()
                                           - plain).max())
        state["examples"] = run_examples(path, sections)
        return r

    res_n = _path(None, "the .blend scene and the examples", run, phase=11)
    r, n = count(res_n)[0], res_n[1]
    if {k: n[k] for k in ("k1", "k2", "k3", "raygen")} != _sum_launches(
            sections.values()) or not (
            n["k1"] > 0 and n["k2"] > 0 and n["k3"] > 0
            and n["k4"] == n["k5"] == n["k6"] == 0):
        raise AssertionError(f"phase 11 launched {n}, its sections "
                             f"{sections}")
    ref = make_big_scene(N_BOXES, seed=0)
    vert_err = max(float(np.abs(getattr(r.scene, k) - getattr(ref, k)).max())
                   for k in ("v0", "e1", "e2"))
    if not (r.scene.num_triangles == ref.num_triangles
            and vert_err <= BLEND_VERTEX_ATOL
            and state["gz_max_abs"] <= BURST_ATOL):
        raise AssertionError(f"the .blend scene: {r.scene.num_triangles} "
                             f"triangles, vertices off by {vert_err}, "
                             f"gzipped frame off by {state['gz_max_abs']}")
    print(f"phase 11: wrote {N_BOXES + 1} mesh objects and 4 cameras as "
          f".blend ({write_s:.2f} s for both files); loaded through the "
          f"shim in {state['load_s']:.3f} s, gzipped in "
          f"{state['gz_load_s']:.3f} s (wall); {r.scene.num_triangles} "
          f"triangles, vertices vs make_big_scene max abs {vert_err:.3e} "
          f"(<= {BLEND_VERTEX_ATOL}); the gzipped file's frame vs the "
          f"plain file's max abs {state['gz_max_abs']:.3e} (<= "
          f"{BURST_ATOL})")
    print(f"phase 11: launches by section: {json.dumps(sections)}")
    r.goto_camera_by_name("insect-eye-spherical-projector")
    cam = r.current_camera()
    frames, shots = state["frames"], state["shots"]
    checks = blend_checks(r, cam, frames, shots)
    for key, f in frames.items():
        print(f"phase 11: .blend frame {key} ({card}): first frame "
              f"{f['first_ms']:.3f} ms, frame ms (CUDA events) "
              f"{f['frame_ms']}; vs twins max abs {checks[key]:.3e} (<= "
              f"{MEANS_ATOL})" + (" (cache on)" if f.get("cache") else ""))
    print(f"phase 11: lit - unlit min {checks['lit_minus_unlit_min']:.3e}; "
          f"cameras at {DISPLAY_W} x {DISPLAY_H} vs oracle ({card}): "
          f"{json.dumps(checks['cameras'])} (< {IMAGE_OFF_SHARE} of pixels "
          f"off by more than 2)")
    k3 = lit_k3_vs_twin(r, cam, SAMPLES[-1])
    print(f"phase 11: K3 vs twin on the .blend's first lit frame "
          f"({card}): decisions differ {k3['decisions_differ']} of "
          f"{k3['live_rays']}, ms {k3['ms']:.3f}, twin ms "
          f"{k3['plain_ms']:.1f} (threshold: >= {K3_AGREE} equal)")
    for name, res in state["examples"].items():
        print(f"phase 11: example {name} ({card}): {json.dumps(res)}")
    st = state["examples"]["speed_test"]["ms_per_frame"]
    for s, ms in zip(SPEED_SAMPLES, st):
        print(f"phase 11: speed_test {s} samples: {ms:.3f} ms per frame, "
              f"{N_OMM * s / (ms / 1000.0):.4e} ommatidial rays/s on the "
              f".blend bench scene ({card})")
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")
    tmp.cleanup()


def _shard_spec() -> dict:
    """What a phase-12 rank renders, from this module's sizes, so a rank
    started as a subprocess renders what its parent checks."""
    return dict(n_boxes=N_BOXES, n_omm=N_OMM, accept_deg=ACCEPT_DEG,
                samples=SAMPLES[-1], raw_samples=SHARD_RAW_SAMPLES,
                burst=list(SHARD_BURST), warmup=SHARD_WARMUP,
                timed=SHARD_TIMED)


def _shard_setting_frames(r, cam, spec, raw: bool = False) -> dict:
    """1 + warm-up + timed frames of the rank's current setting through
    render_frame; returns the first frame's seed, the timed frames' ms
    (median and all), and the last frame's means (or raw samples) with
    its seed."""
    out = dict(first_seed=cam.rng_frame, frame_ms=[])
    for i in range(1 + spec["warmup"] + spec["timed"]):
        ms = _events_ms(r.render_frame)[1]
        if i == 0:
            out["first_frame_ms"] = ms
        elif i > spec["warmup"]:
            out["frame_ms"].append(ms)
    out["median_ms"] = float(np.median(out["frame_ms"]))
    out["seed"] = cam.rng_frame - 1
    out["result"] = (r._raw_samples if raw else r._device_means).cpu().numpy()
    return out


def _collective_ms(run) -> dict:
    """run() with torch.distributed's all_reduce and all_gather timed per
    call (the card synchronised before and after): {name: [ms, ...]}."""
    import torch.distributed as dist

    times = {"all_reduce": [], "all_gather": []}
    orig = {name: getattr(dist, name) for name in times}

    def wrap(name):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = orig[name](*a, **k)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            return res
        return call

    for name in times:
        setattr(dist, name, wrap(name))
    try:
        run()
    finally:
        for name, fn in orig.items():
            setattr(dist, name, fn)
    return times


def _shard_sections_expected(spec: dict) -> dict:
    """Each phase-12 B section's K1, K2, K3 and ray generation launches on
    one rank: a frame is one K1 launch, the first frame with the far-field
    cache builds it (one K2), the first lit frame probes its shadow plan
    (one K1 more) and every lit frame traces its shadow rays (one K3); a
    burst is one K1 launch per frame; each K1 launch traces the rays of
    one ray generation launch."""
    n = 1 + spec["warmup"] + spec["timed"]
    bursts = (1 + spec["timed"]) * spec["burst"][1]
    return {"off": dict(k1=n, k2=0, k3=0, raygen=n),
            "auto": dict(k1=n, k2=1, k3=0, raygen=n),
            "lit": dict(k1=n + 1, k2=0, k3=n, raygen=n + 1),
            "raw": dict(k1=n, k2=0, k3=0, raygen=n),
            "burst": dict(k1=bursts, k2=0, k3=0, raygen=bursts)}


def shard_rank_path(spec: dict):
    """Phase 12 B, one rank (its process group already joined): the bench
    configuration on an EyeRenderer with backend "auto", which must take
    the "sharded" route; with every launch count set to 0, frames at
    spec["samples"] with the far field off, on (the cache: K2) and lit
    (the shard-major shadow plan: K3), raw samples and the renderer's
    bursts, each a section of the path whose launches are counted; the
    counts are read there.  Then, outside the path, one burst against its
    frames one by one and the collectives' times over one frame of each
    kind.  Returns (a JSON-able dict, {name: array})."""
    global N_BOXES, N_OMM, ACCEPT_DEG
    from compound_ray_tpu_torch.parallel import sharding as S

    N_BOXES, N_OMM, ACCEPT_DEG = (spec["n_boxes"], spec["n_omm"],
                                  spec["accept_deg"])
    _set_config()
    r, cam = _bench_renderer("cuda")
    if r._burst_route() != "sharded":
        raise AssertionError(f"rank took the {r._burst_route()} route")
    samples = spec["samples"]
    counters = _counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    res, arrays, sections = {}, {}, {}
    r.set_current_eye_samples_per_ommatidium(samples)
    for tag, farfield, lit in (("off", "off", False), ("auto", "auto", False),
                               ("lit", "auto", True)):
        _set_config(farfield=farfield)
        r.set_lighting(lit)
        res[tag] = _counted(sections, tag,
                            lambda: _shard_setting_frames(r, cam, spec))
        arrays[tag] = res[tag].pop("result")
    r.set_lighting(False)
    _set_config()
    cam.set_projection("raw_ommatidial_samples")
    r.set_current_eye_samples_per_ommatidium(spec["raw_samples"])
    res["raw"] = _counted(sections, "raw", lambda: _shard_setting_frames(
        r, cam, spec, raw=True))
    arrays["raw"] = res["raw"].pop("result")
    cam.set_projection("single_dimension_fast")
    bs, bf = spec["burst"]
    r.set_current_eye_samples_per_ommatidium(bs)
    burst_ms = _counted(sections, "burst", lambda: [
        _events_ms(lambda: r.render_frames_pipelined(bf))[1] / bf
        for _ in range(1 + spec["timed"])][1:])
    res["burst"] = dict(frame_ms=burst_ms,
                        median_ms=float(np.median(burst_ms)),
                        seed=cam.rng_frame)
    res["launches"] = {k: getattr(mod, attr)
                       for k, (mod, attr) in counters.items()}
    res["sections"] = sections
    # after the path: a burst against its frames one by one
    mesh = r._mesh(bs)

    def args(gen):
        return r._frame_args(cam.ommatidia, cam.position, cam.local_space,
                             gen, bs)

    def gens():  # a draw advances its generator: fresh ones for each use
        return [r._generator(cam.rng_frame + k) for k in range(bf)]

    arrays["burst"] = S.render_means_sharded_packed_frames(
        *args(gens()), mesh).cpu().numpy()
    arrays["burst_sequential"] = np.stack([
        S.render_means_sharded_packed(*args(g), mesh).cpu().numpy()
        for g in gens()])
    res["coords"] = list(mesh.coords)
    res["mesh"] = dict(mesh.shape)
    # the collectives, timed alone: a means frame and a raw frame
    r.set_current_eye_samples_per_ommatidium(samples)
    res["collectives_means"] = _collective_ms(r.render_frame)
    cam.set_projection("raw_ommatidial_samples")
    r.set_current_eye_samples_per_ommatidium(spec["raw_samples"])
    res["collectives_raw"] = _collective_ms(r.render_frame)
    cam.set_projection("single_dimension_fast")
    return res, arrays


def shard_rank(rank: int, store: str, out_dir: str, spec: dict) -> None:
    """A phase-12 rank: join the gloo group of SHARD_RANKS ranks through
    the file:// store, run shard_rank_path on the card, write
    rank<rank>.json and .npz into out_dir, leave the group."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=SHARD_RANKS)
    try:
        res, arrays = shard_rank_path(spec)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def run_shard_ranks(out_dir: str, spec: dict) -> list:
    """Start SHARD_RANKS ranks of this script (`--shard-rank`), each with
    SHARD_RANK_TIMEOUT_S; a rank that fails, hangs or exits non-zero fails
    the phase (every rank still running is killed).  Returns each rank's
    (result dict, arrays)."""
    import subprocess

    store = os.path.join(out_dir, "store")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard-rank", str(k),
         store, out_dir, json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(SHARD_RANKS)]
    logs, failed = [], []
    deadline = time.monotonic() + SHARD_RANK_TIMEOUT_S
    try:
        for k, p in enumerate(procs):
            try:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                failed.append(f"rank {k} passed its {SHARD_RANK_TIMEOUT_S} s")
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed += [f"rank {k} exited {p.returncode}:\n{log[-3000:]}"
               for k, (p, log) in enumerate(zip(procs, logs))
               if p.returncode != 0]
    if failed:
        raise AssertionError("phase 12 ranks failed: " + "\n".join(failed))
    out = []
    for k in range(SHARD_RANKS):
        with open(os.path.join(out_dir, f"rank{k}.json")) as f:
            res = json.load(f)
        out.append((res, dict(np.load(os.path.join(out_dir,
                                                   f"rank{k}.npz")))))
    return out


def nccl_one_rank(r, cam, tmp: str):
    """Phase 12 A: a world of one NCCL rank on the card.  The path: 1 +
    SHARD_TIMED unlit SAMPLES[-1]-sample bench frames through
    render_means_sharded_packed on the (1, 1) mesh (its all-reduce and
    all-gather run on the card), all on one seed.  After it, one frame
    through render_means on that seed, bit-equal to the first sharded
    frame (one shard, factor 1.0), as many dense frames timed, and the
    collectives of one more sharded frame.  Returns (a result dict,
    {kernel: launches in the path})."""
    import torch.distributed as dist

    from compound_ray_tpu_torch.parallel import sharding as S

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl-store",
                            rank=0, world_size=1)
    try:
        _set_config()
        mesh = S.make_eye_mesh(sample_parallel=S.pick_sample_parallel(
            SAMPLES[-1]), device="cuda")
        seed = cam.rng_frame

        def sharded():
            return S.render_means_sharded_packed(*r._frame_args(
                cam.ommatidia, cam.position, cam.local_space,
                r._generator(seed), SAMPLES[-1]), mesh)

        runs, n = _path(r, "sharded path A (one NCCL rank)", lambda: [
            _events_ms(sharded) for _ in range(1 + SHARD_TIMED)], phase=12)
        if {k: v for k, v in n.items() if k != "refine"} != dict(
                k1=1 + SHARD_TIMED, k1a=0, k2=1, k3=0, k4=0, k5=0, k6=0,
                shade=1 + SHARD_TIMED, raygen=1 + SHARD_TIMED, cull=1):
            raise AssertionError(f"phase 12 A's path launched {n}, not K1, "
                                 f"the shading and ray generation "
                                 f"{1 + SHARD_TIMED} times, K2 and the "
                                 f"cull once")
        got = runs[0][0]
        dense = _render_out(r, cam, seed)
        if not torch.equal(got, dense):
            raise AssertionError(
                f"the NCCL (1, 1) frame differs from render_means: max abs "
                f"{(got - dense).abs().max().item()}")
        dense_ms = [_events_ms(lambda: _render_out(r, cam, seed))[1]
                    for _ in range(SHARD_TIMED)]
        times = _collective_ms(sharded)
        res = dict(backend=dist.get_backend(), mesh=dict(mesh.shape),
                   bit_equal=True, first_frame_ms=runs[0][1],
                   frame_ms=[round(ms, 4) for _, ms in runs[1:]],
                   dense_frame_ms=[round(x, 4) for x in dense_ms],
                   collectives_ms={k: [round(x, 4) for x in v]
                                   for k, v in times.items()})
        return res, n
    finally:
        dist.destroy_process_group()


def shard_kernels_vs_twins(r, cam, first_seed: int) -> dict:
    """K1 and K3 against their twins at the shapes of the shards: the
    (2, 2) mesh plan of the lit bench frame (probing the ranks' first lit
    frame), each shard core's K1 and K3 inputs recorded as it hands them
    over (K1 at the shard's groups and ray block, K3 on its block of the
    shard-major shadow table); and each shard's partial means through the
    K1 twin against its means through K1."""
    from compound_ray_tpu_torch.parallel import sharding as S
    from compound_ray_tpu_torch.testing import hit_agreement
    from compound_ray_tpu_torch.trace.mm_tracer import (
        _row_ranges,
        packed_tracer_reference,
        rows_occlusion_reference,
        run_packed_tracer,
        run_rows_occlusion,
    )

    _set_config()
    shape = {"omm": SHARD_RANKS // 2, "sample": 2}
    args = r._frame_args(cam.ommatidia, cam.position, cam.local_space,
                         r._generator(first_seed), SAMPLES[-1])
    plan = S._plan_for_mesh(*args, shape, lights=r.get_lights())
    k1_seen, k3_seen = [], []

    def record(seen, fn):
        def call(*a, **k):
            seen.append((a, k))
            return fn(*a, **k)
        return call

    coords = [(i, j) for i in range(shape["omm"])
              for j in range(shape["sample"])]
    plan.kw["tracer"] = record(k1_seen, run_packed_tracer)
    plan.kw["shadow_tracer"] = record(k3_seen, run_rows_occlusion)
    means = [S.shard_core(plan, i, j) for i, j in coords]
    del plan.kw["shadow_tracer"]
    plan.kw["tracer"] = packed_tracer_reference
    means_err = max(float((S.shard_core(plan, i, j) - m).abs().max())
                    for (i, j), m in zip(coords, means))
    k1 = dict(shards=len(k1_seen), slot_agree=1.0, max_abs_err=0.0,
              max_rel_err=0.0, means_vs_twin_max_abs=means_err, ms=[],
              plain_ms=[])
    for a, k in k1_seen:
        rc, pmm, rays = a
        got = run_packed_tracer(*a, **k)
        ref = packed_tracer_reference(*a, **k)
        agree, max_abs, max_rel = hit_agreement(ref, got, rc,
                                                k["nrb"] * k["rb_size"])
        k1.update(slot_agree=min(k1["slot_agree"], agree),
                  max_abs_err=max(k1["max_abs_err"], max_abs),
                  max_rel_err=max(k1["max_rel_err"], max_rel),
                  shape=dict(ng=k["ng"], rb_size=k["rb_size"],
                             rmax=k["rmax"], rays=rays.shape[1]))
        k1["ms"].append(round(time_ms(lambda: run_packed_tracer(*a, **k),
                                      reps=5), 4))
        k1["plain_ms"].append(round(time_ms(
            lambda: packed_tracer_reference(*a, **k), reps=1), 4))
    if not (k1["slot_agree"] >= SLOT_AGREE and k1["max_rel_err"] <= T_RTOL
            and means_err <= MEANS_ATOL):
        raise AssertionError(f"K1 disagrees with its twin at the shard "
                             f"shapes: {k1}")
    differ = live_rays = 0
    ms = []
    for a, k in k3_seen:
        r2v, flag, _, rays = a
        _, vg_rows = _row_ranges(r2v, flag, rays.shape[1] // (
            k["nrb"] * k["rb_size"]))
        live = torch.repeat_interleave(vg_rows > 0, k["nrb"] * k["rb_size"])
        got = run_rows_occlusion(*a, **k)
        ref = rows_occlusion_reference(*a, **k)
        differ += int((got[0, live] != ref[0, live]).sum().item())
        live_rays += int(live.sum().item())
        ms.append(time_ms(lambda: run_rows_occlusion(*a, **k), reps=5,
                          device=r.device))
    counts, r2v, _, flat_rows, _ = plan.kw["shadow"]
    agree = 1.0 - differ / max(live_rays, 1)
    k3 = dict(shards=len(k3_seen), table_rows=int(flat_rows.shape[0]),
              live_rows=int(counts.sum().item()), live_rays=live_rays,
              decisions_differ=differ, decision_agree=agree,
              ms_per_shard=[round(x, 4) for x in ms])
    if not agree >= K3_AGREE:
        raise AssertionError(f"K3 disagrees with its twin on the "
                             f"shard-major table: {k3}")
    return dict(k1=k1, k3=k3)


def shard_checks(r, cam, ranks):
    """Phase 12 B's checks in the parent: every rank's arrays bit-equal;
    the mesh plan's n_pad equal to the dense plan's; rank 0's frames
    against the dense frames of `r` on the same seeds (a lit plan probes the
    ranks' first lit frame first), timed as well; its raw samples against
    render_samples; its burst against its sequential frames.  Returns
    ({setting: max abs error}, {setting: dense median ms}, (mesh n_pad,
    dense n_pad))."""
    from compound_ray_tpu_torch.eye import pipeline as P
    from compound_ray_tpu_torch.eye.pipeline import render_samples
    from compound_ray_tpu_torch.trace.shade import miss_id

    res0, arr0 = ranks[0]
    for k, (res, arr) in enumerate(ranks[1:], 1):
        for name, x in arr0.items():
            if not np.array_equal(arr[name], x):
                raise AssertionError(f"rank {k}'s {name} differs from rank "
                                     f"0's")
    eplan_mesh = P.eye_plan(cam.ommatidia, SAMPLES[-1],
                            ng_multiple=res0["mesh"]["omm"])
    eplan_dense = P.eye_plan(cam.ommatidia, SAMPLES[-1])
    if eplan_mesh.n_pad != eplan_dense.n_pad:
        raise AssertionError(f"mesh n_pad {eplan_mesh.n_pad} != dense "
                             f"{eplan_dense.n_pad}")
    # rank 0 against the dense frames on the same seeds (a lit plan probes
    # the ranks' first lit frame first)
    errs, dense_ms = {}, {}
    for tag, farfield, lit in (("off", "off", False), ("auto", "auto", False),
                               ("lit", "auto", True)):
        _set_config(farfield=farfield)
        kw = dict(lights=r.get_lights()) if lit else {}
        if lit:
            _render(r, cam, res0[tag]["first_seed"], **kw)
        dense = _render(r, cam, res0[tag]["seed"], **kw)
        errs[tag] = float(np.abs(arr0[tag] - dense).max())
        dense_ms[tag] = float(np.median([_events_ms(
            lambda: _render_out(r, cam, res0[tag]["seed"], **kw))[1]
            for _ in range(SHARD_WARMUP + SHARD_TIMED)][SHARD_WARMUP:]))
        tol = SHARD_LIT_ATOL if lit else SHARD_UNLIT_ATOL
        if not errs[tag] <= tol:
            raise AssertionError(f"sharded {tag} frame vs dense: max abs "
                                 f"{errs[tag]} > {tol}")
    _set_config()
    pos, ls, _ = _pose(cam)
    gen = r._generator(res0["raw"]["seed"])
    raw_dense = render_samples(
        r.scene, r.scene.device_triangles(r.device), cam.ommatidia, pos, ls,
        gen, SHARD_RAW_SAMPLES, miss_id(r.scene.background_shader))
    errs["raw"] = float(np.abs(arr0["raw"] - raw_dense.cpu().numpy()).max())
    if not errs["raw"] <= SHARD_LIT_ATOL:
        raise AssertionError(f"sharded raw samples vs dense: max abs "
                             f"{errs['raw']}")
    if not np.array_equal(arr0["burst"], arr0["burst_sequential"]):
        raise AssertionError("a sharded burst frame differs from its "
                             "sequential sharded frame")
    return errs, dense_ms, (eplan_mesh.n_pad, eplan_dense.n_pad)


def sharded_phase(card: str, count, launches: dict) -> None:
    """Phase 12, the sharded path: A, one NCCL rank in process (counted as
    a path); B, SHARD_RANKS gloo ranks on the card (each rank's path
    counted by sections, its launches added to the kernel table), their
    results bit-equal across ranks, rank 0's against the dense frames on
    the same seeds, each burst frame against the sequential sharded frame,
    and K1 and K3 against their twins at the shards' shapes."""
    import tempfile

    t0 = time.perf_counter()
    r, cam = _bench_renderer("cuda")  # fresh plans: the dense references
    cam.set_samples_per_ommatidium(SAMPLES[-1])
    with tempfile.TemporaryDirectory() as tmp:
        a = count(nccl_one_rank(r, cam, tmp))[0]
    print(f"phase 12 A ({card}): {json.dumps(a)} (the (1, 1) frame "
          f"bit-equal to render_means)")
    torch.cuda.empty_cache()
    spec = _shard_spec()
    with tempfile.TemporaryDirectory() as tmp:
        tb = time.perf_counter()
        ranks = run_shard_ranks(tmp, spec)
        ranks_s = time.perf_counter() - tb
    expected = _shard_sections_expected(spec)
    for k, (res, _) in enumerate(ranks):
        total = _sum_launches(res["sections"].values())
        if res["sections"] != expected or any(
                res["launches"][key] != v for key, v in total.items()) or any(
                res["launches"][key] for key in ("k4", "k5", "k6")):
            raise AssertionError(
                f"rank {k}'s path launched {res['launches']} by sections "
                f"{res['sections']}, not {expected}")
        for key, v in res["launches"].items():
            launches[key] += v
    errs, dense_ms, n_pad = shard_checks(r, cam, ranks)
    res0 = ranks[0][0]
    twins = shard_kernels_vs_twins(r, cam, res0["lit"]["first_seed"])
    mesh = res0["mesh"]
    print(f"phase 12 B ({card}): {SHARD_RANKS} gloo ranks on one card, mesh "
          f"{mesh}, n_pad {n_pad[0]} (dense {n_pad[1]}); "
          f"ranks ran {ranks_s:.1f} s; every rank's results bit-equal; "
          f"rank 0 vs dense max abs {json.dumps(errs)} (<= "
          f"{SHARD_UNLIT_ATOL} unlit, {SHARD_LIT_ATOL} lit and raw); burst "
          f"frames bit-equal to the sequential sharded frames")
    print(f"phase 12 B: each rank's launches by section (the sum of its "
          f"path's): {json.dumps(expected)}")
    for k, (res, _) in enumerate(ranks):
        print(f"phase 12 B rank {k} at {res['coords']} ({card}): launches "
              f"{json.dumps(res['launches'])}; " + "; ".join(
                  f"{tag} first {res[tag]['first_frame_ms']:.3f} ms, median "
                  f"{res[tag]['median_ms']:.3f} ms"
                  for tag in ("off", "auto", "lit", "raw"))
              + f"; burst {SHARD_BURST[0]} x {SHARD_BURST[1]} median "
              f"{res['burst']['median_ms']:.3f} ms per frame")
    print(f"phase 12 B ({card}): dense frames in this process, median ms "
          f"{json.dumps(dense_ms)}, against the sharded frames' medians "
          f"above: the cost of {SHARD_RANKS} ranks sharing one card, not "
          f"scaling")
    for k, (res, _) in enumerate(ranks):
        coll = {f"{kind} {name}": dict(
            calls=len(v), median_ms=round(float(np.median(v)), 4) if v
            else None)
            for kind in ("means", "raw")
            for name, v in res[f"collectives_{kind}"].items()}
        print(f"phase 12 B rank {k} collectives ({card}, gloo on the card, "
              f"{SHARD_RANKS} ranks sharing it): {json.dumps(coll)}")
    print(f"phase 12 B: K1 vs twin at the shards' shapes ({card}): "
          f"{json.dumps(twins['k1'])} (thresholds: slots >= {SLOT_AGREE}, "
          f"t rtol {T_RTOL}, partial means <= {MEANS_ATOL})")
    print(f"phase 12 B: K3 vs twin on the shard-major table ({card}): "
          f"{json.dumps(twins['k3'])} (threshold: >= {K3_AGREE} equal)")
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")

def _mode_frames(r, n: int, **cfg) -> tuple:
    """n synced render_frame() calls under RenderConfig(**cfg), the eye's
    frames counted from 0: (the last frame's camera data, each frame's
    CUDA-event ms, {kernel: launches per frame})."""
    _set_config(**cfg)
    r.current_camera().rng_frame = 0
    ms, per = [], []
    for _ in range(n):
        before = _launch_counts()
        ms.append(_events_ms(r.render_frame)[1])
        per.append({k: v - before[k] for k, v in _launch_counts().items()})
    data = r.get_camera_data().copy()
    _check_means(data, f"{cfg} frame", lit=r.lighting)
    return data, ms, per


def _launch_counts() -> dict:
    """The K1 (both forms), K2 and K3 launch counts now."""
    return _tally(("k1", "k1a", "k2", "k3"))


def _expect_launches(per, tag: str, k1: int = 0, k1a: int = 1,
                     k2_first: int = 0) -> None:
    """Each frame of `per` launched K1 k1 times, its 8-feature form k1a
    times, K2 k2_first times in the first frame and never after, and K3
    never."""
    for i, n in enumerate(per):
        want = dict(k1=k1, k1a=k1a, k2=k2_first if i == 0 else 0, k3=0)
        if n != want:
            raise AssertionError(f"{tag} frame {i} launched {n}, not {want}")


def _affine_vs_standard(got, want, mean: float, what: str) -> dict:
    diff = np.abs(got - want)
    res = dict(max_abs=float(diff.max()), mean_abs=float(diff.mean()))
    if not (res["max_abs"] <= AFFINE_ATOL and res["mean_abs"] < mean):
        raise AssertionError(f"affine {what} vs standard: {res}")
    return res


def modes_path(r, cam) -> dict:
    """Phase 13's counted path through EyeRenderer at the bench eye: unlit
    3200-sample frames with the far field off, standard and affine in
    turns (standard, affine, affine, standard), each mode's first frame
    packing; affine frames with the far-field cache (the first builds it
    on K2); lit affine frames (the first probes its shadow plan on the
    8-feature K1); affine raw samples; an affine 128 x 10 burst (one
    8-feature launch); the sphere refine's frames; and backend "xla" at
    100 and 3200 samples (no kernel).  Each affine frame launches the
    8-feature K1 and never the 16-feature one."""
    from compound_ray_tpu_torch.eye import pipeline as P

    out, last = {}, {}
    r.set_current_eye_samples_per_ommatidium(SAMPLES[-1])
    for k, aff in enumerate((False, True, True, False)):
        tag = "affine" if aff else "standard"
        data, ms, per = _mode_frames(r, 1 + MODES_TIMED, farfield="off",
                                     affine_rays=aff)
        _expect_launches(per, tag, k1=int(not aff), k1a=int(aff))
        o = out.setdefault(f"{tag}_off", dict(first_ms=ms[0], ms=[]))
        o["ms"] += ms[1:]
        last.setdefault(tag, data)
        if not np.array_equal(last[tag], data):
            raise AssertionError(f"{tag} frames differ between passes")
    splan = P.scene_plan(r.scene, r.device)
    splan.cache_store.clear()
    data, ms, per = _mode_frames(r, 1 + MODES_TIMED, affine_rays=True)
    _expect_launches(per, "affine cache", k2_first=1)
    out["affine_auto"] = dict(first_ms=ms[0], ms=ms[1:])
    splan.shadow_store.clear()
    r.set_lighting(True)
    data, ms, per = _mode_frames(r, 1 + MODES_TIMED, affine_rays=True)
    r.set_lighting(False)
    # the first frame probes its shadow plan on the 8-feature K1; a frame
    # after a corrective replan probes again
    if per[0] != dict(k1=0, k1a=2, k2=0, k3=1) or any(
            n not in (dict(k1=0, k1a=1, k2=0, k3=1),
                      dict(k1=0, k1a=2, k2=0, k3=1)) for n in per):
        raise AssertionError(f"the affine lit frames launched {per}")
    out["affine_lit"] = dict(first_ms=ms[0], ms=ms[1:],
                             replans=sum(n["k1a"] == 2 for n in per[1:]))
    cam.set_projection("raw_ommatidial_samples")
    data, ms, per = _mode_frames(r, 1 + MODES_TIMED, farfield="off",
                                 affine_rays=True)
    cam.set_projection("single_dimension_fast")
    _expect_launches(per, "affine raw")
    out["affine_raw"] = dict(first_ms=ms[0], ms=ms[1:])
    bs, bf = AFFINE_BURST
    _set_config(farfield="off", affine_rays=True)
    r.set_current_eye_samples_per_ommatidium(bs)
    before = _launch_counts()
    ms = [_events_ms(lambda: r.render_frames_pipelined(bf))[1]
          for _ in range(1 + MODES_TIMED)]
    n = {k: v - before[k] for k, v in _launch_counts().items()}
    if n != dict(k1=0, k1a=1 + MODES_TIMED, k2=0, k3=0):
        raise AssertionError(f"the affine bursts launched {n}")
    out["affine_burst"] = dict(first_ms=ms[0],
                               ms_per_frame=[m / bf for m in ms[1:]])
    r.set_current_eye_samples_per_ommatidium(SAMPLES[-1])
    for mode in ("sphere", "exact"):
        data, ms, per = _mode_frames(r, 1 + MODES_TIMED, farfield="off",
                                     refine_mode=mode)
        _expect_launches(per, f"{mode} refine", k1=1, k1a=0)
        out[f"{mode}_off"] = dict(first_ms=ms[0], ms=ms[1:])
    for samples in XLA_SAMPLES:
        r.set_current_eye_samples_per_ommatidium(samples)
        data, ms, per = _mode_frames(r, 1 + (MODES_TIMED if samples > 100
                                             else 0), backend="xla")
        if any(any(x.values()) for x in per):
            raise AssertionError(f"backend xla launched kernels: {per}")
        out[f"xla_{samples}"] = dict(first_ms=ms[0], ms=ms[1:])
    _set_config()
    r.set_current_eye_samples_per_ommatidium(SAMPLES[-1])
    return out


def modes_checks(r, cam) -> dict:
    """Phase 13 after its path, on the bench eye and seeds of the path:
    affine frames against standard ones (far field off and on, lit, raw
    samples), an affine 128 x 10 burst against its frames (bit-equal), the
    shard core of an affine (2, 2) mesh plan at every coordinate against
    the dense affine frame on the same angles, the sphere refine against
    the exact one (the 1e-5 degree copy of the bench eye and the bench eye
    itself) with both packs' rows, and the culled backend at 100 samples
    against the oracle on the frame's generator."""
    from compound_ray_tpu_torch.api.renderer import frame_seed
    from compound_ray_tpu_torch.config import get_config
    from compound_ray_tpu_torch.eye import pipeline as P
    from compound_ray_tpu_torch.eye.render import (
        render_compound_means,
        render_compound_samples,
    )
    from compound_ray_tpu_torch.parallel import sharding as TS
    from compound_ray_tpu_torch.trace.shade import miss_id

    res = {}
    pos, ls, sig = _pose(cam)
    dev = r.scene.device_triangles(r.device)
    bg = miss_id(r.scene.background_shader)
    s = SAMPLES[-1]

    def gen(seed):
        return torch.Generator(device=r.device).manual_seed(
            frame_seed(get_config().base_seed, seed))

    def frame(omms=None, samples=s, seed=0, **kw):
        return P.render_means(r.scene, dev, cam.ommatidia if omms is None
                              else omms, pos, ls, gen(seed), samples, bg,
                              **kw).cpu().numpy()

    for tag, cfg, kw, mean in (
            ("off", dict(farfield="off"), {}, AFFINE_MEAN),
            ("auto", {}, {}, AFFINE_MEAN),
            ("lit", dict(farfield="off"), dict(lights=r.get_lights()),
             AFFINE_LIT_MEAN)):
        pair = []
        for aff in (False, True):
            _set_config(affine_rays=aff, **cfg)
            pair.append(frame(**kw))
        res[f"affine_{tag}"] = _affine_vs_standard(pair[1], pair[0], mean,
                                                   tag)
    raw = []
    for aff in (False, True):
        _set_config(farfield="off", affine_rays=aff)
        raw.append(P.render_samples(r.scene, dev, cam.ommatidia, pos, ls,
                                    gen(0), s, bg).cpu().numpy())
    share = float(np.isclose(raw[1], raw[0], atol=AFFINE_ATOL).mean())
    res["affine_raw_share_within_atol"] = share
    if not share > AFFINE_RAW_SHARE:
        raise AssertionError(f"affine raw samples: {share} within atol")
    bs, bf = AFFINE_BURST
    _set_config(farfield="off", affine_rays=True)
    burst = P.render_means_frames(r.scene, dev, cam.ommatidia, pos, ls,
                                  [gen(f) for f in range(bf)], bs,
                                  bg).cpu().numpy()
    seq = np.stack([frame(samples=bs, seed=f) for f in range(bf)])
    res["affine_burst_max_abs"] = float(np.abs(burst - seq).max())
    if not res["affine_burst_max_abs"] <= BURST_ATOL:
        raise AssertionError(f"the affine burst differs from its frames: "
                             f"{res['affine_burst_max_abs']}")
    # the shard core at every coordinate of an affine mesh plan; the eye's
    # 1000 ommatidia split evenly over the omm axis, so the mesh plan and
    # the dense plan hold the same groups and angles
    eplan = P.eye_plan(cam.ommatidia, s, ng_multiple=AFFINE_MESH["omm"])
    sd = torch.as_tensor(cam.ommatidia[eplan.perm][:, 6],
                         device=r.device) / P.FWHM_SD_RATIO
    angles = P.sample_angles_ns(gen(0), sd, s)
    plan = TS._plan_for_mesh(r.scene, dev, cam.ommatidia, pos, ls, None, s,
                             bg, AFFINE_MESH, angles=angles)
    if plan.kw["affine"] is not True:
        raise AssertionError("the mesh plan is not affine")
    before = _launch_counts()
    rows = [sum(TS.shard_core(plan, i, j)
                for j in range(AFFINE_MESH["sample"]))
            for i in range(AFFINE_MESH["omm"])]
    shards_k1a = _launch_counts()["k1a"] - before["k1a"]
    meshed = torch.cat(rows)[plan.inv_valid].cpu().numpy()
    kw, inv = P._plan_frame(r.scene, dev, cam.ommatidia, pos, ls, None, s,
                            bg, angles=angles)
    dense = P._trace_shade_angles(**kw)[inv].cpu().numpy()
    res["affine_shards"] = dict(
        k1a_launches=shards_k1a, max_abs=float(np.abs(meshed - dense).max()))
    if not (shards_k1a == 4 and res["affine_shards"]["max_abs"]
            <= AFFINE_SHARD_ATOL):
        raise AssertionError(f"affine shards vs dense: {res}")
    _set_config(farfield="off")
    # the two refines: rows of both packs at the bench eye, the frames there
    # (jittered rule) and on a 1e-5 degree copy (every sample on the axis)
    thin = cam.ommatidia.copy()
    thin[:, 6] = np.radians(1e-5)
    rows, bench, still = {}, {}, {}
    for mode in ("exact", "sphere"):
        _set_config(farfield="off", refine_mode=mode)
        bench[mode] = frame()
        still[mode] = frame(omms=thin, samples=SAMPLES[0])
        splan = P.scene_plan(r.scene, r.device)
        rc = [v[0] for k, v in splan.packed_store.items()
              if k[-2] == mode and k[1] == s and k[2] == sig and not k[-1]
              and not k[3]]
        rows[mode] = dict(total=int(rc[-1].sum().item()),
                          max=int(rc[-1].max().item()))
    d_still = float(np.abs(still["sphere"] - still["exact"]).max())
    d_bench = np.abs(bench["sphere"] - bench["exact"])
    res["refine"] = dict(rows=rows, still_max_abs=d_still,
                         bench_max_abs=float(d_bench.max()),
                         bench_mean_abs=float(d_bench.mean()))
    if not (d_still <= REFINE_ATOL and d_bench.mean() < REFINE_JITTER_MEAN
            and d_bench.max() <= REFINE_JITTER_ATOL):
        raise AssertionError(f"sphere vs exact refine: {res['refine']}")
    _set_config(backend="xla")
    cam.rng_frame = 0
    r.set_current_eye_samples_per_ommatidium(XLA_SAMPLES[0])
    r.render_frame()
    xla = r.get_camera_data()
    oracle = render_compound_means(dev, cam.ommatidia, pos, ls, gen(0),
                                   XLA_SAMPLES[0], bg).cpu().numpy()
    res["xla_vs_oracle_max_abs"] = float(np.abs(xla - oracle).max())
    res["oracle_ms"] = _events_ms(lambda: render_compound_samples(
        dev, cam.ommatidia, pos, ls, gen(0), XLA_SAMPLES[0], bg))[1]
    if not res["xla_vs_oracle_max_abs"] <= XLA_ATOL:
        raise AssertionError(f"backend xla vs the oracle: {res}")
    _set_config()
    r.set_current_eye_samples_per_ommatidium(SAMPLES[-1])
    return res


def modes_phase(card: str, count) -> dict:
    """Phase 13, the render modes: K1's 8-feature form against its twin at
    the bench frame (far field off and on), then the counted path
    (modes_path) and its checks (modes_checks).  Returns the 8-feature
    K1's results for the kernel table."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    r, cam = _bench_renderer("cuda")
    k1a_dense = kernel_vs_twin(r, cam, SAMPLES[-1], "off", timed=True,
                               affine=True)
    k1a = kernel_vs_twin(r, cam, SAMPLES[-1], "auto", timed=True,
                         affine=True)
    for res in (k1a_dense, k1a):
        print(f"phase 13: K1 8-feature (affine) vs twin at {N_OMM} x "
              f"{SAMPLES[-1]} ({card}): {json.dumps(res)} (thresholds: "
              f"slots >= {SLOT_AGREE}, t rtol {T_RTOL})")
    _set_config()
    path = count(_path(r, "render modes", lambda: modes_path(r, cam),
                       phase=13))[0]
    print(f"phase 13: frames ({card}, CUDA-event ms, first frame apart): "
          f"{json.dumps(path)}")
    checks = modes_checks(r, cam)
    print(f"phase 13: checks ({card}): {json.dumps(checks)} (affine vs "
          f"standard max abs <= {AFFINE_ATOL}, mean < {AFFINE_MEAN} ("
          f"lit {AFFINE_LIT_MEAN}); raw samples within the max abs on > "
          f"{AFFINE_RAW_SHARE}; burst <= {BURST_ATOL}; shards <= "
          f"{AFFINE_SHARD_ATOL}; sphere vs exact <= {REFINE_ATOL} at 1e-5 "
          f"degrees, mean < {REFINE_JITTER_MEAN} and max <= "
          f"{REFINE_JITTER_ATOL} at {ACCEPT_DEG} degrees; xla vs oracle <= "
          f"{XLA_ATOL})")
    print(f"phase 13: {time.perf_counter() - t0:.1f} s")
    return dict(k1a=k1a, k1a_dense=k1a_dense)


def _sweep_renderer(scene, omms, samples: int):
    """An EyeRenderer on the card holding the natural-1000 scene and eye at
    `samples` per ommatidium."""
    from compound_ray_tpu_torch import EyeRenderer
    from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera

    r = EyeRenderer(verbose=False, device="cuda")
    r.scene = scene
    r.scene.cameras.append(CompoundEyeCamera("eye", "single_dimension_fast",
                                             []))
    r.goto_camera(len(r.scene.cameras) - 1)
    r.set_ommatidia(omms)
    r.set_current_eye_samples_per_ommatidium(samples)
    return r


def refine_sweep_path(r, poses) -> list:
    """Phase 14's counted path: one render_frame at each pose, every pose
    new to the renderer's memos, so each view packs anew.  Each view's
    refine launches must equal the chunks of its one planning pass
    (_refine_chunks' ranges): 1 at one chunk.  Returns (launches, [chunks
    of each pass]) per view."""
    from compound_ray_tpu_torch.eye import pipeline as P

    chunking, passes, per_view = P._refine_chunks, [], []

    def counted(*args, **kw):
        out = chunking(*args, **kw)
        passes.append(len(out))
        return out

    P._refine_chunks = counted
    try:
        for pose in poses:
            passes.clear()
            before = P.refine_launches
            r.set_camera_pose(*pose)
            r.render_frame()
            per_view.append((P.refine_launches - before, list(passes)))
            _check_means(r.get_camera_data(), f"sweep view at {pose}")
    finally:
        P._refine_chunks = chunking
    for n, chunks in per_view:
        if len(chunks) != 1 or n != sum(chunks):
            raise AssertionError(f"a sweep view launched the refine {n} "
                                 f"times over passes of {chunks} chunks")
    return per_view


def _refine_work(P, splan, chunks, g: int) -> dict:
    """Operations and bytes the refine's chunks need (REFINE_*_OPS; each
    slot-table entry of a referenced cluster, the shortlists, counts and
    member rows read once; rows and keys written once)."""
    ops = nbytes = 0
    for args in chunks:
        omms_p, pos, ls, ids, cl = args[:5]
        kcand = ids.shape[1]
        live = ((torch.arange(kcand, device=ids.device)[None, :]
                 < cl[:, None])[:, :, None]
                & (splan.slot_radius_cl[ids] >= 0.0))
        pairs = int(live.sum())
        sphere = int(P._refine_mask(*args[:9], None)[0].sum())
        ops += (pairs * (g * REFINE_DIST_OPS + REFINE_SPHERE_OPS)
                + sphere * REFINE_TRIANGLE_OPS)
        nbytes += (int(torch.unique(ids).numel()) * P.KERNEL_LEAF
                   * REFINE_SLOT_BYTES + _nbytes(ids, cl)
                   + omms_p.shape[0] * 11 * 4
                   + ids.shape[0] * (4 + kcand * P.KERNEL_LEAF * 4))
    return dict(flop=float(ops), bytes=nbytes)


def refine_phase(card: str) -> dict:
    """Phase 14: the planning refine (csrc/refine_mask.cu) at the pose
    sweep's shapes (100 samples, two ommatidia a group, the exact refine).
    First the counted path, REFINE_VIEWS views of the sweep through
    render_frame (refine_sweep_path).  Then, chunk by chunk as
    _packed_plan calls it, at the configuration's pose and REFINE_POSES
    seeded poses: the kernel against its twin (row counts equal, keys bit
    for bit); its time per pose and the twin's (CUDA events over every
    chunk of the pose; the wrapper's time includes its per-ommatidium
    rows), the kernel's launches alone on precomputed rows, its bound,
    and each pose's one-pass plan (fresh store and hints) through the
    kernel and through the twin.  Returns the bare kernel's result for
    the kernel table, with the path's refine launches."""
    from compound_ray_tpu_torch import testing
    from compound_ray_tpu_torch.config import get_config
    from compound_ray_tpu_torch.eye import pipeline as P

    t0 = time.perf_counter()
    scene, omms, render_config, samples, poses = testing.natural_sweep(
        REFINE_POSES, 14)
    if samples != REFINE_SAMPLES:
        raise AssertionError(f"the sweep renders {samples} samples")
    _set_config(**render_config)
    r = _sweep_renderer(scene, omms, samples)
    views = testing.natural_sweep(REFINE_VIEWS, 15)[4][1:]
    per_view, path_n = _path(r, "pose sweep", lambda: refine_sweep_path(
        r, views), phase=14)
    if not (path_n["refine"] == sum(v[0] for v in per_view)
            and path_n["k1"] == len(views) and path_n["k3"] == 0):
        raise AssertionError(f"the sweep path launched {path_n}")
    one = [v[0] for v in per_view if v[1] == [1]]
    print(f"phase 14: pose sweep, {len(views)} views through render_frame "
          f"({card}): refine launches by view "
          f"{[v[0] for v in per_view]}, chunks by pass "
          f"{[v[1] for v in per_view]}; {len(one)} views at one chunk, "
          f"{sum(one)} launches")
    splan = P.scene_plan(scene, "cuda")
    eplan = P.eye_plan(omms, REFINE_SAMPLES)
    g, sig = eplan.g, get_config().cull_sigmas
    omms_p = eplan.device_arrays(omms, "cuda")[0]
    tri = splan.slot_tri_cl
    per_pose, work = [], dict(flop=0.0, bytes=0)
    for pose in poses:
        pos_np, ls_np = testing.pose_arrays(pose)
        pos = torch.as_tensor(pos_np, device="cuda")
        ls = torch.as_tensor(ls_np, device="cuda")
        gmask, counts, dmin = P._cull_groups(
            omms_p, pos, ls, splan.half_center, splan.half_radius, sig, g)
        kcand = min(splan.num_clusters,
                    max(8, P._ceil_to(max(int(counts.max()), 1), 8)))
        ids = P._shortlist_sorted(gmask, dmin, kcand)[0][:, :kcand]
        cl = torch.clamp(counts, max=kcand)
        chunks = [(omms_p[a * g:b * g], pos, ls, ids[a:b], cl[a:b],
                   splan.slot_center_cl, splan.slot_radius_cl, g, sig, tri)
                  for a, b in P._refine_chunks(ids.shape[0], g, kcand)]
        for args in chunks:
            rows_k, key = P.run_refine(*args)
            torch.cuda.synchronize()
            want_rows, want_key = P.refine_reference(*args)
            if not (torch.equal(rows_k, want_rows)
                    and torch.equal(key, want_key)):
                bad = int((key != want_key).sum())
                raise AssertionError(
                    f"refine kernel vs twin at {pos_np.tolist()}: rows "
                    f"{int((rows_k != want_rows).sum())} differ, keys {bad}")
        w = _refine_work(P, splan, chunks, g)
        work["flop"] += w["flop"]
        work["bytes"] += w["bytes"]
        res = dict(kcand=kcand, chunks=len(chunks), groups=ids.shape[0])
        res["key_ms"] = time_ms(lambda: [P.run_refine(*a) for a in chunks],
                                reps=REFINE_REPS)
        # the kernel alone: its launches on precomputed member rows
        bare = []
        for a in chunks:
            rows = torch.empty(a[3].shape[0], dtype=torch.int32,
                               device="cuda")
            bare.append((P._refine_cones(a[0], pos, ls, sig, True, None),
                         a[3], a[4], a[5], a[6], tri, g, False, rows,
                         torch.empty(a[3].shape[0], a[3].shape[1]
                                     * P.KERNEL_LEAF, device="cuda")))
        res["kernel_ms"] = time_ms(
            lambda: [P._launch_refine(*b) for b in bare], reps=REFINE_REPS)
        res["plain_ms"] = time_ms(
            lambda: [P.refine_reference(*a) for a in chunks], reps=3)
        res.update({k: v for k, v in _bound(w["flop"], w["bytes"]).items()
                    if k in ("bound_ms", "bound_by")})

        def plan(tag):  # the one pass, with a fresh store and hints
            splan.packed_store.clear()
            eplan.kmax_hint, eplan.rmax_hint = 8, 1
            return P._packed_plan(splan, eplan, omms_p, pos, ls,
                                  (pos_np.tobytes(), tag), REFINE_SAMPLES)

        kernel = P.run_refine
        res["plan_ms"] = _events_ms(lambda: plan("kernel"))[1]
        P.run_refine = P.refine_reference
        try:
            res["plan_plain_ms"] = _events_ms(lambda: plan("twin"))[1]
        finally:
            P.run_refine = kernel
        per_pose.append(res)
    n = len(per_pose)
    out = dict(
        poses=n, g=g, max_abs_err=0.0,  # keys bit-equal, or the phase raised
        ms=float(np.mean([p["kernel_ms"] for p in per_pose])),
        key_ms=float(np.mean([p["key_ms"] for p in per_pose])),
        plain_ms=float(np.mean([p["plain_ms"] for p in per_pose])),
        **_bound(work["flop"] / n, work["bytes"] // n),
        plan_ms=float(np.mean([p["plan_ms"] for p in per_pose])),
        plan_plain_ms=float(np.mean([p["plan_plain_ms"] for p in per_pose])),
        launches=path_n["refine"], views=len(views))
    print(f"phase 14: refine kernel vs twin at the pose sweep's shapes "
          f"({N_OMM} ommatidia x {REFINE_SAMPLES} samples, g {g}, exact; "
          f"{card}), per pose: {json.dumps(per_pose)}")
    print(f"phase 14: refine, mean of {n} poses: {json.dumps(out)} "
          f"(rows equal and keys bit for bit at every chunk; "
          f"{time.perf_counter() - t0:.1f} s)")
    return out


def _kernel_ms(fn, name: str, reps: int) -> float:
    """Mean device ms of the kernels whose name holds `name` over `reps`
    calls of fn (torch.profiler's CUDA activity): the kernel alone, without
    the wrapper's host time between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and name in e.name]
    if len(us) != reps:
        raise AssertionError(f"the profiler saw {len(us)} {name} launches "
                             f"of {reps}")
    return sum(us) / len(us) * 1e-3


def _shade_work(kw, out, rays) -> dict:
    """Bytes the unlit shading needs on these inputs, each read once: t
    and the direction of every ray, u, v and slot of every hit, the
    distinct attribute rows and quads the rays' colours take, the group
    counts, a cache frame's per-ommatidium origins, and the means."""
    from compound_ray_tpu_torch.eye import pipeline as P
    from compound_ray_tpu_torch.trace.shade import texture_quad_coords_c

    ng, g, rg_pad, samples = kw["ng"], kw["g"], kw["rg_pad"], kw["samples"]
    n_pad, cache, attr = ng * g, kw["cache"], kw["attr_table"]

    def planes(x):
        return x.reshape(ng, rg_pad)[:, :g * samples].reshape(n_pad, samples)

    t = planes(out[0])
    dx, dy, dz = (planes(rays[c]) for c in range(3))
    hit = (t < 1e30) & torch.repeat_interleave(kw["row_counts"] > 0,
                                               g)[:, None]
    if cache is not None:
        hit = hit & P._inside_far_sphere(t, kw["origins"], dx, dy, dz,
                                         kw["far_sphere"])
    hit = hit.reshape(-1)
    row = torch.clamp(planes(out[3]).reshape(-1).long(), 0,
                      attr.shape[0] - 1)[hit]
    quads = []
    if kw["textured"]:
        cu, cv, texid, _ = P._attrs_from_rows(
            attr[row], planes(out[1]).reshape(-1)[hit],
            planes(out[2]).reshape(-1)[hit], kw["tex_only"],
            attr.shape[1] == P.ATTR_COMPS_FLAT)
        idx = texture_quad_coords_c(kw["scene_dev"], torch.clamp(texid, min=0),
                                    cu, cv)[0]
        quads.append(idx[texid >= 0])
    if cache is not None:
        ch, cw = kw["cache_shape"]
        miss = ~hit
        idx = P._equirect_coords_c(ch, cw, dx.reshape(-1)[miss],
                                   dy.reshape(-1)[miss],
                                   dz.reshape(-1)[miss])[0]
        quads.append(idx + cache.reshape(-1, 16).shape[0] - ch * cw)
    n_quads = (int(torch.unique(torch.cat(quads)).numel()) if quads
               else 0)
    nbytes = (t.numel() * 16 + int(hit.sum()) * 12
              + int(torch.unique(row).numel()) * attr.shape[1] * 4
              + n_quads * 64 + ng * 4
              + (n_pad * 16 + 12 if cache is not None else 0)
              + n_pad * kw["frames"] * 12)
    return dict(nbytes=nbytes, hits=int(hit.sum()), rays=t.numel(),
                quads=n_quads)


def raygen_vs_twin(a, k) -> dict:
    """The ray generation kernel on one frame core's inputs (run_ray_features'
    arguments a, k) against ray_features_reference: rays and origins
    bit-equal, the kernel's device time (the profiler, over SHADE_REPS
    launches), its wrapper's and the twin's (CUDA events), and the bytes
    bound: the angles, the ommatidium rows and the pose read once, the
    rays and the origins written once."""
    from compound_ray_tpu_torch.eye import pipeline as P

    rays, ((ox, oy, oz), tmin) = P.run_ray_features(*a, **k)
    want, ((wx, wy, wz), wt) = P.ray_features_reference(*a, **k)
    pairs = [(rays, want), (ox, wx), (oy, wy), (oz, wz), (tmin, wt)]
    unequal = sum(int((x != y).sum()) for x, y in pairs)
    n_pad, samples = k["ng"] * k["g"], k["samples"]
    res = dict(g=k["g"], samples=samples, rg_pad=k["nrb"] * k["rb_size"],
               feats=rays.shape[0], slots=rays.shape[1],
               bit_equal=unequal == 0, unequal=unequal,
               max_abs_err=max(float((x - y).abs().max()) for x, y in pairs))
    if unequal:
        raise AssertionError(f"ray generation kernel vs twin: {res}")
    res["ms"] = _kernel_ms(lambda: P.run_ray_features(*a, **k),
                           "ray_features_kernel", SHADE_REPS)
    res["wrapper_ms"] = time_ms(lambda: P.run_ray_features(*a, **k),
                                reps=SHADE_REPS, warmup=3)
    res["plain_ms"] = time_ms(lambda: P.ray_features_reference(*a, **k),
                              reps=3)
    nbytes = (n_pad * samples * 8 + n_pad * 32 + 48 + _nbytes(rays)
              + n_pad * 16)
    res.update({key: v for key, v in _bound(0.0, nbytes).items()
                if key in ("bound_ms", "bound_by", "bytes")})
    return res


def shade_phase(card: str) -> list:
    """Phase 15: the frame core's unlit shading and means
    (csrc/shade_means.cu) at the shapes of the benchmark's three steady
    unlit cells (SHADE_CELLS), each built by the benchmark's own scene,
    eye and system code at SHADE_SEED.  Per cell: a counted path of
    SHADE_FRAMES frames through render_frame (one shading launch and one
    K1 launch a frame, no other kernel), the last frame's shading inputs
    through the kernel and the twin (SHADE_MAX_ABS, SHADE_MEAN_ABS), the
    kernel's device time (the profiler, over SHADE_REPS launches), its
    wrapper's and the twin's (CUDA events), and the bytes bound
    (_shade_work); then the ray generation kernel on the last frame's
    inputs (raygen_vs_twin; one launch a frame in the path, too).
    Returns one result dict per cell, the ray generation's under
    "raygen"."""
    from benchmark import scene as bench_scene
    from benchmark.system import System
    from compound_ray_tpu_torch.eye import pipeline as P

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "benchmark")
    results = []
    for config, traffic_name in SHADE_CELLS:
        t0 = time.perf_counter()
        name = f"{config}.{traffic_name}"
        with open(os.path.join(root, "configs", config + ".json")) as f:
            cfg = json.load(f)
        with open(os.path.join(root, "traffic", traffic_name + ".json")) as f:
            traffic = json.load(f)
        system = System(cfg, traffic, bench_scene.build_scene(cfg),
                        bench_scene.build_eye(cfg), SHADE_SEED,
                        torch.device("cuda"))
        system.view(tuple(float(v) for v in cfg["pose"]["position"]
                          + cfg["pose"]["rotation"]))  # plans, cache
        run, calls, frame_ms = P.run_shade_means, [], []
        run_rays, ray_calls = P.run_ray_features, []

        def record(*a, **k):
            calls.append((a, k))
            return run(*a, **k)

        def record_rays(*a, **k):
            ray_calls.append((a, k))
            return run_rays(*a, **k)

        def frames():
            for _ in range(SHADE_FRAMES):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                system.view()
                end.record()
                torch.cuda.synchronize()
                frame_ms.append(start.elapsed_time(end))

        P.run_shade_means, P.run_ray_features = record, record_rays
        try:
            _, n = _path(system.renderer, name, frames, phase=15)
        finally:
            P.run_shade_means, P.run_ray_features = run, run_rays
        if not (n["shade"] == n["k1"] == n["raygen"] == SHADE_FRAMES
                == len(calls) == len(ray_calls)
                and n["k2"] == n["k3"] == n["refine"] == 0):
            raise AssertionError(f"{name}: {SHADE_FRAMES} frames launched "
                                 f"{n}")
        a, k = calls[-1]
        got = run(*a, **k)
        want = P.shade_means_reference(*a, **k)
        err = (got - want).abs()
        res = dict(cell=name, g=k["g"], samples=k["samples"],
                   rg_pad=k["rg_pad"], cache=k["cache"] is not None,
                   textured=k["textured"],
                   max_abs_err=float(err.max()),
                   mean_abs_err=float(err.mean()), launches=n["shade"],
                   frame_ms=float(np.median(frame_ms)))
        if not (res["max_abs_err"] <= SHADE_MAX_ABS
                and res["mean_abs_err"] <= SHADE_MEAN_ABS):
            raise AssertionError(f"shading kernel vs twin: {res}")
        res["ms"] = _kernel_ms(lambda: run(*a, **k), "shade_means_kernel",
                               SHADE_REPS)
        res["wrapper_ms"] = time_ms(lambda: run(*a, **k), reps=SHADE_REPS,
                                    warmup=3)
        res["plain_ms"] = time_ms(
            lambda: P.shade_means_reference(*a, **k), reps=3)
        work = _shade_work(k, *a)
        res.update(work)
        res.update({key: v for key, v in _bound(0.0, work["nbytes"]).items()
                    if key in ("bound_ms", "bound_by")})
        print(f"phase 15: shading kernel at {name}'s shapes ({card}): "
              f"{json.dumps(res)} ({time.perf_counter() - t0:.1f} s)")
        res["raygen"] = raygen_vs_twin(*ray_calls[-1])
        res["raygen"].update(cell=name, launches=n["raygen"])
        print(f"phase 15: ray generation kernel at {name}'s shapes "
              f"({card}): {json.dumps(res['raygen'])} (rays and origins "
              f"bit-equal to the twin)")
        results.append(res)
        system.close()
    return results


def _cull_work(kw, counts, ids) -> dict:
    """Operations and bytes the cache's cull and shortlist needs on these
    inputs: a sub-sphere test (CULL_SUB_OPS) for every (tile, cluster of
    far_mask, sub-sphere); the tile cones and the per-cluster terms read
    once, the counts, ids and dmin written once."""
    ng, c, h = (kw["centroid"].shape[0], kw["far_mask"].shape[0],
                kw["half_radius"].shape[1])
    tests = ng * int(kw["far_mask"].sum()) * h
    nbytes = (ng * 16 + c * h * (12 + 4 + 1 + 4) + c * 4 + c
              + _nbytes(counts, ids) + ids.numel() * 4)
    return dict(sub_tests=tests, flop=float(CULL_SUB_OPS * tests),
                nbytes=nbytes)


def cull_phase(card: str) -> list:
    """Phase 16: the far-field cache's cull and shortlist
    (csrc/cache_cull.cu) on the cache inputs of each configuration of
    CULL_CELLS at its pose (testing.cache_cull_inputs, the default
    RenderConfig's 2048-wide supersampled cache: 8,192 tiles), the scene
    and eye built by the benchmark's own generators: counts, ids and dmin
    bit-equal to the twin, the kernel's device time (the profiler, over
    CULL_REPS launches), its wrapper's with the per-cluster terms and the
    twin's (CUDA events), and its bound (_cull_work).  Returns one result
    dict per configuration."""
    from benchmark import scene as bench_scene
    from benchmark.system import flat_scene
    from compound_ray_tpu_torch import testing
    from compound_ray_tpu_torch.eye import pipeline as P

    _set_config()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "benchmark")
    results = []
    for config in CULL_CELLS:
        t0 = time.perf_counter()
        with open(os.path.join(root, "configs", config + ".json")) as f:
            cfg = json.load(f)
        scene = flat_scene(bench_scene.build_scene(cfg), config)
        pose = tuple(float(v) for v in cfg["pose"]["position"]
                     + cfg["pose"]["rotation"])
        kw = testing.cache_cull_inputs(scene, bench_scene.build_eye(cfg),
                                       pose, "cuda")
        got = P.run_cache_shortlist(**kw)
        want = P.cache_shortlist_reference(**kw)
        unequal = sum(int((a.view(torch.int32) != b.view(torch.int32))
                          .sum()) for a, b in zip(got, want))
        counts = want[0]
        res = dict(cell=config, tiles=int(counts.shape[0]),
                   clusters=int(kw["far_mask"].shape[0]),
                   far_clusters=int(kw["far_mask"].sum()),
                   sub_spheres=int(kw["half_radius"].shape[1]),
                   kmax=kw["kmax"], kp=int(want[1].shape[1]),
                   tiles_at_kmax=int((counts == kw["kmax"]).sum()),
                   mean_count=float(counts.float().mean()),
                   bit_equal=unequal == 0, unequal=unequal, max_abs_err=0.0)
        if unequal:
            raise AssertionError(f"cache cull kernel vs twin: {res}")
        res["ms"] = _kernel_ms(lambda: P.run_cache_shortlist(**kw),
                               "cache_shortlist_kernel", CULL_REPS)
        res["wrapper_ms"] = time_ms(lambda: P.run_cache_shortlist(**kw),
                                    reps=CULL_REPS, warmup=3)
        res["plain_ms"] = time_ms(
            lambda: P.cache_shortlist_reference(**kw), reps=3, warmup=1)
        work = _cull_work(kw, *got[:2])
        res.update(work)
        res.update({key: v for key, v in _bound(
            work["flop"], work["nbytes"]).items()
            if key in ("bound_ms", "bound_by")})
        print(f"phase 16: cache cull and shortlist at {config}'s pose "
              f"({card}): {json.dumps(res)} (counts, ids and dmin bit-equal "
              f"to the twin; {time.perf_counter() - t0:.1f} s)")
        results.append(res)
        del kw, got, want
    return results


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch sees none")
    from compound_ray_tpu_torch.eye import pipeline as P
    from compound_ray_tpu_torch.tools import card_line

    torch.backends.cuda.matmul.allow_tf32 = False  # the twins are plain f32
    card = card_line()
    if card is None:
        raise RuntimeError("nvidia-smi did not report the card")
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    build_kernels()

    t0 = time.perf_counter()
    r, cam = _bench_renderer("cuda")
    k1_dense = kernel_vs_twin(r, cam, SAMPLES[-1], "off", timed=True)
    k1 = kernel_vs_twin(r, cam, SAMPLES[-1], "auto", timed=True)
    for res in (k1_dense, k1):
        print(f"phase 3: K1 vs twin at {N_OMM} x {SAMPLES[-1]}: "
              f"{json.dumps(res)} (thresholds: slots >= {SLOT_AGREE}, "
              f"t rtol {T_RTOL})")
    if not k1["cache"]:
        raise AssertionError("the far-field cache did not engage")
    print(f"phase 3: {time.perf_counter() - t0:.1f} s incl. plans")
    t0 = time.perf_counter()
    k2 = k2_vs_twin(r, cam)
    print(f"phase 4: K2 vs twin at the bench cache: {json.dumps(k2)} "
          f"(threshold: every row of a live tile bit-equal, early exit on "
          f"and off; {time.perf_counter() - t0:.1f} s)")
    print(f"phase 4: K2 pair tests: from below "
          f"{k2['pair_tests_from_below']}, walked {k2['pair_tests_walked']}, "
          f"no early exit {k2['pair_tests_no_early_exit']}; "
          f"{k2['ns_per_walked_pair_test'] * 1e3:.3f} ps per walked pair "
          f"test, {k2['ns_per_pair_test_no_early_exit'] * 1e3:.3f} ps per "
          f"pair test with no early exit; bound {k2['bound_ms']:.4f} ms "
          f"from below, {k2['walked_bound_ms']:.4f} ms walked")

    t0 = time.perf_counter()
    k3 = lit_k3_vs_twin(r, cam, SAMPLES[-1])
    print(f"phase 3: K3 vs twin on the first lit frame's shadow table at "
          f"{N_OMM} x {SAMPLES[-1]} x 4 lights: {json.dumps(k3)} "
          f"(threshold: decisions equal on >= {K3_AGREE} of live rays; "
          f"{time.perf_counter() - t0:.1f} s)")

    splan = P.scene_plan(r.scene, r.device)
    launches = dict.fromkeys(_counters(), 0)
    last = {}  # the last counted path's launches

    def count(res_n):
        res, n = res_n
        for k, v in n.items():
            launches[k] += v
        last.update(n)
        return res, n["k1"], n["k2"], n["k3"]

    def shaded(path, frames):
        """Every unlit means frame of a path shades through the kernel."""
        if last["shade"] != frames:
            raise AssertionError(f"the {path} path launched the shading "
                                 f"kernel {last['shade']} times in {frames} "
                                 f"frames")

    # path a: the far field off, 100 and 3200 samples
    _set_config(farfield="off")
    res_off, a, b, c = count(_path(r, "farfield=off", lambda: {
        s: frames(r, s) for s in SAMPLES}))
    if a != len(SAMPLES) * (WARMUP + TIMED) or b != 0 or c != 0:
        raise AssertionError(f"farfield=off path launched K1 {a}, K2 {b}")
    shaded("farfield=off", a)
    for s in SAMPLES:
        _report(f"farfield=off, {s} samples", res_off[s])
    err_off = frame_vs_twins(r, cam, cache=False)
    print(f"phase 6: farfield=off {SAMPLES[-1]}-sample frame vs the "
          f"twin-rendered frame: max abs {err_off:.3e} (<= {MEANS_ATOL})")

    # path b: the far-field cache, built by the first frame at the pose
    _set_config()
    splan.cache_store.clear()
    res_ff, a, b, c = count(_path(r, "farfield=auto", lambda: frames(
        r, SAMPLES[-1], first_builds_cache=True)))
    if a != 1 + WARMUP + TIMED or b != 1 or c != 0:
        raise AssertionError(f"farfield=auto path launched K1 {a}, K2 {b}")
    shaded("farfield=auto", a)
    _report(f"farfield=auto, {SAMPLES[-1]} samples", res_ff)
    use_cache = len(splan.cache_store) == 1
    print(f"phase 5: farfield=auto: use_cache {use_cache}, clusters in "
          f"the cache {k2['clusters']} of {splan.num_clusters}")
    if not use_cache:
        raise AssertionError("the frames did not memoise one cache")
    cached = r.get_camera_data().copy()
    _set_config(farfield="off")
    direct = _render(r, cam, cam.rng_frame - 1)
    _set_config()
    diff_direct = float(np.abs(cached - direct).mean())
    print(f"phase 6: cache frame vs the direct frame (same seed): mean abs "
          f"{diff_direct:.3e} (< {CACHE_MEAN_ABS}); clusters in the cache "
          f"{k2['clusters']} of {splan.num_clusters}")
    if not diff_direct < CACHE_MEAN_ABS:
        raise AssertionError(f"cache vs direct: mean abs {diff_direct}")
    err_ff = frame_vs_twins(r, cam, cache=True)
    print(f"phase 6: cache frame vs the frame through both twins: max abs "
          f"{err_ff:.3e} (<= {MEANS_ATOL})")

    # path c: the sky split over the cache
    _set_config(sky_split=True)
    splan.cache_store.clear()
    splan.sky_store.clear()
    res_sky, a, b, c = count(_path(r, "sky split", lambda: frames(
        r, SAMPLES[-1], first_builds_cache=True)))
    if a != 1 + WARMUP + TIMED or b != 1 or c != 0:
        raise AssertionError(f"sky-split path launched K1 {a}, K2 {b}")
    shaded("sky split", a)
    _report(f"sky split, {SAMPLES[-1]} samples", res_sky)
    _set_config()
    dense_cache_frame = _render(r, cam, cam.rng_frame - 1)
    _set_config(sky_split=True)
    sky = sky_checks(r, cam, dense_cache_frame, k1["live_groups"])
    print(f"phase 6: sky split: {json.dumps(sky)} (mean abs vs the dense "
          f"cache frame < {CACHE_MEAN_ABS}; sky groups equal across seeds)")
    _set_config()

    # path d: lit, the four default lights, the far field off by the lit
    # gate; the first frame at the pose builds the shadow plan
    r.set_current_eye_samples_per_ommatidium(SAMPLES[-1])
    res_lit, a, b, c = count(_path(r, "lit", lambda: lit_frames(r)))
    n_lit = 1 + WARMUP + TIMED
    if not (a == n_lit + 1 + res_lit["replans"] and b == 0 and c == n_lit):
        raise AssertionError(f"lit path launched K1 {a}, K2 {b}, K3 {c}")
    shaded("lit", 0)
    print(f"phase 5: lit, {SAMPLES[-1]} samples: first frame (builds the "
          f"shadow plan) {res_lit['first_frame_ms']:.3f} ms; frame ms (CUDA "
          f"events) {res_lit['frame_ms']}, mean "
          f"{np.mean(res_lit['frame_ms']):.3f}; render_frame wall ms "
          f"{[round(w, 3) for w in res_lit['wall_ms']]}; refine launches "
          f"by frame {res_lit['refines']}; peak memory "
          f"{res_lit['peak_mb']:.1f} MB; audit over the timed frames "
          f"{res_lit['audit_leaked']} of {res_lit['audit_hits']} hits out "
          f"of shaft; corrective replans {res_lit['replans']} (unsound "
          f"groups {res_lit['unsound_groups']}, all "
          f"{res_lit['sound_all']})")
    lit = lit_checks(r, cam)
    print(f"phase 6: lit frame: {json.dumps(lit)} (lit >= unlit - 1e-6 on "
          f"every ommatidium; vs the frame through the K1 and K3 twins <= "
          f"{MEANS_ATOL})")
    r.set_lighting(False)

    err_small = small_card_vs_cpu("cuda")
    print(f"phase 6: small scene, card (K1) vs CPU (twin): max abs "
          f"{err_small:.3e} (<= {MEANS_ATOL})")
    for sky_on in (False, True):
        err = small_card_vs_cpu("cuda", cache_width=64, sky=sky_on)
        print(f"phase 6: small scene with its cache"
              f"{' and the sky split' if sky_on else ''}, card (K1, K2) vs "
              f"CPU (twins): max abs {err:.3e} (<= {MEANS_ATOL})")
    err = small_lit_card_vs_cpu("cuda")
    print(f"phase 6: small lit scene (canopy), card (K1, K3) vs CPU "
          f"(twins): max abs {err:.3e} (<= {MEANS_ATOL})")

    t0 = time.perf_counter()
    k45 = probe_vs_twins(r.device)
    k6 = dot_bench_vs_twins(r.device)
    print(f"phase 7: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res_n = _path(r, "measurement tools", tools_main, phase=7)
    count(res_n)
    n = res_n[1]
    if not (n["k4"] > 0 and n["k5"] > 0 and n["k6"] > 0 and n["k1"] > 0
            and n["k2"] == 0 and n["k3"] == 0):
        raise AssertionError(f"the tools' path launched {n}")
    print(f"phase 7: both tools' main() in {time.perf_counter() - t0:.1f} s")

    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res_n = _path(r, "API surface", lambda: api_surface(r, cam, tmp),
                      phase=8)
    api, n = count(res_n)[0], res_n[1]
    # raw frames (1 + RAW_TIMED), the means frame, synced and pipelined
    # frames, and the unsynced frame whose syncs are counted
    n_frames = 1 + RAW_TIMED + 1 + 2 * PIPELINED + 1
    if not (n["k1"] == n_frames and n["k3"] == 0 and n["k2"] <= 1):
        raise AssertionError(f"the API path launched {n}, not K1 "
                             f"{n_frames} times")
    syncs = api.pop("host_syncs_unsynced_frame")
    projections = api.pop("projections")
    print(f"phase 8: API surface through the shim at {DISPLAY_W} x "
          f"{DISPLAY_H}, {N_OMM} x {SAMPLES[-1]} ({card}): {json.dumps(api)}"
          f" (raw vs twin <= {MEANS_ATOL}, raw mean vs means frame <= "
          f"{RAW_MEAN_ATOL}; {time.perf_counter() - t0:.1f} s)")
    print(f"phase 8: project_frame card vs CPU at {DISPLAY_W} x {DISPLAY_H} "
          f"({card}): {json.dumps(projections)} (maps equal on >= "
          f"{VORONOI_AGREE}, differing pixels within {NEAR_TIE_RAD} rad; "
          f"colours within {COLOUR_ATOL})")
    print(f"phase 8: pipelined {PIPELINED} frames "
          f"{api['pipelined_total_ms']:.3f} ms against {PIPELINED} synced "
          f"{api['synced_total_ms']:.3f} ms (wall); final camera data "
          f"bit-equal")
    print(f"phase 8: host syncs of one steady-state render_frame(sync=False):"
          f" {len(syncs)} {json.dumps(syncs)}")

    k2i = real_cameras_phase(r, cam, card, count)
    bursts_phase(r, cam, card, count)
    blend_phase(card, count)
    sharded_phase(card, count, launches)
    modes = modes_phase(card, count)
    refine = refine_phase(card)
    # the refine's launches are its sweep path's, not the whole run's
    launches["refine"] = refine["launches"]
    shades = shade_phase(card)
    launches["shade"] += sum(res["launches"] for res in shades)
    launches["raygen"] += sum(res["raygen"]["launches"] for res in shades)
    culls = cull_phase(card)

    def entry(name, source, replaces, key, res):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": None}

    kernels = [
        entry("K1 packed closest-hit tracer", K1_SOURCE, K1_REPLACES, "k1",
              k1),
        entry("K1 packed closest-hit tracer, 8-feature affine form",
              K1_SOURCE, K1_REPLACES, "k1a", modes["k1a"]),
        entry("K2 cluster-shortlist closest-hit tracer", K2_SOURCE,
              K2_REPLACES, "k2", k2),
        entry("K3 any-hit occlusion tracer", K3_SOURCE, K3_REPLACES, "k3",
              k3),
        entry("K4 per-step probe (dot_cand, rs 256)", K45_SOURCE,
              K4_REPLACES, "k4", k45["k4"]),
        entry("K5 3-D probe (dot_cand)", K45_SOURCE, K5_REPLACES, "k5",
              k45["k5"]),
        entry("K6 skinny-K dot bench (K %d, N %d, %s)" % K6_ENTRY, K6_SOURCE,
              K6_REPLACES, "k6", k6),
        entry("Planning refine (per pose of the sweep)",
              REFINE_SOURCE, REFINE_REPLACES, "refine", refine),
    ] + [entry(f"Unlit shading and means ({res['cell']})", SHADE_SOURCE,
               SHADE_REPLACES, "shade", res) for res in shades] + [
        entry(f"Ray generation ({res['cell']})", RAYGEN_SOURCE,
              RAYGEN_REPLACES, "raygen", res["raygen"]) for res in shades] + [
        entry(f"Far-field cache cull and shortlist ({res['cell']})",
              CULL_SOURCE, CULL_REPLACES, "cull", res) for res in culls]
    # a time under its bound means the compiler dropped work the kernel must
    # keep, or the bound counts work the kernel does not need; K1 and K3
    # skip products that their staged tests do not need, so they are held to
    # the bound of the products they need
    under = [(key, res["ms"], bound)
             for key, res in (("K1 dense", k1_dense), ("K1", k1),
                              ("K1 affine dense", modes["k1a_dense"]),
                              ("K1 affine", modes["k1a"]), ("K2", k2),
                              ("K2 image", k2i), ("K3", k3),
                              ("K4", k45["k4"]), ("K5", k45["k5"]),
                              ("K6", k6), ("refine", refine),
                              *((f"shade {res['cell']}", res)
                                for res in shades),
                              *((f"raygen {res['cell']}", res["raygen"])
                                for res in shades),
                              *((f"cull {res['cell']}", res)
                                for res in culls))
             for bound in [res.get("staged_bound_ms", res["bound_ms"])]
             if res["ms"] < bound]
    if under:
        raise AssertionError(f"kernels timed under their bound: {under}")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-rank"]:
        shard_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4],
                   json.loads(sys.argv[5]))
        sys.exit(0)
    sys.exit(main())
