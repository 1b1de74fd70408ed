// K4 and K5: knock-out probes of K1's row step, for Hopper (sm_90a).
//
// Replaces tools/probe_step.py:_make_probe_kernel / run_probe (K4, rays in
// (16, R) planar layout) and run_probe3d (K5, rays in (NG, 16, rb) layout),
// the TPU kernels that dissect the packed tracer's per-row cost.  Contract
// (compound_ray_tpu_torch/tools/probe_step.py, run_probe):
//   row_counts (NG,) int32          payload rows of group g (clamped to rmax)
//   packed     (NG, rmax, 16, 512)  f32 payload rows, column blocks
//                                   w1 | w2 | den | tnum of 128 lanes
//   rays       16 features per ray, feature k of ray `local` of group g at
//              rays[g * group_stride + k * feat_stride + local]
//              (K4: feat_stride R, group_stride rb; K5: rb and 16 rb)
//   out        (1, NG * rb) f32
// For a ray of a group with cnt = row_counts[g] > 0, by mode:
//   copy_only  rays feature 0, no row loop;
//   dma_only   min over rows j < cnt and lanes l of packed[g, j, 0, l]: each
//              row staged, then touched;
//   dot_only   min over j, l of the w1 product (all 16 features);
//   dot_cand   u = w1/den, v = w2/den, t = tnum/den; t where u >= 0, v >= 0,
//              u + v <= 1 and t >= 0, else +inf; min over j, l.
// Groups with cnt = 0 are written +inf in every mode (the TPU kernel leaves
// them unwritten).  The 3-D dot_only of the TPU tool runs the full dot_cand
// body (tools/probe_step.py:170-191); the wrapper maps it onto mode 3.
//
// What the probes dissect: the modes share K1's structure (one block per
// (group, slice of rs rays), one thread per ray, each payload row staged in
// shared memory, csrc/packed_tracer.cu), so on one card
//   dma_only - copy_only   staging + row loop + per-row sink,
//   dot_only - dma_only    the (rs, 16) x (16, 512) products,
//   dot_cand - dot_only    the candidate math (divide, u/v/t, inside tests),
//   K1 - dot_cand          K1's winner select, less the products K1 skips
//                          (it reads 10 features, the probes 16).
//
// What bounds it: dot_only and dot_cand are 64 FMAs per (ray, lane, row) on
// the CUDA cores (at the tool's shape 2.5e10 FMA, 0.75 ms at 67 TFLOP/s);
// copy_only and dma_only are launch- and bytes-sized.  The dot modes compute
// all four 128-lane products, as the TPU kernels compute the whole
// (rs, 512) product before slicing it.  dot_only's w2, den and tnum do not
// reach the output, and the compiler drops work whose result reaches no
// store: an empty `asm volatile` on them does not stop ptxas (on an H100
// dot_only then ran in 0.47 ms, under its own bound).  So dot_only folds
// them into a second per-ray min (two operations per lane against their 48
// FMAs) that is stored to `sink` when the caller passes one; the wrapper
// passes none, and the compiler cannot know that.
//
// Design: rows staged with the 16 features of a column side by side (pitch
// 20 floats: 16-byte aligned rows, and 4-way rather than 16-way bank
// conflicts on the staging stores), read back as four broadcast float4
// loads per column.  One instance per (mode, rs) so that each block size
// gets its own register budget (__launch_bounds__(rs)).
// Build without --use_fast_math: the candidate math keeps IEEE division.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLeaf = 128;        // lanes per column block
constexpr int kCols = 4 * kLeaf;  // w1 | w2 | den | tnum
constexpr int kFeats = 16;        // feature rows per payload row
constexpr int kPitch = 20;        // floats per staged column

enum Mode { kCopyOnly = 0, kDmaOnly = 1, kDotOnly = 2, kDotCand = 3 };

__device__ __forceinline__ float dot16(const float* col, const float (&f)[kFeats]) {
  const float4 a = *reinterpret_cast<const float4*>(col);
  const float4 b = *reinterpret_cast<const float4*>(col + 4);
  const float4 c = *reinterpret_cast<const float4*>(col + 8);
  const float4 d = *reinterpret_cast<const float4*>(col + 12);
  float acc = f[0] * a.x;
  acc = fmaf(f[1], a.y, acc);
  acc = fmaf(f[2], a.z, acc);
  acc = fmaf(f[3], a.w, acc);
  acc = fmaf(f[4], b.x, acc);
  acc = fmaf(f[5], b.y, acc);
  acc = fmaf(f[6], b.z, acc);
  acc = fmaf(f[7], b.w, acc);
  acc = fmaf(f[8], c.x, acc);
  acc = fmaf(f[9], c.y, acc);
  acc = fmaf(f[10], c.z, acc);
  acc = fmaf(f[11], c.w, acc);
  acc = fmaf(f[12], d.x, acc);
  acc = fmaf(f[13], d.y, acc);
  acc = fmaf(f[14], d.z, acc);
  acc = fmaf(f[15], d.w, acc);
  return acc;
}

template <int kMode, int kRs>
__global__ void __launch_bounds__(kRs)
probe_kernel(const int* __restrict__ row_counts, const float* __restrict__ packed,
             const float* __restrict__ rays, float* __restrict__ out,
             float* __restrict__ sink, int rmax, int rb_size,
             long long feat_stride, long long group_stride) {
  __shared__ __align__(16) float tile[kCols * kPitch];

  const int blocks_per_group = rb_size / kRs;
  const int g = blockIdx.x / blocks_per_group;
  const int local = (blockIdx.x - g * blocks_per_group) * kRs + threadIdx.x;
  const long long o = static_cast<long long>(g) * rb_size + local;

  int cnt = row_counts[g];
  cnt = cnt < 0 ? 0 : (cnt > rmax ? rmax : cnt);
  if (cnt == 0) {  // uniform over the block: every thread has the same g
    out[o] = INFINITY;
    return;
  }
  const float* ray = rays + g * group_stride + local;
  if (kMode == kCopyOnly) {
    out[o] = ray[0];
    return;
  }
  float f[kFeats];
  if (kMode != kDmaOnly) {
#pragma unroll
    for (int k = 0; k < kFeats; ++k) f[k] = ray[k * feat_stride];
  }

  float acc = INFINITY;
  float dead = INFINITY;  // dot_only: the products that do not reach out
  const float* group = packed + static_cast<size_t>(g) * rmax * kFeats * kCols;
  for (int j = 0; j < cnt; ++j) {
    const float* row = group + static_cast<size_t>(j) * kFeats * kCols;
    __syncthreads();  // every thread is done with the previous row
    for (int i = threadIdx.x; i < kFeats * kCols; i += kRs) {
      const int feat = i / kCols;
      const int col = i - feat * kCols;
      tile[col * kPitch + feat] = row[i];
    }
    __syncthreads();
    for (int lane = 0; lane < kLeaf; ++lane) {
      if (kMode == kDmaOnly) {
        acc = fminf(acc, tile[lane * kPitch]);
        continue;
      }
      const float w1 = dot16(tile + lane * kPitch, f);
      const float w2 = dot16(tile + (kLeaf + lane) * kPitch, f);
      const float den = dot16(tile + (2 * kLeaf + lane) * kPitch, f);
      const float tnum = dot16(tile + (3 * kLeaf + lane) * kPitch, f);
      if (kMode == kDotOnly) {
        dead = fminf(dead, fmaf(den, tnum, w2));
        acc = fminf(acc, w1);
      } else {
        const float inv = 1.0f / den;
        const float u = w1 * inv;
        const float v = w2 * inv;
        const float t = tnum * inv;
        const bool ok = (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t >= 0.0f);
        acc = fminf(acc, ok ? t : INFINITY);
      }
    }
  }
  out[o] = acc;
  if (kMode == kDotOnly && sink != nullptr) sink[o] = dead;
}

using ProbeKernel = void (*)(const int*, const float*, const float*, float*,
                            float*, int, int, long long, long long);

template <int kRs>
ProbeKernel pick(int mode) {
  switch (mode) {
    case kCopyOnly: return probe_kernel<kCopyOnly, kRs>;
    case kDmaOnly: return probe_kernel<kDmaOnly, kRs>;
    case kDotOnly: return probe_kernel<kDotOnly, kRs>;
    case kDotCand: return probe_kernel<kDotCand, kRs>;
    default: return nullptr;
  }
}

}  // namespace

// Launches K4 or K5 on `stream` and returns cudaGetLastError() (0 =
// launched).  ng groups of rb_size rays, rs threads per block (256, 512 or
// 1024; rb_size a multiple of rs), mode 0-3 as above; feat_stride and
// group_stride place the rays (see the contract); sink, null from the
// wrapper, receives dot_only's other products if given (NG * rb floats).
extern "C" int cr_probe_step(const int* row_counts, const float* packed,
                             const float* rays, float* out, float* sink,
                             int ng, int rmax, int rb_size, int rs, int mode,
                             long long feat_stride, long long group_stride,
                             void* stream) {
  if (ng <= 0 || rmax <= 0 || rb_size <= 0 || rs <= 0 || rb_size % rs != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = static_cast<long long>(ng) * (rb_size / rs);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const ProbeKernel kernel = rs == 256   ? pick<256>(mode)
                             : rs == 512 ? pick<512>(mode)
                             : rs == 1024 ? pick<1024>(mode)
                                          : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), rs, 0,
           static_cast<cudaStream_t>(stream)>>>(row_counts, packed, rays, out,
                                                sink, rmax, rb_size,
                                                feat_stride, group_stride);
  return static_cast<int>(cudaGetLastError());
}
