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
// What the probes dissect.  The grid, the staging and the ray tiling are
// those of K1 as it runs (csrc/packed_tracer.cu): one block per (group,
// slice of rs rays), rs / kRaysPerThread threads, each thread holding
// kRaysPerThread neighbouring rays in registers, each payload row staged in
// shared memory with conflict-free 16-byte stores.  So on one card
//   dma_only - copy_only   staging + row loop + per-row sink,
//   dot_only - dma_only    the (rs, 16) x (16, 512) products,
//   dot_cand - dot_only    the candidate math (divide, u/v/t, inside tests),
//   K1 - dot_cand          K1's winner select, less the work K1 skips: it
//                          reads 10 features where the probes read 16,
//                          forms w2 and tnum only where its keep test asks
//                          for them, and divides only where its reject test
//                          does not reject.  The probes skip nothing.
//
// What bounds it on this card: dot_only and dot_cand are 64 FMAs per (ray,
// lane, row) on the CUDA cores (at the tool's shape 2.5e10 FMA, 0.75 ms at
// 67 TFLOP/s); copy_only and dma_only are launch- and bytes-sized.  An SM
// starts one warp instruction per scheduler and clock, and an FMA is one of
// them, so every shared-memory load, min and candidate instruction beside
// the FMAs comes off the peak.  With one ray per thread a staged column
// (four 16-byte broadcast loads) fed one ray's 16 FMAs: 16 loads beside 64
// FMAs per (warp, lane), a ceiling near 75 % of the peak from these slots
// alone and about one 16-byte shared load per clock and SM.  Once the loads
// are shared, the candidate math shows what it costs: each IEEE reciprocal
// is a range test, a branch to a slow path, the approximation and two
// dependent FMAs, a chain that only other warps can cover.
//
// What the design does about it:
//   * rays tiled in registers: a thread holds kRaysPerThread neighbouring
//     rays' 16 features and running minima, so a staged column's four loads
//     feed that many rays' dots (dots<RT> below); a block still covers rs
//     rays, so the tool's chain-width sweep keeps its meaning;
//   * conflict-free staging in 32 KB: a thread reads 4 feature rows of one
//     column from device memory (coalesced across the warp) and writes them
//     as one 16-byte store.  A column's 16 features lie side by side (pitch
//     16, no padding), its four 16-byte chunks permuted by swizzle(): chunk
//     q of column c sits at chunk q ^ ((c >> 1) & 3).  The eight stores of a
//     quarter warp (eight neighbouring columns, one q) then cover all 32
//     banks once, where the plain pitch of 16 would put them on two groups
//     of four banks.  Reads are broadcasts (a warp reads one column), so the
//     permutation costs them nothing but the offset, shared by the four
//     blocks of a lane (128 is a multiple of 8);
//   * warps to cover the reciprocal's latency: 32 KB lets an SM hold 7
//     blocks where the padded pitch of 20 (40 KB) held 5, and
//     __launch_bounds__ asks for as many blocks as give 28-32 warps per SM
//     (7, 4, 2 blocks at rs 256, 512, 1024), which holds the kernel to 64-72
//     registers, without spills;
//   * one buffer: the other blocks of the SM compute while one stages, at
//     the tool's one row per group and on a ragged three-row shape alike
//     (1.37 against 1.42 ms per 1000 rows; chip_smoke.py phase 7 times
//     both), so a second buffer has nothing left to hide.
// Measured at the tool's shape (1000 groups x 3072 rays, one row each) on an
// NVIDIA H100 80GB HBM3 at 700 W, dot_only / dot_cand at rs 256 in ms
// (bound 0.751; PERF.md): at pitch 20 and 5 blocks per SM, 1 / 2 / 4 / 8
// rays per thread 1.68 / 1.79, 1.26 / 1.54, 1.12 / 1.63, 1.16 / 1.95; at the
// permuted pitch 16 and 7 blocks, the lane loop unrolled by two, 2 rays
// 1.17 / 1.37 and 4 rays 1.08 / 1.49 (2 rays not unrolled 1.30 / 1.42).
// Four rays per thread have the faster products but too few warps for the
// candidate math, so two are committed.  This is K1's form (two rays per
// thread, its staging with 16 features for 12, its unrolled slot loop).
// Each product is summed in feature order 0..15 by one chain of fmaf, so a
// ray's value does not depend on rs or on how many rays its thread holds.
//
// The dot modes compute all four 128-lane products, as the TPU kernels
// compute the whole (rs, 512) product before slicing it.  dot_only's w2, den
// and tnum do not reach the output, and the compiler drops work whose result
// reaches no store: an empty `asm volatile` on them does not stop ptxas (on
// an H100 dot_only then ran in 0.47 ms, under its own bound).  So dot_only
// folds them into a second per-ray min (two operations per lane against
// their 48 FMAs) that is stored to `sink` when the caller passes one; the
// wrapper passes none, and the compiler cannot know that.
// Build without --use_fast_math: the candidate math keeps IEEE division.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLeaf = 128;        // lanes per column block
constexpr int kCols = 4 * kLeaf;  // w1 | w2 | den | tnum
constexpr int kFeats = 16;        // feature rows per payload row
constexpr int kChunks = kFeats / 4;  // staged 4 feature rows at a time
constexpr int kPitch = kFeats;    // floats per staged column, no padding
constexpr int kRaysPerThread = 2;
constexpr int kTileBlocks = 7;    // blocks of one 32 KB tile an SM holds
constexpr int kSmThreads = 1024;  // threads per SM the kernel is built for

enum Mode { kCopyOnly = 0, kDmaOnly = 1, kDotOnly = 2, kDotCand = 3 };

// The permutation of staged column `col`'s chunks, and the float offset
// within a column of permutation `swz` of its features 4q..4q+3.
__device__ __forceinline__ int swizzle(int col) { return (col >> 1) & 3; }
__device__ __forceinline__ int chunk_at(int swz, int q) {
  return (q ^ swz) << 2;
}

// w[k] = sum over q of f[k][q] * col[feature q], q = 0..15 in order, for each
// of the thread's rays: the staged column (permutation swz) is loaded once.
template <int RT>
__device__ __forceinline__ void dots(float (&w)[RT], const float* col, int swz,
                                     const float (&f)[RT][kFeats]) {
  const float4 a = *reinterpret_cast<const float4*>(col + chunk_at(swz, 0));
  const float4 b = *reinterpret_cast<const float4*>(col + chunk_at(swz, 1));
  const float4 c = *reinterpret_cast<const float4*>(col + chunk_at(swz, 2));
  const float4 d = *reinterpret_cast<const float4*>(col + chunk_at(swz, 3));
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    float acc = f[k][0] * a.x;
    acc = fmaf(f[k][1], a.y, acc);
    acc = fmaf(f[k][2], a.z, acc);
    acc = fmaf(f[k][3], a.w, acc);
    acc = fmaf(f[k][4], b.x, acc);
    acc = fmaf(f[k][5], b.y, acc);
    acc = fmaf(f[k][6], b.z, acc);
    acc = fmaf(f[k][7], b.w, acc);
    acc = fmaf(f[k][8], c.x, acc);
    acc = fmaf(f[k][9], c.y, acc);
    acc = fmaf(f[k][10], c.z, acc);
    acc = fmaf(f[k][11], c.w, acc);
    acc = fmaf(f[k][12], d.x, acc);
    acc = fmaf(f[k][13], d.y, acc);
    acc = fmaf(f[k][14], d.z, acc);
    acc = fmaf(f[k][15], d.w, acc);
    w[k] = acc;
  }
}

constexpr int min_blocks(int threads) {
  return kSmThreads / threads < kTileBlocks ? kSmThreads / threads
                                            : kTileBlocks;
}

template <int kMode, int kRs>
__global__ void __launch_bounds__(kRs / kRaysPerThread,
                                  min_blocks(kRs / kRaysPerThread))
probe_kernel(const int* __restrict__ row_counts,
             const float* __restrict__ packed,
             const float* __restrict__ rays, float* __restrict__ out,
             float* __restrict__ sink, int rmax, int rb_size,
             long long feat_stride, long long group_stride) {
  constexpr int kThreads = kRs / kRaysPerThread;
  static_assert(kRs % kRaysPerThread == 0 && kThreads % 32 == 0, "block");
  __shared__ __align__(16) float tile[kCols * kPitch];

  const int blocks_per_group = rb_size / kRs;
  const int g = blockIdx.x / blocks_per_group;
  const int local0 = (blockIdx.x - g * blocks_per_group) * kRs +
                     threadIdx.x * kRaysPerThread;
  const long long o0 = static_cast<long long>(g) * rb_size + local0;

  int cnt = row_counts[g];
  cnt = cnt < 0 ? 0 : (cnt > rmax ? rmax : cnt);
  if (cnt == 0) {  // uniform over the block: every thread has the same g
#pragma unroll
    for (int k = 0; k < kRaysPerThread; ++k) out[o0 + k] = INFINITY;
    return;
  }
  const float* ray = rays + g * group_stride + local0;
  if (kMode == kCopyOnly) {
#pragma unroll
    for (int k = 0; k < kRaysPerThread; ++k) out[o0 + k] = ray[k];
    return;
  }
  float f[kRaysPerThread][kFeats];
  if (kMode != kDmaOnly) {
#pragma unroll
    for (int k = 0; k < kRaysPerThread; ++k) {
#pragma unroll
      for (int q = 0; q < kFeats; ++q) f[k][q] = ray[q * feat_stride + k];
    }
  }

  float acc[kRaysPerThread];
  float dead[kRaysPerThread];  // dot_only: the products that do not reach out
#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) acc[k] = dead[k] = INFINITY;
  const float* group = packed + static_cast<size_t>(g) * rmax * kFeats * kCols;
  for (int j = 0; j < cnt; ++j) {
    const float* row = group + static_cast<size_t>(j) * kFeats * kCols;
    __syncthreads();  // every thread is done with the previous row
#pragma unroll 4
    for (int i = threadIdx.x; i < kChunks * kCols; i += kThreads) {
      const int chunk = i / kCols;
      const int col = i - chunk * kCols;
      const float* src = row + chunk * 4 * kCols + col;
      *reinterpret_cast<float4*>(tile + col * kPitch +
                                 chunk_at(swizzle(col), chunk)) = make_float4(
          src[0], src[kCols], src[2 * kCols], src[3 * kCols]);
    }
    __syncthreads();
    if (kMode == kDmaOnly) {  // one touch per lane serves the thread's rays
      float touch = INFINITY;
      for (int lane = 0; lane < kLeaf; ++lane) {
        touch = fminf(touch, tile[lane * kPitch + chunk_at(swizzle(lane), 0)]);
      }
#pragma unroll
      for (int k = 0; k < kRaysPerThread; ++k) acc[k] = fminf(acc[k], touch);
    }
    constexpr int kDotLanes = kMode == kDmaOnly ? 0 : kLeaf;
#pragma unroll 2
    for (int lane = 0; lane < kDotLanes; ++lane) {
      float w1[kRaysPerThread], w2[kRaysPerThread], den[kRaysPerThread],
          tnum[kRaysPerThread];
      const int swz = swizzle(lane);  // and of lane + k * kLeaf: 8 | kLeaf
      dots(w1, tile + lane * kPitch, swz, f);
      dots(w2, tile + (kLeaf + lane) * kPitch, swz, f);
      dots(den, tile + (2 * kLeaf + lane) * kPitch, swz, f);
      dots(tnum, tile + (3 * kLeaf + lane) * kPitch, swz, f);
#pragma unroll
      for (int k = 0; k < kRaysPerThread; ++k) {
        if (kMode == kDotOnly) {
          dead[k] = fminf(dead[k], fmaf(den[k], tnum[k], w2[k]));
          acc[k] = fminf(acc[k], w1[k]);
        } else {
          const float inv = 1.0f / den[k];
          const float u = w1[k] * inv;
          const float v = w2[k] * inv;
          const float t = tnum[k] * inv;
          const bool ok =
              (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t >= 0.0f);
          acc[k] = fminf(acc[k], ok ? t : INFINITY);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) {
    out[o0 + k] = acc[k];
    if (kMode == kDotOnly && sink != nullptr) sink[o0 + k] = dead[k];
  }
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
// launched).  ng groups of rb_size rays, rs rays per block (256, 512 or
// 1024; rb_size a multiple of rs) on rs / kRaysPerThread threads, mode 0-3
// as above; feat_stride and group_stride place the rays (see the contract);
// sink, null from the wrapper, receives dot_only's other products if given
// (NG * rb floats).
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
  kernel<<<static_cast<unsigned>(blocks), rs / kRaysPerThread, 0,
           static_cast<cudaStream_t>(stream)>>>(row_counts, packed, rays, out,
                                                sink, rmax, rb_size,
                                                feat_stride, group_stride);
  return static_cast<int>(cudaGetLastError());
}
