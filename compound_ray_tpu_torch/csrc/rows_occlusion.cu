// K3: any-hit occlusion of the lit frame's shadow rays, for Hopper (sm_90a).
//
// Replaces compound_ray_tpu/trace/mm_tracer.py:_make_rows_occlusion_kernel /
// run_rows_occlusion, the TPU kernel that traces every shadow ray of a lit
// frame.  Contract (trace/mm_tracer.py in this package, run_rows_occlusion):
//   row_start, row_count (NVG,) int32  first table row and live rows of each
//                                      virtual group (light * NG + group);
//                                      the wrapper derives them from r2v and
//                                      flag on the device
//   rows   (TB, F, 512) f32            occluder rows sorted by virtual
//                                      group; column blocks w1 | w2 | den |
//                                      tnum of 128 slots; F = 8 or 16
//   rays   (F, R) f32 planar           R = NVG * rg; virtual group v owns
//                                      rays [v * rg, (v + 1) * rg)
//   out    (1, R) f32                  1.0 occluded, 0.0 clear
// Per slot the F-term products of the ray with the four columns give w1,
// w2, den and tnum.  The test is sign-folded and divide-free
// (mm_tracer.py:861-867): s = den >= 0 ? 1 : -1, a = w1 s, b = w2 s,
// d = den s, tt = tnum s, and the slot occludes iff a >= 0, b >= 0,
// a + b <= d, tt >= 0, tt <= d and d > 0 (all-zero padding columns have
// d = 0 and never pass).  Virtual groups with no rows are written 0.0.
//
// What bounds it: once a row is in shared memory, pair tests: 4 F-term
// dot products and a few compares per (ray, slot) on the CUDA cores.  A
// row (16 KB at F = 8) is read from device memory once per block and
// reused by its 128 rays.
//
// What the design does about it:
//   * one block of 128 threads per (virtual group, 128-ray slice of its
//     rays), one thread per ray, its F features in registers;
//   * the block walks its group's rows in order, staging each row in shared
//     memory with the F features of a column side by side, so a thread
//     reads a column as F/4 broadcast float4 loads;
//   * any-hit early exit, which the TPU kernel cannot take: a thread stops
//     testing once its ray is occluded, and the block leaves the row loop
//     when every ray in it is occluded (__syncthreads_and, which is also
//     the barrier before the shared row is overwritten).  The result is an
//     OR, so stopping cannot change it.
// Later work: double-buffered row staging (cp.async or TMA), several rows
// per stage, and a tensor-core form of the 4-wide products.
//
// Bit-equal decisions with the torch twin (rows_occlusion_reference): each
// product sums its F terms in feature order with one rounded multiply and
// one rounded add per term (__fmul_rn / __fadd_rn, which the compiler may
// not contract into FMAs), as the twin does with separate f32 tensor ops.
// So kernel and twin reach every decision alike, and lit frames on the
// card can be held to twin-rendered frames.

#include <cuda_runtime.h>

namespace {

constexpr int kLeaf = 128;        // slots per row
constexpr int kCols = 4 * kLeaf;  // w1 | w2 | den | tnum
constexpr int kThreads = 128;     // rays per block

template <int F>
__device__ __forceinline__ float dot_rn(const float* col, const float (&f)[F]) {
  float acc = __fmul_rn(f[0], col[0]);
#pragma unroll
  for (int k = 1; k < F; ++k) acc = __fadd_rn(acc, __fmul_rn(f[k], col[k]));
  return acc;
}

template <int F>
__global__ void __launch_bounds__(kThreads)
rows_occlusion_kernel(const int* __restrict__ row_start,
                      const int* __restrict__ row_count,
                      const float* __restrict__ rows,
                      const float* __restrict__ rays,
                      float* __restrict__ out,
                      int rg, int blocks_per_group, long long n_rays) {
  // column-major staging: tile[col * F + feature]
  __shared__ __align__(16) float tile[kCols * F];

  const int v = blockIdx.x / blocks_per_group;
  const int local = (blockIdx.x - v * blocks_per_group) * kThreads + threadIdx.x;
  const long long r = static_cast<long long>(v) * rg + local;

  float f[F];
#pragma unroll
  for (int k = 0; k < F; ++k) f[k] = rays[k * n_rays + r];

  const int first = row_start[v];
  const int cnt = row_count[v];
  bool occ = false;
  for (int j = 0; j < cnt; ++j) {
    // every thread is done with the previous row; all rays occluded: stop
    if (__syncthreads_and(occ)) break;
    const float* row = rows + static_cast<size_t>(first + j) * F * kCols;
    for (int i = threadIdx.x; i < F * kCols; i += kThreads) {
      const int feat = i / kCols;
      const int col = i - feat * kCols;
      tile[col * F + feat] = row[i];
    }
    __syncthreads();
    if (occ) continue;
    for (int lane = 0; lane < kLeaf; ++lane) {
      float c1[F], c2[F], c3[F], c4[F];
#pragma unroll
      for (int k = 0; k < F; k += 4) {
        *reinterpret_cast<float4*>(c1 + k) =
            *reinterpret_cast<const float4*>(tile + lane * F + k);
        *reinterpret_cast<float4*>(c2 + k) =
            *reinterpret_cast<const float4*>(tile + (kLeaf + lane) * F + k);
        *reinterpret_cast<float4*>(c3 + k) =
            *reinterpret_cast<const float4*>(tile + (2 * kLeaf + lane) * F + k);
        *reinterpret_cast<float4*>(c4 + k) =
            *reinterpret_cast<const float4*>(tile + (3 * kLeaf + lane) * F + k);
      }
      const float w1 = dot_rn<F>(c1, f);
      const float w2 = dot_rn<F>(c2, f);
      const float den = dot_rn<F>(c3, f);
      const float tnum = dot_rn<F>(c4, f);
      const float s = den >= 0.0f ? 1.0f : -1.0f;
      const float a = w1 * s;
      const float b = w2 * s;
      const float d = den * s;
      const float tt = tnum * s;
      if ((a >= 0.0f) & (b >= 0.0f) & (__fadd_rn(a, b) <= d) & (tt >= 0.0f) &
          (tt <= d) & (d > 0.0f)) {
        occ = true;
        break;
      }
    }
  }
  out[r] = occ ? 1.0f : 0.0f;
}

}  // namespace

// Launches K3 on `stream` and returns cudaGetLastError() (0 = launched).
// nvg virtual groups of rg rays each (rg a multiple of 128); n_rays =
// nvg * rg; feats = F, 8 or 16.
extern "C" int cr_rows_occlusion(const int* row_start, const int* row_count,
                                 const float* rows, const float* rays,
                                 float* out, int nvg, int feats, int rg,
                                 long long n_rays, void* stream) {
  if (nvg <= 0 || rg <= 0 || rg % kThreads != 0 ||
      n_rays != static_cast<long long>(nvg) * rg) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks_per_group = rg / kThreads;
  const long long blocks = static_cast<long long>(nvg) * blocks_per_group;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (feats == 8) {
    rows_occlusion_kernel<8><<<grid, kThreads, 0, s>>>(
        row_start, row_count, rows, rays, out, rg, blocks_per_group, n_rays);
  } else if (feats == 16) {
    rows_occlusion_kernel<16><<<grid, kThreads, 0, s>>>(
        row_start, row_count, rows, rays, out, rg, blocks_per_group, n_rays);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
