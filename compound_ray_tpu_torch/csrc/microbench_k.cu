// K6: the skinny-K dot bench, for Hopper (sm_90a).
//
// Replaces tools/microbench_k.py:make_bench, the TPU kernel that times a
// loop of (256, K) x (K, N) products on the matrix unit.  Contract
// (compound_ray_tpu_torch/tools/microbench_k.py, run_dot_bench):
//   ft  (K, 256) f32        the 256 rays' K features
//   mm  (4, K, N) f32       four payload rows, cycled (j mod 4) so that the
//                           row is loop-variant
//   out (256, 128) f32      sum over j < n_steps of (ft^T mm[j mod 4])[:, :128],
//                           each step's product formed in f32 and added to
//                           an f32 accumulator
// precision 0 ("highest"): f32 products and sums on the CUDA cores.
// precision 1 ("default"): the TPU's one bf16 pass: operands rounded to
// bf16 (round to nearest even), products accumulated in f32, on the tensor
// cores through nvcuda::wmma 16x16x16 bf16 fragments.
// K is a multiple of 16 in [16, 256]; N a multiple of 32, at least 128.
//
// What bounds it: 2 * 256 * K * N FLOP per step, all of it live (below),
// against 67 TFLOP/s f32 or 989 TFLOP/s bf16: e.g. K = 16, N = 2048, 4000
// steps is 1.0 ms f32 and 68 us bf16.  The operands are at most 8.4 MB and
// are staged in shared memory once, so bytes do not bound it.
//
// The trap this source avoids: the TPU kernel forms the whole (256, N)
// product and slices it (microbench_k.py:46-51); that full product is what
// it times (N = 512 against N = 2048 is the bench's question).  Columns past
// 128 never reach the output, and the compiler drops work whose result
// reaches no store.  An empty `asm volatile` on those products does not
// stop ptxas (csrc/probe_step.cu: its dot_only then ran under its own
// bound).  So every block sums its products the same way, and a block past
// column 128 stores its sums to `sink` when the caller passes one: the
// wrapper passes none, and the compiler cannot know that.  chip_smoke.py
// fails any variant timed under its bound.  Without fast-math, nvcc does
// not reassociate the float sums across steps.
//
// Design: one block per 32 x 32 output tile of the (256, N) product, so N =
// 512 gives 128 blocks and N = 2048 gives 512 (the card has 132 SMs); the
// block stages its ft slice and its four mm slices in shared memory once
// (dynamic shared memory, up to 160 KB at K = 256) and loops over all
// n_steps.  f32: 128 threads, each a 2 x 4 micro-tile.  bf16: four warps,
// each one 16 x 16 wmma fragment; wgmma is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kRays = 256;    // rows of the product
constexpr int kOutCols = 128;  // columns summed into the output
constexpr int kRows = 4;       // payload rows cycled
constexpr int kTile = 32;      // block tile (rows and columns)
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
dot_f32_kernel(const float* __restrict__ ft, const float* __restrict__ mm,
               float* __restrict__ out, float* __restrict__ sink, int k, int n,
               int n_steps) {
  extern __shared__ __align__(16) float smem[];
  float* fts = smem;                // [k][kTile]: ft[kk, row0 + i]
  float* mms = smem + k * kTile;    // [kRows][k][kTile]: mm[r, kk, col0 + c]
  const int tiles_n = n / kTile;
  const int row0 = (blockIdx.x / tiles_n) * kTile;
  const int col0 = (blockIdx.x % tiles_n) * kTile;
  for (int i = threadIdx.x; i < k * kTile; i += kThreads) {
    fts[i] = ft[(i / kTile) * kRays + row0 + i % kTile];
  }
  for (int i = threadIdx.x; i < kRows * k * kTile; i += kThreads) {
    mms[i] = mm[static_cast<size_t>(i / kTile) * n + col0 + i % kTile];
  }
  __syncthreads();

  const int cg = threadIdx.x % 8;  // columns cg*4 .. cg*4+3 of the tile
  const int rg = threadIdx.x / 8;  // rows rg*2, rg*2+1 of the tile
  float acc[2][4] = {};
  for (int j = 0; j < n_steps; ++j) {
    const float* a = fts + rg * 2;
    const float* b = mms + (j % kRows) * k * kTile + cg * 4;
    float p[2][4];
    {
      const float2 av = *reinterpret_cast<const float2*>(a);
      const float4 bv = *reinterpret_cast<const float4*>(b);
      p[0][0] = av.x * bv.x; p[0][1] = av.x * bv.y;
      p[0][2] = av.x * bv.z; p[0][3] = av.x * bv.w;
      p[1][0] = av.y * bv.x; p[1][1] = av.y * bv.y;
      p[1][2] = av.y * bv.z; p[1][3] = av.y * bv.w;
    }
    for (int kk = 1; kk < k; ++kk) {
      const float2 av = *reinterpret_cast<const float2*>(a + kk * kTile);
      const float4 bv = *reinterpret_cast<const float4*>(b + kk * kTile);
      p[0][0] = fmaf(av.x, bv.x, p[0][0]); p[0][1] = fmaf(av.x, bv.y, p[0][1]);
      p[0][2] = fmaf(av.x, bv.z, p[0][2]); p[0][3] = fmaf(av.x, bv.w, p[0][3]);
      p[1][0] = fmaf(av.y, bv.x, p[1][0]); p[1][1] = fmaf(av.y, bv.y, p[1][1]);
      p[1][2] = fmaf(av.y, bv.z, p[1][2]); p[1][3] = fmaf(av.y, bv.w, p[1][3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += p[r][c];
    }
  }
  // the summed columns to out; the others to sink, (256, N), if given
  float* dst = col0 < kOutCols ? out : sink;
  const int ld = col0 < kOutCols ? kOutCols : n;
  if (dst == nullptr) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    *reinterpret_cast<float4*>(dst + (row0 + rg * 2 + r) * ld + col0 + cg * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

__global__ void __launch_bounds__(kThreads)
dot_bf16_kernel(const float* __restrict__ ft, const float* __restrict__ mm,
                float* __restrict__ out, float* __restrict__ sink, int k, int n,
                int n_steps) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // A = ft^T tile, column-major: as[kk * kTile + i] = bf16(ft[kk, row0 + i])
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // B tiles, row-major: bs[(r * k + kk) * kTile + c] = bf16(mm[r, kk, col0 + c])
  __nv_bfloat16* bs = as + k * kTile;
  const int tiles_n = n / kTile;
  const int row0 = (blockIdx.x / tiles_n) * kTile;
  const int col0 = (blockIdx.x % tiles_n) * kTile;
  for (int i = threadIdx.x; i < k * kTile; i += kThreads) {
    as[i] = __float2bfloat16_rn(ft[(i / kTile) * kRays + row0 + i % kTile]);
  }
  for (int i = threadIdx.x; i < kRows * k * kTile; i += kThreads) {
    bs[i] = __float2bfloat16_rn(
        mm[static_cast<size_t>(i / kTile) * n + col0 + i % kTile]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int wr = warp / 2;  // fragment rows wr*16 .. of the tile
  const int wc = warp % 2;  // fragment columns wc*16 ..
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc, p;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
  wmma::fill_fragment(acc, 0.0f);
  for (int j = 0; j < n_steps; ++j) {
    const __nv_bfloat16* bj = bs + (j % kRows) * k * kTile;
    wmma::fill_fragment(p, 0.0f);
    for (int kk = 0; kk < k; kk += 16) {
      wmma::load_matrix_sync(a, as + kk * kTile + wr * 16, kTile);
      wmma::load_matrix_sync(b, bj + kk * kTile + wc * 16, kTile);
      wmma::mma_sync(p, a, b, p);
    }
#pragma unroll
    for (int e = 0; e < p.num_elements; ++e) acc.x[e] += p.x[e];
  }
  float* dst = col0 < kOutCols ? out : sink;  // as in dot_f32_kernel
  const int ld = col0 < kOutCols ? kOutCols : n;
  if (dst == nullptr) return;
  wmma::store_matrix_sync(dst + (row0 + wr * 16) * ld + col0 + wc * 16, acc,
                          ld, wmma::mem_row_major);
}

}  // namespace

// Launches K6 on `stream` and returns the first CUDA error (0 = launched).
// precision 0 = "highest" (f32), 1 = "default" (bf16 operands, f32 sums);
// sink, null from the wrapper, receives the other columns' sums if given
// ((256, N) floats).
extern "C" int cr_dot_bench(const float* ft, const float* mm, float* out,
                            float* sink, int k, int n, int n_steps,
                            int precision, void* stream) {
  if (k < 16 || k > 256 || k % 16 != 0 || n < kOutCols || n % kTile != 0 ||
      n_steps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = (kRays / kTile) * (n / kTile);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (precision == 0) {
    const size_t smem = static_cast<size_t>(k) * kTile * (1 + kRows) * sizeof(float);
    err = cudaFuncSetAttribute(dot_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dot_f32_kernel<<<grid, kThreads, smem, s>>>(ft, mm, out, sink, k, n,
                                                   n_steps);
  } else if (precision == 1) {
    const size_t smem =
        static_cast<size_t>(k) * kTile * (1 + kRows) * sizeof(__nv_bfloat16);
    err = cudaFuncSetAttribute(dot_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dot_bf16_kernel<<<grid, kThreads, smem, s>>>(ft, mm, out, sink, k, n,
                                                   n_steps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
