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
// cores through wgmma.mma_async m64nNk16 (sm_90a only).
// K is a multiple of 16 in [16, 256]; N a multiple of 32, at least 128.
//
// What bounds it: 2 * 256 * K * N FLOP per step, all of it live (below),
// against 67 TFLOP/s f32 or 989 TFLOP/s bf16: e.g. K = 16, N = 2048, 4000
// steps is 1.0 ms f32 and 68 us bf16.  The operands are at most 8.4 MB and
// are staged in shared memory once, so bytes do not bound it.  The contract
// adds each step's product to the accumulator with one f32 add per output
// on the CUDA cores (the TPU kernel's acc + dot(...), the twin's sum
// order); at K = 16 those adds take the CUDA cores about as long as the step's product
// runs on the tensor cores, so about twice the bf16 bound is this
// contract's ceiling there.  From K = 48 up the product dominates.  Summing
// inside the tensor core across steps would be another sum order.
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
// Design, f32: one block per output tile of the (256, N) product; the block
// stages its ft slice and its four mm slices in shared memory once and
// loops over all n_steps.  32 x 32 tiles, 128 threads of a 2 x 4 micro-tile
// each (2 shared loads per 8 FMAs: bound by the shared-memory loads), below
// N = 2048 (N = 512 gives 128 blocks, the card has 132 SMs); from N = 2048,
// where they still fill the card, 64 x 64 tiles of 4 x 8 micro-tiles (4
// loads per 32 FMAs) while the staged operands fit (K up to 176).
//
// Design, bf16: one warpgroup (128 threads) per 64 x NT tile, NT = 16 below
// N = 2048 (N = 512 gives 128 blocks) and 64 from there (128 blocks too).
//   * A = ft^T (64 x K) is loop-invariant: each thread loads its wgmma A
//     fragments from device memory once, rounds them to bf16 and keeps them
//     in registers (4 per 16 of K), so a step reads only B from shared
//     memory.
//   * B: the block's four (K, NT) slices of mm, rounded to bf16 and staged
//     once in the layout the matrix descriptor names: no swizzle, N-major
//     (mm is (K, N) row-major, so N is the contiguous dimension: the
//     instruction's transpose-B bit).  A core matrix is 8 (k) x 8 (n)
//     values, 128 contiguous bytes, k rows of 16 bytes; core matrices next
//     to each other along N are 128 bytes apart (the descriptor's stride
//     byte offset), the two k groups of a 16-deep slice NT / 8 core matrices
//     apart (its leading byte offset).  Either major-ness is open to bf16
//     through the transpose bits; for TF32 operands wgmma accepts only
//     K-major ones, so a TF32 form of this or of K1 has to stage ft and mm
//     transposed.
//   * products independent, only the add is a chain: a step's product is
//     K / 16 wgmma into its own register set (scale-d = 0 on the first, so
//     it starts from zero); a batch of G steps is committed as one group,
//     and two groups of G sets alternate, so batch b + 1's products run on
//     the tensor cores while batch b's are added to the accumulator in step
//     order.  A lone K = 16 product is all latency, so G = 4 on the narrow
//     tile.  wgmma.wait_group 0 precedes each start: ptxas serialises every
//     wgmma of a function in which a product set is read while more than
//     the one other group is open.  wgmma.fence precedes each batch's first
//     wgmma: its sets were last read by ordinary adds, the A fragments
//     written by ordinary loads.
//   * accumulator fragment of m64nNk16: thread (warp w, lane l) holds rows
//     16 w + l / 4 and + 8, columns 8 i + 2 (l % 4) and + 1 of each 8-wide
//     column group i, as d[4 i + {0, 1}] and d[4 i + {2, 3}].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRays = 256;    // rows of the product
constexpr int kOutCols = 128;  // columns summed into the output
constexpr int kRows = 4;       // payload rows cycled
constexpr int kTile = 32;      // block tile (rows and columns)
constexpr int kThreads = 128;

// kT: the block's tile (rows and columns); each of the 128 threads holds a
// kMR x kMC micro-tile, its columns in groups of 4 that lie kT / (kMC / 4)
// apart, so a warp's 16-byte loads of B cover 128 contiguous bytes.
template <int kT, int kMR, int kMC>
__global__ void __launch_bounds__(kThreads)
dot_f32_kernel(const float* __restrict__ ft, const float* __restrict__ mm,
               float* __restrict__ out, float* __restrict__ sink, int k, int n,
               int n_steps) {
  constexpr int kColGroups = kMC / 4;
  constexpr int kGroupPitch = kT / kColGroups;
  constexpr int kThreadCols = kGroupPitch / 4;  // threads across a tile row
  static_assert(kMC % 4 == 0 && kMR % 2 == 0 &&
                    (kT / kMR) * kThreadCols == kThreads,
                "128 micro-tiles cover the tile");
  extern __shared__ __align__(16) float smem[];
  float* fts = smem;              // [k][kT]: ft[kk, row0 + i]
  float* mms = smem + k * kT;     // [kRows][k][kT]: mm[r, kk, col0 + c]
  const int tiles_n = n / kT;
  const int row0 = (blockIdx.x / tiles_n) * kT;
  const int col0 = (blockIdx.x % tiles_n) * kT;
  for (int i = threadIdx.x; i < k * kT; i += kThreads) {
    fts[i] = ft[(i / kT) * kRays + row0 + i % kT];
  }
  for (int i = threadIdx.x; i < kRows * k * kT; i += kThreads) {
    mms[i] = mm[static_cast<size_t>(i / kT) * n + col0 + i % kT];
  }
  __syncthreads();

  const int cg = threadIdx.x % kThreadCols;  // columns cg*4 .. of each group
  const int rg = threadIdx.x / kThreadCols;  // rows rg*kMR ..
  float acc[kMR][kMC] = {};
  for (int j = 0; j < n_steps; ++j) {
    const float* a = fts + rg * kMR;
    const float* b = mms + (j % kRows) * k * kT + cg * 4;
    float p[kMR][kMC], av[kMR], bv[kMC];
    auto load = [&](int kk) {
#pragma unroll
      for (int r = 0; r < kMR; r += 2) {
        const float2 v = *reinterpret_cast<const float2*>(a + kk * kT + r);
        av[r] = v.x;
        av[r + 1] = v.y;
      }
#pragma unroll
      for (int m = 0; m < kColGroups; ++m) {
        const float4 v = *reinterpret_cast<const float4*>(b + kk * kT +
                                                          m * kGroupPitch);
        bv[4 * m] = v.x; bv[4 * m + 1] = v.y;
        bv[4 * m + 2] = v.z; bv[4 * m + 3] = v.w;
      }
    };
    load(0);  // the first term starts the sum: no add to a zero
#pragma unroll
    for (int r = 0; r < kMR; ++r) {
#pragma unroll
      for (int c = 0; c < kMC; ++c) p[r][c] = av[r] * bv[c];
    }
    for (int kk = 1; kk < k; ++kk) {
      load(kk);
#pragma unroll
      for (int r = 0; r < kMR; ++r) {
#pragma unroll
        for (int c = 0; c < kMC; ++c) p[r][c] = fmaf(av[r], bv[c], p[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < kMR; ++r) {
#pragma unroll
      for (int c = 0; c < kMC; ++c) acc[r][c] += p[r][c];
    }
  }
  // the summed columns to out; the others to sink, (256, N), if given
  float* dst = col0 < kOutCols ? out : sink;
  const int ld = col0 < kOutCols ? kOutCols : n;
  if (dst == nullptr) return;
#pragma unroll
  for (int r = 0; r < kMR; ++r) {
#pragma unroll
    for (int m = 0; m < kColGroups; ++m) {
      *reinterpret_cast<float4*>(dst + (row0 + rg * kMR + r) * ld + col0 +
                                 m * kGroupPitch + cg * 4) =
          make_float4(acc[r][4 * m], acc[r][4 * m + 1], acc[r][4 * m + 2],
                      acc[r][4 * m + 3]);
    }
  }
}

template <int kT, int kMR, int kMC>
cudaError_t launch_f32(const float* ft, const float* mm, float* out,
                       float* sink, int k, int n, int n_steps,
                       cudaStream_t s) {
  auto kernel = dot_f32_kernel<kT, kMR, kMC>;
  const int smem = k * kT * (1 + kRows) * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(kRays / kT) * (n / kT), kThreads, smem, s>>>(ft, mm, out, sink, k,
                                                         n, n_steps);
  return cudaGetLastError();
}

// One m64nNTk16 wgmma, a from registers (bf16 pairs), b through its
// shared-memory descriptor, N-major (the last immediate).  The first of a
// step writes d = a b (scale-d = 0; d is an output only, so the compiler
// sees a fresh definition and carries nothing into it), the others
// d += a b.  ptxas serialises every wgmma of a function in which any other
// instruction defines one of their accumulator registers while a group is
// open (a zero-fill, a register move at a join), so nothing but wgmma
// writes a product set.
#define K6_D8(C)                                                            \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7])
#define K6_D32(C)                                                           \
  K6_D8(C), C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]),       \
      C(d[14]), C(d[15]), C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]), \
      C(d[21]), C(d[22]), C(d[23]), C(d[24]), C(d[25]), C(d[26]), C(d[27]), \
      C(d[28]), C(d[29]), C(d[30]), C(d[31])
#define K6_WGMMA16(OUT, SCALE)                                              \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, "         \
      "p, 1, 1, 1;\n}\n"                                                    \
      : K6_D8(OUT)                                                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(SCALE))
#define K6_WGMMA64(OUT, SCALE)                                              \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"    \
      : K6_D32(OUT)                                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(SCALE))

template <bool kFirst>
__device__ __forceinline__ void wgmma_k16(float (&d)[8], const uint32_t (&a)[4],
                                          uint64_t desc) {
  if constexpr (kFirst) {
    K6_WGMMA16("=f", 0);
  } else {
    K6_WGMMA16("+f", 1);
  }
}

template <bool kFirst>
__device__ __forceinline__ void wgmma_k16(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  if constexpr (kFirst) {
    K6_WGMMA64("=f", 0);
  } else {
    K6_WGMMA64("+f", 1);
  }
}

// G steps' products, each into its own set of p (from zero), committed as
// one wgmma group; step s of the batch reads payload row (row0 + s) % kRows.
template <int KT, int G, int NR>
__device__ __forceinline__ void start_batch(float (&p)[G][NR],
                                            const uint32_t (&a)[KT][4],
                                            uint64_t desc0, int row0) {
  // 16-byte units between the 16-deep K slices of a staged row, and
  // between rows
  constexpr uint64_t kSlice = 2 * (NR / 4) * 128 / 16;
  constexpr uint64_t kRowUnits = KT * kSlice;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < G; ++s) {
    const uint64_t desc = desc0 + ((row0 + s) % kRows) * kRowUnits;
    wgmma_k16<true>(p[s], a[0], desc);
#pragma unroll
    for (int q = 1; q < KT; ++q) {
      wgmma_k16<false>(p[s], a[q], desc + q * kSlice);
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Adds a finished batch's products in step order, the first `steps` of
// them: the contract's one f32 add per output and step.  The empty asm
// keeps the adds behind the wait before them.
template <int G, int NR>
__device__ __forceinline__ void add_batch(float (&acc)[NR], float (&p)[G][NR],
                                          int steps) {
#pragma unroll
  for (int s = 0; s < G; ++s) {
    if (s >= steps) return;
#pragma unroll
    for (int e = 0; e < NR; ++e) {
      asm volatile("" : "+f"(p[s][e])::"memory");
      acc[e] += p[s][e];
    }
  }
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// KT = K / 16; NT the tile's columns; G the steps of a batch.  Two groups
// of G product register sets alternate; a loop turn is kTurn steps, a
// multiple of both 2 G and kRows, so a group and a payload row belong to
// each of its steps at compile time.
template <int KT, int NT, int G>
__global__ void __launch_bounds__(kThreads)
dot_bf16_kernel(const float* __restrict__ ft, const float* __restrict__ mm,
                float* __restrict__ out, float* __restrict__ sink, int n,
                int n_steps) {
  constexpr int kTurn = 2 * G > kRows ? 2 * G : kRows;
  static_assert(kTurn % (2 * G) == 0 && kTurn % kRows == 0, "turn");
  constexpr int K = KT * 16;
  constexpr int NC = NT / 8;   // core matrices along N
  constexpr int NR = NT / 2;   // accumulator registers per thread
  constexpr int kTileM = 64;   // rows of a warpgroup's tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tiles_n = n / NT;
  const int row0 = (blockIdx.x / tiles_n) * kTileM;
  const int col0 = (blockIdx.x % tiles_n) * NT;

  // B: (r, kk, c) -> row r, slice kk / 16, k group, core matrix c / 8, then
  // 8 k rows of 8 n values
  for (int i = threadIdx.x; i < kRows * K * NT; i += kThreads) {
    const int c = i % NT;
    const int rk = i / NT;  // r * K + kk
    const int kk = rk % K;
    const int idx = ((rk / 8) * NC + c / 8) * 64 + (kk % 8) * 8 + c % 8;
    bs[idx] = __float2bfloat16_rn(mm[static_cast<size_t>(rk) * n + col0 + c]);
  }
  // A fragments: rows r and r + 8, k pairs at 2 (l % 4) and + 8 of a slice
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = row0 + 16 * warp + lane / 4;
  const int c2 = 2 * (lane % 4);
  uint32_t a[KT][4];
#pragma unroll
  for (int s = 0; s < KT; ++s) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* src = ft + (16 * s + c2 + 8 * (q / 2)) * kRays + r +
                         8 * (q % 2);
      const __nv_bfloat162 h = __floats2bfloat162_rn(src[0], src[kRays]);
      a[s][q] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  // the staged B is read by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // descriptor of row 0, slice 0: start address, leading (k group) and
  // stride (N core matrix) byte offsets, all in 16-byte units; no swizzle
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(bs));
  const uint64_t desc0 = static_cast<uint64_t>((base & 0x3FFFF) >> 4) |
                         (static_cast<uint64_t>(NC * 128 / 16) << 16) |
                         (static_cast<uint64_t>(128 / 16) << 32);
  float acc[NR], p[2][G][NR];
#pragma unroll
  for (int e = 0; e < NR; ++e) acc[e] = 0.0f;
  // One batch's products are in flight while the batch before it is added:
  // wait for batch b, start batch b + 1 into the other group, then add
  // batch b.  Nothing reads a product set while its own group is open, and
  // every start is unconditional (a branch around a wgmma would define its
  // sets at the join, see wgmma_k16), so up to kTurn + G products past the
  // last step are formed and never added.
  start_batch<KT>(p[0], a, desc0, 0);
  int j0 = 0;
  for (; j0 + kTurn <= n_steps; j0 += kTurn) {
#pragma unroll
    for (int b = 0; b < kTurn / G; ++b) {
      wgmma_wait_all();
      start_batch<KT>(p[(b + 1) % 2], a, desc0, (b + 1) * G);
      add_batch(acc, p[b % 2], G);
    }
  }
  // the last n_steps % kTurn steps: the same, with the adds counted
#pragma unroll
  for (int b = 0; b < kTurn / G; ++b) {
    wgmma_wait_all();
    start_batch<KT>(p[(b + 1) % 2], a, desc0, (b + 1) * G);
    add_batch(acc, p[b % 2], n_steps - j0 - b * G);
  }
  wgmma_wait_all();

  float* dst = col0 < kOutCols ? out : sink;  // as in dot_f32_kernel
  const int ld = col0 < kOutCols ? kOutCols : n;
  if (dst == nullptr) return;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    float* d0 = dst + static_cast<size_t>(r) * ld + col0 + 8 * i + c2;
    *reinterpret_cast<float2*>(d0) = make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(d0 + 8 * static_cast<size_t>(ld)) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

#undef K6_WGMMA64
#undef K6_WGMMA16
#undef K6_D32
#undef K6_D8

// Launches dot_bf16_kernel<k / 16, NT, G>: batches of 4 steps on the narrow
// tile, of 2 on the wide one while its 4 product sets and the A fragments
// fit in registers (K up to 96), else of 1.
template <int NT, int KT = 1>
cudaError_t launch_bf16(const float* ft, const float* mm, float* out,
                        float* sink, int k, int n, int n_steps,
                        cudaStream_t s) {
  if constexpr (KT > 16) {
    return cudaErrorInvalidValue;
  } else {
    if (k != KT * 16) {
      return launch_bf16<NT, KT + 1>(ft, mm, out, sink, k, n, n_steps,
                                            s);
    }
    constexpr int G = NT == 16 ? 4 : (KT <= 6 ? 2 : 1);
    auto kernel = dot_bf16_kernel<KT, NT, G>;
    const int smem = kRows * k * NT * static_cast<int>(sizeof(__nv_bfloat16));
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<(kRays / 64) * (n / NT), kThreads, smem, s>>>(ft, mm, out, sink,
                                                           n, n_steps);
    return cudaGetLastError();
  }
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (precision == 0) {
    // 64 x 64 tiles of 4 x 8 micro-tiles where they fill the card (N from
    // 2048: 128 blocks) and their staged operands fit (K up to 176: 220 KB);
    // else 32 x 32 tiles of 2 x 4
    err = (n >= 2048 && n % 64 == 0 && k <= 176)
              ? launch_f32<64, 4, 8>(ft, mm, out, sink, k, n, n_steps, s)
              : launch_f32<32, 2, 4>(ft, mm, out, sink, k, n, n_steps, s);
    return static_cast<int>(err);
  } else if (precision == 1) {
    // 64-column tiles fill the card from N = 2048 (128 blocks); below that
    // 16-column tiles do (N = 512: 128 blocks)
    err = (n >= 2048 && n % 64 == 0)
              ? launch_bf16<64>(ft, mm, out, sink, k, n, n_steps, s)
              : launch_bf16<16>(ft, mm, out, sink, k, n, n_steps, s);
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
