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
// Per slot the products of the ray's first L features (the live ones; L =
// 4, 8 or 16, L <= F) with the four columns give w1, w2, den and tnum.  The
// test is sign-folded and divide-free (mm_tracer.py:861-867 of the JAX
// package): s = den >= 0 ? 1 : -1, a = w1 s, b = w2 s, d = den s,
// tt = tnum s, and the slot occludes iff a >= 0, b >= 0, a + b <= d,
// tt >= 0, tt <= d and d > 0 (all-zero padding columns have d = 0 and never
// pass).  Virtual groups with no rows are written 0.0.
//
// What bounds it on this card, as far as counts show (no profiler reaches
// the card): issue slots on the CUDA cores.  Each pair test is two to four
// L-term products summed without FMAs (at L = 4, 4 multiplies and 3 adds
// each), the sign-folded compares, and one 16-byte shared load per
// product's column; 2.4e9 tests in a lit frame of the bench, and its warps
// issue a quarter more, since a warp steps over a row's slots until its
// last open ray is occluded (lane efficiency 0.80 on an H100, PERF.md).
// The rows are small (8 KB at L = 4) and are read from device memory once
// per block.  The first form of this kernel also spent half its
// multiplies on the shadow table's zero features 4-7, and staged each row
// with an 8-way bank conflict between two barriers, with no test
// overlapping the copy.
//
// What the design does about it:
//   * live features: the kernel is templated on L and reads only features
//     0..L-1 of a table whose feature stride is F.  The lit frame passes
//     L = 4: the shadow plan's rows are transform_payload_affine'd, so their
//     features 4-7 are exactly zero, and so are the rays' ([D, 1, 0 x 4]).
//     Dropping those terms leaves the decisions bit-equal to the F-term sum:
//     each dropped product is 0 * 0 = +0, and adding a signed zero changes a
//     partial sum at most in the sign of a zero result.  None of the tests
//     can tell +0 from -0: den >= 0 holds for both (s = 1), a >= 0, b >= 0,
//     tt >= 0, a + b <= d and tt <= d compare zeros as equal, and d > 0 is
//     false for both;
//   * one ray per thread, its features in registers: rays tiled 2 or 4 to
//     a thread were slower (PERF.md).  At L = 4 a column is one 16-byte
//     broadcast load against 28 multiplies and adds per ray, so tiling saves
//     few loads, while it costs registers and lets a ray's slow neighbours
//     hold its thread.  A thread leaves the slot loop when its ray is
//     occluded, the block leaves the row loop when all of its rays are
//     (__syncthreads_and); the result is an OR, so stopping cannot change
//     it.  A warp holds 32 consecutive samples;
//   * staged tests: den and w1 come first, then w2 only where a >= 0 and
//     d > 0 hold, then tnum only where b >= 0 and a + b <= d hold too.  The
//     conjunction is the twin's, so every decision is too.  Neighbouring
//     shadow rays mostly fail the same test on the same slot, so a warp
//     usually skips the later products as a whole; the twin counts the
//     products this run needs, for the bound;
//   * double-buffered staging: row j + 1 is copied into the second of two
//     shared buffers with 4-byte cp.async while row j is tested, then
//     cp.async.wait_group and the one barrier per row that already existed.
//     Element i of a staged row is feature i % L of column i / L, so the 32
//     copies of a warp land on 32 consecutive words (no bank conflict) and
//     read L feature rows of 32 / L consecutive columns (whole 32-byte
//     sectors at L = 4); the copy transposes as it lands.
// One ray per thread and 128 threads per block were the fastest of 1, 2 and
// 4 rays per thread and 64, 128 and 256 threads on the bench's lit frame
// (PERF.md).
//
// Bit-equal decisions with the torch twin (rows_occlusion_reference): each
// product sums its L terms in feature order with one rounded multiply and
// one rounded add per term (__fmul_rn / __fadd_rn, which the compiler may
// not contract into FMAs), as the twin does with separate f32 tensor ops.
// So kernel and twin reach every decision alike, and lit frames on the
// card can be held to twin-rendered frames.

#include <cuda_runtime.h>

namespace {

constexpr int kLeaf = 128;        // slots per row
constexpr int kCols = 4 * kLeaf;  // w1 | w2 | den | tnum
constexpr int kThreads = 128;     // rays per block, one per thread

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying the first L feature rows of `row` (feature stride kCols)
// into `buf` as buf[col * L + feat].
template <int L>
__device__ __forceinline__ void stage_row(float* buf, const float* row) {
  for (int i = threadIdx.x; i < kCols * L; i += kThreads) {
    const int col = i / L;
    const int feat = i - col * L;
    cp_async4(buf + i, row + feat * kCols + col);
  }
  cp_async_commit();
}

template <int L>
__device__ __forceinline__ float dot_rn(const float (&c)[L],
                                        const float (&f)[L]) {
  float acc = __fmul_rn(f[0], c[0]);
#pragma unroll
  for (int k = 1; k < L; ++k) acc = __fadd_rn(acc, __fmul_rn(f[k], c[k]));
  return acc;
}

template <int L>
__device__ __forceinline__ void load_col(float (&c)[L], const float* col) {
#pragma unroll
  for (int k = 0; k < L; k += 4) {
    *reinterpret_cast<float4*>(c + k) =
        *reinterpret_cast<const float4*>(col + k);
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads)
rows_occlusion_kernel(const int* __restrict__ row_start,
                      const int* __restrict__ row_count,
                      const float* __restrict__ rows,
                      const float* __restrict__ rays,
                      float* __restrict__ out, int feats, int rg,
                      int blocks_per_group, long long n_rays) {
  // two staged rows, each kCols columns of L features side by side
  extern __shared__ __align__(16) float smem[];

  const int v = blockIdx.x / blocks_per_group;
  const int local = (blockIdx.x - v * blocks_per_group) * kThreads +
                    threadIdx.x;
  const long long r = static_cast<long long>(v) * rg + local;

  // this thread's ray is live and not yet occluded
  bool open = local < rg;
  float f[L];
#pragma unroll
  for (int q = 0; q < L; ++q) f[q] = open ? rays[q * n_rays + r] : 0.0f;

  const int first = row_start[v];
  const int cnt = row_count[v];
  const size_t row_floats = static_cast<size_t>(feats) * kCols;
  if (cnt > 0) {
    stage_row<L>(smem, rows + static_cast<size_t>(first) * row_floats);
  }
  for (int j = 0; j < cnt; ++j) {
    cp_async_wait_all();  // this thread's copies of row j have landed
    // every copy of row j is visible and every thread is done with row
    // j - 1; all rays occluded: stop
    if (__syncthreads_and(!open)) break;
    if (j + 1 < cnt) {
      stage_row<L>(smem + ((j + 1) & 1) * kCols * L,
                   rows + static_cast<size_t>(first + j + 1) * row_floats);
    }
    if (!open) continue;
    const float* tile = smem + (j & 1) * kCols * L;
    for (int lane = 0; lane < kLeaf; ++lane) {
      float c1[L], c3[L];
      load_col<L>(c1, tile + lane * L);
      load_col<L>(c3, tile + (2 * kLeaf + lane) * L);
      const float den = dot_rn<L>(c3, f);
      const float s = den >= 0.0f ? 1.0f : -1.0f;
      const float d = den * s;
      const float a = dot_rn<L>(c1, f) * s;
      if ((a >= 0.0f) & (d > 0.0f)) {
        float c2[L];
        load_col<L>(c2, tile + (kLeaf + lane) * L);
        const float b = dot_rn<L>(c2, f) * s;
        if ((b >= 0.0f) & (__fadd_rn(a, b) <= d)) {
          float c4[L];
          load_col<L>(c4, tile + (3 * kLeaf + lane) * L);
          const float tt = dot_rn<L>(c4, f) * s;
          if ((tt >= 0.0f) & (tt <= d)) open = false;
        }
      }
      if (!open) break;
    }
  }
  if (local < rg) out[r] = open ? 0.0f : 1.0f;
}

template <int L>
cudaError_t launch(const int* row_start, const int* row_count,
                   const float* rows, const float* rays, float* out, int nvg,
                   int feats, int rg, long long n_rays, cudaStream_t s) {
  const int blocks_per_group = (rg + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(nvg) * blocks_per_group;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = 2 * kCols * L * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rows_occlusion_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  rows_occlusion_kernel<L><<<static_cast<unsigned>(blocks), kThreads, smem,
                             s>>>(row_start, row_count, rows, rays, out,
                                  feats, rg, blocks_per_group, n_rays);
  return cudaGetLastError();
}

}  // namespace

// Launches K3 on `stream` and returns a CUDA error code (0 = launched).
// nvg virtual groups of rg rays each; n_rays = nvg * rg; feats = F, 8 or
// 16, the table's and the rays' feature stride; live = L, the features
// read: 4, 8 or 16, at most F.
extern "C" int cr_rows_occlusion(const int* row_start, const int* row_count,
                                 const float* rows, const float* rays,
                                 float* out, int nvg, int feats, int live,
                                 int rg, long long n_rays, void* stream) {
  if (nvg <= 0 || rg <= 0 || (feats != 8 && feats != 16) || live > feats ||
      n_rays != static_cast<long long>(nvg) * rg) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (live == 4) {
    err = launch<4>(row_start, row_count, rows, rays, out, nvg, feats, rg,
                    n_rays, s);
  } else if (live == 8) {
    err = launch<8>(row_start, row_count, rows, rays, out, nvg, feats, rg,
                    n_rays, s);
  } else if (live == 16) {
    err = launch<16>(row_start, row_count, rows, rays, out, nvg, feats, rg,
                     n_rays, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

