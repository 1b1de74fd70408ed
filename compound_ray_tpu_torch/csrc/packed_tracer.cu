// K1: packed closest-hit tracer for Hopper (sm_90a).
//
// Replaces compound_ray_tpu/trace/mm_tracer.py:_make_packed_kernel /
// run_packed_tracer, the TPU kernel that traces every near-field ray of the
// compound-eye frame (emit "bary"), in both its forms (ray_feats 16 and 8).
// Contract (trace/mm_tracer.py in this package, run_packed_tracer):
//   row_counts (NG,) int32         payload rows of group g
//   packed     (NG, rmax, 16, 512) f32; column blocks w1 | w2 | den | tnum
//                                  of 128 slots each, feature rows 0-9 live,
//                                  row 10 of the w1 block = global slot id
//   rays       (16, R) f32 planar  [d, m, -o', 1, 0 x 6], R = NG * rg
//   out        (8, R) f32 planar   [t, u, v, slot, 0 x 4]; t = +inf, u = v
//                                  = 0, slot = -1 on a miss
// The affine form (cr_packed_tracer_affine, ray_feats 8) takes a payload
// that transform_payload_affine has folded each group's ray origin and tmin
// into: feature rows 0-3 live [Q_d, Q_c], rows 4-7 zero, row 10 of the w1
// block the slot id, unchanged; and rays (8, R) planar [d, 1, 0 x 4].  Its
// products have 4 terms, not 10, and it stages payload rows 0-3 and the
// slot-id row only.  Everything else below holds for both forms.
// Per slot: u = w1/den, v = w2/den, t = tnum/den (w1, w2, den, tnum are
// the ray's features dotted with the slot's four columns); the slot hits
// iff u >= 0, v >= 0, u + v <= 1 and t >= 0.  Groups with row_counts == 0
// are written as misses.
//
// What bounds it on this card: each (ray, slot) pair costs 20 or 40 FMAs
// on the CUDA cores (two or four 10-term products; 8 or 16 in the affine
// form), with no
// product large or regular enough to pay for the tensor cores at f32
// accuracy.  Bytes are small by comparison: a group's payload (rows x 32 KB)
// is read once per block.  The one-ray-per-thread form spent issue slots
// beside the FMAs: 12 shared loads per pair (each column fed one ray), an
// IEEE divide with its Newton fix-up on every pair though almost every pair
// fails the sign tests, and a staging copy with a 4-way bank conflict on
// its writes.
//
// What the design does about it:
//   * one block per (group, slice of 256 of the group's rays), 256 /
//     kRaysPerThread threads; each thread holds kRaysPerThread neighbouring
//     rays' 10 (affine: 4) live features and running winners in registers,
//     so each staged column (two 16-byte and one 8-byte broadcast load;
//     affine: one 16-byte load) feeds that many rays' dots;
//   * each payload row (rows 0-11 of its 512 columns; affine: rows 0-3,
//     with the 128 slot ids of row 10 beside them) is staged in shared
//     memory with the features of a column side by side (pitch 12; affine:
//     4): a thread reads 4 feature rows of one column from device memory
//     (coalesced across the warp) and writes them as one 16-byte store,
//     eight of which in a quarter warp cover all 32 banks once;
//   * the divide leaves the common path: a divide-free reject test on the
//     products alone (k1_reject below, the torch function
//     trace/mm_tracer.py:k1_reject) runs first, and only the pairs it does
//     not reject take the exact test, unchanged, so winners, t, u and v
//     are those of the exact test alone;
//   * staged products: den and w1 come first, and a thread computes w2 and
//     tnum for a slot only when the keep test's first two conditions
//     (k1_keep_first: d > 0, a >= -m) hold for one of its rays.  They fail
//     for most slots, and for most of a warp's neighbouring rays alike, so
//     most slots cost half the FMAs;
//   * a per-ray running winner, updated when t < best or t == best on a
//     lower lane.  Rows run in order, so within a lane the earlier row
//     keeps a tie: the same winner as the TPU kernel's per-lane strict `<`
//     over rows followed by a first-lane argmin over lanes
//     (mm_tracer.py:602-616, 650).
// Two rays per thread with the slot loop unrolled by two were the fastest of
// 1, 2 and 4 rays per thread and of the slot loop unrolled or not, on the
// bench frame (PERF.md).
//
// Why the reject test never rejects a pair the exact test accepts.  With
// s = den >= 0 ? 1 : -1, a = w1 s, b = w2 s, tt = tnum s and d = den s (all
// exact) and m = RN(d 2^-20), a pair is kept iff d > 0, a >= -m, b >= -m,
// tt >= -m and RN(a + b) <= RN(d + m), and rejected otherwise.
//   - d > 0 fails (den = +0 or -0, as in all-zero padding columns, or den
//     NaN), or inv = RN(1/den) = +-inf (d under ~2^-128): the exact test
//     never accepts.  u is NaN when w1 = 0 or den is NaN and +-inf
//     otherwise, v likewise, so u >= 0 and v >= 0 need u = v = +inf, and
//     then u + v <= 1 fails.
//   - Otherwise inv is finite (or +-0 at d = inf) with the sign of den, and
//     while finite d |inv| >= 1 - 2^-22 (relative error 2^-24 while 1/d is
//     normal, absolute error 2^-150 while it is subnormal, d < 2^128).  So
//     d >= 2^-128, m >= 2^-148, and a < -m gives |a| >= d 2^-20 (1 -
//     2^-24): the product w1 inv = a |inv| is negative with magnitude over
//     2^-150, so it rounds to a negative u, not to -0, and u >= 0 fails.
//     The same holds for b and v, tt and t.  A bare sign test (a < 0) would
//     not be sound: a tiny negative w1 inv rounds to -0, which passes
//     u >= 0.  At d = inf, m = inf and a < -m never holds.
//   - If the exact test accepts, u + v <= 1 + 2^-24 before its rounding,
//     and u >= a |inv| (1 - 2^-24) - 2^-150 (which also covers a u rounded
//     to -0), the same for v; so a + b <= d (1 + 2^-21), and by monotone
//     rounding RN(a + b) <= RN(d (1 + 2^-21)) <= RN(d + m), since m >=
//     d 2^-21.  So the sum rule keeps it.
//   - A NaN in a, b or tt is a NaN w1, w2 or tnum, and a NaN a + b needs a
//     and b infinite of opposite signs, so one of u, v is -inf or NaN: the
//     exact test rejects all of these too.
// The margin 2^-20 is far above these error terms and far below any pair
// that misses by a visible amount, so it rejects nearly every miss.  The
// argument is about the four products w1, w2, den and tnum alone, not about
// how many features they sum, so it holds for the affine form as it is.
// Build without --use_fast_math: padding columns (all zero, den = 0) mask
// themselves only through IEEE division (1/0 = inf, 0 * inf = NaN) and
// NaN comparisons, and the argument above assumes IEEE rounding.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLeaf = 128;        // slots per payload row
constexpr int kCols = 4 * kLeaf;  // w1 | w2 | den | tnum
constexpr int kFeats = 16;        // feature rows per payload row
constexpr int kSlotFeat = 10;     // feature row of the slot id (w1 block)
constexpr int kBlockRays = 256;
constexpr int kRaysPerThread = 2;
constexpr int kThreads = kBlockRays / kRaysPerThread;
constexpr int kOutComps = 8;
static_assert(kBlockRays % kRaysPerThread == 0, "rays per thread");

// The two forms, by live ray features: 10 ([d, m, -o', 1]: staged feature
// rows 0-11, 4 at a time, the slot id among them) or 4 (affine [d, 1]:
// staged rows 0-3, the slot ids staged apart).
template <int LIVE>
struct Form;
template <>
struct Form<10> {
  static constexpr int kChunks = 3;  // staged feature rows 0-11
  static constexpr int kPitch = 12;  // floats per staged column
};
template <>
struct Form<4> {
  static constexpr int kChunks = 1;  // staged feature rows 0-3
  static constexpr int kPitch = 4;
};

// True only for pairs the exact test rejects (see the note above).
__device__ __forceinline__ bool k1_reject(float w1, float w2, float den,
                                          float tnum) {
  const float s = den >= 0.0f ? 1.0f : -1.0f;
  const float a = w1 * s;
  const float b = w2 * s;
  const float tt = tnum * s;
  const float d = den * s;
  const float m = __fmul_rn(d, 0x1p-20f);
  return !((d > 0.0f) & (a >= -m) & (b >= -m) & (tt >= -m) &
           (__fadd_rn(a, b) <= __fadd_rn(d, m)));
}

// The first two conditions of the keep test, on den and w1 alone: false
// only where k1_reject is true (trace/mm_tracer.py:k1_keep_first).
__device__ __forceinline__ bool k1_keep_first(float w1, float den) {
  const float s = den >= 0.0f ? 1.0f : -1.0f;
  const float d = den * s;
  return (d > 0.0f) & (w1 * s >= -__fmul_rn(d, 0x1p-20f));
}

// The LIVE-term products of each of a thread's rays with one staged
// column, summed in feature order.
template <int LIVE, int RT>
__device__ __forceinline__ void dots(float (&w)[RT], const float* col,
                                     const float (&f)[RT][LIVE]) {
  const float4 a = *reinterpret_cast<const float4*>(col);
  if constexpr (LIVE == 4) {
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      float acc = f[k][0] * a.x;
      acc = fmaf(f[k][1], a.y, acc);
      acc = fmaf(f[k][2], a.z, acc);
      w[k] = fmaf(f[k][3], a.w, acc);
    }
  } else {
    const float4 b = *reinterpret_cast<const float4*>(col + 4);
    const float2 c = *reinterpret_cast<const float2*>(col + 8);
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
      w[k] = acc;
    }
  }
}

template <int LIVE>
__global__ void __launch_bounds__(kThreads)
packed_tracer_kernel(const int* __restrict__ row_counts,
                     const float* __restrict__ packed,
                     const float* __restrict__ rays,
                     float* __restrict__ out,
                     int rmax, int rg, int blocks_per_group, long long n_rays) {
  constexpr int kChunks = Form<LIVE>::kChunks;
  constexpr int kPitch = Form<LIVE>::kPitch;
  __shared__ __align__(16) float tile[kCols * kPitch];
  // the affine form's slot ids (the full form stages them in the tile)
  __shared__ float slot_ids[LIVE == 4 ? kLeaf : 1];

  const int g = blockIdx.x / blocks_per_group;
  const int local0 = (blockIdx.x - g * blocks_per_group) * kBlockRays +
                     threadIdx.x * kRaysPerThread;
  const long long r0 = static_cast<long long>(g) * rg + local0;

  float f[kRaysPerThread][LIVE];
  float best_t[kRaysPerThread], best_u[kRaysPerThread],
      best_v[kRaysPerThread], best_slot[kRaysPerThread];
  int best_lane[kRaysPerThread];
#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) {
    const bool live = local0 + k < rg;
#pragma unroll
    for (int q = 0; q < LIVE; ++q) {
      f[k][q] = live ? rays[q * n_rays + r0 + k] : 0.0f;
    }
    best_t[k] = INFINITY;
    best_u[k] = 0.0f;
    best_v[k] = 0.0f;
    best_slot[k] = -1.0f;
    best_lane[k] = -1;
  }

  int cnt = row_counts[g];
  cnt = cnt < 0 ? 0 : (cnt > rmax ? rmax : cnt);

  const float* group = packed + static_cast<size_t>(g) * rmax * kFeats * kCols;
  for (int j = 0; j < cnt; ++j) {
    const float* row = group + static_cast<size_t>(j) * kFeats * kCols;
    __syncthreads();  // every thread is done with the previous row
    for (int i = threadIdx.x; i < kChunks * kCols; i += kThreads) {
      const int chunk = i / kCols;
      const int col = i - chunk * kCols;
      const float* src = row + chunk * 4 * kCols + col;
      *reinterpret_cast<float4*>(tile + col * kPitch + chunk * 4) =
          make_float4(src[0], src[kCols], src[2 * kCols], src[3 * kCols]);
    }
    if constexpr (LIVE == 4) {
      for (int i = threadIdx.x; i < kLeaf; i += kThreads) {
        slot_ids[i] = row[kSlotFeat * kCols + i];
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int lane = 0; lane < kLeaf; ++lane) {
      float w1[kRaysPerThread], w2[kRaysPerThread], den[kRaysPerThread],
          tnum[kRaysPerThread];
      dots<LIVE>(den, tile + (2 * kLeaf + lane) * kPitch, f);
      dots<LIVE>(w1, tile + lane * kPitch, f);
      bool need = false;
#pragma unroll
      for (int k = 0; k < kRaysPerThread; ++k) {
        need |= k1_keep_first(w1[k], den[k]);
      }
      if (!need) continue;
      dots<LIVE>(w2, tile + (kLeaf + lane) * kPitch, f);
      dots<LIVE>(tnum, tile + (3 * kLeaf + lane) * kPitch, f);
#pragma unroll
      for (int k = 0; k < kRaysPerThread; ++k) {
        if (__builtin_expect(k1_reject(w1[k], w2[k], den[k], tnum[k]), 1)) {
          continue;
        }
        const float inv = 1.0f / den[k];
        const float u = w1[k] * inv;
        const float v = w2[k] * inv;
        const float t = tnum[k] * inv;
        const bool ok = (u >= 0.0f) & (v >= 0.0f) & (__fadd_rn(u, v) <= 1.0f) &
                        (t >= 0.0f);
        if (ok && (t < best_t[k] || (t == best_t[k] && lane < best_lane[k]))) {
          best_t[k] = t;
          best_u[k] = u;
          best_v[k] = v;
          best_lane[k] = lane;
          if constexpr (LIVE == 4) {
            best_slot[k] = slot_ids[lane];
          } else {
            best_slot[k] = tile[lane * kPitch + kSlotFeat];
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) {
    if (local0 + k >= rg) continue;
    const long long r = r0 + k;
    out[0 * n_rays + r] = best_t[k];
    out[1 * n_rays + r] = best_u[k];
    out[2 * n_rays + r] = best_v[k];
    out[3 * n_rays + r] = best_slot[k];
#pragma unroll
    for (int c = 4; c < kOutComps; ++c) out[c * n_rays + r] = 0.0f;
  }
}

template <int LIVE>
int launch(const int* row_counts, const float* packed, const float* rays,
           float* out, int ng, int rmax, int rg, long long n_rays,
           void* stream) {
  if (ng <= 0 || rmax <= 0 || rg <= 0 ||
      n_rays != static_cast<long long>(ng) * rg) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks_per_group = (rg + kBlockRays - 1) / kBlockRays;
  const long long blocks = static_cast<long long>(ng) * blocks_per_group;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  packed_tracer_kernel<LIVE><<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      row_counts, packed, rays, out, rmax, rg, blocks_per_group, n_rays);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch K1 on `stream` and return cudaGetLastError() (0 = launched).
// ng groups of rg rays each; n_rays = ng * rg.  cr_packed_tracer takes the
// 16-feature rays, cr_packed_tracer_affine the 8-feature affine rays (it
// reads their first 4 rows).
extern "C" int cr_packed_tracer(const int* row_counts, const float* packed,
                                const float* rays, float* out, int ng, int rmax,
                                int rg, long long n_rays, void* stream) {
  return launch<10>(row_counts, packed, rays, out, ng, rmax, rg, n_rays,
                    stream);
}

extern "C" int cr_packed_tracer_affine(const int* row_counts,
                                       const float* packed, const float* rays,
                                       float* out, int ng, int rmax, int rg,
                                       long long n_rays, void* stream) {
  return launch<4>(row_counts, packed, rays, out, ng, rmax, rg, n_rays,
                   stream);
}
