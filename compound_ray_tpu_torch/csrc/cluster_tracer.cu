// K2: cluster-shortlist closest-hit tracer for Hopper (sm_90a).
//
// Replaces compound_ray_tpu/trace/pallas_tracer.py:_tracer_kernel_body /
// run_tracer_kernel, the TPU kernel that renders the far-field equirect
// radiance cache (compound_ray_tpu/eye/pipeline.py:_render_cache) with its
// early exit on.  Contract (trace/cluster_tracer.py in this package,
// run_tracer_kernel):
//   counts  (NG,) int32        shortlist length of group g
//   ids     (NG, KP) int32     cluster ids, nearest first
//   dmin    (NG, KP) f32       lower distance bound of each entry
//   payload (C, 16, 128) f32   per cluster: rows 0-5 w1 edge 6-vector,
//                              6-11 w2 edge 6-vector, 12-14 n, 15 c0, over
//                              128 triangle lanes
//   rays    (R, 16) f32        [d, m = o x d, o, tmin, 0 x 6], R = NG * rg
//   out     (R, 8) f32         [t, u, v, cluster id, lane, 0, 0, 0]; a miss
//                              is t = +inf, u = v = 0, cluster = -1, lane 0
// Per lane: u = w1/den, v = w2/den, t = (c0 - o.n)/den with den = d.n; the
// lane hits iff u >= 0, v >= 0, u + v <= 1 and t >= tmin.  A group walks
// min(counts[g], kmax) clusters; counts <= 0 gives misses.
//
// What bounds it: FP32 work on the CUDA cores.  A cluster's 8 KB payload is
// read once per block from L2 (the whole payload of a 256-cluster scene is
// 2 MB) and reused by the block's 128 rays; each (ray, lane) pair then
// costs the 18 multiplies and 14 adds of w1, w2, den and o.n, a divide
// and the compares.  Few pairs need all of it: a ray hits at most a handful
// of a cluster's 128 lanes.  And on the far-field cache the work is uneven:
// half the tiles have an empty shortlist, a tenth have 8 to 19 clusters, and
// those few blocks set the kernel's time.
//
// What the design does about it:
//   * one block per (group, batch of 128 rays): the 128-ray batch is the
//     granularity of the TPU kernel's early-exit decision
//     (pallas_tracer.py:183, BATCH_RAYS), so the exit matches it batch for
//     batch.  A group with no shortlist writes its misses and leaves;
//   * kSplit threads per ray, next to each other in a warp, each with the
//     ray's 10 live features and a running winner in registers and a share
//     of every cluster's lanes: a long shortlist is walked by kSplit times
//     the threads.  The ray's best t for the exit decision and its winner at
//     the end come from warp shuffles over those threads;
//   * a cluster's payload stays in shared memory as it lies in device
//     memory, component-major (16, 128): no transposing copy.  A thread
//     tests 4 adjacent lanes per step, steps dealt round robin to the ray's
//     threads, and one 16-byte load per component feeds those 4 lanes (a
//     warp reads kSplit adjacent pieces, the same for all its rays);
//   * the copy is one cp.async.bulk of the cluster's 8192 contiguous bytes,
//     started by one thread into one of two slots with an mbarrier each;
//     cluster j + 1 is in flight while j is tested.  It is started after the
//     barrier that ends cluster j - 1's tests (its slot is free then) and
//     only for j + 1 < counts[g]; if the batch then exits before j + 1, the
//     8 KB from L2 were wasted, and the block waits for them before it
//     leaves;
//   * the shortlist is read ahead: dmin[g, j + 1] and ids[g, j + 2] are
//     loaded while cluster j is tested, so no load from device memory
//     stands between a barrier and the exit decision;
//   * early exit: before cluster j the block continues only while some ray
//     of the batch has a current best t above dmin[g, j]
//     (__syncthreads_or), the TPU kernel's "worst ray's best > dmin"
//     (pallas_tracer.py:309-320);
//   * the divide leaves the common path.  den and w1 come first; w2 only
//     for a lane where the keep test's first two conditions hold
//     (k2_keep_first); o.n, the divide and the exact test,
//     unchanged, only for the pairs that the divide-free reject test
//     (k2_reject below, trace/cluster_tracer.py:k2_reject in torch) does not
//     reject.  Winners, t, u and v are those of the exact test alone;
//   * sums in the twin's order with each product and sum rounded on its own
//     (__fmul_rn, __fadd_rn: no FMA contraction), so t, u and v equal the
//     plain torch twin's bit for bit, and with them every tie;
//   * a per-thread running winner, updated when t < best or t == best on a
//     lower lane.  Clusters run in shortlist order and a thread's lanes
//     ascending (also within a step of 4), and the ray's threads are merged
//     by least t, then lowest lane; a lane belongs to one thread.  So this
//     is the TPU kernel's per-lane strict `<` over clusters followed by a
//     first-lane argmin over lanes (pallas_tracer.py:326-344).
// 2 threads per ray were the fastest of 1, 2, 4 and 8 on the bench cache, and
// one ray per thread faster than two (PERF.md).
//
// Why the reject test never rejects a pair the exact test accepts.  With
// s = den >= 0 ? 1 : -1, a = w1 s, b = w2 s and d = den s (all exact) and
// m = RN(d 2^-20), a pair is kept iff d > 0, a >= -m, b >= -m and
// RN(a + b) <= RN(d + m), and rejected otherwise.  (The kernel forms d as
// |den| and a, b by giving w1, w2 the sign bit of den: the same values but
// for den = -0, where d > 0 fails either way.)  tmin is no part of it:
// t >= tmin is tested after the divide, as in the twin.
//   - d > 0 fails (den = +0 or -0, as in all-zero padding lanes, or den
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
//     The same holds for b and v.  A bare sign test (a < 0) would not be
//     sound: a tiny negative w1 inv rounds to -0, which passes u >= 0.  At
//     d = inf, m = inf and a < -m never holds.
//   - If the exact test accepts, u + v <= 1 + 2^-24 before its rounding,
//     and u >= a |inv| (1 - 2^-24) - 2^-150 (which also covers a u rounded
//     to -0), the same for v; so a + b <= d (1 + 2^-21), and by monotone
//     rounding RN(a + b) <= RN(d (1 + 2^-21)) <= RN(d + m), since m >=
//     d 2^-21.  So the sum rule keeps it.
//   - A NaN in a or b is a NaN w1 or w2, and a NaN a + b needs a and b
//     infinite of opposite signs, so one of u, v is -inf or NaN: the exact
//     test rejects all of these too.
// Build without --use_fast_math: the argument assumes IEEE rounding and an
// IEEE divide, and the exact test masks what passes the reject test with a
// zero or NaN den only through them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLeaf = 128;      // triangle lanes per cluster
constexpr int kComps = 16;      // payload rows per cluster
constexpr int kBatch = 128;     // rays per block = early-exit batch
constexpr int kSplit = 2;       // threads per ray, each a share of the lanes
constexpr int kThreads = kBatch * kSplit;
constexpr int kRayComps = 16;
constexpr int kOutComps = 8;
constexpr int kSlotFloats = kComps * kLeaf;
constexpr uint32_t kSlotBytes = kSlotFloats * sizeof(float);
static_assert(kSplit == 1 || kSplit == 2 || kSplit == 4 || kSplit == 8,
              "a ray's threads share a warp and a 128-byte row of a slot");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Starts the copy of one cluster's payload into a slot; `bar` completes
// when its 8192 bytes have landed.
__device__ __forceinline__ void copy_cluster(float* slot, const float* src,
                                             uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(b), "r"(kSlotBytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(slot)),
      "l"(src), "r"(kSlotBytes), "r"(b)
      : "memory");
}

// Waits for the phase of `bar` with this parity (0 for a slot's first copy,
// then alternating) to complete.
__device__ __forceinline__ void wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  } while (!done);
}

// x with its sign flipped where den is negative: x * (den >= 0 ? 1 : -1)
// for every den but -0.
__device__ __forceinline__ float with_sign_of(float x, float den) {
  return __int_as_float(__float_as_int(x) ^
                        (__float_as_int(den) & static_cast<int>(0x80000000u)));
}

// The first two conditions of the keep test, on den and w1 alone: false
// only where k2_reject is true (trace/cluster_tracer.py:k2_keep_first).
__device__ __forceinline__ bool k2_keep_first(float w1, float den) {
  const float d = fabsf(den);
  return (d > 0.0f) & (with_sign_of(w1, den) >= -__fmul_rn(d, 0x1p-20f));
}

// True only for pairs the exact test rejects (see the note above).
__device__ __forceinline__ bool k2_reject(float w1, float w2, float den) {
  const float d = fabsf(den);
  const float m = __fmul_rn(d, 0x1p-20f);
  const float a = with_sign_of(w1, den);
  const float b = with_sign_of(w2, den);
  return !((d > 0.0f) & (a >= -m) & (b >= -m) &
           (__fadd_rn(a, b) <= __fadd_rn(d, m)));
}

// ((x a + y b) + z c), each product and sum rounded: the twin's den, o.n.
__device__ __forceinline__ float dot3(float x, float y, float z, float a,
                                      float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)),
                   __fmul_rn(z, c));
}

// The twin's 6-term sum of a Pluecker side product, left to right.
__device__ __forceinline__ float dot6(const float (&f)[10], float a0, float a1,
                                      float a2, float a3, float a4, float a5) {
  float acc = __fadd_rn(__fmul_rn(f[0], a0), __fmul_rn(f[1], a1));
  acc = __fadd_rn(acc, __fmul_rn(f[2], a2));
  acc = __fadd_rn(acc, __fmul_rn(f[3], a3));
  acc = __fadd_rn(acc, __fmul_rn(f[4], a4));
  return __fadd_rn(acc, __fmul_rn(f[5], a5));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads)
cluster_tracer_kernel(const int* __restrict__ counts,
                      const int* __restrict__ ids,
                      const float* __restrict__ dmin,
                      const float* __restrict__ payload,
                      const float* __restrict__ rays,
                      float* __restrict__ out,
                      int kp, int kmax, int n_clusters, int rg,
                      int blocks_per_group, int early_exit) {
  __shared__ __align__(128) float slots[2][kSlotFloats];
  __shared__ __align__(8) uint64_t bars[2];

  const int g = blockIdx.x / blocks_per_group;
  const int batch = blockIdx.x - g * blocks_per_group;
  const int part = threadIdx.x % kSplit;  // this thread's share of the lanes
  const long long r = static_cast<long long>(g) * rg +
                      static_cast<long long>(batch) * kBatch +
                      threadIdx.x / kSplit;

  int cnt = counts[g];
  cnt = cnt < 0 ? 0 : (cnt > kmax ? kmax : cnt);
  float4* o4 = reinterpret_cast<float4*>(out + r * kOutComps);
  if (cnt == 0) {  // the whole block: nothing to walk, every ray misses
    if (part == 0) {
      o4[0] = make_float4(INFINITY, 0.0f, 0.0f, -1.0f);
      o4[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    return;
  }
  const int* gids = ids + static_cast<long long>(g) * kp;
  const float* gdmin = dmin + static_cast<long long>(g) * kp;

  // f: dx dy dz mx my mz ox oy oz tmin
  float f[10];
  {
    const float4* ray4 = reinterpret_cast<const float4*>(rays + r * kRayComps);
    const float4 ra = ray4[0], rb = ray4[1], rc = ray4[2];
    f[0] = ra.x; f[1] = ra.y; f[2] = ra.z; f[3] = ra.w;
    f[4] = rb.x; f[5] = rb.y; f[6] = rb.z; f[7] = rb.w;
    f[8] = rc.x; f[9] = rc.y;
  }
  float best_t = INFINITY, best_u = 0.0f, best_v = 0.0f, best_c = -1.0f;
  int best_lane = -1;
  auto cluster_at = [&](int j) {  // the clamped id of shortlist entry j
    if (j >= cnt) return 0;
    const int cid = gids[j];
    return cid < 0 ? 0 : (cid >= n_clusters ? n_clusters - 1 : cid);
  };
  auto cluster_src = [&](int cid) {
    return payload + static_cast<long long>(cid) * kSlotFloats;
  };

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(&bars[0]))
                 : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(&bars[1]))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int cid = cluster_at(0), cid_next = cluster_at(1);
  float d_j = gdmin[0];
  if (threadIdx.x == 0) copy_cluster(slots[0], cluster_src(cid), &bars[0]);
  int j = 0;
  for (; j < cnt; ++j) {
    // the barrier after which cluster j - 1's slot may be overwritten
    if (early_exit) {
      // the ray's best t so far, over its kSplit threads
      float ray_t = best_t;
#pragma unroll
      for (int x = 1; x < kSplit; x *= 2) {
        ray_t = fminf(ray_t, __shfl_xor_sync(0xffffffffu, ray_t, x));
      }
      if (!__syncthreads_or(ray_t > d_j)) break;
    } else {
      __syncthreads();
    }
    if (threadIdx.x == 0 && j + 1 < cnt) {
      copy_cluster(slots[(j + 1) & 1], cluster_src(cid_next),
                   &bars[(j + 1) & 1]);
    }
    const float cf = static_cast<float>(cid);
    cid = cid_next;
    cid_next = cluster_at(j + 2);
    if (j + 1 < cnt) d_j = gdmin[j + 1];
    const float* tile = slots[j & 1];
    wait_cluster(&bars[j & 1], (j >> 1) & 1);

    // steps of 4 lanes, dealt round robin to the ray's threads: the threads
    // of a warp read kSplit adjacent 16-byte pieces of a component's row
    for (int q = 4 * part; q < kLeaf; q += 4 * kSplit) {
      float4 c[kComps];  // c[i]: component i of lanes q .. q + 3
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        c[i] = *reinterpret_cast<const float4*>(tile + i * kLeaf + q);
      }
#pragma unroll
      for (int i = 12; i < 15; ++i) {
        c[i] = *reinterpret_cast<const float4*>(tile + i * kLeaf + q);
      }
      float den[4], w1[4];
      bool keep[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        den[l] = dot3(f[0], f[1], f[2], comp(c[12], l), comp(c[13], l),
                      comp(c[14], l));
        w1[l] = dot6(f, comp(c[0], l), comp(c[1], l), comp(c[2], l),
                     comp(c[3], l), comp(c[4], l), comp(c[5], l));
        keep[l] = k2_keep_first(w1[l], den[l]);
      }
      if (!(keep[0] | keep[1] | keep[2] | keep[3])) continue;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        if (!keep[l]) continue;
        const int lane = q + l;
        const float* col = tile + lane;
        const float w2 = dot6(f, col[6 * kLeaf], col[7 * kLeaf],
                              col[8 * kLeaf], col[9 * kLeaf], col[10 * kLeaf],
                              col[11 * kLeaf]);
        if (__builtin_expect(k2_reject(w1[l], w2, den[l]), 1)) continue;
        const float onum = dot3(f[6], f[7], f[8], comp(c[12], l),
                                comp(c[13], l), comp(c[14], l));
        const float inv = 1.0f / den[l];
        const float u = __fmul_rn(w1[l], inv);
        const float v = __fmul_rn(w2, inv);
        const float t = __fmul_rn(__fsub_rn(col[15 * kLeaf], onum), inv);
        const bool ok = (u >= 0.0f) & (v >= 0.0f) &
                        (__fadd_rn(u, v) <= 1.0f) & (t >= f[9]);
        if (ok && (t < best_t || (t == best_t && lane < best_lane))) {
          best_t = t;
          best_u = u;
          best_v = v;
          best_c = cf;
          best_lane = lane;
        }
      }
    }
  }
  // a batch that left early leaves cluster j's copy in flight
  if (j < cnt) wait_cluster(&bars[j & 1], (j >> 1) & 1);

  // the ray's winner over its threads: the least t, then the lowest lane (a
  // lane belongs to one thread, which kept its earliest cluster)
#pragma unroll
  for (int x = 1; x < kSplit; x *= 2) {
    const float ot = __shfl_xor_sync(0xffffffffu, best_t, x);
    const float ou = __shfl_xor_sync(0xffffffffu, best_u, x);
    const float ov = __shfl_xor_sync(0xffffffffu, best_v, x);
    const float oc = __shfl_xor_sync(0xffffffffu, best_c, x);
    const int ol = __shfl_xor_sync(0xffffffffu, best_lane, x);
    if (ot < best_t || (ot == best_t && ol < best_lane)) {
      best_t = ot;
      best_u = ou;
      best_v = ov;
      best_c = oc;
      best_lane = ol;
    }
  }
  if (part != 0) return;
  o4[0] = make_float4(best_t, best_u, best_v, best_c);
  o4[1] = make_float4(best_lane < 0 ? 0.0f : static_cast<float>(best_lane),
                      0.0f, 0.0f, 0.0f);
}

}  // namespace

// Launches K2 on `stream` and returns cudaGetLastError() (0 = launched).
// ng groups of rg rays each (rg a multiple of 128); kp shortlist columns,
// of which at most kmax are walked; n_clusters payload clusters.
extern "C" int cr_cluster_tracer(const int* counts, const int* ids,
                                 const float* dmin, const float* payload,
                                 const float* rays, float* out, int ng, int kp,
                                 int kmax, int n_clusters, int rg,
                                 int early_exit, void* stream) {
  if (ng <= 0 || kp <= 0 || kmax <= 0 || kmax > kp || n_clusters <= 0 ||
      rg <= 0 || rg % kBatch != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks_per_group = rg / kBatch;
  const long long blocks = static_cast<long long>(ng) * blocks_per_group;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cluster_tracer_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      counts, ids, dmin, payload, rays, out, kp, kmax, n_clusters, rg,
      blocks_per_group, early_exit);
  return static_cast<int>(cudaGetLastError());
}
