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
// What bounds it: once a cluster's payload is in shared memory, each
// (ray, lane) pair costs ~20 FMAs, one IEEE divide and a few compares:
// FP32 work on the CUDA cores.  A cluster's 8 KB payload is read once per
// block from L2 (the whole payload of a 256-cluster scene is 2 MB) and
// reused by the block's 128 rays.
//
// What the design does about it:
//   * one block per (group, batch of 128 rays), one thread per ray: the
//     128-ray batch is the granularity of the TPU kernel's early-exit
//     decision (pallas_tracer.py:183, BATCH_RAYS), so the exit matches it
//     batch for batch;
//   * the ray's 10 live features stay in registers; each cluster's payload
//     is staged in shared memory lane-major with a pitch of 20 floats, so a
//     lane's 16 components reach every thread as four 16-byte broadcast
//     loads;
//   * early exit: before cluster j the block continues only while some ray
//     of the batch has a current best t above dmin[g, j]
//     (__syncthreads_or), the TPU kernel's "worst ray's best > dmin"
//     (pallas_tracer.py:309-320);
//   * a per-thread running winner, updated when t < best or t == best on a
//     lower lane.  Clusters run in shortlist order and lanes ascending, so
//     this is the TPU kernel's per-lane strict `<` over clusters followed
//     by a first-lane argmin over lanes (pallas_tracer.py:326-344).
// Later work: double-buffered staging (cp.async of cluster j+1 while j is
// tested) and a persistent grid over the tiles.
// Build without --use_fast_math: padding lanes (all zero, den = 0) mask
// themselves only through IEEE division (1/0 = inf, 0 * inf = NaN) and NaN
// comparisons.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLeaf = 128;      // triangle lanes per cluster
constexpr int kComps = 16;      // payload rows per cluster
constexpr int kPitch = 20;      // floats per staged lane (16-byte aligned)
constexpr int kThreads = 128;   // rays per block = early-exit batch
constexpr int kRayComps = 16;
constexpr int kOutComps = 8;

__global__ void __launch_bounds__(kThreads)
cluster_tracer_kernel(const int* __restrict__ counts,
                      const int* __restrict__ ids,
                      const float* __restrict__ dmin,
                      const float* __restrict__ payload,
                      const float* __restrict__ rays,
                      float* __restrict__ out,
                      int kp, int kmax, int n_clusters, int rg,
                      int blocks_per_group, int early_exit) {
  __shared__ __align__(16) float tile[kLeaf * kPitch];

  const int g = blockIdx.x / blocks_per_group;
  const int batch = blockIdx.x - g * blocks_per_group;
  const long long r = static_cast<long long>(g) * rg +
                      static_cast<long long>(batch) * kThreads + threadIdx.x;

  const float4* ray4 = reinterpret_cast<const float4*>(rays + r * kRayComps);
  const float4 ra = ray4[0];  // dx dy dz mx
  const float4 rb = ray4[1];  // my mz ox oy
  const float4 rc = ray4[2];  // oz tmin - -
  const float dx = ra.x, dy = ra.y, dz = ra.z, mx = ra.w;
  const float my = rb.x, mz = rb.y, ox = rb.z, oy = rb.w;
  const float oz = rc.x, tmin = rc.y;

  int cnt = counts[g];
  cnt = cnt < 0 ? 0 : (cnt > kmax ? kmax : cnt);
  const int* gids = ids + static_cast<long long>(g) * kp;
  const float* gdmin = dmin + static_cast<long long>(g) * kp;

  float best_t = INFINITY, best_u = 0.0f, best_v = 0.0f, best_c = -1.0f;
  int best_lane = -1;

  for (int j = 0; j < cnt; ++j) {
    if (early_exit) {
      // also the barrier after which the previous tile may be overwritten
      if (!__syncthreads_or(best_t > gdmin[j])) break;
    } else {
      __syncthreads();  // every thread is done with the previous tile
    }
    int cid = gids[j];
    cid = cid < 0 ? 0 : (cid >= n_clusters ? n_clusters - 1 : cid);
    const float* src = payload + static_cast<long long>(cid) * kComps * kLeaf;
#pragma unroll
    for (int c = 0; c < kComps; ++c) {
      tile[threadIdx.x * kPitch + c] = src[c * kLeaf + threadIdx.x];
    }
    __syncthreads();
    const float cf = static_cast<float>(cid);
    for (int lane = 0; lane < kLeaf; ++lane) {
      const float4* p = reinterpret_cast<const float4*>(tile + lane * kPitch);
      const float4 a = p[0];  // w1: 0-3
      const float4 b = p[1];  // w1: 4-5, w2: 6-7
      const float4 c = p[2];  // w2: 8-11
      const float4 e = p[3];  // n, c0
      const float w1 = dx * a.x + dy * a.y + dz * a.z + mx * a.w + my * b.x +
                       mz * b.y;
      const float w2 = dx * b.z + dy * b.w + dz * c.x + mx * c.y + my * c.z +
                       mz * c.w;
      const float den = dx * e.x + dy * e.y + dz * e.z;
      const float onum = ox * e.x + oy * e.y + oz * e.z;
      const float inv = 1.0f / den;
      const float u = w1 * inv;
      const float v = w2 * inv;
      const float t = (e.w - onum) * inv;
      const bool ok =
          (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t >= tmin);
      if (ok && (t < best_t || (t == best_t && lane < best_lane))) {
        best_t = t;
        best_u = u;
        best_v = v;
        best_c = cf;
        best_lane = lane;
      }
    }
  }
  float4* o4 = reinterpret_cast<float4*>(out + r * kOutComps);
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
      rg <= 0 || rg % kThreads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks_per_group = rg / kThreads;
  const long long blocks = static_cast<long long>(ng) * blocks_per_group;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cluster_tracer_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      counts, ids, dmin, payload, rays, out, kp, kmax, n_clusters, rg,
      blocks_per_group, early_exit);
  return static_cast<int>(cudaGetLastError());
}
