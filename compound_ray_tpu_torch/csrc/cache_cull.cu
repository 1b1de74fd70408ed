// The far-field cache's tile cull and shortlist for Hopper (sm_90a).
//
// Replaces no Pallas kernel: on the TPU, XLA fused the cache's cull, the
// (tiles x clusters x halves) cone-vs-sphere test, and jnp.argsort ran
// the shortlist (compound_ray_tpu/eye/pipeline.py:3093-3151).  Eager torch
// instead runs the test as ~20 launches over (G, C, 2) float32 temporaries
// (537 MB each at the meadow's 8,192 tiles and 8,192 clusters) and a
// stable segmented argsort of all G x C keys, only to keep the first KP of
// each row.  This kernel takes their place on CUDA tensors.  Contract
// (eye/pipeline.py in this package, run_cache_shortlist; the torch twin is
// cache_shortlist_reference there):
//   centroid  (G, 3) f32     unit axis of each tile's bounding cone
//   half_ang  (G,) f32       its half angle
//   to_c      (C, H, 3) f32  each sub-sphere's centre minus the cache's
//                            centre (H = 2, or 8 in scenes of <= 64
//                            clusters: accel/clusters.py)
//   inv_d     (C, H) f32     1 / max(|to_c|, 1e-30)
//   inside    (C, H) bool    the centre lies inside the sub-sphere
//   beta      (C, H) f32     asin(clamp(radius * inv_d, 0, 1))
//   dmin_all  (C,) f32       the cluster's distance bound (its sort key)
//   far_mask  (C,) bool      the clusters the cache traces
//   counts    (G,) int32     out: min(survivors, kmax)
//   ids       (G, KP) int32  out, KP = kmax rounded up to 128: the
//   dmin      (G, KP) f32         survivors by (dmin, id), then the
//                                 non-survivors by id with dmin 3e38, id 0
//                                 past C
// The per-cluster terms come from the twin's own torch expressions
// (_cache_cluster_terms).  A (tile, cluster) pair survives iff the cluster
// is in far_mask and one of its sub-spheres has inside, or
// acos(clamp(((tx cx + ty cy) + tz cz) inv_d, -1, 1)) <= half_ang + beta.
// Each column holds what the twin's stable argsort of the G x max(C, KP)
// keys (dmin_all where the pair survives, +inf elsewhere and past C) puts
// there, with a key that is not finite written as 3e38.  Keys order as
// CUB's radix sort orders float bits, which is what torch's segmented sort
// runs on the card: a survivor whose key is +inf falls among the
// non-survivors by id, one whose key is NaN after them.
//
// What bounds it on this card: operations.  A sub-sphere test is ~12
// operations, an acos among them, for every (tile, live cluster,
// sub-sphere):
// at the meadow's 8,192 tiles and ~7,150 live clusters 1.2e8 tests, ~1.4
// GFLOP, 0.02 ms at 67 TFLOP/s.  The bytes are the per-cluster terms (~0.4
// MB, read from L2) and the 16.8 MB of ids and dmin written once, 0.005
// ms at 3.35 TB/s.
//
// What the design does about it:
//   * a block of 256 threads holds T tiles (8 at KP <= 768): their cones sit
//     in shared memory, and each thread loads one cluster's terms into
//     registers per 256-cluster chunk and tests it against all T, so a
//     cluster's terms leave L2 once per block, not once per tile;
//   * acos only near the boundary: with c = cos(half) cos(beta) -
//     sin(half) sin(beta) (sincosf per tile, __sincosf per cluster, ~1e-6
//     off), x > c + 3e-5 passes and x < c - 3e-5 fails, as acosf(x) (2 ulp)
//     against half + beta rounded would decide, since |d acos / dx| >= 1
//     and half + beta <= 3 keeps cos decreasing; elsewhere, and for any
//     NaN, the twin's own test decides.  So every decision is the twin's;
//   * survivors go by warp ballots into a per-tile buffer of 64-bit keys
//     (radix key << 32 | id) in shared memory, in any order, since ids are
//     unique and the final order is total; a buffer over KP after a chunk
//     is sorted and cut to its first KP (rare: the meadow cell's poses
//     have at most ~36 of 8,192 tiles over 256), so any number of
//     survivors fits;
//   * a bitonic sort per tile over the buffer's next power of two, then
//     coalesced writes: the sorted survivors, then the first non-survivor
//     ids in ascending order, found by testing the clusters from id 0 again
//     (most tiles fill their KP columns from the first chunk or two), then
//     any NaN-keyed survivors;
//   * the same numbers as the twin: each product and sum of the test is
//     written as the torch expression rounds it, in its order (__fmul_rn,
//     __fadd_rn, which the compiler may not contract into FMAs), acosf as
//     torch's CUDA arccos calls it (no fast math), clamps that keep a NaN as
//     torch's do.  So counts, ids and dmin equal the twin's bit for bit.
//
// Limits: KP <= 4096 (T = 8, 4, 2, 1 tiles a block as the buffer grows to
// 8192 entries, 64 KiB of shared memory); H = 2 or 8; any G and C (ids
// below 2^31).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKp = 4096;
constexpr int kSmemBytes = 64 * 1024;  // the tile buffers of one block
constexpr unsigned kKeyInf = 0xff800000u;  // radix_key(+inf)
constexpr unsigned long long kPad = ~0ull;  // after every real entry
constexpr float kSlack = 3e-5f;  // the prefilter's margin on cos(alpha)
constexpr float kLimMax = 3.0f;  // the largest half + beta it decides
constexpr float kFar = 3e38f;  // dmin of a column past the survivors

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
// torch.clamp(x, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// CUB's radix order of float bits as an unsigned key
__device__ __forceinline__ unsigned radix_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

struct Params {
  const float* centroid;
  const float* half_ang;
  const float* to_c;
  const float* inv_d;
  const unsigned char* inside;
  const float* beta;
  const float* dmin_all;
  const unsigned char* far_mask;
  int ng, c, kmax, kp, cap;
  int* counts;
  int* ids;
  float* dmin;
};

struct Cone {
  float cx, cy, cz, half, cosh, sinh;
};

template <int H>
struct Cluster {
  float tx[H], ty[H], tz[H], inv_d[H], beta[H], cosb[H], sinb[H];
  bool inside[H];
  bool live;     // id < C and in far_mask
  unsigned key;  // radix_key(dmin_all)
};

template <int H>
__device__ __forceinline__ Cluster<H> load_cluster(const Params& p, int j) {
  Cluster<H> cl{};
  cl.live = j < p.c && p.far_mask[j] != 0;
  if (!cl.live) return cl;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const size_t s = static_cast<size_t>(j) * H + h;
    cl.tx[h] = p.to_c[3 * s];
    cl.ty[h] = p.to_c[3 * s + 1];
    cl.tz[h] = p.to_c[3 * s + 2];
    cl.inv_d[h] = p.inv_d[s];
    cl.beta[h] = p.beta[s];
    cl.inside[h] = p.inside[s] != 0;
    __sincosf(cl.beta[h], &cl.sinb[h], &cl.cosb[h]);
  }
  cl.key = radix_key(p.dmin_all[j]);
  return cl;
}

// The twin's pair test for a live cluster: inside, or the angle from the
// tile's axis to a sub-sphere's centre within half + beta (any of them).
template <int H>
__device__ __forceinline__ bool meets(const Cone& t, const Cluster<H>& cl) {
#pragma unroll
  for (int h = 0; h < H; ++h) {
    if (cl.inside[h]) return true;
    const float x = clamp2(
        mul(add(add(mul(cl.tx[h], t.cx), mul(cl.ty[h], t.cy)),
                mul(cl.tz[h], t.cz)),
            cl.inv_d[h]),
        -1.0f, 1.0f);
    const float lim = add(t.half, cl.beta[h]);
    if (lim <= kLimMax) {  // false for a NaN: the exact test decides
      const float c = t.cosh * cl.cosb[h] - t.sinh * cl.sinb[h];
      if (x > c + kSlack) return true;
      if (x < c - kSlack) continue;
    }
    if (acosf(x) <= lim) return true;
  }
  return false;
}

// Sorts the first s (a power of two, >= 2) entries of each of the block's
// `tiles` buffers ascending, after padding each past its n entries.
__device__ void sort_buffers(unsigned long long* buf, const int* n,
                             int tiles, int cap, int s) {
  const int ls = __ffs(s) - 1;
  for (int i = threadIdx.x; i < tiles * s; i += kThreads) {
    const int t = i >> ls, k = i & (s - 1);
    if (k >= n[t]) buf[t * cap + k] = kPad;
  }
  __syncthreads();
  const int half = s >> 1, lh = ls - 1;
  for (int k = 2; k <= s; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int i = threadIdx.x; i < tiles * half; i += kThreads) {
        const int r = i & (half - 1);
        unsigned long long* b = buf + (i >> lh) * cap;
        const int lo = ((r & ~(jj - 1)) << 1) | (r & (jj - 1));
        const int hi = lo | jj;
        const unsigned long long x = b[lo], y = b[hi];
        if ((x > y) == ((lo & k) == 0)) {
          b[lo] = y;
          b[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ void put(const Params& p, size_t at,
                                    unsigned long long e) {
  const float f = key_float(static_cast<unsigned>(e >> 32));
  p.ids[at] = static_cast<int>(static_cast<unsigned>(e));
  p.dmin[at] = isfinite(f) ? f : kFar;
}

template <int T, int H>
__global__ void __launch_bounds__(kThreads)
    cache_shortlist_kernel(const Params p) {
  extern __shared__ unsigned long long buf[];  // T x cap entries
  __shared__ Cone cones[T];
  __shared__ int nbuf[T], nsurv[T], na[T], filled[T];
  __shared__ int warp_n[T][kWarps];
  __shared__ int sort_len;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int g0 = blockIdx.x * T;
  const int tiles = min(T, p.ng - g0);
  if (threadIdx.x < T) {
    const int t = threadIdx.x;
    Cone cn{0.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f};
    if (t < tiles) {
      const float* a = p.centroid + 3 * static_cast<size_t>(g0 + t);
      cn.cx = a[0];
      cn.cy = a[1];
      cn.cz = a[2];
      cn.half = p.half_ang[g0 + t];
      sincosf(cn.half, &cn.sinh, &cn.cosh);
    }
    cones[t] = cn;
    nbuf[t] = 0;
    nsurv[t] = 0;
    filled[t] = 0;
  }
  __syncthreads();

  // 1. the cull: each chunk of 256 clusters against the block's tiles;
  //    every survivor counts, those keyed below +inf go to the buffer
  for (int base = 0; base < p.c; base += kThreads) {
    const int j = base + threadIdx.x;
    const Cluster<H> cl = load_cluster<H>(p, j);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (t >= tiles) break;
      const bool pass = cl.live && meets(cones[t], cl);
      const unsigned m = __ballot_sync(~0u, pass);
      if (m == 0) continue;
      const bool keep = pass && cl.key != kKeyInf;
      const unsigned mk = __ballot_sync(~0u, keep);
      int at = 0;
      if (lane == 0) {
        atomicAdd(&nsurv[t], __popc(m));
        if (mk) at = atomicAdd(&nbuf[t], __popc(mk));
      }
      at = __shfl_sync(~0u, at, 0);
      if (keep) {
        buf[t * p.cap + at + __popc(mk & below)] =
            (static_cast<unsigned long long>(cl.key) << 32) |
            static_cast<unsigned>(j);
      }
    }
    __syncthreads();
    // a buffer over KP: keep its first KP (a chunk adds at most 256, so
    // cap >= KP + 256 holds them)
    if (__syncthreads_or(threadIdx.x < tiles && nbuf[threadIdx.x] > p.kp)) {
      sort_buffers(buf, nbuf, tiles, p.cap, p.cap);
      if (threadIdx.x < tiles) {
        nbuf[threadIdx.x] = min(nbuf[threadIdx.x], p.kp);
      }
      __syncthreads();
    }
  }

  // 2. each buffer in (key, id) order
  if (threadIdx.x == 0) {
    int most = 1;
    for (int t = 0; t < tiles; ++t) most = max(most, nbuf[t]);
    int s = 1;
    while (s < most) s <<= 1;
    sort_len = s;
  }
  if (threadIdx.x < tiles) na[threadIdx.x] = nbuf[threadIdx.x];
  __syncthreads();
  if (sort_len > 1) sort_buffers(buf, nbuf, tiles, p.cap, sort_len);
  // na: the entries keyed below +inf, ahead of the NaN-keyed ones
  for (int i = threadIdx.x; i < tiles * sort_len; i += kThreads) {
    const int t = i / sort_len, k = i % sort_len;
    if (k < nbuf[t] && static_cast<unsigned>(buf[t * p.cap + k] >> 32) >
                           kKeyInf &&
        (k == 0 ||
         static_cast<unsigned>(buf[t * p.cap + k - 1] >> 32) < kKeyInf)) {
      na[t] = k;
    }
  }
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const size_t row = static_cast<size_t>(g0 + t) * p.kp;
    for (int i = threadIdx.x; i < na[t]; i += kThreads) {
      put(p, row + i, buf[t * p.cap + i]);
    }
  }

  // 3. the columns after them: ids 0, 1, ... that are not in a buffer
  //    (non-survivors, +inf-keyed survivors, then the ids past C), found
  //    by testing the clusters again, chunk by chunk until every tile is
  //    full
  const int n_all = max(p.c, p.kp);
  for (int base = 0; base < n_all; base += kThreads) {
    bool need[T];
    bool any = false;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      need[t] = t < tiles && na[t] + filled[t] < p.kp;
      any |= need[t];
    }
    if (!any) break;
    const int j = base + threadIdx.x;
    const Cluster<H> cl = load_cluster<H>(p, j);
    int rank[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      rank[t] = -1;
      if (!need[t]) continue;
      const bool other =
          j < n_all && !(cl.live && cl.key != kKeyInf && meets(cones[t], cl));
      const unsigned m = __ballot_sync(~0u, other);
      if (lane == 0) warp_n[t][warp] = __popc(m);
      if (other) rank[t] = __popc(m & below);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (rank[t] < 0) continue;
      int pos = na[t] + filled[t] + rank[t];
      for (int w = 0; w < warp; ++w) pos += warp_n[t][w];
      if (pos < p.kp) {
        const size_t at = static_cast<size_t>(g0 + t) * p.kp + pos;
        p.ids[at] = j < p.c ? j : 0;
        p.dmin[at] = kFar;
      }
    }
    __syncthreads();
    if (threadIdx.x < tiles &&
        na[threadIdx.x] + filled[threadIdx.x] < p.kp) {  // need[t]
      int total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total += warp_n[threadIdx.x][w];
      filled[threadIdx.x] += total;
    }
    __syncthreads();
  }

  // 4. where those run out, the NaN-keyed survivors; then the counts
  for (int t = 0; t < tiles; ++t) {
    const int start = na[t] + filled[t];
    const size_t row = static_cast<size_t>(g0 + t) * p.kp;
    for (int i = threadIdx.x; start + i < p.kp; i += kThreads) {
      if (na[t] + i < nbuf[t]) {
        put(p, row + start + i, buf[t * p.cap + na[t] + i]);
      } else {  // not reached: the ids cover max(C, KP) >= KP columns
        p.ids[row + start + i] = 0;
        p.dmin[row + start + i] = kFar;
      }
    }
  }
  if (threadIdx.x < tiles) {
    p.counts[g0 + threadIdx.x] = min(nsurv[threadIdx.x], p.kmax);
  }
}

template <int T, int H>
int launch(const Params& p, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(T) * p.cap * sizeof(uint64_t);
  const cudaError_t err = cudaFuncSetAttribute(
      cache_shortlist_kernel<T, H>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cache_shortlist_kernel<T, H><<<(p.ng + T - 1) / T, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int launch_tiles(const Params& p, cudaStream_t s) {
  const int tiles = kSmemBytes / (p.cap * static_cast<int>(sizeof(uint64_t)));
  if (tiles >= 8) return launch<8, H>(p, s);
  if (tiles >= 4) return launch<4, H>(p, s);
  if (tiles >= 2) return launch<2, H>(p, s);
  return launch<1, H>(p, s);
}

}  // namespace

// Launches the cull and shortlist on `stream` and returns a CUDA error code
// (0 = launched).  ng tiles, c clusters of h (2 or 8) sub-spheres, kmax >= 1
// with KP = kmax rounded up to 128 at most 4096; ids and dmin hold ng x KP
// entries.
extern "C" int cr_cache_shortlist(const float* centroid, const float* half_ang,
                                  int ng, const float* to_c,
                                  const float* inv_d,
                                  const unsigned char* inside,
                                  const float* beta, const float* dmin_all,
                                  const unsigned char* far_mask, int c,
                                  int h, int kmax, int* counts, int* ids,
                                  float* dmin, void* stream) {
  if (ng < 1 || c < 0 || (h != 2 && h != 8) || kmax < 1 ||
      counts == nullptr || ids == nullptr ||
      dmin == nullptr ||
      (c > 0 && (to_c == nullptr || inv_d == nullptr || inside == nullptr ||
                 beta == nullptr || dmin_all == nullptr ||
                 far_mask == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kp = (kmax + 127) / 128 * 128;
  if (kp > kMaxKp) return static_cast<int>(cudaErrorInvalidValue);
  int cap = 1;
  while (cap < kp + kThreads) cap <<= 1;
  const Params p{centroid, half_ang, to_c, inv_d, inside, beta, dmin_all,
                 far_mask, ng, c, kmax, kp, cap, counts, ids, dmin};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return h == 2 ? launch_tiles<2>(p, s) : launch_tiles<8>(p, s);
}
