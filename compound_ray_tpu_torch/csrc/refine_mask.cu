// The planning layer's per-triangle refine for Hopper (sm_90a).
//
// Replaces no Pallas kernel: on the TPU, XLA fused this chain of
// elementwise operations (compound_ray_tpu/eye/pipeline.py:486,
// _refine_mask) into one pass.  Eager torch instead runs it as some 270
// launches per chunk of groups, each writing a (groups * g, kcand * 128)
// f32 temporary to device memory; this kernel takes their place on CUDA
// tensors.  Contract (eye/pipeline.py in this package, run_refine; the
// torch twin is _refine_mask there):
//   omm     (NG * g, 11) f32     per ommatidium of the chunk: cone apex (3),
//                                unit axis (3), half angle, and under the
//                                exact refine cos(hs), sin(min(hs, pi/2))
//                                and hs >= pi/2 (1.0 or 0.0) with hs =
//                                min(half + 1e-3, pi), then the shadow
//                                refine's apex-distance bound dmax; the
//                                wrapper computes every column with the
//                                twin's own torch operations
//   ids     (NG, >= kcand) int32 shortlisted cluster ids, row stride
//                                ids_stride; the first kcand are read
//   counts  (NG,) int32          live shortlist entries of each group
//   center  (C, 128, 3) f32      per-slot triangle bounding spheres
//   radius  (C, 128) f32         their radii, -1 on padding slots
//   tri     (C, 128, 9) f32      [v0 | e1 | e2] per slot (exact refine)
//   rows    (NG,) int32          out: ceil(refined slots / 128)
//   key     (NG, kcand * 128)    out: the member-minimum apex-to-centre
//           f32                  distance of each refined slot, +inf
//                                elsewhere
// A (group, slot) pair is refined iff its shortlist entry is live, its
// radius is >= 0 and some member ommatidium's cone passes: the
// cone-vs-sphere test (apex inside the sphere, or the angle to its centre
// within half plus the sphere's angular radius); under the exact refine
// also the cone-vs-triangle test on the unit sphere about the apex (a
// vertex in the cap, an edge arc within half of the axis, the axis inside
// the triangle, or a degenerate edge or vertex, with 1e-3 rad slack); and
// with dmax, dist - radius <= dmax.
//
// What bounds it on this card: operations, and issue slots more than
// FLOP/s.  A member test is ~25 operations for the sphere (one square
// root, one division, an acos and an asin) and ~290 more for the triangle
// (three reciprocal square roots for the vertices and three for the edge
// normals), per (group, slot, member).  The bytes a pair needs are 13
// floats of slot data (52 B), read through the shortlist from tables of
// C * 128 * 52 B that stay in L2, and 4 B of key.  At the pose sweep's
// chunks (2**23 member pairs at most) that is ~2.6 GFLOP, 0.04 ms at 67
// TFLOP/s, and under 0.1 ms of bytes even if every slot read went to
// device memory; the eager chain spent ~12 ms on each pass.
//
// What the design does about it:
//   * one block per group, its threads strided over the group's kcand *
//     128 slots, a warp on 32 neighbouring slots of one cluster (coalesced
//     slot reads and key writes); the group's member cones sit in shared
//     memory, and the refined-slot count is reduced inside the block;
//   * no work where the answer is known: slots past the group's live
//     shortlist or with a negative radius are not tested (their key is
//     +inf), the triangle test runs only where the sphere
//     test and the dmax bound pass, and only until one member has refined
//     the slot.  Every member's distance is still taken, since the key is
//     the minimum over all members, as the twin's;
//   * the same numbers as the twin: every product, sum, difference and
//     division is written as the torch expression rounds it, in its order
//     (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, which the compiler may
//     not contract into FMAs), with sqrtf, rsqrtf, acosf and asinf as
//     torch's CUDA kernels call them, clamps that keep a NaN as torch's
//     do, and 1 / x as torch's reciprocal.  The per-ommatidium columns
//     (apex, axis, half, the cap's cosine and sine) come from the twin's
//     own torch operations.  So each mask bit, row count and key is bit
//     for bit the twin's on the same card, and the pack sorts the same
//     keys.

#include <cuda_runtime.h>

namespace {

constexpr int kLeaf = 128;     // slots per cluster
constexpr int kThreads = 256;  // slots of a group in flight per block
constexpr int kMaxG = 32;      // ommatidia per group, at most (eye_plan)
constexpr int kOmm = 11;       // floats per ommatidium row of `omm`

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
// x * x + y * y + z * z as torch evaluates it: (x*x + y*y) + z*z
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return add(add(a, b), c);
}
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return sum3(mul(ax, bx), mul(ay, by), mul(az, bz));
}
// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
// torch.clamp(x, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

struct Cone {
  float ax, ay, az;  // apex
  float wx, wy, wz;  // unit axis
  float half, cosh, sinh, wide, dmax;
};

struct Unit {
  float x, y, z, l2;
};

// unit3 of the twin: (x, y, z) * rsqrt(max(l2, 1e-24)) and the bare l2
__device__ __forceinline__ Unit unit3(float x, float y, float z) {
  const float l2 = sum3(mul(x, x), mul(y, y), mul(z, z));
  const float inv = rsqrtf(clamp_min(l2, 1e-24f));
  return {mul(x, inv), mul(y, inv), mul(z, inv), l2};
}

// edge_test of the twin on the minor arc u_i -> u_j; writes the arc's
// unnormalised normal (u_i x u_j) for the axis-inside test
__device__ __forceinline__ bool edge_test(const Unit& ui, const Unit& uj,
                                          const Cone& c, float& cxx,
                                          float& cyy, float& czz) {
  cxx = sub(mul(ui.y, uj.z), mul(ui.z, uj.y));
  cyy = sub(mul(ui.z, uj.x), mul(ui.x, uj.z));
  czz = sub(mul(ui.x, uj.y), mul(ui.y, uj.x));
  const float cl2 = sum3(mul(cxx, cxx), mul(cyy, cyy), mul(czz, czz));
  const float invc = rsqrtf(clamp_min(cl2, 1e-24f));
  const float nx = mul(cxx, invc), ny = mul(cyy, invc), nz = mul(czz, invc);
  const float sind = dot3(c.wx, c.wy, c.wz, nx, ny, nz);
  const float ccx = sub(c.wx, mul(sind, nx));
  const float ccy = sub(c.wy, mul(sind, ny));
  const float ccz = sub(c.wz, mul(sind, nz));
  const bool in1 =
      sum3(mul(sub(mul(ui.y, ccz), mul(ui.z, ccy)), nx),
           mul(sub(mul(ui.z, ccx), mul(ui.x, ccz)), ny),
           mul(sub(mul(ui.x, ccy), mul(ui.y, ccx)), nz)) >= 0.0f;
  const bool in2 =
      sum3(mul(sub(mul(ccy, uj.z), mul(ccz, uj.y)), nx),
           mul(sub(mul(ccz, uj.x), mul(ccx, uj.z)), ny),
           mul(sub(mul(ccx, uj.y), mul(ccy, uj.x)), nz)) >= 0.0f;
  const float dotij = dot3(ui.x, ui.y, ui.z, uj.x, uj.y, uj.z);
  const bool deg = (cl2 < 1e-12f) & (dotij < 0.0f);
  return (in1 & in2 & ((fabsf(sind) <= c.sinh) | (c.wide != 0.0f))) | deg;
}

// same_side of the twin: the axis and the opposite vertex agree on n
__device__ __forceinline__ bool same_side(float nx, float ny, float nz,
                                          const Unit& p, const Cone& c) {
  return mul(dot3(c.wx, c.wy, c.wz, nx, ny, nz),
             dot3(p.x, p.y, p.z, nx, ny, nz)) >= 0.0f;
}

// The exact cone-vs-triangle test of the twin for one member cone.
__device__ __forceinline__ bool triangle_test(const float (&t)[9],
                                              const Cone& c) {
  const float d0x = sub(t[0], c.ax);
  const float d0y = sub(t[1], c.ay);
  const float d0z = sub(t[2], c.az);
  const Unit u0 = unit3(d0x, d0y, d0z);
  const Unit u1 = unit3(add(d0x, t[3]), add(d0y, t[4]), add(d0z, t[5]));
  const Unit u2 = unit3(add(d0x, t[6]), add(d0y, t[7]), add(d0z, t[8]));
  const bool vert_in =
      (dot3(u0.x, u0.y, u0.z, c.wx, c.wy, c.wz) >= c.cosh) |
      (dot3(u1.x, u1.y, u1.z, c.wx, c.wy, c.wz) >= c.cosh) |
      (dot3(u2.x, u2.y, u2.z, c.wx, c.wy, c.wz) >= c.cosh);
  // apex within f32 range of a vertex: projection undefined -> keep
  const bool deg_len = (u0.l2 < 1e-12f) | (u1.l2 < 1e-12f) | (u2.l2 < 1e-12f);
  if (vert_in | deg_len) return true;
  float n01x, n01y, n01z, n12x, n12y, n12z, n20x, n20y, n20z;
  const bool e01 = edge_test(u0, u1, c, n01x, n01y, n01z);
  const bool e12 = edge_test(u1, u2, c, n12x, n12y, n12z);
  const bool e20 = edge_test(u2, u0, c, n20x, n20y, n20z);
  const bool axis_in = same_side(n01x, n01y, n01z, u2, c) &
                       same_side(n12x, n12y, n12z, u0, c) &
                       same_side(n20x, n20y, n20z, u1, c);
  return e01 | e12 | e20 | axis_in;
}

template <bool Exact>
__global__ void __launch_bounds__(kThreads)
refine_kernel(const float* __restrict__ omm, const int* __restrict__ ids,
              int ids_stride, const int* __restrict__ counts,
              const float* __restrict__ center,
              const float* __restrict__ radius,
              const float* __restrict__ tri, int g, int kcand, int has_dmax,
              int* __restrict__ rows, float* __restrict__ key) {
  __shared__ Cone cones[kMaxG];
  __shared__ int warp_sums[kThreads / 32];
  const int grp = blockIdx.x;
  if (threadIdx.x < g) {
    const float* o = omm + (static_cast<size_t>(grp) * g + threadIdx.x) * kOmm;
    cones[threadIdx.x] = {o[0], o[1], o[2], o[3], o[4], o[5],
                          o[6], o[7], o[8], o[9], o[10]};
  }
  __syncthreads();

  const int kc = kcand * kLeaf;
  // cand < counts[grp] marks a live shortlist entry
  const int live = min(max(counts[grp], 0), kcand) * kLeaf;
  const int* gids = ids + static_cast<size_t>(grp) * ids_stride;
  float* gkey = key + static_cast<size_t>(grp) * kc;
  const float inf = __int_as_float(0x7f800000);
  int refined = 0;
  for (int k = threadIdx.x; k < live; k += kThreads) {
    const size_t s = static_cast<size_t>(gids[k / kLeaf]) * kLeaf + k % kLeaf;
    const float r = radius[s];
    bool hit = false;
    float dmin = inf;
    if (r >= 0.0f) {  // r < 0 (or NaN) marks a padding slot
      const float cx = center[3 * s], cy = center[3 * s + 1],
                  cz = center[3 * s + 2];
      float t[9];
      if (Exact) {
#pragma unroll
        for (int q = 0; q < 9; ++q) t[q] = tri[9 * s + q];
      }
      for (int m = 0; m < g; ++m) {
        const Cone& c = cones[m];
        const float tx = sub(cx, c.ax), ty = sub(cy, c.ay),
                    tz = sub(cz, c.az);
        const float dist = sqrtf(sum3(mul(tx, tx), mul(ty, ty), mul(tz, tz)));
        if (dist < dmin || dist != dist) dmin = dist;  // amin keeps a NaN
        if (hit) continue;
        if (has_dmax && !(sub(dist, r) <= c.dmax)) continue;
        const float inv_d = __fdiv_rn(1.0f, clamp_min(dist, 1e-30f));
        bool m_hit = dist <= r;
        if (!m_hit) {
          const float cos_a = mul(dot3(tx, ty, tz, c.wx, c.wy, c.wz), inv_d);
          const float alpha = acosf(clamp2(cos_a, -1.0f, 1.0f));
          const float beta = asinf(clamp2(mul(r, inv_d), 0.0f, 1.0f));
          m_hit = alpha <= add(c.half, beta);
        }
        if (Exact && m_hit) m_hit = triangle_test(t, c);
        hit = m_hit;
      }
    }
    refined += hit;
    gkey[k] = hit ? dmin : inf;
  }
  for (int k = live + threadIdx.x; k < kc; k += kThreads) gkey[k] = inf;

  for (int off = 16; off > 0; off >>= 1) {
    refined += __shfl_down_sync(0xffffffffu, refined, off);
  }
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = refined;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    rows[grp] = (total + kLeaf - 1) / kLeaf;
  }
}

}  // namespace

// Launches the refine on `stream` and returns a CUDA error code (0 =
// launched).  ng groups of g ommatidia (1 <= g <= 32), kcand shortlist
// entries each; exact != 0 runs the triangle test on `tri`; has_dmax != 0
// applies the omm rows' dmax.
extern "C" int cr_refine_mask(const float* omm, const int* ids,
                              int ids_stride, const int* counts,
                              const float* center, const float* radius,
                              const float* tri, int ng, int g, int kcand,
                              int exact, int has_dmax, int* rows, float* key,
                              void* stream) {
  if (ng <= 0 || g < 1 || g > kMaxG || kcand < 1 || ids_stride < kcand ||
      (exact && tri == nullptr) || key == nullptr ||
      static_cast<long long>(kcand) * kLeaf > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (exact) {
    refine_kernel<true><<<ng, kThreads, 0, s>>>(
        omm, ids, ids_stride, counts, center, radius, tri, g, kcand,
        has_dmax, rows, key);
  } else {
    refine_kernel<false><<<ng, kThreads, 0, s>>>(
        omm, ids, ids_stride, counts, center, radius, tri, g, kcand,
        has_dmax, rows, key);
  }
  return static_cast<int>(cudaGetLastError());
}
