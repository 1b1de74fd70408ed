// The frame core's ray generation for Hopper (sm_90a): cone-jittered
// sample angles -> K1's planar rays and the per-ommatidium world origins.
//
// Replaces no Pallas kernel: on the TPU, XLA fused ray generation
// (compound_ray_tpu/eye/pipeline.py:1036-1100: the focal-retracted world
// origin, generateOffsetRay's two rotations, the world transform, the
// normalisation, the Plücker moment and the tmin-shifted origin, the edge
// padding of each group's ray block) into the frame's program.  Eager torch
// instead runs it as ~170 launches a frame, each writing an (Np, S)
// temporary, then a replicate pad and a stack of the rows.  This kernel
// takes their place before K1 on every CUDA frame core.  Contract
// (eye/pipeline.py in this package, run_ray_features; the torch twin is
// ray_features_reference there):
//   omms    (Np, 8) f32     permuted ommatidium rows [pos(3), axis(3),
//                           acceptance, focal offset]
//   pose    (3,) f32        the eye's world position
//   ls      (3, 3) f32      its local space, rows the world x/y/z axes
//   splay, spin (Np, S) f32 the drawn angles, row strides given, columns
//                           contiguous (a stacked burst: S = F x S')
//   rays    (F, R) f32      out: R = NG * rg_pad; F = 16: [d, m = o x d,
//                           -(o + tmin d), 1, 0 x 6]; F = 8 (affine):
//                           [d, 1, 0 x 4]
//   origins (4, Np) f32     out: rows ox, oy, oz, tmin (world)
// Slot j of group k's block (j < rg_pad) is ray (ommatidium k * g + jj /
// S, sample jj % S) with jj = min(j, g * S - 1): a padding slot repeats
// its group's last real ray, as the replicate pad does.
//
// What bounds it on this card: bytes.  It reads 8 B of angles a ray and
// writes F x 4 B a padded slot, never reading them back: at 3.2 M rays and
// 16 features, ~0.21-0.33 GB, 0.07-0.10 ms at 3.35 TB/s.
//
// What the design does about it:
//   * one thread per padded slot, so each of the F rows is stored fully
//     coalesced, and neighbouring threads read neighbouring angles;
//   * the per-ommatidium quantities (axis, perp, origin, tmin) are computed
//     once per block into shared memory by a prologue (a block of 256
//     slots spans at most 256 ommatidia), and the block holding an
//     ommatidium's sample 0 writes its origins row; no intermediate plane
//     is ever written;
//   * the same numbers as the twin: each product, sum and difference is
//     written as the torch expression rounds it, in its order (__fmul_rn,
//     __fadd_rn, __fsub_rn and __fdiv_rn, which the compiler may not
//     contract into FMAs); sinf, cosf, sqrtf and rsqrtf as torch's CUDA
//     kernels call them (no fast math); clamps that keep a NaN as torch's
//     do; the reference's degeneracy test sum(perp) == 0.  So the rays and
//     the origins equal the twin's on the same card bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// per-ommatidium table columns in shared memory
constexpr int kAx = 0, kAy = 1, kAz = 2, kPx = 3, kPy = 4, kPz = 5, kOx = 6,
              kOy = 7, kOz = 8, kTmin = 9, kCols = 10;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

struct Params {
  const float* omms;
  const float* pose;
  const float* ls;
  const float* splay;
  long long splay_stride;
  const float* spin;
  long long spin_stride;
  int n_pad, g, samples, rg_pad;
  long long r;  // NG * rg_pad: the rays' row stride
  float* rays;
  float* origins;
};

// the ommatidium whose ray padded slot `slot` holds
__device__ __forceinline__ int omm_of(long long slot, const Params& p) {
  const long long grp = slot / p.rg_pad;
  const int j = static_cast<int>(slot - grp * p.rg_pad);
  const int jj = min(j, p.g * p.samples - 1);
  return static_cast<int>(grp) * p.g + jj / p.samples;
}

// _omm_world_origins and cone_offset_components' perp for ommatidium o
__device__ void omm_row(const Params& p, int o, float* t) {
  const float* row = p.omms + static_cast<long long>(o) * 8;
  const float ax = row[3], ay = row[4], az = row[5], focal = row[7];
  const float axis_len =
      sqrtf(add(add(mul(ax, ax), mul(ay, ay)), mul(az, az)));
  // 1.0 / clamp(axis_len): torch's reciprocal, then a product with 1
  const float inv_al = __fdiv_rn(1.0f, clamp_min(axis_len, 1e-30f));
  const float rx = sub(row[0], mul(mul(ax, inv_al), focal));
  const float ry = sub(row[1], mul(mul(ay, inv_al), focal));
  const float rz = sub(row[2], mul(mul(az, inv_al), focal));
  const float* L = p.ls;
  t[kOx] = add(add(add(p.pose[0], mul(rx, L[0])), mul(ry, L[3])),
               mul(rz, L[6]));
  t[kOy] = add(add(add(p.pose[1], mul(rx, L[1])), mul(ry, L[4])),
               mul(rz, L[7]));
  t[kOz] = add(add(add(p.pose[2], mul(rx, L[2])), mul(ry, L[5])),
               mul(rz, L[8]));
  t[kTmin] = mul(focal, axis_len);
  // perp = cross(+y, axis) = (az, 0, -ax), unit, or +z where its sum is 0
  const float px = az, py = 0.0f, pz = -ax;
  const bool degenerate = add(add(px, py), pz) == 0.0f;
  const float norm = clamp_min(
      sqrtf(add(add(mul(px, px), mul(py, py)), mul(pz, pz))), 1e-30f);
  t[kPx] = degenerate ? 0.0f : __fdiv_rn(px, norm);
  t[kPy] = degenerate ? 0.0f : __fdiv_rn(py, norm);
  t[kPz] = degenerate ? 1.0f : __fdiv_rn(pz, norm);
  t[kAx] = ax;
  t[kAy] = ay;
  t[kAz] = az;
}

// rodrigues_c: point (qx, qy, qz) about the unnormalised axis (ax, ay, az)
// by `angle`
__device__ __forceinline__ void rotate(float qx, float qy, float qz,
                                       float angle, float ax, float ay,
                                       float az, float& ox, float& oy,
                                       float& oz) {
  const float c = cosf(angle);
  const float s = sinf(angle);
  const float cx = sub(mul(ay, qz), mul(az, qy));
  const float cy = sub(mul(az, qx), mul(ax, qz));
  const float cz = sub(mul(ax, qy), mul(ay, qx));
  const float d = mul(sub(1.0f, c),
                      add(add(mul(ax, qx), mul(ay, qy)), mul(az, qz)));
  ox = add(add(mul(c, qx), mul(s, cx)), mul(d, ax));
  oy = add(add(mul(c, qy), mul(s, cy)), mul(d, ay));
  oz = add(add(mul(c, qz), mul(s, cz)), mul(d, az));
}

template <int Feats>
__global__ void __launch_bounds__(kThreads)
    ray_features_kernel(const Params p) {
  __shared__ float tab[kCols][kThreads];
  const long long s0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long s1 = min(s0 + kThreads, p.r) - 1;
  const int o_lo = omm_of(s0, p);
  const int n = omm_of(s1, p) - o_lo + 1;
  if (static_cast<int>(threadIdx.x) < n) {
    const int o = o_lo + threadIdx.x;
    float t[kCols];
    omm_row(p, o, t);
    for (int c = 0; c < kCols; ++c) tab[c][threadIdx.x] = t[c];
    // the block holding the ommatidium's sample 0 writes its origins
    const long long first = static_cast<long long>(o / p.g) * p.rg_pad +
                            static_cast<long long>(o % p.g) * p.samples;
    if (first >= s0) {
      p.origins[o] = t[kOx];
      p.origins[p.n_pad + o] = t[kOy];
      p.origins[2 * p.n_pad + o] = t[kOz];
      p.origins[3 * p.n_pad + o] = t[kTmin];
    }
  }
  __syncthreads();
  const long long slot = s0 + threadIdx.x;
  if (slot >= p.r) return;
  const long long grp = slot / p.rg_pad;
  const int j = min(static_cast<int>(slot - grp * p.rg_pad),
                    p.g * p.samples - 1);
  const int o = static_cast<int>(grp) * p.g + j / p.samples;
  const int smp = j % p.samples;
  const int i = o - o_lo;
  const float ax = tab[kAx][i], ay = tab[kAy][i], az = tab[kAz][i];
  const float splay = p.splay[o * p.splay_stride + smp];
  const float spin = p.spin[o * p.spin_stride + smp];
  float sx, sy, sz, rdx, rdy, rdz;
  rotate(ax, ay, az, splay, tab[kPx][i], tab[kPy][i], tab[kPz][i], sx, sy,
         sz);
  rotate(sx, sy, sz, spin, ax, ay, az, rdx, rdy, rdz);
  const float* L = p.ls;
  const float wdx = add(add(mul(rdx, L[0]), mul(rdy, L[3])), mul(rdz, L[6]));
  const float wdy = add(add(mul(rdx, L[1]), mul(rdy, L[4])), mul(rdz, L[7]));
  const float wdz = add(add(mul(rdx, L[2]), mul(rdy, L[5])), mul(rdz, L[8]));
  // clamp(min=1e-60) on f32 is clamp(min=0): 1e-60 rounds to 0 in float
  const float inv_n = rsqrtf(clamp_min(
      add(add(mul(wdx, wdx), mul(wdy, wdy)), mul(wdz, wdz)),
      static_cast<float>(1e-60)));
  const float dx = mul(wdx, inv_n), dy = mul(wdy, inv_n),
              dz = mul(wdz, inv_n);
  float* out = p.rays + slot;
  const long long r = p.r;
  out[0] = dx;
  out[r] = dy;
  out[2 * r] = dz;
  if (Feats == 8) {
    out[3 * r] = 1.0f;
    for (int f = 4; f < 8; ++f) out[f * r] = 0.0f;
    return;
  }
  const float ox = tab[kOx][i], oy = tab[kOy][i], oz = tab[kOz][i];
  const float tmin = tab[kTmin][i];
  out[3 * r] = sub(mul(oy, dz), mul(oz, dy));
  out[4 * r] = sub(mul(oz, dx), mul(ox, dz));
  out[5 * r] = sub(mul(ox, dy), mul(oy, dx));
  out[6 * r] = -add(ox, mul(tmin, dx));
  out[7 * r] = -add(oy, mul(tmin, dy));
  out[8 * r] = -add(oz, mul(tmin, dz));
  out[9 * r] = 1.0f;
  for (int f = 10; f < 16; ++f) out[f * r] = 0.0f;
}

}  // namespace

// Launches ray generation on `stream` and returns a CUDA error code (0 =
// launched).  feats 16 or 8 picks the form; ng groups of g ommatidia, each
// block rg_pad >= g * samples slots.
extern "C" int cr_ray_features(const float* omms, const float* pose,
                               const float* ls, const float* splay,
                               long long splay_stride, const float* spin,
                               long long spin_stride, int ng, int g,
                               int samples, int rg_pad, int feats,
                               float* rays, float* origins, void* stream) {
  if (ng < 1 || g < 1 || samples < 1 || rg_pad < g * samples ||
      (feats != 16 && feats != 8) ||
      static_cast<long long>(ng) * g > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long r = static_cast<long long>(ng) * rg_pad;
  Params p{omms,    pose,  ls, splay, splay_stride, spin, spin_stride,
           ng * g,  g,     samples, rg_pad, r, rays, origins};
  const long long blocks = (r + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feats == 16) {
    ray_features_kernel<16><<<static_cast<int>(blocks), kThreads, 0, s>>>(p);
  } else {
    ray_features_kernel<8><<<static_cast<int>(blocks), kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
