// The frame core's unlit shading and per-ommatidium mean for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: on the TPU, XLA fused the unlit epilogue of
// the frame (compound_ray_tpu/eye/pipeline.py:1191-1545: winner
// attributes, texture, miss shader or far-field cache, the mean) into the
// frame's program.  Eager torch instead runs it as ~270 launches a frame,
// each writing a (rays,) temporary to device memory, with row gathers of
// the attribute table and of 64-byte texel or cache quads between them.
// This kernel takes their place after K1 on every CUDA frame that is unlit
// and wants means.  Contract (eye/pipeline.py in this package,
// run_shade_means; the torch twin is shade_means_reference there):
//   out     (8, R) f32       K1's planar rows: t (+inf on a miss), u, v,
//                            slot (its attribute row, as a float)
//   rays    (F, R) f32       K1's rays; rows 0-2 are the unit direction in
//                            both forms (16 and 8 features)
//   counts  (NG,) int32      payload rows per group; a group with none is
//                            a miss whatever its rays hold
//   attr    (S, A) f32       winner attributes, A = 8 (every triangle
//                            textured), 10 (flat: the material colour) or
//                            24 (vertex colours, linearised by pow 2.2)
//   tex_*   (T,) int32       per texture: atlas offset, width, height,
//                            wrap s, wrap t, filter (1 linear)
//   quads   (P, 16) f32      2 x 2 RGBA texel quads: the texture quads, the
//                            far-field cache's equirect quads, or both, the
//                            cache's (ch * cw) rows from cache_row on
//   ox..tmin (Np,) f32       per ommatidium: world ray origin and tmin, as
//                            ray generation computed them (cache frames)
//   centre  (3,) f32, d2     the far-field sphere: a hit counts only where
//                            |o + (t + tmin) d - centre|^2 <= d2
//   means   (Np, frames, 3)  out: each (ommatidium, frame)'s mean colour
// Ray (ommatidium i, frame f, sample s) sits at slot grp * rg_pad + m *
// frames * S + f * S + s with grp = i / g, m = i % g: each (ommatidium,
// frame) owns S contiguous slots, and the padding slots at the end of a
// group's rg_pad block are never read.
//
// What bounds it on this card: bytes.  A ray reads 28 B of K1's rows and
// its direction, coalesced, and at most one 64-byte quad; the attribute
// rows (~100 B each) and the texture table come from tables that stay in
// L2.  At 3.2 M rays that is ~0.1-0.3 GB, 0.03-0.09 ms at 3.35 TB/s; the
// eager chain took 6.6-7.3 ms.
//
// What the design does about it:
//   * L lanes per (ommatidium, frame), L the power of two nearest above S
//     up to 256, 256 / L of them per block: neighbouring lanes read
//     neighbouring slots, each lane sums its samples in registers, and the
//     sums meet by warp shuffles (and, for L > 32, one shared-memory step),
//     in an order fixed by the launch; nothing but the means is written;
//   * only the work a ray needs: the attribute row and the texture or
//     cache lookup are read only where the ray's colour takes them, quads
//     as four 16-byte read-only loads;
//   * the same numbers as the twin: each product, sum and difference is
//     written as the torch expression rounds it, in its order (__fmul_rn,
//     __fadd_rn, __fsub_rn, __fdiv_rn, which the compiler may not contract
//     into FMAs); a division by a constant is the multiplication by its
//     float reciprocal that torch's CUDA kernels make of it; atan2f,
//     asinf, floorf, rintf and powf as torch's CUDA kernels call them; and
//     clamps and minima that keep a NaN as torch's do.  So each sample's
//     colour and hit decision is the twin's on the same card; only the
//     mean's order of summation differs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the attribute forms, of 8, 10 and 24 columns
constexpr int kTexOnly = 0, kFlat = 1, kFull = 2;
constexpr double kPi = 3.14159265358979323846;
// torch divides by a scalar on the card as a product with the reciprocal
// computed in float from the float divisor (div_true_kernel_cuda)
constexpr float kInvPi = 1.0f / static_cast<float>(kPi);
constexpr float kInv2Pi = 1.0f / static_cast<float>(2.0 * kPi);
constexpr float kPiF = static_cast<float>(kPi);
constexpr float kHalfPiF = static_cast<float>(kPi / 2.0);

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
// torch.clamp(x, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
// torch.minimum(x, hi) for a hi that is never NaN: NaN stays NaN
__device__ __forceinline__ float minimum(float x, float hi) {
  return (x < hi || x != x) ? x : hi;
}

struct Rgb {
  float r, g, b;
};

struct Params {
  const float* out;
  const float* rays;
  long long r;  // row stride of out and rays
  const int* counts;
  const float* attr;
  int attr_rows, attr_cols;
  const int* tex_offset;
  const int* tex_width;
  const int* tex_height;
  const int* tex_wrap_s;
  const int* tex_wrap_t;
  const int* tex_filter;
  const float* quads;
  long long cache_row;
  int cache_h, cache_w;
  const float* ox;
  const float* oy;
  const float* oz;
  const float* tmin;
  const float* centre;
  float d2;
  int background;
  int n_pad, g, frames, samples, rg_pad, lanes;
  float inv_samples;
  float* means;
};

// _addr_dynamic of trace/shade.py: wrap (0), clamp (1) or mirror (2) a
// texel coordinate, then clamp it into the texture
__device__ __forceinline__ int texel(float coord, int n, int mode) {
  const float nf = static_cast<float>(n);
  const float top = sub(nf, 1.0f);
  const float wrapped =
      sub(coord, mul(floorf(__fdiv_rn(coord, nf)), nf));
  const float clamped = minimum(clamp_min(coord, 0.0f), top);
  const float period = mul(2.0f, nf);
  const float m = sub(coord, mul(floorf(__fdiv_rn(coord, period)), period));
  const float mirrored = m < nf ? m : sub(sub(period, 1.0f), m);
  const float o = mode == 1 ? clamped : (mode == 2 ? mirrored : wrapped);
  return static_cast<int>(minimum(clamp_min(o, 0.0f), top));
}

// quad_bilinear_c of trace/shade.py on one quad row
__device__ __forceinline__ Rgb bilinear(const float* row, float fx,
                                        float fy) {
  const float4* q4 = reinterpret_cast<const float4*>(row);
  const float4 c00 = __ldg(q4), c10 = __ldg(q4 + 1), c01 = __ldg(q4 + 2),
               c11 = __ldg(q4 + 3);
  const float w00 = mul(sub(1.0f, fx), sub(1.0f, fy));
  const float w10 = mul(fx, sub(1.0f, fy));
  const float w01 = mul(sub(1.0f, fx), fy);
  const float w11 = mul(fx, fy);
  const auto ch = [&](float a, float b, float c, float d) {
    return add(add(add(mul(a, w00), mul(b, w10)), mul(c, w01)),
               mul(d, w11));
  };
  return {ch(c00.x, c10.x, c01.x, c11.x), ch(c00.y, c10.y, c01.y, c11.y),
          ch(c00.z, c10.z, c01.z, c11.z)};
}

// texture_quad_coords_c + quad_bilinear_c of trace/shade.py for one hit
__device__ __forceinline__ Rgb texture(const Params& p, int tid, float cu,
                                       float cv) {
  const int off = __ldg(p.tex_offset + tid), w = __ldg(p.tex_width + tid),
            h = __ldg(p.tex_height + tid);
  const bool linear = __ldg(p.tex_filter + tid) == 1;
  const float x = sub(mul(cu, static_cast<float>(w)), 0.5f);
  const float y = sub(mul(cv, static_cast<float>(h)), 0.5f);
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = linear ? sub(x, x0) : 0.0f;
  const float fy = linear ? sub(y, y0) : 0.0f;
  // nearest filtering rounds half to even, as torch.round
  const int xi = texel(linear ? x0 : rintf(x), w, __ldg(p.tex_wrap_s + tid));
  const int yi = texel(linear ? y0 : rintf(y), h, __ldg(p.tex_wrap_t + tid));
  const long long row = off + yi * w + xi;  // int32 sums, as the twin's
  return bilinear(p.quads + row * 16, fx, fy);
}

// _equirect_coords_c of eye/pipeline.py + the cache quad's blend
__device__ __forceinline__ Rgb cache_lookup(const Params& p, float dx,
                                            float dy, float dz) {
  const float ax = atan2f(dz, dx);
  const float ay = asinf(clamp2(dy, -1.0f, 1.0f));
  const float u = add(mul(sub(kHalfPiF, ax), kInv2Pi), 0.5f);
  const float v = add(mul(ay, kInvPi), 0.5f);
  const int h = p.cache_h, w = p.cache_w;
  const float x = sub(mul(u, static_cast<float>(w)), 0.5f);
  const float y = clamp2(sub(mul(v, static_cast<float>(h)), 0.5f), 0.0f,
                         static_cast<float>(h - 1));
  const float x0 = floorf(x), y0 = floorf(y);
  // torch.remainder on int64: the result takes the divisor's sign
  long long xi = static_cast<long long>(x0) % w;
  if (xi < 0) xi += w;
  long long yi = static_cast<long long>(y0);
  yi = yi < 0 ? 0 : (yi > h - 1 ? h - 1 : yi);
  return bilinear(p.quads + (p.cache_row + yi * w + xi) * 16, sub(x, x0),
                  sub(y, y0));
}

// miss_color_c of trace/shade.py
__device__ __forceinline__ Rgb miss(int which, float dx, float dy, float dz) {
  if (which == 1) return {1.0f, 1.0f, 1.0f};
  if (which == 2) return {0.0f, 0.0f, 0.0f};
  const float as = asinf(clamp2(dy, -1.0f, 1.0f));
  if (which == 3) {  // simple_sky
    const float mix = clamp2(mul(mul(as, 2.0f), kInvPi), 0.0f, 1.0f);
    const float lo = sub(1.0f, mix);
    const auto ch = [&](double lower, double upper) {
      return add(mul(static_cast<float>(lower), lo),
                 mul(static_cast<float>(upper), mix));
    };
    return {ch(143.0 / 255.0 * 0.8, 1.0 / 255.0),
            ch(179.0 / 255.0 * 0.8, 31.0 / 255.0),
            ch(203.0 / 255.0 * 0.8, 117.0 / 255.0)};
  }
  const float u = mul(add(atan2f(dz, dx), kPiF), kInv2Pi);
  const float v = mul(add(as, kHalfPiF), kInvPi);
  const bool on_axis =
      (fabsf(dx) < 0.01f) | (fabsf(dy) < 0.01f) | (fabsf(dz) < 0.01f);
  return {on_axis ? 0.0f : u, on_axis ? 0.0f : v, 0.0f};
}

// One ray's colour: the winner's colour, its texture, the cache or the
// miss shader, as _shade_planes decides it
template <int Attr, bool Textured, bool Cache>
__device__ __forceinline__ Rgb shade(const Params& p, long long k, bool live,
                                     float oxc, float oyc, float ozc,
                                     float tmin) {
  const float t = p.out[k];
  const float dx = p.rays[k], dy = p.rays[p.r + k], dz = p.rays[2 * p.r + k];
  bool hit = live && t < 1e30f;
  if constexpr (Cache) {
    if (hit) {  // _inside_far_sphere
      const float tt = add(t, tmin);
      const float px = add(oxc, mul(tt, dx));
      const float py = add(oyc, mul(tt, dy));
      const float pz = add(ozc, mul(tt, dz));
      hit = add(add(mul(px, px), mul(py, py)), mul(pz, pz)) <= p.d2;
    }
  }
  if (!hit) {
    if constexpr (Cache) {
      return cache_lookup(p, dx, dy, dz);
    } else {
      return miss(p.background, dx, dy, dz);
    }
  }
  const float u = p.out[p.r + k], v = p.out[2 * p.r + k],
              sl = p.out[3 * p.r + k];
  // clamp(slot.long(), 0, rows - 1); a NaN converts to 0
  const int row = sl >= 0.0f
                      ? (sl < static_cast<float>(p.attr_rows)
                             ? static_cast<int>(sl)
                             : p.attr_rows - 1)
                      : 0;
  const float* a = p.attr + static_cast<long long>(row) * p.attr_cols;
  const float w0n = sub(sub(1.0f, u), v);
  if constexpr (Textured) {
    const int texid = static_cast<int>(__ldg(a + 6));
    if (texid >= 0) {
      const float cu =
          add(add(mul(w0n, __ldg(a)), mul(u, __ldg(a + 2))),
              mul(v, __ldg(a + 4)));
      const float cv =
          add(add(mul(w0n, __ldg(a + 1)), mul(u, __ldg(a + 3))),
              mul(v, __ldg(a + 5)));
      return texture(p, texid, cu, cv);
    }
  }
  if constexpr (Attr == kTexOnly) {
    return {0.0f, 0.0f, 0.0f};
  } else if constexpr (Attr == kFlat) {
    return {__ldg(a + 7), __ldg(a + 8), __ldg(a + 9)};
  } else {  // vertex colours: interpolated, then linearised where flagged
    const bool lin = __ldg(a + 7) > 0.5f;
    const auto ch = [&](int c) {
      const float x = add(add(mul(w0n, __ldg(a + 8 + c)),
                              mul(u, __ldg(a + 11 + c))),
                          mul(v, __ldg(a + 14 + c)));
      return lin ? powf(clamp_min(x, 0.0f), 2.2f) : x;
    };
    return {ch(0), ch(1), ch(2)};
  }
}

template <int Attr, bool Textured, bool Cache>
__global__ void __launch_bounds__(kThreads)
shade_means_kernel(const Params p) {
  __shared__ float part[kWarps][3];
  const int lanes = p.lanes;
  const int lane = threadIdx.x & (lanes - 1);
  const int seg = blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  const int nseg = p.n_pad * p.frames;
  float sr = 0.0f, sg = 0.0f, sb = 0.0f;
  if (seg < nseg) {
    const int i = seg / p.frames, f = seg - i * p.frames;
    const int grp = i / p.g, m = i - grp * p.g;
    const long long base = static_cast<long long>(grp) * p.rg_pad +
                           static_cast<long long>(m) * p.frames * p.samples +
                           static_cast<long long>(f) * p.samples;
    const bool live = p.counts[grp] > 0;
    float oxc = 0.0f, oyc = 0.0f, ozc = 0.0f, tmin = 0.0f;
    if constexpr (Cache) {  // the twin's (o - centre), tmin per ommatidium
      oxc = sub(p.ox[i], p.centre[0]);
      oyc = sub(p.oy[i], p.centre[1]);
      ozc = sub(p.oz[i], p.centre[2]);
      tmin = p.tmin[i];
    }
    for (int s = lane; s < p.samples; s += lanes) {
      const Rgb c = shade<Attr, Textured, Cache>(p, base + s, live, oxc, oyc,
                                                 ozc, tmin);
      sr += c.r;
      sg += c.g;
      sb += c.b;
    }
  }
  // the lanes of a segment meet: shuffles within a warp (width lanes up to
  // 32), then the segment's warps through shared memory
  const int width = lanes < 32 ? lanes : 32;
  for (int off = width / 2; off > 0; off >>= 1) {
    sr += __shfl_down_sync(0xffffffffu, sr, off, width);
    sg += __shfl_down_sync(0xffffffffu, sg, off, width);
    sb += __shfl_down_sync(0xffffffffu, sb, off, width);
  }
  if (lanes > 32) {
    const int warp = threadIdx.x / 32;
    if ((threadIdx.x & 31) == 0) {
      part[warp][0] = sr;
      part[warp][1] = sg;
      part[warp][2] = sb;
    }
    __syncthreads();
    if (lane != 0) return;
    sr = sg = sb = 0.0f;
    for (int w = warp; w < warp + lanes / 32; ++w) {
      sr += part[w][0];
      sg += part[w][1];
      sb += part[w][2];
    }
  } else if (lane != 0) {
    return;
  }
  if (seg < nseg) {
    float* o = p.means + static_cast<long long>(seg) * 3;
    o[0] = mul(sr, p.inv_samples);
    o[1] = mul(sg, p.inv_samples);
    o[2] = mul(sb, p.inv_samples);
  }
}

template <int Attr, bool Textured, bool Cache>
cudaError_t launch(const Params& p, int blocks, cudaStream_t s) {
  shade_means_kernel<Attr, Textured, Cache><<<blocks, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

template <int Attr>
cudaError_t dispatch(const Params& p, bool textured, bool cache, int blocks,
                     cudaStream_t s) {
  if (textured) {
    return cache ? launch<Attr, true, true>(p, blocks, s)
                 : launch<Attr, true, false>(p, blocks, s);
  }
  return cache ? launch<Attr, false, true>(p, blocks, s)
               : launch<Attr, false, false>(p, blocks, s);
}

}  // namespace

// Launches the shading on `stream` and returns a CUDA error code (0 =
// launched).  attr_cols 8, 10 or 24 picks the attribute form; textured !=
// 0 reads the texture tables and the texture quads; cache != 0 tests the
// far-field sphere and reads misses from the cache quads (cache_row on,
// cache_h x cache_w), else the miss shader `background` (0-3).
extern "C" int cr_shade_means(
    const float* out, const float* rays, long long r, const int* counts,
    const float* attr, int attr_rows, int attr_cols, const int* tex_offset,
    const int* tex_width, const int* tex_height, const int* tex_wrap_s,
    const int* tex_wrap_t, const int* tex_filter, const float* quads,
    long long cache_row, int cache_h, int cache_w, const float* ox,
    const float* oy, const float* oz, const float* tmin,
    const float* centre, float d2, int background, int n_pad, int g,
    int frames, int samples, int rg_pad, int textured, int cache,
    float* means, void* stream) {
  const int attr_kind = attr_cols == 8 ? kTexOnly
                        : attr_cols == 10 ? kFlat
                        : attr_cols == 24 ? kFull : -1;
  if (attr_kind < 0 || attr_rows < 1 || n_pad < 1 || g < 1 ||
      frames < 1 || samples < 1 || rg_pad < g * frames * samples ||
      background < 0 || background > 3 ||
      (textured && (tex_offset == nullptr || quads == nullptr)) ||
      (attr_kind == kTexOnly && !textured) ||
      (cache && (quads == nullptr || ox == nullptr || centre == nullptr ||
                 cache_h < 1 || cache_w < 1)) ||
      static_cast<long long>(n_pad) * frames > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int lanes = 1;
  while (lanes < samples && lanes < kThreads) lanes *= 2;
  Params p{out, rays, r, counts, attr, attr_rows, attr_cols, tex_offset,
           tex_width, tex_height, tex_wrap_s, tex_wrap_t, tex_filter, quads,
           cache_row, cache_h, cache_w, ox, oy, oz, tmin, centre, d2,
           background, n_pad, g, frames, samples, rg_pad, lanes,
           1.0f / static_cast<float>(samples), means};
  const long long nseg = static_cast<long long>(n_pad) * frames;
  const int per_block = kThreads / lanes;
  const int blocks = static_cast<int>((nseg + per_block - 1) / per_block);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (attr_kind == kTexOnly) {
    err = dispatch<kTexOnly>(p, true, cache != 0, blocks, s);
  } else if (attr_kind == kFlat) {
    err = dispatch<kFlat>(p, textured != 0, cache != 0, blocks, s);
  } else {
    err = dispatch<kFull>(p, textured != 0, cache != 0, blocks, s);
  }
  return static_cast<int>(err);
}
