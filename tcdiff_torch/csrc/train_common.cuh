// Building blocks of the train-block kernels (sa_block_train.cu,
// ca_block_train.cu, ff_tail_train.cu): row kernels for the LayerNorm /
// dropout / FiLM chains forward and backward, the reductions of parameter
// gradients, and a flash-style attention forward and backward with the
// hash dropout on the probabilities, generic in Lq and Lk.
//
// Parameter gradients are sums over the b*L rows. Hopper blocks run in no
// set order, so nothing is accumulated across blocks: each block writes
// the partial sum of its rows, and a second pass (reduce_kernel) adds the
// partials in a fixed order. A run repeats bit for bit; no atomics.
#pragma once

#include "attention.cuh"
#include "gemm_mma.cuh"

namespace tcd {

// ------------------------------------------------------------- row kernels
// The row kernels of the attention blocks' chains (chain_top_fwd,
// chain_top_bwd, rows_bwd; K3 and K4, and K5's last row pass), one warp a
// row, as ln_rows of common.cuh: a block of RW warps owns chunk c of nch
// of one batch element's L rows, rows [c L / nch, (c + 1) L / nch) (grid
// (nch, B)), and warp w walks its rows l0 + w, l0 + w + RW, ...
//
// What bounds them on the H100: a handful of operations and two dropout
// hashes an element against 6-14 bytes of it in and out: the bytes (K4's
// chain_top_bwd at 28800 x 512: g and the f32 z in, dz out, 118 MB, 35 us
// at 3.35 TB/s; rows_bwd: the f32 dr, x and g in, dx out, 148 MB, 44 us).
//
// Design: a lane holds EPL = d / 32 elements of a row in registers, read
// once in chunks of W = min(EPL, 8) contiguous elements (16 bytes of bf16,
// two 16-byte vectors of f32) at column (c * 32 + lane) * W, so a rotary
// pair lies in one lane, and every load of a row is issued before its
// statistics; those are xor shuffles (no block barrier). The block's
// constant rows (the LayerNorm affine, the batch element's FiLM rows) sit
// in shared memory and the registers hold the row and the running column
// sums, so that four blocks fit an SM (at 231 registers a thread, with
// the constants in registers too, two did). Each dropout mask is hashed
// once per salt and element (chain_top_bwd keeps the FC mask's bits for
// its last pass). Templated on d / 32 for d = 64 .. 1024; EPL = 0 is a
// pair-wise body (pairs (2p, 2p + 1), p = lane, lane + 32, ..., element
// loads) for any other even d <= 1024 or an operand not 16-byte aligned.
//
// Parameter gradients (the LayerNorm affines, and per batch element the
// FiLM rows) are sums over rows; nothing is added across blocks: a warp
// adds its rows in registers, the block adds its warps in warp order
// through shared memory and writes the chunk's partial to row b * nch + c
// of its (B * nch, d) array, and reduce_kernel adds the chunks in a fixed
// order, so a backward repeats bit for bit. A block's rows never cross a
// batch element, since dfs and dfb are per element.
constexpr int RW = 4;       // warps of a row block
constexpr int RCH = 32;     // rows of a chunk, about: nch = cdiv(L, RCH) (ops/train_common.py RCH)
constexpr int ROW_MAX_D = 1024;

// Chunk c of nch over L rows starts at row_at(c).
__device__ __forceinline__ int row_at(int c, int nch, int L) { return (int)((long long)c * L / nch); }

// A lane's columns: NC chunks of W, chunk c at (c * 32 + lane) * W.
template <int EPL>
struct RowShape {
  static constexpr int W = EPL > 0 ? (EPL < 8 ? EPL : 8) : 2;
  static constexpr int NC = EPL > 0 ? EPL / W : ROW_MAX_D / 64;
  // whether chunk c of this lane lies in the row (always, where templated)
  static __device__ __forceinline__ bool in(int c, int lane, int d) { return EPL > 0 || (c * 32 + lane) * W < d; }
};

// W elements at p widened to f32: one or two vectors where templated,
// element loads in the pair-wise body.
template <int EPL, int W, typename TT>
__device__ __forceinline__ void ld_row(const TT* p, float (&v)[W]) {
  if constexpr (EPL > 0) {
    ld_vec<W>(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = to_f(p[e]);
  }
}
template <int EPL, int W, typename TT>
__device__ __forceinline__ void st_row(TT* p, const float (&v)[W]) {
  if constexpr (EPL > 0) {
    st_vec<W>(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) p[e] = from_f<TT>(v[e]);
  }
}

// v * scale where kept, else 0 (the site off: v).
__device__ __forceinline__ float drop_kept(float v, const Drop& d, bool keep) {
  return !d.on ? v : keep ? v * d.scale : 0.f;
}

// The block's sum of its warps' per-lane column sums a, in warp order,
// written to row `row` of the (rows, d) array p (null: none). red: RW x
// ROW_MAX_D floats of shared memory.
template <int EPL, int NC, int W>
__device__ __forceinline__ void store_chunk(float (*red)[ROW_MAX_D], const float (&a)[NC][W], float* p, size_t row,
                                            int d) {
  if (!p) return;  // the same for the whole block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // an earlier call's readers are done with red
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (RowShape<EPL>::in(c, lane, d))
#pragma unroll
      for (int e = 0; e < W; ++e) red[warp][(c * 32 + lane) * W + e] = a[c][e];
  __syncthreads();
  for (int col = threadIdx.x; col < d; col += 32 * RW) {
    float t = red[0][col];
#pragma unroll
    for (int w = 1; w < RW; ++w) t += red[w][col];
    p[row * d + col] = t;
  }
}

// The block's constant rows (the LayerNorm affine, its batch element's
// FiLM rows) in shared memory, where the warps read them as they need them
// (registers hold a row's values and the running sums instead): n rows of
// d, row i from src[i] (+ add[i]).
template <int N>
__device__ __forceinline__ void stage_rows(float (*cst)[ROW_MAX_D], const float* const (&src)[N],
                                           const float (&add)[N], int d) {
  for (int i = threadIdx.x; i < d; i += 32 * RW)
#pragma unroll
    for (int r = 0; r < N; ++r) cst[r][i] = src[r][i] + add[r];
  __syncthreads();
}

// Chain top of an attention block, forward:
//   out = x + (fs+1) * drop_OUT(LN(drop_FC(z); eps) * s + b) + fb
template <typename T, int EPL>
__global__ void __launch_bounds__(32 * RW)
chain_top_fwd_kernel(const float* __restrict__ z, const T* __restrict__ x, const float* __restrict__ s,
                     const float* __restrict__ bb, const float* __restrict__ fs, const float* __restrict__ fb,
                     float eps, int L, int d, int nch, Drop dr, T* __restrict__ out) {
  using S = RowShape<EPL>;
  constexpr int W = S::W, NC = S::NC;
  __shared__ __align__(16) float cst[4][ROW_MAX_D];  // s, b, fs + 1, fb
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.y;
  const int l1 = row_at(blockIdx.x + 1, nch, L);
  stage_rows<4>(cst, {s, bb, fs + (size_t)b * d, fb + (size_t)b * d}, {0.f, 0.f, 1.f, 0.f}, d);
  const uint32_t kfc = drop_key(dr, b, SALT_FC), kout = drop_key(dr, b, SALT_OUT);
  for (int l = row_at(blockIdx.x, nch, L) + warp; l < l1; l += RW) {
    const size_t row = ((size_t)b * L + l) * d;
    float v[NC][W], xr[NC][W];
    float su = 0.f, ss = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = (c * 32 + lane) * W;
      if (!S::in(c, lane, d)) continue;
      ld_row<EPL>(z + row + col, v[c]);
      ld_row<EPL>(x + row + col, xr[c]);
#pragma unroll
      for (int e = 0; e < W; ++e) {
        v[c][e] = drop_kept(v[c][e], dr, keep_key(dr, kfc, (uint32_t)(l * d + col + e)));
        su += v[c][e];
        ss += v[c][e] * v[c][e];
      }
    }
    warp_sum2(su, ss);
    const float mu = su / d, rs = rsqrtf(ss / d - mu * mu + eps);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = (c * 32 + lane) * W;
      if (!S::in(c, lane, d)) continue;
      float sc[W], bi[W], f1[W], f2[W];
      ld_vec<W>(cst[0] + col, sc);
      ld_vec<W>(cst[1] + col, bi);
      ld_vec<W>(cst[2] + col, f1);
      ld_vec<W>(cst[3] + col, f2);
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const float sa = drop_kept((v[c][e] - mu) * rs * sc[e] + bi[e], dr,
                                   keep_key(dr, kout, (uint32_t)(l * d + col + e)));
        xr[c][e] = xr[c][e] + f1[e] * sa + f2[e];
      }
      st_row<EPL>(out + row + col, xr[c]);
    }
  }
}

// Chain top backward: given g = d out, recompute z2 = drop_FC(z), its LN
// and sa_d = drop_OUT(LN * s + b); then
//   d fs += g * sa_d, d fb += g                       (per batch element)
//   gsa = drop_OUT(g * (fs+1));  d s += gsa * xhat, d b += gsa
//   dz = drop_FC(LN_bwd(gsa))                         -> T
// A block's rows share s, b and fs, so a lane keeps three column sums,
// G = sum g, P = sum k g xhat and Q = sum k g (k the OUT mask's keep), and
// the four partials follow at the end: d fs = c (s P + b Q), d fb = G,
// d s = c (fs+1) P, d b = c (fs+1) Q, c the kept values' scale.
template <typename T, int EPL>
__global__ void __launch_bounds__(32 * RW)
chain_top_bwd_kernel(const T* __restrict__ g, const float* __restrict__ z, const float* __restrict__ s,
                     const float* __restrict__ bb, const float* __restrict__ fs, float eps, int L, int d, int nch,
                     Drop dr, T* __restrict__ dz, float* p_fs, float* p_fb, float* p_s, float* p_b) {
  using S = RowShape<EPL>;
  constexpr int W = S::W, NC = S::NC;
  static_assert(NC * W <= 32, "a lane's FC mask bits fit one word");
  __shared__ float red[RW][ROW_MAX_D];
  __shared__ __align__(16) float cst[3][ROW_MAX_D];  // s, b, fs + 1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.y;
  const int l1 = row_at(blockIdx.x + 1, nch, L);
  stage_rows<3>(cst, {s, bb, fs + (size_t)b * d}, {0.f, 0.f, 1.f}, d);
  float ag[NC][W], agp[NC][W], agq[NC][W];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < W; ++e) ag[c][e] = agp[c][e] = agq[c][e] = 0.f;
  const uint32_t kfc = drop_key(dr, b, SALT_FC), kout = drop_key(dr, b, SALT_OUT);
  for (int l = row_at(blockIdx.x, nch, L) + warp; l < l1; l += RW) {
    const size_t row = ((size_t)b * L + l) * d;
    float xh[NC][W], gx[NC][W];
    uint32_t fc_bits = 0u;
    float su = 0.f, ss = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = (c * 32 + lane) * W;
      if (!S::in(c, lane, d)) continue;
      ld_row<EPL>(z + row + col, xh[c]);
      ld_row<EPL>(g + row + col, gx[c]);  // g, until it becomes gx below
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const bool keep = keep_key(dr, kfc, (uint32_t)(l * d + col + e));
        fc_bits |= (uint32_t)keep << (c * W + e);
        xh[c][e] = drop_kept(xh[c][e], dr, keep);
        su += xh[c][e];
        ss += xh[c][e] * xh[c][e];
      }
    }
    warp_sum2(su, ss);
    const float mu = su / d, rs = rsqrtf(ss / d - mu * mu + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = (c * 32 + lane) * W;
      if (!S::in(c, lane, d)) continue;
      float sc[W], f1[W];
      ld_vec<W>(cst[0] + col, sc);
      ld_vec<W>(cst[2] + col, f1);
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const bool keep = keep_key(dr, kout, (uint32_t)(l * d + col + e));
        xh[c][e] = (xh[c][e] - mu) * rs;
        const float gg = gx[c][e], gk = keep ? gg : 0.f;
        ag[c][e] += gg;
        agp[c][e] += gk * xh[c][e];
        agq[c][e] += gk;
        gx[c][e] = drop_kept(gg * f1[e], dr, keep) * sc[e];
        m1 += gx[c][e];
        m2 += gx[c][e] * xh[c][e];
      }
    }
    warp_sum2(m1, m2);
    m1 /= d;
    m2 /= d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = (c * 32 + lane) * W;
      if (!S::in(c, lane, d)) continue;
      float o[W];
#pragma unroll
      for (int e = 0; e < W; ++e)
        o[e] = drop_kept(rs * (gx[c][e] - m1 - xh[c][e] * m2), dr, (fc_bits >> (c * W + e)) & 1u);
      st_row<EPL>(dz + row + col, o);
    }
  }
  // the four partials from G, P and Q
  const float ks = dr.on ? dr.scale : 1.f;
  float t[NC][W];
  auto derive = [&](int which) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = (c * 32 + lane) * W;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const bool in = S::in(c, lane, d);
        const float sc = in ? cst[0][col + e] : 0.f, bi = in ? cst[1][col + e] : 0.f;
        const float f1 = in ? cst[2][col + e] : 0.f;
        t[c][e] = which == 0 ? ks * (sc * agp[c][e] + bi * agq[c][e])
                             : ks * f1 * (which == 1 ? agp[c][e] : agq[c][e]);
      }
    }
  };
  const size_t prow = (size_t)b * nch + blockIdx.x;
  derive(0);
  store_chunk<EPL>(red, t, p_fs, prow, d);
  store_chunk<EPL>(red, ag, p_fb, prow, d);
  derive(1);
  store_chunk<EPL>(red, t, p_s, prow, d);
  derive(2);
  store_chunk<EPL>(red, t, p_b, prow, d);
}

// The bottom of a block's backward:
//   dy  = (cos ? rot^T(dr) : dr) + (dadd ? dadd : 0)       rot^T(g) = g*cos + swap(g*ssin)
//   dxl = x ? LN_bwd(dy; stats of x, scale s) : dy           d s += dy * xhat, d b += dy
//   out = T(dxl + resT + res32)                              (residuals where given)
// d even; partials only with x.
template <typename T, int EPL>
__global__ void __launch_bounds__(32 * RW)
rows_bwd_kernel(const float* __restrict__ dr, const T* __restrict__ cos_t, const T* __restrict__ ssin_t,
                const float* __restrict__ dadd, const T* __restrict__ x, const float* __restrict__ s, float eps,
                const T* __restrict__ resT, const float* __restrict__ res32, int L, int d, int nch,
                T* __restrict__ out, float* p_s, float* p_b) {
  using S = RowShape<EPL>;
  constexpr int W = S::W, NC = S::NC;
  __shared__ float red[RW][ROW_MAX_D];
  __shared__ __align__(16) float cst[1][ROW_MAX_D];  // s
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.y;
  const int l1 = row_at(blockIdx.x + 1, nch, L);
  if (x) stage_rows<1>(cst, {s}, {0.f}, d);
  float as[NC][W], ab[NC][W];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < W; ++e) as[c][e] = ab[c][e] = 0.f;
  for (int l = row_at(blockIdx.x, nch, L) + warp; l < l1; l += RW) {
    const size_t row = ((size_t)b * L + l) * d;
    float dy[NC][W], xh[NC][W], rr[NC][W];  // rr: the residuals, read with the rest
    float su = 0.f, ss = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = (c * 32 + lane) * W;
#pragma unroll
      for (int e = 0; e < W; ++e) dy[c][e] = xh[c][e] = rr[c][e] = 0.f;
      if (!S::in(c, lane, d)) continue;
      ld_row<EPL>(dr + row + col, dy[c]);
      if (x) ld_row<EPL>(x + row + col, xh[c]);
      if (resT) ld_row<EPL>(resT + row + col, rr[c]);
      if (res32) {
        float a[W];
        ld_row<EPL>(res32 + row + col, a);
#pragma unroll
        for (int e = 0; e < W; ++e) rr[c][e] += a[e];
      }
      if (cos_t) {
        float cs[W], sn[W];
        ld_row<EPL>(cos_t + (size_t)l * d + col, cs);
        ld_row<EPL>(ssin_t + (size_t)l * d + col, sn);
#pragma unroll
        for (int e = 0; e < W; e += 2) {
          const float g0 = dy[c][e], g1 = dy[c][e + 1];
          dy[c][e] = g0 * cs[e] + g1 * sn[e + 1];
          dy[c][e + 1] = g1 * cs[e + 1] + g0 * sn[e];
        }
      }
      if (dadd) {
        float a[W];
        ld_row<EPL>(dadd + row + col, a);
#pragma unroll
        for (int e = 0; e < W; ++e) dy[c][e] += a[e];
      }
#pragma unroll
      for (int e = 0; e < W; ++e) {
        su += xh[c][e];
        ss += xh[c][e] * xh[c][e];
      }
    }
    float m1 = 0.f, m2 = 0.f, rs = 1.f;
    if (x) {
      warp_sum2(su, ss);
      const float mu = su / d;
      rs = rsqrtf(ss / d - mu * mu + eps);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = (c * 32 + lane) * W;
        float sc[W];
#pragma unroll
        for (int e = 0; e < W; ++e) sc[e] = 0.f;  // and dy is, past d
        if (S::in(c, lane, d)) ld_vec<W>(cst[0] + col, sc);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          xh[c][e] = (xh[c][e] - mu) * rs;
          as[c][e] += dy[c][e] * xh[c][e];
          ab[c][e] += dy[c][e];
          dy[c][e] *= sc[e];  // gx
          m1 += dy[c][e];
          m2 += dy[c][e] * xh[c][e];
        }
      }
      warp_sum2(m1, m2);
      m1 /= d;
      m2 /= d;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = (c * 32 + lane) * W;
      if (!S::in(c, lane, d)) continue;
      float v[W];
#pragma unroll
      for (int e = 0; e < W; ++e) v[e] = (x ? rs * (dy[c][e] - m1 - xh[c][e] * m2) : dy[c][e]) + rr[c][e];
      st_row<EPL>(out + row + col, v);
    }
  }
  const size_t prow = (size_t)b * nch + blockIdx.x;
  store_chunk<EPL>(red, as, p_s, prow, d);
  store_chunk<EPL>(red, ab, p_b, prow, d);
}

// The launches of the row kernels: grid (nch, B) of RW warps, the body
// templated on d / 32 where d is 64 .. 1024 and every operand 16-byte
// aligned, else the pair-wise body; refused (launch_status) for an odd d
// or d > ROW_MAX_D.
#define TCD_ROW_DISPATCH(KERNEL, T, d, vec, grid, st, ...)                              \
  do {                                                                                  \
    if ((d) % 2 || (d) > ROW_MAX_D) {                                                   \
      refuse();                                                                         \
      break;                                                                            \
    }                                                                                   \
    switch ((vec) ? (d) : 0) {                                                          \
      case 64: KERNEL<T, 2><<<grid, 32 * RW, 0, st>>>(__VA_ARGS__); break;             \
      case 128: KERNEL<T, 4><<<grid, 32 * RW, 0, st>>>(__VA_ARGS__); break;            \
      case 256: KERNEL<T, 8><<<grid, 32 * RW, 0, st>>>(__VA_ARGS__); break;            \
      case 512: KERNEL<T, 16><<<grid, 32 * RW, 0, st>>>(__VA_ARGS__); break;           \
      case 1024: KERNEL<T, 32><<<grid, 32 * RW, 0, st>>>(__VA_ARGS__); break;          \
      default: KERNEL<T, 0><<<grid, 32 * RW, 0, st>>>(__VA_ARGS__); break;             \
    }                                                                                   \
  } while (0)

template <typename T>
inline void chain_top_fwd(const float* z, const T* x, const float* s, const float* bb, const float* fs,
                          const float* fb, float eps, int B, int L, int d, int nch, const Drop& dr, T* out,
                          cudaStream_t st) {
  const bool vec = aligned(z, 16) && aligned(x, 16) && aligned(s, 16) && aligned(bb, 16) && aligned(fs, 16) &&
                   aligned(fb, 16) && aligned(out, 16);
  TCD_ROW_DISPATCH(chain_top_fwd_kernel, T, d, vec, dim3(nch, B), st, z, x, s, bb, fs, fb, eps, L, d, nch, dr, out);
}

template <typename T>
inline void chain_top_bwd(const T* g, const float* z, const float* s, const float* bb, const float* fs, float eps,
                          int B, int L, int d, int nch, const Drop& dr, T* dz, float* p_fs, float* p_fb, float* p_s,
                          float* p_b, cudaStream_t st) {
  const bool vec = aligned(g, 16) && aligned(z, 16) && aligned(s, 16) && aligned(bb, 16) && aligned(fs, 16) &&
                   aligned(dz, 16);
  TCD_ROW_DISPATCH(chain_top_bwd_kernel, T, d, vec, dim3(nch, B), st, g, z, s, bb, fs, eps, L, d, nch, dr, dz,
                   p_fs, p_fb, p_s, p_b);
}

template <typename T>
inline void rows_bwd(const float* dr, const T* cos_t, const T* ssin_t, const float* dadd, const T* x,
                     const float* s, float eps, const T* resT, const float* res32, int B, int L, int d, int nch,
                     T* out, float* p_s, float* p_b, cudaStream_t st) {
  const bool vec = aligned(dr, 16) && aligned(cos_t, 16) && aligned(ssin_t, 16) && aligned(dadd, 16) &&
                   aligned(x, 16) && aligned(s, 16) && aligned(resT, 16) && aligned(res32, 16) && aligned(out, 16);
  TCD_ROW_DISPATCH(rows_bwd_kernel, T, d, vec, dim3(nch, B), st, dr, cos_t, ssin_t, dadd, x, s, eps, resT, res32, L,
                   d, nch, out, p_s, p_b);
}

// Column sums of the row-chunk partials: per batch element (dfs, dfb) or
// over everything (LayerNorm affines, biases); `part` is (B * nch, cols).
inline void reduce_per_batch(const float* part, int B, int nch, int cols, float* out, cudaStream_t st) {
  reduce<float>(part, B, nch, cols, out, st);
}
inline void reduce_all(const float* part, int B, int nch, int cols, float* out, cudaStream_t st) {
  reduce<float>(part, 1, B * nch, cols, out, st);
}

// ---------------------------------------------------------------- attention
// q (B, Lq, hd), k/v (B, Lk, hd), o (B, Lq, hd): head h in columns
// [h*dk, (h+1)*dk). The probabilities are dropped with the seed of their
// batch element and salt SALT_ATTN + h at index i * Lk + j. Logits are
// (T(q * T(scale))) . k, as the TPU kernel rounds the scaled q. lse
// (B, H, Lq) = the log of each row's softmax normaliser, saved for the
// backward.
//
// The forward is the serving attention's (attention.cuh) with its train
// options: dropout on the probabilities and lse out. The backward keeps
// two kernels, one for dq (a block per query tile walking the key tiles)
// and one for dk and dv (a block per key tile walking the query tiles), so
// no gradient is summed across blocks and a run repeats bit for bit. Each
// recomputes S = q.k^T and dP = dO.v^T; P = exp(S - lse), dropped;
// dS = P (dP * keep / (1 - rate) - D) with D = rowsum(dO * o).
//
// What bounds it on the H100: at the train shapes (b = 64, 8 heads of 64,
// 450 x 450 and 450 x 152) the backward is 5 products of 13.3 (4.5) GFLOP,
// 7 with S and dP in both kernels, against ~0.2 GB of operands:
// operations, so they run on the tensor cores.
// bf16 (attn_bwd_dq_mma_kernel, attn_bwd_dkdv_mma_kernel): FlashAttention-2's
// backward on mma.sync, 64-row tiles per block of 4 warps (16 rows a warp),
// the streamed tiles double-buffered by 16-byte cp.async. The dk/dv kernel
// computes S^T = k.q^T and dP^T = v.dO^T with its keys as rows, so that
// T(drop(P))^T and T(dS)^T leave their C fragments as the A fragments of
// dv += T(drop(P))^T . dO and dk += T(dS)^T . T(q * scale), with dO and q
// through ldmatrix.trans; the dq kernel keeps q and dO as A fragments and
// takes dq += T(dS) . k straight from its registers. f32 keeps the FMA
// kernels below, since the tensor cores would take it only as TF32.
constexpr int AK = 32;     // f32 kernels: keys per tile
constexpr int BQ = 32;     // f32 backward: rows per block / tile (8 threads per row)

// Dsum (B, H, Lq) = rowsum(dO * O) per head: one warp per (row, head).
template <typename T>
__global__ void attn_dsum_kernel(const T* __restrict__ dO, const T* __restrict__ o, int Lq, int H,
                                 int hd, int dk, float* __restrict__ Dsum) {
  const int w = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31, b = blockIdx.y;
  if (w >= Lq * H) return;
  const int i = w / H, h = w % H;
  const size_t base = ((size_t)b * Lq + i) * hd + (size_t)h * dk;
  float s = 0.f;
  for (int c = lane; c < dk; c += 32) s += to_f(dO[base + c]) * to_f(o[base + c]);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) Dsum[((size_t)b * H + h) * Lq + i] = s;
}

// dS_ij = P_ij (dP_ij - D_i) with P = exp(s - lse), dP = drop(dO . v); the
// probability and gradient of one (query, key) pair; key = drop_key(dr, b,
// SALT_ATTN + h).
struct PairGrad {
  float pd;  // dropped probability (enters dV)
  float ds;  // logit gradient
};

__device__ __forceinline__ PairGrad pair_grad(float s, float dpd, float lse_i, float D_i, bool valid,
                                              const Drop& dr, uint32_t key, uint32_t idx) {
  PairGrad r{0.f, 0.f};
  if (!valid) return r;
  const float p = expf(s - lse_i);
  const float sc = dr.on ? (keep_key(dr, key, idx) ? dr.scale : 0.f) : 1.f;
  r.pd = p * sc;
  r.ds = p * (dpd * sc - D_i);
  return r;
}

// dQ (grid (cdiv(Lq, BQ), H, B)): each block keeps 32 query rows and walks
// the key tiles; dq = scale * sum_j T(dS_ij) k_j.
template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dO, const float* __restrict__ lse,
                   const float* __restrict__ Dsum, int Lq, int Lk, int hd, int dk, float scale,
                   Drop dr, T* __restrict__ dq) {
  __shared__ float Qs[BQ][FDK + 1];
  __shared__ float dOs[BQ][FDK + 1];
  __shared__ float Ks[AK][FDK + 1];
  __shared__ float Vs[AK][FDK + 1];
  __shared__ float dSs[BQ][AK + 1];

  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, r = tid >> 3, cg = tid & 7;
  const size_t qbase = (size_t)b * Lq * hd + (size_t)h * dk;
  const size_t kbase = (size_t)b * Lk * hd + (size_t)h * dk;
  const uint32_t dkey = drop_key(dr, b, SALT_ATTN + h);
  const float sc = round_t<T>(scale);
  for (int idx = tid; idx < BQ * dk; idx += 256) {
    const int rr = idx / dk, c = idx % dk, gq = q0 + rr;
    const bool ok = gq < Lq;
    Qs[rr][c] = ok ? round_t<T>(to_f(q[qbase + (size_t)gq * hd + c]) * sc) : 0.f;
    dOs[rr][c] = ok ? to_f(dO[qbase + (size_t)gq * hd + c]) : 0.f;
  }
  const int gq = q0 + r;
  const size_t row = ((size_t)b * H + h) * Lq + gq;
  const float lse_r = gq < Lq ? lse[row] : 0.f, D_r = gq < Lq ? Dsum[row] : 0.f;
  const int dpt = dk / 8;
  float acc[FDK / 8];
#pragma unroll
  for (int i = 0; i < FDK / 8; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += AK) {
    __syncthreads();
    for (int idx = tid; idx < AK * dk; idx += 256) {
      const int kk = idx / dk, c = idx % dk, gk = k0 + kk;
      const bool ok = gk < Lk;
      Ks[kk][c] = ok ? to_f(k[kbase + (size_t)gk * hd + c]) : 0.f;
      Vs[kk][c] = ok ? to_f(v[kbase + (size_t)gk * hd + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < AK / 8; ++jj) {
      const int j = cg * (AK / 8) + jj, gk = k0 + j;
      float s = 0.f, dpd = 0.f;
      for (int c = 0; c < dk; ++c) {
        s = fmaf(Qs[r][c], Ks[j][c], s);
        dpd = fmaf(dOs[r][c], Vs[j][c], dpd);
      }
      const PairGrad pg = pair_grad(s, dpd, lse_r, D_r, gq < Lq && gk < Lk, dr, dkey,
                                    (uint32_t)gq * Lk + gk);
      dSs[r][j] = round_t<T>(pg.ds);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < FDK / 8; ++i) {
      if (i < dpt) {
        const int c = cg * dpt + i;
        float a = acc[i];
        for (int j = 0; j < AK; ++j) a = fmaf(dSs[r][j], Ks[j][c], a);
        acc[i] = a;
      }
    }
  }
  if (gq < Lq) {
#pragma unroll
    for (int i = 0; i < FDK / 8; ++i)
      if (i < dpt) dq[qbase + (size_t)gq * hd + cg * dpt + i] = from_f<T>(acc[i] * scale);
  }
}

// dK, dV (grid (cdiv(Lk, AK), H, B)): each block keeps 32 keys and walks
// the query tiles; dv = sum_i T(drop(P_ij)) dO_i, dk = sum_i T(dS_ij)
// T(scale * q_i) (= scale * sum_i dS_ij q_i up to rounding).
template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dO, const float* __restrict__ lse,
                     const float* __restrict__ Dsum, int Lq, int Lk, int hd, int dk, float scale,
                     Drop dr, T* __restrict__ dk_out, T* __restrict__ dv_out) {
  __shared__ float Ks[AK][FDK + 1];
  __shared__ float Vs[AK][FDK + 1];
  __shared__ float Qs[BQ][FDK + 1];
  __shared__ float dOs[BQ][FDK + 1];
  __shared__ float Pd[BQ][AK + 1];
  __shared__ float dSs[BQ][AK + 1];
  __shared__ float lse_s[BQ], D_s[BQ];

  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, k0 = blockIdx.x * AK;
  const int tid = threadIdx.x, j = tid >> 3, cg = tid & 7;
  const size_t qbase = (size_t)b * Lq * hd + (size_t)h * dk;
  const size_t kbase = (size_t)b * Lk * hd + (size_t)h * dk;
  const uint32_t dkey = drop_key(dr, b, SALT_ATTN + h);
  const float sc = round_t<T>(scale);
  for (int idx = tid; idx < AK * dk; idx += 256) {
    const int kk = idx / dk, c = idx % dk, gk = k0 + kk;
    const bool ok = gk < Lk;
    Ks[kk][c] = ok ? to_f(k[kbase + (size_t)gk * hd + c]) : 0.f;
    Vs[kk][c] = ok ? to_f(v[kbase + (size_t)gk * hd + c]) : 0.f;
  }
  const int gk = k0 + j;
  const int dpt = dk / 8;
  float acc_k[FDK / 8], acc_v[FDK / 8];
#pragma unroll
  for (int i = 0; i < FDK / 8; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    __syncthreads();
    for (int idx = tid; idx < BQ * dk; idx += 256) {
      const int rr = idx / dk, c = idx % dk, gq = q0 + rr;
      const bool ok = gq < Lq;
      Qs[rr][c] = ok ? round_t<T>(to_f(q[qbase + (size_t)gq * hd + c]) * sc) : 0.f;
      dOs[rr][c] = ok ? to_f(dO[qbase + (size_t)gq * hd + c]) : 0.f;
    }
    if (tid < BQ) {
      const int gq = q0 + tid;
      const size_t row = ((size_t)b * H + h) * Lq + gq;
      lse_s[tid] = gq < Lq ? lse[row] : 0.f;
      D_s[tid] = gq < Lq ? Dsum[row] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < BQ / 8; ++ii) {
      const int i = cg * (BQ / 8) + ii, gq = q0 + i;
      float s = 0.f, dpd = 0.f;
      for (int c = 0; c < dk; ++c) {
        s = fmaf(Qs[i][c], Ks[j][c], s);
        dpd = fmaf(dOs[i][c], Vs[j][c], dpd);
      }
      const PairGrad pg = pair_grad(s, dpd, lse_s[i], D_s[i], gq < Lq && gk < Lk, dr, dkey,
                                    (uint32_t)gq * Lk + gk);
      Pd[i][j] = round_t<T>(pg.pd);
      dSs[i][j] = round_t<T>(pg.ds);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < FDK / 8; ++t) {
      if (t < dpt) {
        const int c = cg * dpt + t;
        float ak = acc_k[t], av = acc_v[t];
        for (int i = 0; i < BQ; ++i) {
          av = fmaf(Pd[i][j], dOs[i][c], av);
          ak = fmaf(dSs[i][j], Qs[i][c], ak);
        }
        acc_k[t] = ak;
        acc_v[t] = av;
      }
    }
  }
  if (gk < Lk) {
#pragma unroll
    for (int t = 0; t < FDK / 8; ++t) {
      if (t < dpt) {
        const size_t o = kbase + (size_t)gk * hd + cg * dpt + t;
        dk_out[o] = from_f<T>(acc_k[t]);
        dv_out[o] = from_f<T>(acc_v[t]);
      }
    }
  }
}

// ------------------------------------------ attention backward, tensor cores
struct AttnBwd {
  const bf16 *q, *k, *v, *dO;
  const float *lse, *Dsum;
  bf16 *dq, *dk, *dv;
  int Lq, Lk, hd, dh;  // dh: the head dim
  float scale;
  Drop dr;
};

// Dynamic shared memory of both kernels: two single tiles and two 2-stage
// rings of 64 rows (+ the dk/dv kernel's 2 x 2 x 64 f32 of lse and D).
template <int DKP>
constexpr int attn_bwd_smem() {
  return 6 * 64 * (DKP + 8) * 2 + 4 * MQ * 4;
}

// dq: one block per (64 queries, head, batch), 16 queries a warp.
template <int DKP>
__global__ void __launch_bounds__(MT) attn_bwd_dq_mma_kernel(AttnBwd a, bool vec) {
  constexpr int LD = DKP + 8, KS = DKP / 16, NT = DKP / 8;
  extern __shared__ __align__(16) unsigned char tcd_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tcd_smem);  // dq is staged here at the end
  bf16* dOs = Qs + MQ * LD;
  bf16* Ks = dOs + MQ * LD;  // 2 stages
  bf16* Vs = Ks + 2 * MK * LD;

  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, q0 = blockIdx.x * MQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int Lq = a.Lq, Lk = a.Lk, dk = a.dh;
  const size_t qbase = (size_t)b * Lq * a.hd + (size_t)h * dk;
  const size_t kbase = (size_t)b * Lk * a.hd + (size_t)h * dk;
  const bf16* k = a.k + kbase;
  const bf16* v = a.v + kbase;
  const FragOff f = frag_off(lane);

  load_tile<MQ, DKP>(Qs, a.q + qbase, a.hd, q0, Lq, dk, vec);
  load_tile<MQ, DKP>(dOs, a.dO + qbase, a.hd, q0, Lq, dk, vec);
  load_tile<MK, DKP>(Ks, k, a.hd, 0, Lk, dk, vec);
  load_tile<MK, DKP>(Vs, v, a.hd, 0, Lk, dk, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const float sc = __bfloat162float(__float2bfloat16(a.scale));
  uint32_t qf[KS][4], of[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldsm_x4(qf[kk], Qs + (warp * 16 + f.ra) * LD + kk * 16 + f.ca);
    ldsm_x4(of[kk], dOs + (warp * 16 + f.ra) * LD + kk * 16 + f.ca);
#pragma unroll
    for (int i = 0; i < 4; ++i) qf[kk][i] = scale_pair(qf[kk][i], sc);
  }
  int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse[2], D[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t r = ((size_t)b * H + h) * Lq + row[i];
    lse[i] = row[i] < Lq ? a.lse[r] : 0.f;
    D[i] = row[i] < Lq ? a.Dsum[r] : 0.f;
  }
  const uint32_t dkey = drop_key(a.dr, b, SALT_ATTN + h);
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  const int nk = (Lk + MK - 1) / MK;
  for (int it = 0; it < nk; ++it) {
    const bf16* Kst = Ks + (it & 1) * MK * LD;
    const bf16* Vst = Vs + (it & 1) * MK * LD;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1
    if (it + 1 < nk) {
      load_tile<MK, DKP>(Ks + ((it + 1) & 1) * MK * LD, k, a.hd, (it + 1) * MK, Lk, dk, vec);
      load_tile<MK, DKP>(Vs + ((it + 1) & 1) * MK * LD, v, a.hd, (it + 1) * MK, Lk, dk, vec);
    }
    cp_async_commit();

    float s[MK / 8][4], dp[MK / 8][4];
#pragma unroll
    for (int j = 0; j < MK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < MK / 16; ++np) {
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, Kst + (np * 16 + f.rb) * LD + kk * 16 + f.cb);
        mma16816(s[2 * np], qf[kk], kb[0], kb[1]);
        mma16816(s[2 * np + 1], qf[kk], kb[2], kb[3]);
        ldsm_x4(vb, Vst + (np * 16 + f.rb) * LD + kk * 16 + f.cb);
        mma16816(dp[2 * np], of[kk], vb[0], vb[1]);
        mma16816(dp[2 * np + 1], of[kk], vb[2], vb[3]);
      }
    const int k0 = it * MK;
#pragma unroll
    for (int j = 0; j < MK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1), i = e >> 1;
        s[j][e] = pair_grad(s[j][e], dp[j][e], lse[i], D[i], row[i] < Lq && key < Lk, a.dr, dkey,
                            (uint32_t)row[i] * Lk + key).ds;
      }
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      uint32_t da[4];
      c_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < KS; ++dn) {
        uint32_t kb[4];
        ldsm_x4_t(kb, Kst + (kk * 16 + f.ra) * LD + dn * 16 + f.ca);
        mma16816(acc[2 * dn], da, kb[0], kb[1]);
        mma16816(acc[2 * dn + 1], da, kb[2], kb[3]);
      }
    }
  }
  bf16* stg = Qs + warp * 16 * LD;  // this warp's q rows, read only before the loop
  stage_rows16<DKP>(stg, acc, a.scale, a.scale, lane);
  __syncwarp();
  store_rows16<DKP>(stg, a.dq + qbase, a.hd, q0 + warp * 16, Lq, dk, vec, lane);
}

// dk, dv: one block per (64 keys, head, batch), 16 keys a warp.
template <int DKP>
__global__ void __launch_bounds__(MT) attn_bwd_dkdv_mma_kernel(AttnBwd a, bool vec) {
  constexpr int LD = DKP + 8, KS = DKP / 16, NT = DKP / 8;
  extern __shared__ __align__(16) unsigned char tcd_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tcd_smem);  // dk is staged here at the end
  bf16* Vs = Ks + MK * LD;                       // dv likewise
  bf16* Qs = Vs + MK * LD;                       // 2 stages, scaled in place
  bf16* dOs = Qs + 2 * MQ * LD;                  // 2 stages
  float* ls = reinterpret_cast<float*>(dOs + 2 * MQ * LD);  // lse, 2 stages
  float* Ds = ls + 2 * MQ;                                   // D, 2 stages

  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, k0 = blockIdx.x * MK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int Lq = a.Lq, Lk = a.Lk, dk = a.dh;
  const size_t qbase = (size_t)b * Lq * a.hd + (size_t)h * dk;
  const size_t kbase = (size_t)b * Lk * a.hd + (size_t)h * dk;
  const bf16* q = a.q + qbase;
  const bf16* dO = a.dO + qbase;
  const size_t rows = ((size_t)b * H + h) * Lq;
  const FragOff f = frag_off(lane);

  load_tile<MK, DKP>(Ks, a.k + kbase, a.hd, k0, Lk, dk, vec);
  load_tile<MK, DKP>(Vs, a.v + kbase, a.hd, k0, Lk, dk, vec);
  load_tile<MQ, DKP>(Qs, q, a.hd, 0, Lq, dk, vec);
  load_tile<MQ, DKP>(dOs, dO, a.hd, 0, Lq, dk, vec);
  cp_async_commit();
  if (tid < MQ) {
    ls[tid] = tid < Lq ? a.lse[rows + tid] : 0.f;
    Ds[tid] = tid < Lq ? a.Dsum[rows + tid] : 0.f;
  }

  const float sc = __bfloat162float(__float2bfloat16(a.scale));
  int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const uint32_t dkey = drop_key(a.dr, b, SALT_ATTN + h);
  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;

  const int nq = (Lq + MQ - 1) / MQ;
  for (int it = 0; it < nq; ++it) {
    const int st = it & 1;
    bf16* Qst = Qs + st * MQ * LD;
    const bf16* dOst = dOs + st * MQ * LD;
    const float* lst = ls + st * MQ;
    const float* Dst = Ds + st * MQ;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1
    if (it + 1 < nq) {
      const int n0 = (it + 1) * MQ;
      load_tile<MQ, DKP>(Qs + (st ^ 1) * MQ * LD, q, a.hd, n0, Lq, dk, vec);
      load_tile<MQ, DKP>(dOs + (st ^ 1) * MQ * LD, dO, a.hd, n0, Lq, dk, vec);
      if (tid < MQ) {
        ls[(st ^ 1) * MQ + tid] = n0 + tid < Lq ? a.lse[rows + n0 + tid] : 0.f;
        Ds[(st ^ 1) * MQ + tid] = n0 + tid < Lq ? a.Dsum[rows + n0 + tid] : 0.f;
      }
    }
    cp_async_commit();
    for (int idx = tid; idx < MQ * DKP / 2; idx += MT) {  // T(q * T(scale)), padding stays 0
      uint32_t* p = reinterpret_cast<uint32_t*>(Qst + (idx / (DKP / 2)) * LD) + idx % (DKP / 2);
      *p = scale_pair(*p, sc);
    }
    __syncthreads();

    float s[MQ / 8][4], dp[MQ / 8][4];  // S^T, dP^T: this warp's 16 keys x 64 queries
#pragma unroll
    for (int j = 0; j < MQ / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, Ks + (warp * 16 + f.ra) * LD + kk * 16 + f.ca);
      ldsm_x4(va, Vs + (warp * 16 + f.ra) * LD + kk * 16 + f.ca);
#pragma unroll
      for (int np = 0; np < MQ / 16; ++np) {
        uint32_t qb[4], ob[4];
        ldsm_x4(qb, Qst + (np * 16 + f.rb) * LD + kk * 16 + f.cb);
        mma16816(s[2 * np], ka, qb[0], qb[1]);
        mma16816(s[2 * np + 1], ka, qb[2], qb[3]);
        ldsm_x4(ob, dOst + (np * 16 + f.rb) * LD + kk * 16 + f.cb);
        mma16816(dp[2 * np], va, ob[0], ob[1]);
        mma16816(dp[2 * np + 1], va, ob[2], ob[3]);
      }
    }
    const int q0 = it * MQ;
#pragma unroll
    for (int j = 0; j < MQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1), qr = q0 + c, i = e >> 1;
        const PairGrad pg = pair_grad(s[j][e], dp[j][e], lst[c], Dst[c], qr < Lq && key[i] < Lk, a.dr,
                                      dkey, (uint32_t)qr * Lk + key[i]);
        s[j][e] = pg.pd;
        dp[j][e] = pg.ds;
      }
#pragma unroll
    for (int kq = 0; kq < MQ / 16; ++kq) {
      uint32_t pa[4], da[4];
      c_to_a(pa, s[2 * kq], s[2 * kq + 1]);
      c_to_a(da, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int dn = 0; dn < KS; ++dn) {
        uint32_t ob[4], qb[4];
        ldsm_x4_t(ob, dOst + (kq * 16 + f.ra) * LD + dn * 16 + f.ca);
        mma16816(dva[2 * dn], pa, ob[0], ob[1]);
        mma16816(dva[2 * dn + 1], pa, ob[2], ob[3]);
        ldsm_x4_t(qb, Qst + (kq * 16 + f.ra) * LD + dn * 16 + f.ca);
        mma16816(dka[2 * dn], da, qb[0], qb[1]);
        mma16816(dka[2 * dn + 1], da, qb[2], qb[3]);
      }
    }
  }
  __syncwarp();  // this warp's k and v rows are read by no other warp
  stage_rows16<DKP>(Ks + warp * 16 * LD, dka, 1.f, 1.f, lane);
  stage_rows16<DKP>(Vs + warp * 16 * LD, dva, 1.f, 1.f, lane);
  __syncwarp();
  store_rows16<DKP>(Ks + warp * 16 * LD, a.dk + kbase, a.hd, k0 + warp * 16, Lk, dk, vec, lane);
  store_rows16<DKP>(Vs + warp * 16 * LD, a.dv + kbase, a.hd, k0 + warp * 16, Lk, dk, vec, lane);
}

template <int DKP>
inline void attention_bwd_mma(const AttnBwd& a, int B, int H, bool vec, cudaStream_t st) {
  launch_mma(attn_bwd_dq_mma_kernel<DKP>, dim3(cdiv(a.Lq, MQ), H, B), MT, attn_bwd_smem<DKP>(), st, a, vec);
  launch_mma(attn_bwd_dkdv_mma_kernel<DKP>, dim3(cdiv(a.Lk, MK), H, B), MT, attn_bwd_smem<DKP>(), st, a, vec);
}

// The whole attention forward / backward of one block.
template <typename T>
inline void attention_fwd(const T* q, const T* k, const T* v, int B, int H, int Lq, int Lk, int hd,
                          const Drop& dr, T* o, float* lse, cudaStream_t st) {
  heads_attention<T>(q, k, v, o, B, Lq, Lk, hd, H, nullptr, nullptr, st, AttnTrain{dr, lse});
}

template <typename T>
inline void attention_bwd(const T* q, const T* k, const T* v, const T* o, const T* dO,
                          const float* lse, int B, int H, int Lq, int Lk, int hd, const Drop& dr,
                          float* Dsum, T* dq, T* dk, T* dv, cudaStream_t st) {
  const int dkh = hd / H;
  const float scale = 1.f / sqrtf((float)dkh);
  attn_dsum_kernel<T><<<dim3(cdiv(Lq * H, 8), B), 256, 0, st>>>(dO, o, Lq, H, hd, dkh, Dsum);
  if constexpr (std::is_same<T, float>::value) {
    attn_bwd_dq_kernel<T><<<dim3(cdiv(Lq, BQ), H, B), 256, 0, st>>>(q, k, v, dO, lse, Dsum, Lq, Lk,
                                                                    hd, dkh, scale, dr, dq);
    attn_bwd_dkdv_kernel<T><<<dim3(cdiv(Lk, AK), H, B), 256, 0, st>>>(q, k, v, dO, lse, Dsum, Lq,
                                                                      Lk, hd, dkh, scale, dr, dk, dv);
  } else {
    const AttnBwd a{q, k, v, dO, lse, Dsum, dq, dk, dv, Lq, Lk, hd, dkh, scale, dr};
    const bool vec = rows16(q, 0, 0, hd, dkh) && rows16(k, 0, 0, hd, dkh) && rows16(v, 0, 0, hd, dkh) &&
                     rows16(dO, 0, 0, hd, dkh) && rows16(dq, 0, 0, hd, dkh) &&
                     rows16(dk, 0, 0, hd, dkh) && rows16(dv, 0, 0, hd, dkh);
    switch ((dkh + 15) / 16) {
      case 1: attention_bwd_mma<16>(a, B, H, vec, st); break;
      case 2: attention_bwd_mma<32>(a, B, H, vec, st); break;
      case 3: attention_bwd_mma<48>(a, B, H, vec, st); break;
      default: attention_bwd_mma<64>(a, B, H, vec, st); break;
    }
  }
}

inline Drop make_drop(const void* seeds, uint32_t thresh, float scale, int on) {
  Drop d;
  d.seeds = static_cast<const uint32_t*>(seeds);
  d.thresh = thresh;
  d.scale = scale;
  d.on = on;
  return d;
}

}  // namespace tcd
