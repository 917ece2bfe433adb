// Building blocks shared by the kernels (the serving blocks through
// blocks.cuh, the per-op kernels and the train kernels through
// train_common.cuh).
//
// Everything is templated on the element type T (float or __nv_bfloat16):
// tensors are loaded and stored in T, and LayerNorm statistics, products
// and sums are taken in f32. Weights arrive in nn.Linear layout (out, in),
// so a projection is C[M, N] = A[M, K] . W[N, K]^T; the backward's
// products use the same tiles with the other operand layouts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace tcd {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// round a f32 value through T and back (bf16 rounding where T is bf16)
template <typename T> __device__ __forceinline__ float round_t(float v) { return to_f(from_f<T>(v)); }

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// A launch refused on the host (a shape or an alignment its kernel does not
// take), recorded by refuse() and reported by the entry point's
// launch_status() as a failed launch is: the wrapper raises. No launch
// falls back to another kernel.
inline cudaError_t& refused() {
  static thread_local cudaError_t e = cudaSuccess;
  return e;
}
inline void refuse(cudaError_t e = cudaErrorInvalidValue) {
  if (refused() == cudaSuccess) refused() = e;
}
// cudaGetLastError(), or else the first refusal since the last call.
inline int launch_status() {
  const cudaError_t r = refused(), l = cudaGetLastError();
  refused() = cudaSuccess;
  return (int)(l != cudaSuccess ? l : r);
}

// ------------------------------------------------------------- dropout
// The hash dropout of the train path, bit for bit the TPU kernels'
// _keep_mask: element idx of a site with salt `salt` is kept iff
// hash(seed, salt, idx) >= thresh, and kept values are scaled by `scale`.
// idx = row * ncols + col over the per-batch-element (rows, ncols) array.
__device__ __forceinline__ uint32_t drop_mix(uint32_t h) {
  h = (h ^ (h >> 16)) * 0x7FEB352Du;
  h = (h ^ (h >> 15)) * 0x846CA68Bu;
  return h ^ (h >> 16);
}
__device__ __forceinline__ uint32_t drop_hash(uint32_t seed, uint32_t salt, uint32_t idx) {
  return drop_mix(idx ^ (seed + 0x9E3779B9u * salt));
}

struct Drop {
  const uint32_t* seeds;  // (B,) one seed per batch element
  uint32_t thresh;
  float scale;            // 1 / (1 - rate) in f32
  int on;                 // 0: rate == 0, the site is skipped
};

// Whether element idx is kept, with the (seed, salt) part taken once out
// of a loop: key = drop_key(d, b, salt), then keep_key(d, key, idx) is
// drop_hash(d.seeds[b], salt, idx) >= d.thresh (always true with d.on == 0).
__device__ __forceinline__ uint32_t drop_key(const Drop& d, int b, uint32_t salt) {
  return d.on ? d.seeds[b] + 0x9E3779B9u * salt : 0u;
}
__device__ __forceinline__ bool keep_key(const Drop& d, uint32_t key, uint32_t idx) {
  return !d.on || drop_mix(idx ^ key) >= d.thresh;
}

__device__ __forceinline__ float dropv(float v, const Drop& d, int b, uint32_t salt, uint32_t idx) {
  return !d.on ? v : (drop_hash(d.seeds[b], salt, idx) >= d.thresh ? v * d.scale : 0.f);
}

// dropout-site salts (ops/train_common.py)
constexpr uint32_t SALT_ATTN = 0x100, SALT_FC = 0x200, SALT_OUT = 0x300, SALT_FF1 = 0x400,
                   SALT_FF2 = 0x500;

// Sum of two values over the block (blockDim.x a multiple of 32, <= 1024).
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[32], sb[32];
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  __syncthreads();  // the buffers may still be read by an earlier call
  if (lane == 0) { sa[w] = a; sb[w] = b; }
  __syncthreads();
  a = lane < nw ? sa[lane] : 0.f;
  b = lane < nw ? sb[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// Sum of two values over a warp, by xor shuffles: every lane ends with
// the same sums, added in the same order.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// Whether a pointer is aligned to `bytes` (a null pointer is).
inline bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// NW 32-bit words at p (4 NW bytes, aligned to that size or to 16).
template <int NW>
__device__ __forceinline__ void ld_words(const void* p, uint32_t (&w)[NW]) {
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NW / 4; ++q) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[q];
      w[4 * q] = u.x;
      w[4 * q + 1] = u.y;
      w[4 * q + 2] = u.z;
      w[4 * q + 3] = u.w;
    }
  } else if constexpr (NW == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else {
    static_assert(NW == 1, "1, 2 or a multiple of 4 words");
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}
template <int NW>
__device__ __forceinline__ void st_words(void* p, const uint32_t (&w)[NW]) {
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NW / 4; ++q)
      reinterpret_cast<uint4*>(p)[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  } else if constexpr (NW == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    static_assert(NW == 1, "1, 2 or a multiple of 4 words");
    *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

// W contiguous elements at p widened to f32 (ld_vec), or W f32 values
// rounded to the element type and stored at p (st_vec), in as few vector
// accesses as the alignment of p allows (16 bytes of bf16 at W = 8).
template <int W>
__device__ __forceinline__ void ld_vec(const float* p, float (&v)[W]) {
  uint32_t w[W];
  ld_words<W>(p, w);
#pragma unroll
  for (int e = 0; e < W; ++e) v[e] = __uint_as_float(w[e]);
}
template <int W>
__device__ __forceinline__ void ld_vec(const __nv_bfloat16* p, float (&v)[W]) {
  uint32_t w[W / 2];
  ld_words<W / 2>(p, w);
#pragma unroll
  for (int e = 0; e < W / 2; ++e) {  // element 2e in the low half of word e
    v[2 * e] = __uint_as_float(w[e] << 16);
    v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}
template <int W>
__device__ __forceinline__ void st_vec(float* p, const float (&v)[W]) {
  uint32_t w[W];
#pragma unroll
  for (int e = 0; e < W; ++e) w[e] = __float_as_uint(v[e]);
  st_words<W>(p, w);
}
template <int W>
__device__ __forceinline__ void st_vec(__nv_bfloat16* p, const float (&v)[W]) {
  uint32_t w[W / 2];
#pragma unroll
  for (int e = 0; e < W / 2; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    w[e] = *reinterpret_cast<const uint32_t*>(&h);
  }
  st_words<W / 2>(p, w);
}

// ------------------------------------------------------ LayerNorm rows
// The arithmetic of one LayerNorm row, shared by the row body below and
// the q projection's prologue (gemm_lnrot of gemm_mma.cuh), so that both
// round alike: explicit round-to-nearest operations leave the compiler no
// multiply-add contraction of its own to choose.
struct LnStat {
  float mu, rs;
};
__device__ __forceinline__ void ln_add(float x, float& s, float& ss) {
  s = __fadd_rn(s, x);
  ss = __fmaf_rn(x, x, ss);
}
// The row's (mu, rsqrt(E[x^2] - mu^2 + eps)) from a lane's partial sums.
__device__ __forceinline__ LnStat ln_stat(float s, float ss, int d, float eps) {
  warp_sum2(s, ss);
  const float mu = __fdiv_rn(s, (float)d);
  return {mu, rsqrtf(__fadd_rn(__fsub_rn(__fdiv_rn(ss, (float)d), __fmul_rn(mu, mu)), eps))};
}
__device__ __forceinline__ float ln_y(float x, LnStat st, float sc, float bi) {
  return __fmaf_rn(__fmul_rn(__fsub_rn(x, st.mu), st.rs), sc, bi);
}
// The rotary of the pair (y0, y1) of columns (c, c + 1), c even:
// y * cos + swap_pairs(y) * ssin.
__device__ __forceinline__ void rot_pair(float y0, float y1, float c0, float c1, float s0, float s1, float& r0,
                                         float& r1) {
  r0 = __fmaf_rn(y1, s0, __fmul_rn(y0, c0));
  r1 = __fmaf_rn(y0, s1, __fmul_rn(y1, c1));
}

// The LayerNorm row body of every kernel (K10, and the row stages of K1,
// K2, K2b, K6-K9 and K3-K5's forwards): y = LN(in) in f32 (var = E[x^2] -
// mu^2, as the TPU kernels), then
//   out     = T(y)                                      (resid == nullptr)
//   out     = T(resid + (fs[b] + 1) * y + fb[b])        (FiLM residual)
//   out_rot = T(y * cos + swap_pairs(y) * ssin)         (cos != nullptr)
// Rows are m = b * L + l; cos/ssin are (L, d) tables in T with the
// rotate-half signs folded into ssin; out may be null (the rotated output
// only). d must be even. NORM = false: no LayerNorm, y = in (the rotary
// alone: K4's memory side, rot_rows).
//
// What bounds it on the H100: ~8 operations an element against 2-4 bytes
// in and 2-4 out: the bytes (3,600 rows of 512 in bf16: 3.7 MB, 1.1 us at
// 3.35 TB/s; 2.2 us with an f32 input or the rotated output beside).
//
// Design: one warp per row, LN_WARPS warps a block, each warp walking the
// rows m, m + (the grid's warps), ...; the grid is what the card holds at
// once. The statistics are xor shuffles within the warp (no shared
// memory, no barrier), in a fixed order. EPL = d / 32 elements a lane for
// d = 64, 128, 256, 512, 1024: the row is read once into registers, in
// chunks of W = min(EPL, 8) contiguous elements (16 bytes of bf16); chunk c
// of a lane starts at column (c * 32 + lane) * W, so a warp's loads of one
// chunk are one contiguous span. scale and bias stay in registers across
// the warp's rows; the rotary tables, the residual and the FiLM rows are
// read in the same vectors, and a rotary pair (c, c + 1) lies within one
// chunk. EPL = 0 is the body for any other even d, or an operand not
// 16-byte aligned: pairs of columns, element loads, the row read twice
// (the second time from L1).
constexpr int LN_WARPS = 8;

template <typename TI, typename T, int EPL, bool NORM = true>
__global__ void __launch_bounds__(32 * LN_WARPS)
ln_rows_kernel(const TI* __restrict__ in, const float* __restrict__ scale, const float* __restrict__ bias,
               float eps, int M, int d, int L, const T* __restrict__ cos_t, const T* __restrict__ ssin_t,
               const T* __restrict__ resid, const float* __restrict__ fs, const float* __restrict__ fb,
               T* __restrict__ out, T* __restrict__ out_rot) {
  const int lane = threadIdx.x & 31, stride = gridDim.x * LN_WARPS;
  const int first = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if constexpr (EPL > 0) {
    constexpr int W = EPL < 8 ? EPL : 8, NC = EPL / W;
    float sc[NC][W], bi[NC][W];
    if constexpr (NORM) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        ld_vec<W>(scale + (c * 32 + lane) * W, sc[c]);
        ld_vec<W>(bias + (c * 32 + lane) * W, bi[c]);
      }
    }
    for (int m = first; m < M; m += stride) {
      const size_t row = (size_t)m * d;
      float x[NC][W];
#pragma unroll
      for (int c = 0; c < NC; ++c) ld_vec<W>(in + row + (c * 32 + lane) * W, x[c]);
      LnStat st{0.f, 1.f};
      if constexpr (NORM) {
        float s = 0.f, ss = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < W; ++e) ln_add(x[c][e], s, ss);
        st = ln_stat(s, ss, d, eps);
      }
      const int l = m % L, b = m / L;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = (c * 32 + lane) * W;
        float y[W];
#pragma unroll
        for (int e = 0; e < W; ++e) y[e] = NORM ? ln_y(x[c][e], st, sc[c][e], bi[c][e]) : x[c][e];
        if (out_rot) {
          float cs[W], sn[W], r[W];
          ld_vec<W>(cos_t + (size_t)l * d + col, cs);
          ld_vec<W>(ssin_t + (size_t)l * d + col, sn);
#pragma unroll
          for (int e = 0; e < W; e += 2) rot_pair(y[e], y[e + 1], cs[e], cs[e + 1], sn[e], sn[e + 1], r[e], r[e + 1]);
          st_vec<W>(out_rot + row + col, r);
        }
        if (out) {
          if (resid) {
            float rr[W], f1[W], f2[W];
            ld_vec<W>(resid + row + col, rr);
            ld_vec<W>(fs + (size_t)b * d + col, f1);
            ld_vec<W>(fb + (size_t)b * d + col, f2);
#pragma unroll
            for (int e = 0; e < W; ++e) y[e] = rr[e] + (f1[e] + 1.f) * y[e] + f2[e];
          }
          st_vec<W>(out + row + col, y);
        }
      }
    }
  } else {
    for (int m = first; m < M; m += stride) {
      const TI* x = in + (size_t)m * d;
      LnStat st{0.f, 1.f};
      if constexpr (NORM) {
        float s = 0.f, ss = 0.f;
        for (int c = lane; c < d; c += 32) ln_add(to_f(x[c]), s, ss);
        st = ln_stat(s, ss, d, eps);
      }
      const int l = m % L, b = m / L;
      for (int p = lane; p < d / 2; p += 32) {
        const int c0 = 2 * p, c1 = c0 + 1;
        float y0 = NORM ? ln_y(to_f(x[c0]), st, scale[c0], bias[c0]) : to_f(x[c0]);
        float y1 = NORM ? ln_y(to_f(x[c1]), st, scale[c1], bias[c1]) : to_f(x[c1]);
        if (out_rot) {
          const size_t t = (size_t)l * d;
          float r0, r1;
          rot_pair(y0, y1, to_f(cos_t[t + c0]), to_f(cos_t[t + c1]), to_f(ssin_t[t + c0]), to_f(ssin_t[t + c1]),
                   r0, r1);
          out_rot[(size_t)m * d + c0] = from_f<T>(r0);
          out_rot[(size_t)m * d + c1] = from_f<T>(r1);
        }
        if (out) {
          if (resid) {
            const size_t f = (size_t)b * d;
            y0 = to_f(resid[(size_t)m * d + c0]) + (fs[f + c0] + 1.f) * y0 + fb[f + c0];
            y1 = to_f(resid[(size_t)m * d + c1]) + (fs[f + c1] + 1.f) * y1 + fb[f + c1];
          }
          out[(size_t)m * d + c0] = from_f<T>(y0);
          out[(size_t)m * d + c1] = from_f<T>(y1);
        }
      }
    }
  }
}

// The SMs of the device this process runs on, read once.
inline int device_sms() {
  static const int sms = [] {
    int dev = 0, n = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

// One launch of ln_rows_kernel<TI, T, EPL, NORM>: min(rows / LN_WARPS, the
// blocks the card holds at once) blocks, found once per instance.
template <typename TI, typename T, int EPL, bool NORM, typename... Args>
inline void launch_ln_rows(int M, cudaStream_t st, Args... args) {
  static const int resident = [] {
    int per = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, ln_rows_kernel<TI, T, EPL, NORM>, 32 * LN_WARPS, 0);
    return device_sms() * (per > 0 ? per : 1);
  }();
  const int blocks = std::max(1, std::min(cdiv(M, LN_WARPS), resident));
  ln_rows_kernel<TI, T, EPL, NORM><<<blocks, 32 * LN_WARPS, 0, st>>>(args...);
}

// The LayerNorm rows above over M rows of d (NORM), or the rotary alone
// (!NORM): the body templated on d / 32 where d is one of the widths the
// paths use and every operand is 16-byte aligned, else the general body.
template <typename TI, typename T, bool NORM = true>
inline void ln_rows(const TI* in, const float* scale, const float* bias, float eps, int M, int d, int L,
                    const T* cos_t, const T* ssin_t, const T* resid, const float* fs, const float* fb, T* out,
                    T* out_rot, cudaStream_t st) {
  const bool vec = aligned(in, 16) && aligned(scale, 16) && aligned(bias, 16) && aligned(cos_t, 16) &&
                   aligned(ssin_t, 16) && aligned(resid, 16) && aligned(fs, 16) && aligned(fb, 16) &&
                   aligned(out, 16) && aligned(out_rot, 16);
#define TCD_LN_ROWS(EPL)                                                                                   \
  return launch_ln_rows<TI, T, EPL, NORM>(M, st, in, scale, bias, eps, M, d, L, cos_t, ssin_t, resid, fs, fb, \
                                          out, out_rot)
  switch (vec ? d : 0) {
    case 64: TCD_LN_ROWS(2);
    case 128: TCD_LN_ROWS(4);
    case 256: TCD_LN_ROWS(8);
    case 512: TCD_LN_ROWS(16);
    case 1024: TCD_LN_ROWS(32);
    default: TCD_LN_ROWS(0);
  }
#undef TCD_LN_ROWS
}

// The rotary alone, out = T(in * cos + swap_pairs(in) * ssin), with the
// row body (the cross-attention memory side of K4).
template <typename T>
inline void rot_rows(const T* in, const T* cos_t, const T* ssin_t, int M, int d, int L, T* out, cudaStream_t st) {
  ln_rows<T, T, false>(in, nullptr, nullptr, 0.f, M, d, L, cos_t, ssin_t, nullptr, nullptr, nullptr, nullptr, out,
                       st);
}

// ---------------------------------------------------------------- GEMM
// C[M, N] = opA[M, K] . opB[K, N] with an epilogue, FMA tiles: a 64x64
// output tile per block of 256 threads, 4x4 outputs per thread, K in steps
// of 16 through shared memory (operands widened to f32 on the way in).
// TA: A is stored (K, M) (else (M, K)); TB: B is stored (N, K) (else
// (K, N)); both row-major. The projections are TB (a weight in nn.Linear
// layout), the input gradients plain, the weight gradients TA with the
// rows as K, split over blockIdx.z into chunks of `kchunk` (EPI_PARTIAL).
// This body serves f32 only: every bf16 product, in each of the three
// layouts, runs on the tensor cores (gemm_mma.cuh: gemm<T, EPI>,
// gemm_group, gemm_nn, wgrad), and a bf16 instance of gemm_kernel does not
// compile.
enum Epi {
  EPI_STORE = 0,       // C(T)   = acc
  EPI_STORE_F32 = 1,   // C(f32) = acc
  EPI_BIAS = 2,        // C(T)   = acc + bias
  EPI_BIAS_GELU = 3,   // u = acc + bias; C(T) = drop(gelu_erf(u)); c2(f32) = u if c2
  EPI_BIAS_FILM = 4,   // zd = drop(acc + bias); C(f32) = resid + (fs[b] + 1) * zd + fb[b];
                       // c2(f32) = zd if c2
  EPI_ACC_F32 = 5,     // C(f32) += acc
  EPI_PARTIAL = 6,     // C(f32)[blockIdx.z][m][n] = acc over this block's K chunk
  EPI_BIAS_ROUNDED = 7,  // C(T) = T(T(acc) + T(bias)): the product rounded before the bias
  EPI_BIAS_FILM_T = 8,   // C(T) = T(resid + (fs[b] + 1) * (acc + bias) + fb[b]), in f32 before the rounding
};

struct EpiArgs {
  void* c;
  const float* bias;
  const void* resid;  // T, (M, N)
  const float* fs;    // (M / L, N)
  const float* fb;
  int L;
  float* c2;          // second output of EPI_BIAS_GELU / EPI_BIAS_FILM
  Drop dr;            // dropout of EPI_BIAS_GELU / EPI_BIAS_FILM; off unless set
  uint32_t salt;
};

// The epilogues in phases, shared by the FMA body below and the
// tensor-core body (gemm_mma.cuh). epi_load: what output element (m, n)
// reads besides its f32 sum (the bias, and the residual and FiLM rows of
// EPI_BIAS_FILM(_T)); epi_math: from the sum and those, the values it
// stores (c, and c2 for EPI_BIAS_GELU and EPI_BIAS_FILM); epi_store: the
// stores. A body can so issue the loads of many elements before any store
// (a store between them would hold them back, as it might alias them), and
// load or store two neighbouring elements at once. The rounding points are
// the TPU kernels': EPI_BIAS_ROUNDED rounds the product and the bias to T
// before adding them, EPI_BIAS_FILM keeps its output in f32, and the
// dropout index is (m % L) * N + n.
struct EpiIn {
  float bias, resid, fs, fb;
};
struct EpiVal {
  float c, c2;
};

template <int EPI>
__host__ __device__ constexpr bool epi_bias() {
  return EPI == EPI_BIAS || EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_FILM || EPI == EPI_BIAS_FILM_T ||
         EPI == EPI_BIAS_ROUNDED;
}
template <int EPI>
__host__ __device__ constexpr bool epi_film() {
  return EPI == EPI_BIAS_FILM || EPI == EPI_BIAS_FILM_T;
}

template <typename T, int EPI>
__device__ __forceinline__ EpiIn epi_load(const EpiArgs& ep, int N, int m, int n) {
  EpiIn in{0.f, 0.f, 0.f, 0.f};
  if (epi_bias<EPI>()) in.bias = ep.bias[n];
  if (epi_film<EPI>()) {
    const size_t f = (size_t)(m / ep.L) * N + n;
    in.resid = to_f(static_cast<const T*>(ep.resid)[(size_t)m * N + n]);
    in.fs = ep.fs[f];
    in.fb = ep.fb[f];
  }
  return in;
}

template <typename T, int EPI>
__device__ __forceinline__ EpiVal epi_math(const EpiArgs& ep, int N, int m, int n, float v, const EpiIn& in) {
  if (EPI == EPI_BIAS) return {v + in.bias, 0.f};
  if (EPI == EPI_BIAS_GELU) {
    const float u = v + in.bias;
    const float g = 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
    return {dropv(g, ep.dr, m / ep.L, ep.salt, (uint32_t)((m % ep.L) * N + n)), u};
  }
  if (EPI == EPI_BIAS_FILM) {
    const float zd = dropv(v + in.bias, ep.dr, m / ep.L, ep.salt, (uint32_t)((m % ep.L) * N + n));
    return {in.resid + (in.fs + 1.f) * zd + in.fb, zd};
  }
  if (EPI == EPI_BIAS_FILM_T) return {in.resid + (in.fs + 1.f) * (v + in.bias) + in.fb, 0.f};
  if (EPI == EPI_BIAS_ROUNDED) return {round_t<T>(v) + round_t<T>(in.bias), 0.f};
  return {v, 0.f};  // EPI_STORE, EPI_STORE_F32, EPI_ACC_F32, EPI_PARTIAL
}

// The element type of an epilogue's output C.
template <typename T, int EPI>
using EpiOut = typename std::conditional<EPI == EPI_STORE_F32 || EPI == EPI_BIAS_FILM || EPI == EPI_ACC_F32 ||
                                             EPI == EPI_PARTIAL, float, T>::type;

// z is the K chunk of EPI_PARTIAL.
template <typename T, int EPI>
__device__ __forceinline__ void epi_store(const EpiArgs& ep, int M, int N, int m, int n, int z, EpiVal r) {
  const size_t o = (size_t)m * N + n;
  using TC = EpiOut<T, EPI>;
  if ((EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_FILM) && ep.c2) ep.c2[o] = r.c2;
  if (EPI == EPI_ACC_F32) {
    static_cast<float*>(ep.c)[o] += r.c;
  } else if (EPI == EPI_PARTIAL) {
    static_cast<float*>(ep.c)[(size_t)z * M * N + o] = r.c;
  } else {
    static_cast<TC*>(ep.c)[o] = from_f<TC>(r.c);
  }
}

constexpr int GBM = 64, GBN = 64, GBK = 16;

template <typename T, bool TA, bool TB, int EPI>
__global__ void __launch_bounds__(256)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, int M, int N, int K, int kchunk,
            EpiArgs ep) {
  static_assert(std::is_same<T, float>::value,
                "bf16 products run on the tensor cores (gemm_mma.cuh), never on the FMA body");
  __shared__ float As[GBK][GBM + 4];
  __shared__ float Bs[GBK][GBN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += GBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * 256;
      // neighbouring threads read neighbouring addresses in either layout
      const int ar = TA ? idx % GBM : idx / GBK, ac = TA ? idx / GBM : idx % GBK;
      const int gm = m0 + ar, gka = k0 + ac;
      As[ac][ar] = (gm < M && gka < ke)
                       ? to_f(TA ? A[(size_t)gka * M + gm] : A[(size_t)gm * K + gka]) : 0.f;
      const int bn = TB ? idx / GBK : idx % GBN, bk = TB ? idx % GBK : idx / GBN;
      const int gn = n0 + bn, gkb = k0 + bk;
      Bs[bk][bn] = (gn < N && gkb < ke)
                       ? to_f(TB ? B[(size_t)gn * K + gkb] : B[(size_t)gkb * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GBK; ++k) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N)
        epi_store<T, EPI>(ep, M, N, m, n, blockIdx.z,
                          epi_math<T, EPI>(ep, N, m, n, acc[i][j], epi_load<T, EPI>(ep, N, m, n)));
    }
  }
}

// The FMA body, f32 only; gemm_mma.cuh dispatches to it by dtype.
template <typename T, bool TA, bool TB, int EPI>
inline void gemm_t(const T* A, const T* B, int M, int N, int K, EpiArgs ep, cudaStream_t st,
                   int kchunk = 0) {
  static_assert(std::is_same<T, float>::value,
                "bf16 products run on the tensor cores: gemm, gemm_group, gemm_nn or wgrad of gemm_mma.cuh");
  if (kchunk <= 0) kchunk = K;
  gemm_kernel<T, TA, TB, EPI><<<dim3(cdiv(N, GBN), cdiv(M, GBM), cdiv(K, kchunk)), 256, 0, st>>>(
      A, B, M, N, K, kchunk, ep);
}

inline EpiArgs epi(void* c, const float* bias = nullptr, const void* resid = nullptr,
                   const float* fs = nullptr, const float* fb = nullptr, int L = 1) {
  EpiArgs e;
  e.c = c;
  e.bias = bias;
  e.resid = resid;
  e.fs = fs;
  e.fb = fb;
  e.L = L;
  e.c2 = nullptr;
  e.dr.seeds = nullptr;
  e.dr.thresh = 0;
  e.dr.scale = 1.f;
  e.dr.on = 0;
  e.salt = 0;
  return e;
}

}  // namespace tcd
