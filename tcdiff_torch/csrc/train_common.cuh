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
// A row kernel's block of RT threads walks RCH consecutive rows of one
// batch element (grid (cdiv(L, RCH), B)); thread t owns columns
// t, t + RT, ... (at most CPT of them, so d <= RT * CPT = 1024) and keeps
// its columns' partial gradient sums in registers across the rows.
constexpr int RT = 128, CPT = 8, RCH = 16;

// Column sums of the row-chunk partials: per batch element (dfs, dfb) or
// over everything (LayerNorm affines, biases); `part` is (B * nch, cols).
inline void reduce_per_batch(const float* part, int B, int nch, int cols, float* out, cudaStream_t st) {
  reduce<float>(part, B, nch, cols, out, st);
}
inline void reduce_all(const float* part, int B, int nch, int cols, float* out, cudaStream_t st) {
  reduce<float>(part, 1, B * nch, cols, out, st);
}

// Writes a thread's column partials to row `row` of each given (rows, d) array.
__device__ __forceinline__ void store_partial(float* p, size_t row, int d, const float (&a)[CPT]) {
  if (!p) return;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = threadIdx.x + k * RT;
    if (c < d) p[row * d + c] = a[k];
  }
}

// Chain top of an attention block, forward, one row per block (grid M):
//   out = x + (fs+1) * drop_OUT(LN(drop_FC(z); eps) * s + b) + fb
template <typename T>
__global__ void __launch_bounds__(RT)
chain_top_fwd_kernel(const float* __restrict__ z, const T* __restrict__ x, const float* __restrict__ s,
                     const float* __restrict__ bb, const float* __restrict__ fs,
                     const float* __restrict__ fb, float eps, int L, int d, Drop dr, T* __restrict__ out) {
  const int m = blockIdx.x, b = m / L, l = m % L;
  float v[CPT];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = threadIdx.x + k * RT;
    v[k] = c < d ? dropv(z[(size_t)m * d + c], dr, b, SALT_FC, (uint32_t)(l * d + c)) : 0.f;
    s1 += v[k];
    s2 += v[k] * v[k];
  }
  block_sum2(s1, s2);
  const float mu = s1 / d, rs = rsqrtf(s2 / d - mu * mu + eps);
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = threadIdx.x + k * RT;
    if (c >= d) continue;
    const uint32_t idx = (uint32_t)(l * d + c);
    const float sa = dropv((v[k] - mu) * rs * s[c] + bb[c], dr, b, SALT_OUT, idx);
    const size_t o = (size_t)m * d + c;
    out[o] = from_f<T>(to_f(x[o]) + (fs[(size_t)b * d + c] + 1.f) * sa + fb[(size_t)b * d + c]);
  }
}

// Chain top backward (grid (cdiv(L, RCH), B)): given g = d out, recompute
// z2 = drop_FC(z), its LN and sa_d = drop_OUT(LN * s + b); then
//   d fs += g * sa_d, d fb += g                       (per batch element)
//   gsa = drop_OUT(g * (fs+1));  d s += gsa * xhat, d b += gsa
//   dz = drop_FC(LN_bwd(gsa))                         -> T
template <typename T>
__global__ void __launch_bounds__(RT)
chain_top_bwd_kernel(const T* __restrict__ g, const float* __restrict__ z, const float* __restrict__ s,
                     const float* __restrict__ bb, const float* __restrict__ fs, float eps, int L,
                     int d, Drop dr, T* __restrict__ dz, float* p_fs, float* p_fb, float* p_s,
                     float* p_b) {
  const int chunk = blockIdx.x, b = blockIdx.y;
  float afs[CPT], afb[CPT], as[CPT], ab[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) afs[k] = afb[k] = as[k] = ab[k] = 0.f;
  const int l1 = min(L, (chunk + 1) * RCH);
  for (int l = chunk * RCH; l < l1; ++l) {
    const size_t m = (size_t)b * L + l;
    float xh[CPT], gx[CPT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = threadIdx.x + k * RT;
      xh[k] = c < d ? dropv(z[m * d + c], dr, b, SALT_FC, (uint32_t)(l * d + c)) : 0.f;
      s1 += xh[k];
      s2 += xh[k] * xh[k];
    }
    block_sum2(s1, s2);
    const float mu = s1 / d, rs = rsqrtf(s2 / d - mu * mu + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = threadIdx.x + k * RT;
      gx[k] = 0.f;
      if (c >= d) continue;
      const uint32_t idx = (uint32_t)(l * d + c);
      xh[k] = (xh[k] - mu) * rs;
      const float sad = dropv(xh[k] * s[c] + bb[c], dr, b, SALT_OUT, idx);
      const float gg = to_f(g[m * d + c]);
      afs[k] += gg * sad;
      afb[k] += gg;
      const float gsa = dropv(gg * (fs[(size_t)b * d + c] + 1.f), dr, b, SALT_OUT, idx);
      as[k] += gsa * xh[k];
      ab[k] += gsa;
      gx[k] = gsa * s[c];
      m1 += gx[k];
      m2 += gx[k] * xh[k];
    }
    block_sum2(m1, m2);
    m1 /= d;
    m2 /= d;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = threadIdx.x + k * RT;
      if (c >= d) continue;
      const float dz2 = rs * (gx[k] - m1 - xh[k] * m2);
      dz[m * d + c] = from_f<T>(dropv(dz2, dr, b, SALT_FC, (uint32_t)(l * d + c)));
    }
  }
  const size_t row = (size_t)b * gridDim.x + chunk;
  store_partial(p_fs, row, d, afs);
  store_partial(p_fb, row, d, afb);
  store_partial(p_s, row, d, as);
  store_partial(p_b, row, d, ab);
}

// The bottom of a block's backward (grid (cdiv(L, RCH), B)):
//   dy  = (cos ? rot^T(dr) : dr) + (dadd ? dadd : 0)       rot^T(g) = g*cos + swap(g*ssin)
//   dxl = x ? LN_bwd(dy; stats of x, scale s) : dy           d s += dy * xhat, d b += dy
//   out = T(dxl + resT + res32)                              (residuals where given)
// d must be even (rotary pairs (2i, 2i+1) sit in neighbouring lanes).
template <typename T>
__global__ void __launch_bounds__(RT)
rows_bwd_kernel(const float* __restrict__ dr, const T* __restrict__ cos_t, const T* __restrict__ ssin_t,
                const float* __restrict__ dadd, const T* __restrict__ x, const float* __restrict__ s,
                float eps, const T* __restrict__ resT, const float* __restrict__ res32, int L, int d,
                T* __restrict__ out, float* p_s, float* p_b) {
  const int chunk = blockIdx.x, b = blockIdx.y;
  float as[CPT], ab[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) as[k] = ab[k] = 0.f;
  const int l1 = min(L, (chunk + 1) * RCH);
  for (int l = chunk * RCH; l < l1; ++l) {
    const size_t m = (size_t)b * L + l;
    float dy[CPT], xh[CPT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = threadIdx.x + k * RT;
      const bool ok = c < d;
      const float g = ok ? dr[m * d + c] : 0.f;
      if (cos_t) {  // every lane takes part in the shuffle
        const float w = ok ? g * to_f(ssin_t[(size_t)l * d + c]) : 0.f;
        const float partner = __shfl_xor_sync(0xffffffffu, w, 1);
        dy[k] = ok ? g * to_f(cos_t[(size_t)l * d + c]) + partner : 0.f;
      } else {
        dy[k] = g;
      }
      if (ok && dadd) dy[k] += dadd[m * d + c];
      xh[k] = (ok && x) ? to_f(x[m * d + c]) : 0.f;
      s1 += xh[k];
      s2 += xh[k] * xh[k];
    }
    float m1 = 0.f, m2 = 0.f, rs = 1.f;
    if (x) {
      block_sum2(s1, s2);
      const float mu = s1 / d;
      rs = rsqrtf(s2 / d - mu * mu + eps);
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = threadIdx.x + k * RT;
        if (c >= d) continue;
        xh[k] = (xh[k] - mu) * rs;
        as[k] += dy[k] * xh[k];
        ab[k] += dy[k];
        const float gx = dy[k] * s[c];
        m1 += gx;
        m2 += gx * xh[k];
      }
      block_sum2(m1, m2);
      m1 /= d;
      m2 /= d;
    }
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = threadIdx.x + k * RT;
      if (c >= d) continue;
      float v = x ? rs * (dy[k] * s[c] - m1 - xh[k] * m2) : dy[k];
      if (resT) v += to_f(resT[m * d + c]);
      if (res32) v += res32[m * d + c];
      out[m * d + c] = from_f<T>(v);
    }
  }
  const size_t row = (size_t)b * gridDim.x + chunk;
  store_partial(p_s, row, d, as);
  store_partial(p_b, row, d, ab);
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
