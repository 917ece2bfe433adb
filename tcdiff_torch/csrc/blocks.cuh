// Launch sequences of the serving blocks, shared by the block kernels
// (sa_block.cu K1, ff_tail.cu K2, ff_block.cu K2b, ca_block.cu K7) and the
// whole decoder layer (layer.cu K6), which runs K1's, the cross-attention's
// and K2's sequences back to back on one stream.
//
// Each sequence is a few hand-written launches on the stream it is given:
// LayerNorm row kernels (f32 statistics), projections with fused
// epilogues (gemm_mma.cuh) and heads_attention (attention.cuh), both on
// the tensor cores in bf16 and on the FMA units in f32. Buffers are
// row-major (B * L rows); projections are (rows, h*dk) with head h in
// columns [h*dk, (h+1)*dk); weights in nn.Linear layout (out, in).
// Intermediates land in T where the TPU kernels round them to the compute
// dtype, in f32 where they keep f32 (the fc output before its LayerNorm,
// the FF block's FiLM residual before LN4).
#pragma once

#include "attention.cuh"
#include "gemm_mma.cuh"

namespace tcd {

// The attention blocks' last two steps: z = o . Wfc^T in f32, then
// out = T(LN(z; eps2)), or T(resid + (fs+1) * LN(z) + fb) with FiLM rows.
template <typename T>
inline void fc_post_ln(const T* o, const T* wfc, const float* s2, const float* b2, const T* resid,
                       const float* fs, const float* fb, int B, int L, int d, int hd, float eps2,
                       float* z, T* out, cudaStream_t st) {
  const int M = B * L;
  gemm<T, EPI_STORE_F32>(o, wfc, M, d, hd, epi(z), st);
  ln_rows_kernel<float, T><<<M, 256, 0, st>>>(z, s2, b2, eps2, d, L, nullptr, nullptr,
                                              fs ? resid : nullptr, fs, fb, out, nullptr);
}

// K1, the self-attention block: y = LN(x; eps1), r = rot(y); q = r.Wq,
// k = r.Wk, v = y.Wv in one grouped launch; attention [+ TRPE]; fc;
// LN(eps2) [+ FiLM residual]: 5 launches.
template <typename T>
void sa_block(const T* x, const float* s1, const float* b1, const T* cos_t, const T* ssin_t,
              const T* wq, const T* wk, const T* wv, const T* wfc, const float* s2, const float* b2,
              const T* table, const int32_t* dist, const float* fs, const float* fb, int B, int L,
              int d, int hd, int nhead, float eps1, float eps2, T* y, T* r, T* q, T* k, T* v, T* o,
              float* z, T* out, cudaStream_t st) {
  const int M = B * L;
  ln_rows_kernel<T, T><<<M, 256, 0, st>>>(x, s1, b1, eps1, d, L, cos_t, ssin_t, nullptr,
                                          nullptr, nullptr, y, r);
  const T* as[3] = {r, r, y};
  const T* ws[3] = {wq, wk, wv};
  void* cs[3] = {q, k, v};
  gemm_group<T, EPI_STORE>(3, as, ws, cs, M, hd, d, epi(nullptr), st);
  heads_attention<T>(q, k, v, o, B, L, L, hd, nhead, table, dist, st);
  fc_post_ln<T>(o, wfc, s2, b2, x, fs, fb, B, L, d, hd, eps2, z, out, st);
}

// The query side of cross-attention against projected k, v (B, Lm, hd):
// q = rot(LN(x; eps1)).Wq; attention; fc; LN(eps2) [+ FiLM residual].
// K7 after its k/v projections, and K6's cached-k/v section.
template <typename T>
void cross_attention(const T* x, const float* s1, const float* b1, const T* cos_t,
                     const T* ssin_t, const T* k, const T* v, int Lm, const T* wq, const T* wfc,
                     const float* s2, const float* b2, const float* fs, const float* fb, int B,
                     int L, int d, int hd, int nhead, float eps1, float eps2, T* r, T* q, T* o,
                     float* z, T* out, cudaStream_t st) {
  const int M = B * L;
  ln_rows_kernel<T, T><<<M, 256, 0, st>>>(x, s1, b1, eps1, d, L, cos_t, ssin_t, nullptr,
                                          nullptr, nullptr, nullptr, r);
  gemm<T, EPI_STORE>(r, wq, M, hd, d, epi(q), st);
  heads_attention<T>(q, k, v, o, B, L, Lm, hd, nhead, nullptr, nullptr, st);
  fc_post_ln<T>(o, wfc, s2, b2, x, fs, fb, B, L, d, hd, eps2, z, out, st);
}

// The FF block's first half: y = T(LN3(x)), h = T(gelu_erf(y.W1^T + b1)).
template <typename T>
inline void ff_hidden(const T* x, const float* s3, const float* b3, const T* w1,
                      const float* bb1, int M, int L, int d, int ff, float eps, T* y, T* h,
                      cudaStream_t st) {
  ln_rows_kernel<T, T><<<M, 256, 0, st>>>(x, s3, b3, eps, d, L, nullptr, nullptr, nullptr,
                                          nullptr, nullptr, y, nullptr);
  gemm<T, EPI_BIAS_GELU>(y, w1, M, ff, d, epi(h, bb1), st);
}

// K2, the FF block and the layer tail: x' = x + (fs+1) * (h.W2^T + b2) + fb
// kept in f32 (o32), then out = T(LN4(x')).W3^T + b3.
template <typename T>
void ff_tail(const T* x, const float* s3, const float* b3, const T* w1, const float* bb1,
             const T* w2, const float* bb2, const float* fs, const float* fb, const float* s4,
             const float* b4, const T* w3, const float* bb3, int B, int L, int d, int ff, float eps,
             T* y, T* h, float* o32, T* z, T* out, cudaStream_t st) {
  const int M = B * L;
  ff_hidden<T>(x, s3, b3, w1, bb1, M, L, d, ff, eps, y, h, st);
  gemm<T, EPI_BIAS_FILM>(h, w2, M, d, ff, epi(o32, bb2, x, fs, fb, L), st);
  ln_rows_kernel<float, T><<<M, 256, 0, st>>>(o32, s4, b4, eps, d, L, nullptr, nullptr,
                                              nullptr, nullptr, nullptr, z, nullptr);
  gemm<T, EPI_BIAS>(z, w3, M, d, d, epi(out, bb3), st);
}

}  // namespace tcd
