// Launch sequences of the serving blocks, shared by the block kernels
// (sa_block.cu K1, ff_tail.cu K2, ff_block.cu K2b, ca_block.cu K7 in both
// its forms) and the whole decoder layer (layer.cu K6), which runs K1's,
// the cross-attention's and K2's steps back to back on one stream.
//
// Each sequence is a few hand-written launches on the stream it is given:
// LayerNorm row kernels (ln_rows of common.cuh, f32 statistics),
// projections with fused epilogues and heads_attention (attention.cuh). In
// bf16 the projections run on the wgmma + TMA body (gemm_wgmma.cuh: proj,
// proj_group; mma.sync, gemm_mma.cuh, where its rule sends a product) and
// the attention on its wgmma + TMA body (mma.sync where its rule sends a
// call); in f32 both run on the FMA units. Buffers are
// row-major (B * L rows); projections are (rows, h*dk) with head h in
// columns [h*dk, (h+1)*dk); weights in nn.Linear layout (out, in).
// Intermediates land in T where the TPU kernels round them to the compute
// dtype. In bf16 a LayerNorm that follows a product (the post-attention LN
// after fc, LN4 after W2, and K6's next block's LN) runs in the product's
// epilogue (gemm_ln_wg: a cluster along N holds whole rows), so the
// product's f32 value never leaves the SMs; in f32 the product lands in an
// f32 scratch and a row kernel reads it back.
#pragma once

#include "attention.cuh"
#include "gemm_wgmma.cuh"

namespace tcd {

// C[g] = A[g] . W[g]^T for g < G (<= 3) with the epilogue EPI, the
// products sharing N and the epilogue's other operands: bf16 on the wgmma
// body (one launch of gemm_wg, by its rule), f32 on the FMA tiles.
template <typename T, int EPI>
inline void proj_group(int G, const T* const* A, const T* const* W, void* const* C, int M, int N, int K,
                       EpiArgs ep, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int ns[WGROUP] = {N, N, N};
    gemm_wg<EPI>(G, A, W, C, ns, M, K, ep, st);
  } else {
    gemm_group<T, EPI>(G, A, W, C, M, N, K, ep, st);
  }
}

// C = A . W^T with the epilogue EPI into ep.c, as proj_group.
template <typename T, int EPI>
inline void proj(const T* A, const T* W, int M, int N, int K, EpiArgs ep, cudaStream_t st) {
  proj_group<T, EPI>(1, &A, &W, &ep.c, M, N, K, ep, st);
}

// A second LayerNorm on fc_post_ln's output (K6's): out = T(rot(LN(x)))
// with the rotary tables, T(LN(x)) without; s == nullptr: none.
template <typename T>
struct NextLn {
  const float *s = nullptr, *b = nullptr;
  float eps = 0.f;
  const T *cos = nullptr, *ssin = nullptr;
  T* out = nullptr;
};

// The attention blocks' last two steps: z = o . Wfc^T in f32, then
// out = T(LN(z; eps2)), or T(resid + (fs+1) * LN(z) + fb) with FiLM rows;
// then `next` on out. bf16: one cluster launch with both LayerNorms in its
// epilogue (gemm_ln_wg; z unused); f32: the product into z and a row
// kernel for each LayerNorm. LN2 must name next's form (LN2_NONE without
// one).
template <typename T, int LN2 = LN2_NONE>
inline void fc_post_ln(const T* o, const T* wfc, const float* s2, const float* b2, const T* resid,
                       const float* fs, const float* fb, int B, int L, int d, int hd, float eps2,
                       float* z, T* out, cudaStream_t st, const NextLn<T>& next = {}) {
  const int M = B * L;
  if constexpr (std::is_same<T, bf16>::value) {
    LnFold f{};
    f.out = out;
    f.s = s2;
    f.b = b2;
    f.eps = eps2;
    f.resid = fs ? resid : nullptr;
    f.fs = fs;
    f.fb = fb;
    f.L = L;
    f.s2 = next.s;
    f.b2 = next.b;
    f.eps2 = next.eps;
    f.cos = next.cos;
    f.ssin = next.ssin;
    f.out2 = next.out;
    gemm_ln_wg<LN_POST, LN2>(o, wfc, M, d, hd, f, st);
  } else {
    gemm<T, EPI_STORE_F32>(o, wfc, M, d, hd, epi(z), st);
    ln_rows<float, T>(z, s2, b2, eps2, M, d, L, nullptr, nullptr, fs ? resid : nullptr, fs, fb, out,
                      nullptr, st);
    if (LN2 != LN2_NONE)
      ln_rows<T, T>(out, next.s, next.b, next.eps, M, d, L, next.cos, next.ssin, nullptr, nullptr, nullptr,
                    LN2 == LN2_ROT ? nullptr : next.out, LN2 == LN2_ROT ? next.out : nullptr, st);
  }
}

// K1's first steps: y = LN(x; eps1), r = rot(y); q = r.Wq, k = r.Wk,
// v = y.Wv in one grouped launch; o = attention [+ TRPE]: 3 launches.
template <typename T>
void sa_attend(const T* x, const float* s1, const float* b1, const T* cos_t, const T* ssin_t, const T* wq,
               const T* wk, const T* wv, const T* table, const int32_t* dist, int B, int L, int d, int hd,
               int nhead, float eps1, T* y, T* r, T* q, T* k, T* v, T* o, cudaStream_t st) {
  const int M = B * L;
  ln_rows<T, T>(x, s1, b1, eps1, M, d, L, cos_t, ssin_t, nullptr, nullptr, nullptr, y, r, st);
  const T* as[3] = {r, r, y};
  const T* ws[3] = {wq, wk, wv};
  void* cs[3] = {q, k, v};
  proj_group<T, EPI_STORE>(3, as, ws, cs, M, hd, d, epi(nullptr), st);
  heads_attention<T>(q, k, v, o, B, L, L, hd, nhead, table, dist, st);
}

// K1, the self-attention block: sa_attend, then fc and LN(eps2) [+ FiLM
// residual]: 4 launches in bf16 (the post-LN in fc's epilogue), 5 in f32.
template <typename T>
void sa_block(const T* x, const float* s1, const float* b1, const T* cos_t, const T* ssin_t,
              const T* wq, const T* wk, const T* wv, const T* wfc, const float* s2, const float* b2,
              const T* table, const int32_t* dist, const float* fs, const float* fb, int B, int L,
              int d, int hd, int nhead, float eps1, float eps2, T* y, T* r, T* q, T* k, T* v, T* o,
              float* z, T* out, cudaStream_t st) {
  sa_attend<T>(x, s1, b1, cos_t, ssin_t, wq, wk, wv, table, dist, B, L, d, hd, nhead, eps1, y, r, q, k, v, o,
               st);
  fc_post_ln<T>(o, wfc, s2, b2, x, fs, fb, B, L, d, hd, eps2, z, out, st);
}

// Cross-attention from r = rot(LN(x)) against projected k, v (B, Lm, hd):
// q = r.Wq, o = attention: 2 launches.
template <typename T>
void cross_attend(const T* r, const T* k, const T* v, int Lm, const T* wq, int B, int L, int d, int hd,
                  int nhead, T* q, T* o, cudaStream_t st) {
  proj<T, EPI_STORE>(r, wq, B * L, hd, d, epi(q), st);
  heads_attention<T>(q, k, v, o, B, L, Lm, hd, nhead, nullptr, nullptr, st);
}

// The cross-attention's q from the raw residual: q = T(rot(LN(x; eps1))).Wq
// over M rows. bf16: one launch with the LayerNorm and the rotary in its
// prologue (gemm_lnrot; r unused); f32: r = rot(LN(x)) by the row kernel,
// then the product: 2 launches.
template <typename T>
void cross_q(const T* x, const float* s1, const float* b1, float eps1, const T* cos_t, const T* ssin_t,
             const T* wq, int M, int L, int d, int hd, T* r, T* q, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    gemm_lnrot<T>(x, s1, b1, eps1, cos_t, ssin_t, L, wq, M, hd, d, q, st);
  } else {
    ln_rows<T, T>(x, s1, b1, eps1, M, d, L, cos_t, ssin_t, nullptr, nullptr, nullptr, nullptr, r, st);
    gemm<T, EPI_STORE>(r, wq, M, hd, d, epi(q), st);
  }
}

// The query side of cross-attention against projected k, v (B, Lm, hd):
// cross_q; the attention; fc; LN(eps2) [+ FiLM residual]. K7 after its
// k/v projections: 3 launches in bf16, 5 in f32.
template <typename T>
void cross_attention(const T* x, const float* s1, const float* b1, const T* cos_t,
                     const T* ssin_t, const T* k, const T* v, int Lm, const T* wq, const T* wfc,
                     const float* s2, const float* b2, const float* fs, const float* fb, int B,
                     int L, int d, int hd, int nhead, float eps1, float eps2, T* r, T* q, T* o,
                     float* z, T* out, cudaStream_t st) {
  cross_q<T>(x, s1, b1, eps1, cos_t, ssin_t, wq, B * L, L, d, hd, r, q, st);
  heads_attention<T>(q, k, v, o, B, L, Lm, hd, nhead, nullptr, nullptr, st);
  fc_post_ln<T>(o, wfc, s2, b2, x, fs, fb, B, L, d, hd, eps2, z, out, st);
}

// The FF block's first half: y = T(LN3(x)), h = T(gelu_erf(y.W1^T + b1)).
template <typename T>
inline void ff_hidden(const T* x, const float* s3, const float* b3, const T* w1,
                      const float* bb1, int M, int L, int d, int ff, float eps, T* y, T* h,
                      cudaStream_t st) {
  ln_rows<T, T>(x, s3, b3, eps, M, d, L, nullptr, nullptr, nullptr, nullptr, nullptr, y, nullptr, st);
  proj<T, EPI_BIAS_GELU>(y, w1, M, ff, d, epi(h, bb1), st);
}

// K2 after its hidden activation h: x' = x + (fs+1) * (h.W2^T + b2) + fb in
// f32, z = T(LN4(x')), out = z.W3^T + b3. bf16: LN4 in W2's epilogue (one
// cluster launch of gemm_ln_wg; x' never leaves the SMs); f32: x' through
// o32 and a row kernel.
template <typename T>
inline void ff_out(const T* x, const T* h, const T* w2, const float* bb2, const float* fs, const float* fb,
                   const float* s4, const float* b4, const T* w3, const float* bb3, int M, int L, int d, int ff,
                   float eps, float* o32, T* z, T* out, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    LnFold f{};
    f.out = z;
    f.s = s4;
    f.b = b4;
    f.eps = eps;
    f.bias = bb2;
    f.resid = x;
    f.fs = fs;
    f.fb = fb;
    f.L = L;
    gemm_ln_wg<LN_FILM_PRE, LN2_NONE>(h, w2, M, d, ff, f, st);
  } else {
    gemm<T, EPI_BIAS_FILM>(h, w2, M, d, ff, epi(o32, bb2, x, fs, fb, L), st);
    ln_rows<float, T>(o32, s4, b4, eps, M, d, L, nullptr, nullptr, nullptr, nullptr, nullptr, z, nullptr, st);
  }
  proj<T, EPI_BIAS>(z, w3, M, d, d, epi(out, bb3), st);
}

// K2, the FF block and the layer tail: ff_hidden, then ff_out: 4 launches
// in bf16, 5 in f32.
template <typename T>
void ff_tail(const T* x, const float* s3, const float* b3, const T* w1, const float* bb1,
             const T* w2, const float* bb2, const float* fs, const float* fb, const float* s4,
             const float* b4, const T* w3, const float* bb3, int B, int L, int d, int ff, float eps,
             T* y, T* h, float* o32, T* z, T* out, cudaStream_t st) {
  const int M = B * L;
  ff_hidden<T>(x, s3, b3, w1, bb1, M, L, d, ff, eps, y, h, st);
  ff_out<T>(x, h, w2, bb2, fs, fb, s4, b4, w3, bb3, M, L, d, ff, eps, o32, z, out, st);
}

}  // namespace tcd
