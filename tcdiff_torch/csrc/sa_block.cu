// Self-attention block of the FiLM decoder layer, for Hopper (sm_90a).
//
// Replaces tcdiff_tpu/ops/fused_sa_block.py::fused_sa_block (the Pallas
// program _sa_block_kernel, one VMEM-resident program per batch element):
//
//   y  = LN(x; eps1)          r = rotary(y) on the full model vector
//   q  = r.Wq   k = r.Wk   v = y.Wv                  (bias-free)
//   o  = per-head softmax(q.k^T/sqrt(dk) [+ TRPE bias]) . v
//   sa = LN(o.Wfc; eps2)      [out = x + (fs+1)*sa + fb]   (optional FiLM)
//
// TRPE bias: bias[i, j] = q_unscaled[i] . table[dist[i, j], head] where
// 0 <= dist < 10, as the TPU kernel's predicated adds.
//
// What bounds it on the H100: at the serving shape (b=8, L=450, d=512,
// 8x64 heads) the block is 7.5 GFLOP of projections and 3.3 GFLOP of
// attention against ~15 MB of activations, so it is compute-bound; the
// (L, L) logits of one head (810 KB in f32) do not fit the 227 KB of shared
// memory a block may use, which the TPU kernel's 16 MB VMEM program held.
//
// Design: a short pipeline of hand-written launches on one stream.
//   1. ln_rows (common.cuh): LN + rotary per row (f32 stats), one warp a
//      row, y and r stored in T;
//   2. q, k and v in one grouped launch of the projection (gemm_wg of
//      gemm_wgmma.cuh: wgmma fed by TMA, three products of one launch);
//   3. heads_attention (attention.cuh, shared with K11): flash attention,
//      streaming key tiles with an online softmax, so no logit row ever
//      leaves the block; in bf16 on the tensor cores (at head width 64
//      without TRPE the wgmma + TMA body, a persistent grid of 128-query
//      tiles; else mma.sync, a block for each 64 queries of a head and
//      row), in f32 on the FMA units;
//   4. the out projection with the post-attention LN and the FiLM residual
//      in its epilogue: in bf16 one cluster of d/128 blocks along N holds
//      whole rows and reduces their statistics through distributed shared
//      memory (gemm_ln_wg, on the wgmma body), so the f32 product never
//      leaves the SMs; in f32 the product goes to an f32 scratch and a row
//      kernel reads it back.
// Four launches in bf16, five in f32. The projections run on the tensor
// cores in bf16 (wgmma fed by TMA, gemm_wgmma.cuh; mma.sync, gemm_mma.cuh,
// where the body's rule sends a product), on the FMA units in f32. The
// sequence is tcd::sa_block of blocks.cuh, whose steps K6 (layer.cu)
// reuses.
#include "blocks.cuh"

// dtype: 0 = float32, 1 = bfloat16. table/dist and fs/fb may be null.
// Returns the launches' status (launch_status).
extern "C" int tcd_sa_block(int dtype, const void* x, const float* s1, const float* b1,
                            const void* cos_t, const void* ssin_t, const void* wq,
                            const void* wk, const void* wv, const void* wfc, const float* s2,
                            const float* b2, const void* table, const int32_t* dist,
                            const float* fs, const float* fb, int B, int L, int d, int hd,
                            int nhead, float eps1, float eps2, void* y, void* r, void* q,
                            void* k, void* v, void* o, float* z, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using T = float;
    tcd::sa_block<T>((const T*)x, s1, b1, (const T*)cos_t, (const T*)ssin_t, (const T*)wq,
                     (const T*)wk, (const T*)wv, (const T*)wfc, s2, b2, (const T*)table, dist, fs,
                     fb, B, L, d, hd, nhead, eps1, eps2, (T*)y, (T*)r, (T*)q, (T*)k, (T*)v, (T*)o,
                     z, (T*)out, st);
    return tcd::launch_status();
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    tcd::sa_block<T>((const T*)x, s1, b1, (const T*)cos_t, (const T*)ssin_t, (const T*)wq,
                     (const T*)wk, (const T*)wv, (const T*)wfc, s2, b2, (const T*)table, dist, fs,
                     fb, B, L, d, hd, nhead, eps1, eps2, (T*)y, (T*)r, (T*)q, (T*)k, (T*)v, (T*)o,
                     z, (T*)out, st);
    return tcd::launch_status();
  }
  return -1;
}
