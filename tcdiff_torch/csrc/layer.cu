// A whole decoder layer on the serving path, for Hopper (sm_90a): K6 of the
// port.
//
// Replaces tcdiff_tpu/ops/fused_layer.py::fused_layer (the Pallas program
// _layer_kernel, one VMEM-resident program per batch element):
//
//   x1  = T(x + (f1s+1) * SA(x) + f1b)           K1's block, FiLM in f32
//   x2  = T(x1 + (f2s+1) * CA(x1; kcat, vcat) + f2b)
//   out = linear3(LN4(x2 + (f3s+1) * FF(x2) + f3b))        (include_ff)
//   out = x2                                                (otherwise)
//
// CA is the cross-attention query side against k/v that arrive projected
// (B, Lm, h*dk) in the compute dtype T: the cond cache's music rows and
// the step's two time-token rows, concatenated by the caller. x1 and x2
// are rounded to T before reuse, where the three block programs of the
// per-block path store the residual stream; the self-attention FiLM is
// always applied inside, in f32. No TRPE: the layer runs only without a
// trj_dist. It serves the configuration TCDIFF_LAYER_FUSE=1 (with the k/v
// cache); with TCDIFF_LAYER_FUSE_FF=0 the caller finishes the layer with K2.
//
// What bounds it on the H100: at the serving shape (b=8, L=450, Lm=152,
// d=512, 8x64 heads, ff=1024) 10.9 GFLOP of self-attention, 4.9 of
// cross-attention and 9.4 of FF and tail against ~25 MB: operations,
// ~25 us at the bf16 tensor-core peak.
//
// Design: one C entry point launches the layer's whole sequence on one
// stream, from the steps of blocks.cuh. In bf16, 10 launches: LN1 with the
// rotary (a row kernel), q/k/v in one grouped launch, the attention, the
// SA fc with its fold, the CA q projection, the attention, the CA fc with
// its fold, W1 with GELU, W2 with its fold, W3. A fold is the product
// launched as a cluster of d/128 blocks along N whose epilogue holds whole
// rows (gemm_ln_wg of gemm_wgmma.cuh):
//   SA fc: x1 = T(x + (f1s+1) * LN(z; eps2) + f1b), then r = T(rot(LN(x1;
//          eps1))) on the rounded x1: the cross-attention's query input;
//   CA fc: x2 = T(x1 + (f2s+1) * LN(zc; eps2) + f2b), then y = T(LN3(x2));
//   W2:    z = T(LN4(x2 + (f3s+1) * (h.W2^T + b2) + f3b)), in f32 before it.
// So the f32 z, zc and FiLM residual, which the TPU kernel keeps in VMEM,
// never reach device memory, and the six row kernels of K1's, the
// cross-attention's and K2's sequences shrink to one. x1 and x2 make one
// round trip each through device memory, in T, so the roundings are those
// of the TPU kernel. In f32 the same steps run unfused (15 launches: the
// products on the FMA tiles, each LayerNorm a row kernel). In bf16 the
// projections run on the wgmma + TMA body (gemm_wgmma.cuh, its folds
// too) and the flash attention (attention.cuh) on mma.sync.
#include "blocks.cuh"

// Pointers, then the ints, then the floats: the layout of the ctypes
// mirror in ops/layer.py. The FF section's pointers are unused unless
// include_ff.
struct LayerArgs {
  const void *x, *cos, *ssin;
  const float *s1, *b1;
  const void *wq, *wk, *wv, *wfc;
  const float *sa_s2, *sa_b2, *f1s, *f1b, *n2s, *n2b;
  const void *cwq, *cfc;
  const float *ca_s2, *ca_b2;
  const void *kcat, *vcat;
  const float *f2s, *f2b, *s3, *b3;
  const void* w1;
  const float* bb1;
  const void* w2;
  const float *bb2, *f3s, *f3b, *s4, *b4;
  const void* w3;
  const float* bb3;
  void *y, *r, *q, *k, *v, *o;
  float* z;
  void *x1, *x2, *h, *out;
  int B, L, Lm, d, hd, nhead, ff, include_ff;
  float eps1, eps2;
};

namespace tcd {

template <typename T>
void layer(const LayerArgs& a, cudaStream_t st) {
  const T *x = (const T*)a.x, *cos = (const T*)a.cos, *ssin = (const T*)a.ssin;
  T *y = (T*)a.y, *r = (T*)a.r, *q = (T*)a.q, *o = (T*)a.o, *x1 = (T*)a.x1;
  T* x2 = a.include_ff ? (T*)a.x2 : (T*)a.out;
  sa_attend<T>(x, a.s1, a.b1, cos, ssin, (const T*)a.wq, (const T*)a.wk, (const T*)a.wv, nullptr, nullptr, a.B,
               a.L, a.d, a.hd, a.nhead, a.eps1, y, r, q, (T*)a.k, (T*)a.v, o, st);
  NextLn<T> ln2;  // the cross-attention's LN + rotary on the rounded x1
  ln2.s = a.n2s;
  ln2.b = a.n2b;
  ln2.eps = a.eps1;
  ln2.cos = cos;
  ln2.ssin = ssin;
  ln2.out = r;
  fc_post_ln<T, LN2_ROT>(o, (const T*)a.wfc, a.sa_s2, a.sa_b2, x, a.f1s, a.f1b, a.B, a.L, a.d, a.hd, a.eps2, a.z,
                         x1, st, ln2);
  cross_attend<T>(r, (const T*)a.kcat, (const T*)a.vcat, a.Lm, (const T*)a.cwq, a.B, a.L, a.d, a.hd, a.nhead, q,
                  o, st);
  if (!a.include_ff) {
    fc_post_ln<T>(o, (const T*)a.cfc, a.ca_s2, a.ca_b2, x1, a.f2s, a.f2b, a.B, a.L, a.d, a.hd, a.eps2, a.z, x2,
                  st);
    return;
  }
  NextLn<T> ln3;  // the FF block's LN on the rounded x2
  ln3.s = a.s3;
  ln3.b = a.b3;
  ln3.eps = a.eps1;
  ln3.out = y;
  fc_post_ln<T, LN2_PLAIN>(o, (const T*)a.cfc, a.ca_s2, a.ca_b2, x1, a.f2s, a.f2b, a.B, a.L, a.d, a.hd, a.eps2,
                           a.z, x2, st, ln3);
  const int M = a.B * a.L;
  proj<T, EPI_BIAS_GELU>(y, (const T*)a.w1, M, a.ff, a.d, epi(a.h, a.bb1), st);
  ff_out<T>(x2, (const T*)a.h, (const T*)a.w2, a.bb2, a.f3s, a.f3b, a.s4, a.b4, (const T*)a.w3, a.bb3, M, a.L, a.d,
            a.ff, a.eps1, a.z, r, (T*)a.out, st);
}

}  // namespace tcd

// x (B, L, d), d even (at most 1024 in bf16); cos/ssin (L, d) in T;
// projection weights in nn.Linear layout in T; kcat/vcat (B, Lm, hd) in T;
// LN affines, biases and FiLM rows (B, d) f32. Scratch in T: y, r, x1, x2
// (B*L, d), q, k, v, o (B*L, hd), h (B*L, ff); z (B*L, d) f32, used in f32
// only. dtype: 0 = float32, 1 = bfloat16. Returns the launches' status
// (launch_status).
extern "C" int tcd_layer(int dtype, const LayerArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    tcd::layer<float>(*a, st);
  } else if (dtype == 1) {
    tcd::layer<__nv_bfloat16>(*a, st);
  } else {
    return -1;
  }
  return tcd::launch_status();
}
