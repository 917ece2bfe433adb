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
// stream: K1's (blocks.cuh sa_block, with FiLM), the cross-attention
// sequence shared with K7 (cross_attention, with FiLM) and K2's (ff_tail).
// The TPU kernel keeps the residual stream in VMEM between its sections;
// here x1 and x2 make one round trip each through device memory, in T, so
// the roundings are those of the TPU kernel. The projections (gemm_mma.cuh)
// and the flash attention (attention.cuh) run on the tensor cores in bf16.
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
  const T *cos = (const T*)a.cos, *ssin = (const T*)a.ssin;
  T *y = (T*)a.y, *r = (T*)a.r, *q = (T*)a.q, *o = (T*)a.o, *x1 = (T*)a.x1;
  T* x2 = a.include_ff ? (T*)a.x2 : (T*)a.out;
  sa_block<T>((const T*)a.x, a.s1, a.b1, cos, ssin, (const T*)a.wq, (const T*)a.wk,
              (const T*)a.wv, (const T*)a.wfc, a.sa_s2, a.sa_b2, nullptr, nullptr, a.f1s, a.f1b,
              a.B, a.L, a.d, a.hd, a.nhead, a.eps1, a.eps2, y, r, q, (T*)a.k, (T*)a.v, o, a.z,
              x1, st);
  cross_attention<T>(x1, a.n2s, a.n2b, cos, ssin, (const T*)a.kcat, (const T*)a.vcat, a.Lm,
                     (const T*)a.cwq, (const T*)a.cfc, a.ca_s2, a.ca_b2, a.f2s, a.f2b, a.B, a.L,
                     a.d, a.hd, a.nhead, a.eps1, a.eps2, r, q, o, a.z, x2, st);
  if (a.include_ff)
    ff_tail<T>(x2, a.s3, a.b3, (const T*)a.w1, a.bb1, (const T*)a.w2, a.bb2, a.f3s, a.f3b, a.s4,
               a.b4, (const T*)a.w3, a.bb3, a.B, a.L, a.d, a.ff, a.eps1, y, (T*)a.h, a.z, r,
               (T*)a.out, st);
}

}  // namespace tcd

// x (B, L, d), d even; cos/ssin (L, d) in T; projection weights in
// nn.Linear layout in T; kcat/vcat (B, Lm, hd) in T; LN affines, biases
// and FiLM rows (B, d) f32. Scratch in T: y, r, x1, x2 (B*L, d), q, k, v,
// o (B*L, hd), h (B*L, ff); z (B*L, d) f32. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() after the launches.
extern "C" int tcd_layer(int dtype, const LayerArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    tcd::layer<float>(*a, st);
  } else if (dtype == 1) {
    tcd::layer<__nv_bfloat16>(*a, st);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
