// Feed-forward block and layer tail of the FiLM decoder layer, for Hopper
// (sm_90a).
//
// Replaces tcdiff_tpu/ops/fused_ff_block.py::fused_ff_tail (the Pallas
// program _ff_tail_kernel, one VMEM-resident program per batch element):
//
//   h   = gelu_erf(LN3(x).W1^T + b1)
//   x'  = x + (fs+1) * (h.W2^T + b2) + fb          (FiLM residual, f32)
//   out = LN4(x').W3^T + b3
//
// GELU is the exact erf form through CUDA's erff (the TPU kernel inlines
// XLA's f32 erf polynomial; both are within a few ulp of erf).
//
// What bounds it on the H100: at the serving shape (b=8, L=450, d=512,
// ff=1024) the chain is 9.4 GFLOP against ~4 MB of weights and ~15 MB of
// activations: compute-bound, with the (M, ff) hidden activation the one
// large intermediate.
//
// Design: hand-written launches on one stream. LN3 is a row kernel (f32
// stats, one warp a row, result in T); the three projections (the wgmma
// + TMA body of gemm_wgmma.cuh in bf16, FMA tiles in f32) apply
// bias+GELU, bias+FiLM residual and bias to their sums. In bf16 LN4 runs
// in W2's epilogue: W2 launches as clusters of d/128 blocks along N, which
// hold whole rows and reduce their statistics through distributed shared
// memory (gemm_ln_wg), so the f32 FiLM residual
// the TPU kernel feeds LN4 never leaves the SMs: four launches. In f32 it
// lands in an f32 scratch that a row kernel reads back: five. The sequence
// is tcd::ff_tail of blocks.cuh, whose steps K6 (layer.cu) reuses.
#include "blocks.cuh"

// dtype: 0 = float32, 1 = bfloat16; o32 is used in f32 only. Returns the
// launches' status (launch_status).
extern "C" int tcd_ff_tail(int dtype, const void* x, const float* s3, const float* b3,
                           const void* w1, const float* bb1, const void* w2, const float* bb2,
                           const float* fs, const float* fb, const float* s4, const float* b4,
                           const void* w3, const float* bb3, int B, int L, int d, int ff,
                           float eps, void* y, void* h, float* o32, void* z, void* out,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using T = float;
    tcd::ff_tail<T>((const T*)x, s3, b3, (const T*)w1, bb1, (const T*)w2, bb2, fs, fb, s4, b4,
                    (const T*)w3, bb3, B, L, d, ff, eps, (T*)y, (T*)h, o32, (T*)z, (T*)out, st);
    return tcd::launch_status();
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    tcd::ff_tail<T>((const T*)x, s3, b3, (const T*)w1, bb1, (const T*)w2, bb2, fs, fb, s4, b4,
                    (const T*)w3, bb3, B, L, d, ff, eps, (T*)y, (T*)h, o32, (T*)z, (T*)out, st);
    return tcd::launch_status();
  }
  return -1;
}
