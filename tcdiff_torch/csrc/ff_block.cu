// Feed-forward block of the FiLM decoder layer without the layer tail, for
// Hopper (sm_90a): K2b of the port.
//
// Replaces tcdiff_tpu/ops/fused_ff_block.py::fused_ff_block (the Pallas
// program _ff_kernel, one VMEM-resident program per batch element):
//
//   h   = gelu_erf(LN3(x).W1^T + b1)
//   out = h.W2^T + b2                              (no FiLM rows)
//   out = x + (fs+1) * (h.W2^T + b2) + fb          (FiLM residual, in f32)
//
// rounded once to the compute dtype T at the end, as the TPU kernel
// stores its f32 result. It serves the configuration with the FF block
// kernel on and the tail off (TCDIFF_PALLAS_FFT=0); linear3(norm4(x))
// then runs outside, plain or through K9.
//
// What bounds it on the H100: at the serving shape (b=8, L=450, d=512,
// ff=1024) the block is 7.5 GFLOP against ~2 MB of weights and ~15 MB of
// activations: operations, ~7.6 us at the bf16 tensor-core peak.
//
// Design: K2's sequence (blocks.cuh) without its last LayerNorm and GEMM.
// ff_hidden is the LN row kernel and the bias+GELU GEMM; the second GEMM's
// epilogue adds the bias (EPI_BIAS) or the bias and the FiLM residual
// (EPI_BIAS_FILM_T, which writes T where K2's EPI_BIAS_FILM keeps f32 for
// LN4). The projections run on the tensor cores in bf16 (gemm_mma.cuh);
// the (M, ff) hidden activation makes one round trip through device memory
// that the TPU kernel keeps in VMEM.
#include "blocks.cuh"

namespace tcd {

template <typename T>
void ff_block(const T* x, const float* s3, const float* b3, const T* w1, const float* bb1,
              const T* w2, const float* bb2, const float* fs, const float* fb, int B, int L, int d,
              int ff, float eps, T* y, T* h, T* out, cudaStream_t st) {
  const int M = B * L;
  ff_hidden<T>(x, s3, b3, w1, bb1, M, L, d, ff, eps, y, h, st);
  if (fs)
    gemm<T, EPI_BIAS_FILM_T>(h, w2, M, d, ff, epi(out, bb2, x, fs, fb, L), st);
  else
    gemm<T, EPI_BIAS>(h, w2, M, d, ff, epi(out, bb2), st);
}

}  // namespace tcd

// x (B, L, d), d even; w1 (ff, d), w2 (d, ff) in T; fs/fb (B, d) f32 or
// both null; y (M, d), h (M, ff) scratch in T. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() after the launches.
extern "C" int tcd_ff_block(int dtype, const void* x, const float* s3, const float* b3,
                            const void* w1, const float* bb1, const void* w2, const float* bb2,
                            const float* fs, const float* fb, int B, int L, int d, int ff,
                            float eps, void* y, void* h, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using T = float;
    tcd::ff_block<T>((const T*)x, s3, b3, (const T*)w1, bb1, (const T*)w2, bb2, fs, fb, B, L, d,
                     ff, eps, (T*)y, (T*)h, (T*)out, st);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    tcd::ff_block<T>((const T*)x, s3, b3, (const T*)w1, bb1, (const T*)w2, bb2, fs, fb, B, L, d,
                     ff, eps, (T*)y, (T*)h, (T*)out, st);
    return (int)cudaGetLastError();
  }
  return -1;
}
