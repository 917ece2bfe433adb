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
// Design, bf16: three launches. ln_rows writes LN3's output y, then both
// products run on the wgmma + TMA body (gemm_wg of gemm_wgmma.cuh;
// mma.sync where its rule sends them): W1 with bias + GELU in its
// epilogue, W2 with the bias (EPI_BIAS) or the bias and the FiLM residual
// (EPI_BIAS_FILM_T, which writes T where K2's EPI_BIAS_FILM keeps f32 for
// LN4). LN3 in W1's prologue (one launch fewer, y never in device memory)
// measured slower on the H100 than ln_rows + W1 at the serving shape
// (PERF.md), so the row body runs it. The (M, ff) hidden activation makes one
// round trip, which the TPU kernel keeps in VMEM (at the serving shape
// 7.4 MB, within L2). f32: K2's sequence without its last LayerNorm and
// GEMM (ff_hidden of blocks.cuh, then W2), FMA products.
#include "blocks.cuh"
#include "gemm_wgmma.cuh"

namespace tcd {

template <typename T>
void ff_block(const T* x, const float* s3, const float* b3, const T* w1, const float* bb1,
              const T* w2, const float* bb2, const float* fs, const float* fb, int B, int L, int d,
              int ff, float eps, T* y, T* h, T* out, cudaStream_t st) {
  const int M = B * L;
  if constexpr (std::is_same<T, bf16>::value) {
    ln_rows<T, T>(x, s3, b3, eps, M, d, L, nullptr, nullptr, nullptr, nullptr, nullptr, y, nullptr, st);
    const T* yc = y;
    void* hc = h;
    gemm_wg<EPI_BIAS_GELU>(1, &yc, &w1, &hc, &ff, M, d, epi(h, bb1), st);
    const T* ha = h;
    void* oc = out;
    if (fs)
      gemm_wg<EPI_BIAS_FILM_T>(1, &ha, &w2, &oc, &d, M, ff, epi(out, bb2, x, fs, fb, L), st);
    else
      gemm_wg<EPI_BIAS>(1, &ha, &w2, &oc, &d, M, ff, epi(out, bb2), st);
  } else {
    ff_hidden<T>(x, s3, b3, w1, bb1, M, L, d, ff, eps, y, h, st);
    if (fs)
      gemm<T, EPI_BIAS_FILM_T>(h, w2, M, d, ff, epi(out, bb2, x, fs, fb, L), st);
    else
      gemm<T, EPI_BIAS>(h, w2, M, d, ff, epi(out, bb2), st);
  }
}

}  // namespace tcd

// x (B, L, d), d even; w1 (ff, d), w2 (d, ff) in T; fs/fb (B, d) f32 or
// both null; y (M, d), h (M, ff) scratch in T. dtype: 0 = float32,
// 1 = bfloat16.
// Returns the launches' status (launch_status: a failed or refused launch
// is not 0).
extern "C" int tcd_ff_block(int dtype, const void* x, const float* s3, const float* b3,
                            const void* w1, const float* bb1, const void* w2, const float* bb2,
                            const float* fs, const float* fb, int B, int L, int d, int ff,
                            float eps, void* y, void* h, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using T = float;
    tcd::ff_block<T>((const T*)x, s3, b3, (const T*)w1, bb1, (const T*)w2, bb2, fs, fb, B, L, d,
                     ff, eps, (T*)y, (T*)h, (T*)out, st);
    return tcd::launch_status();
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    tcd::ff_block<T>((const T*)x, s3, b3, (const T*)w1, bb1, (const T*)w2, bb2, fs, fb, B, L, d,
                     ff, eps, (T*)y, (T*)h, (T*)out, st);
    return tcd::launch_status();
  }
  return -1;
}
