// LayerNorm into a biased projection, for Hopper (sm_90a): K9 of the port.
//
// Replaces tcdiff_tpu/ops/fused_ln_matmul.py::fused_ln_matmul (the Pallas
// program _lnmm_kernel), the decoder layer's norm3 -> linear1 and
// norm4 -> linear3:
//
//   y   = T(LN(x))                         (f32 statistics and affine)
//   out = T(T(y . W^T) + T(bias))          (f32 sums)
//
// The product is rounded to T BEFORE the bias is added in T, as the TPU
// kernel does (fused_ln_matmul.py:38); in bf16 that differs from a linear
// layer that adds the bias to the f32 sum.
//
// What bounds it on the H100: at the serving shape (3600 rows, d = 512,
// N = 1024 for linear1) 3.8 GFLOP against ~12 MB in bf16: operations,
// ~3.8 us at the bf16 tensor-core peak.
//
// Design: two launches on one stream, ln_rows_kernel into a (M, d) scratch
// y in T, then the projection of gemm_mma.cuh (the tensor cores in bf16)
// with the rounded-bias epilogue. y
// makes one round trip through device memory that the TPU kernel keeps in
// VMEM.
#include "gemm_mma.cuh"

namespace tcd {

template <typename T>
int ln_matmul(const T* x, const float* s, const float* b, const T* w, const float* bias, int M,
              int d, int N, float eps, T* y, T* out, cudaStream_t st) {
  ln_rows<T, T>(x, s, b, eps, M, d, 1, nullptr, nullptr, nullptr, nullptr, nullptr, y, nullptr, st);
  gemm<T, EPI_BIAS_ROUNDED>(y, w, M, N, d, epi(out, bias), st);
  return (int)cudaGetLastError();
}

}  // namespace tcd

// x (M, d), d even; w (N, d) in nn.Linear layout; bias (N,) f32; y (M, d)
// scratch; out (M, N). dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launches.
extern "C" int tcd_ln_matmul(int dtype, const void* x, const float* s, const float* b,
                             const void* w, const float* bias, int M, int d, int N, float eps,
                             void* y, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using T = float;
    return tcd::ln_matmul<T>((const T*)x, s, b, (const T*)w, bias, M, d, N, eps, (T*)y, (T*)out, st);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return tcd::ln_matmul<T>((const T*)x, s, b, (const T*)w, bias, M, d, N, eps, (T*)y, (T*)out, st);
  }
  return -1;
}
