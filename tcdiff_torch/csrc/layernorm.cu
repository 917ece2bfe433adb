// Row LayerNorm, for Hopper (sm_90a): K10 of the port.
//
// Replaces tcdiff_tpu/ops/fused_layernorm.py::fused_layernorm (the Pallas
// program _ln_kernel over large row blocks):
//
//   out = T((x - mu) * rsqrt(E[x^2] - mu^2 + eps) * scale + bias)
//
// with the statistics and the affine in f32, x and out in T.
//
// What bounds it on the H100: 8 operations per element against 2 or 4
// bytes in and out, far below the ~20 FLOP/byte of the f32 units, so the
// bytes: at the serving shape (3600 rows of 512) one read and one write of
// 3.7 MB in bf16, ~2.2 us at 3.35 TB/s.
//
// Design: ln_rows_kernel of common.cuh, one block of 256 threads per row
// (each thread one pair of columns at d = 512); the row is read twice, the
// second time from L1/L2.
#include "common.cuh"

namespace tcd {

template <typename T>
int layernorm(const T* x, const float* s, const float* b, int M, int d, float eps, T* out,
              cudaStream_t st) {
  ln_rows_kernel<T, T><<<M, 256, 0, st>>>(x, s, b, eps, d, 1, nullptr, nullptr, nullptr, nullptr,
                                          nullptr, out, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace tcd

// x, out (M, d) with d even; dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch.
extern "C" int tcd_layernorm(int dtype, const void* x, const float* s, const float* b, int M, int d,
                             float eps, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return tcd::layernorm<float>((const float*)x, s, b, M, d, eps, (float*)out, st);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return tcd::layernorm<T>((const T*)x, s, b, M, d, eps, (T*)out, st);
  }
  return -1;
}
