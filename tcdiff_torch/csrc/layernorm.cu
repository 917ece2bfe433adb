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
// Design: ln_rows of common.cuh, the row body every kernel's LayerNorm
// stage shares: one warp per row, the row read once into registers in
// 16-byte vectors (16 elements a lane at d = 512), the statistics by warp
// shuffles in a fixed order (no shared memory, no barrier), scale and bias
// held in registers while a warp walks its rows; a grid of what the card
// holds at once. Widths other than 64, 128, 256, 512 and 1024 run the same
// layout over pairs of columns.
#include "common.cuh"

namespace tcd {

template <typename T>
int layernorm(const T* x, const float* s, const float* b, int M, int d, float eps, T* out,
              cudaStream_t st) {
  ln_rows<T, T>(x, s, b, eps, M, d, 1, nullptr, nullptr, nullptr, nullptr, nullptr, out, nullptr, st);
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

// The row body alone with every option, for tests and measurement
// (ops/layernorm.py ln_rows): in (M, d) in TI, out and out_rot (M, d) in
// T, either may be null; cos/ssin (L, d) in T or null; resid (M, d) in T
// and fs/fb (M / L, d) f32, or null. in_dtype, dtype: 0 = float32,
// 1 = bfloat16; a bf16 input takes a bf16 output. Returns
// cudaGetLastError() after the launch, -1 for what it does not take.
extern "C" int tcd_ln_rows(int in_dtype, int dtype, const void* in, const float* s, const float* b, int M, int d,
                           int L, float eps, const void* cos_t, const void* ssin_t, const void* resid,
                           const float* fs, const float* fb, void* out, void* out_rot, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using T = __nv_bfloat16;
  if (in_dtype == 0 && dtype == 0) {
    tcd::ln_rows<float, float>((const float*)in, s, b, eps, M, d, L, (const float*)cos_t, (const float*)ssin_t,
                               (const float*)resid, fs, fb, (float*)out, (float*)out_rot, st);
  } else if (in_dtype == 0 && dtype == 1) {
    tcd::ln_rows<float, T>((const float*)in, s, b, eps, M, d, L, (const T*)cos_t, (const T*)ssin_t,
                           (const T*)resid, fs, fb, (T*)out, (T*)out_rot, st);
  } else if (in_dtype == 1 && dtype == 1) {
    tcd::ln_rows<T, T>((const T*)in, s, b, eps, M, d, L, (const T*)cos_t, (const T*)ssin_t, (const T*)resid, fs,
                       fb, (T*)out, (T*)out_rot, st);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
