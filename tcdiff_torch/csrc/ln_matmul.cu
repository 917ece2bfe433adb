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
// What bounds it on the H100: at the serving shape (3600 rows, d = 512)
// linear1 (N = 1024) is 3.8 GFLOP against ~12 MB in bf16: operations,
// ~3.8 us at the bf16 tensor-core peak; linear3 (N = 512) 1.9 GFLOP
// against ~8 MB: bytes, ~2.4 us at the HBM rate.
//
// Design, bf16: two launches. ln_rows (the row body of common.cuh, one
// warp a row) writes y into a (M, d) scratch, then one launch of the
// wgmma + TMA body (gemm_wg of gemm_wgmma.cuh) runs the product with the
// rounded-bias epilogue: 8 x 29 blocks of 128 x 128 at linear1, 4 x 29 at
// linear3 (mma.sync where the body's rule sends it). y makes one round
// trip through device memory that the TPU kernel keeps in VMEM; the
// LayerNorm in the product's prologue measured slower on the H100 at K8's
// and K2b's products (PERF.md), so the row body runs it. f32: ln_rows and
// the FMA projection.
#include "gemm_wgmma.cuh"

// The layout of the ctypes mirror in ops/ln_matmul.py. x (M, d), d even;
// w (N, d) in nn.Linear layout; bias (N,) f32; y (M, d) scratch; out
// (M, N).
struct LnMatmulArgs {
  const void* x;
  const float *s, *b;
  const void* w;
  const float* bias;
  void *y, *out;
  int M, d, N;
  float eps;
};

namespace tcd {

template <typename T>
int ln_matmul(const LnMatmulArgs& a, cudaStream_t st) {
  T *y = (T*)a.y, *out = (T*)a.out;
  const T* w = (const T*)a.w;
  ln_rows<T, T>((const T*)a.x, a.s, a.b, a.eps, a.M, a.d, 1, nullptr, nullptr, nullptr, nullptr, nullptr, y, nullptr,
                st);
  if constexpr (std::is_same<T, bf16>::value) {
    const T* A[1] = {y};
    const T* W[1] = {w};
    void* C[1] = {out};
    const int N[1] = {a.N};
    gemm_wg<EPI_BIAS_ROUNDED>(1, A, W, C, N, a.M, a.d, epi(nullptr, a.bias), st);
  } else {
    gemm<T, EPI_BIAS_ROUNDED>(y, w, a.M, a.N, a.d, epi(out, a.bias), st);
  }
  return launch_status();
}

}  // namespace tcd

// dtype: 0 = float32, 1 = bfloat16. Returns the launches' status: a
// failed or refused launch (launch_status) is not 0.
extern "C" int tcd_ln_matmul(int dtype, const LnMatmulArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return tcd::ln_matmul<float>(*a, st);
  if (dtype == 1) return tcd::ln_matmul<tcd::bf16>(*a, st);
  return -1;
}
