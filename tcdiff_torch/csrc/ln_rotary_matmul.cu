// LayerNorm -> rotary -> projections, for Hopper (sm_90a): K8 of the port.
//
// Replaces tcdiff_tpu/ops/fused_ln_rotary_matmul.py::fused_ln_rotary_matmul,
// both of its Pallas programs:
//
//   _kernel          qk = T(rot(y)) . Wr^T,  v = T(y) . Wp^T
//   _kernel_rot_only qk = T(rot(y)) . Wr^T
//
// with y = LN(x) in f32 and rot(y) = y * cos + swap_pairs(y) * ssin on the
// full model vector, computed in f32 from cos / sign-folded sin tables that
// were rounded to T (the TPU kernel's _tables). Self-attention passes
// Wr = [Wq; Wk] and Wp = Wv; the cross-attention query side (with the k/v
// cache off) passes Wr = Wq alone.
//
// What bounds it on the H100: at the serving shape (3600 rows, d = 512,
// Wr (1024, 512), Wp (512, 512)) 5.7 GFLOP against ~13 MB in bf16:
// operations, ~5.7 us at the bf16 tensor-core peak.
//
// Design: K1's first stage alone. ln_rows_kernel writes y and rot(y) in T
// to scratch, then one projection per weight (gemm_mma.cuh: the tensor
// cores in bf16); y and rot(y) make one round trip through device memory
// that the TPU kernel keeps in VMEM.
#include "gemm_mma.cuh"

namespace tcd {

template <typename T>
int ln_rotary_matmul(const T* x, const float* s, const float* b, const T* cos_t, const T* ssin_t,
                     const T* wr, const T* wp, int M, int L, int d, int fr, int fp, float eps,
                     T* y, T* r, T* qk, T* v, cudaStream_t st) {
  ln_rows<T, T>(x, s, b, eps, M, d, L, cos_t, ssin_t, nullptr, nullptr, nullptr, wp ? y : nullptr, r, st);
  gemm<T, EPI_STORE>(r, wr, M, fr, d, epi(qk), st);
  if (wp) gemm<T, EPI_STORE>(y, wp, M, fp, d, epi(v), st);
  return (int)cudaGetLastError();
}

}  // namespace tcd

// x (B * L rows of d), d even; cos/ssin (L, d) in T; wr (fr, d), wp (fp, d)
// or null (rot-only: y and v unused); y, r (M, d) scratch; qk (M, fr),
// v (M, fp). dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError()
// after the launches.
extern "C" int tcd_ln_rotary_matmul(int dtype, const void* x, const float* s, const float* b,
                                    const void* cos_t, const void* ssin_t, const void* wr,
                                    const void* wp, int M, int L, int d, int fr, int fp, float eps,
                                    void* y, void* r, void* qk, void* v, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using T = float;
    return tcd::ln_rotary_matmul<T>((const T*)x, s, b, (const T*)cos_t, (const T*)ssin_t,
                                    (const T*)wr, (const T*)wp, M, L, d, fr, fp, eps, (T*)y, (T*)r,
                                    (T*)qk, (T*)v, st);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return tcd::ln_rotary_matmul<T>((const T*)x, s, b, (const T*)cos_t, (const T*)ssin_t,
                                    (const T*)wr, (const T*)wp, M, L, d, fr, fp, eps, (T*)y, (T*)r,
                                    (T*)qk, (T*)v, st);
  }
  return -1;
}
