// The forward projection of gemm_mma.cuh alone, for tests and measurement:
// C[g] = A[g] . W[g]^T for up to 3 triples that share M, N, K and the
// epilogue (the grouped form is K1's q/k/v launch). No path of the model
// calls it; the kernels reach the same code through blocks.cuh and
// train_common.cuh.
#include "gemm_mma.cuh"

// Pointers, then the ints: the layout of the ctypes mirror in ops/gemm.py.
// a1, a2, w1, w2, c1, c2 are read only when groups > 1; bias, resid, fs,
// fb as the epilogue needs them (common.cuh: Epi).
struct GemmArgs {
  const void *a0, *a1, *a2, *w0, *w1, *w2;
  void *c0, *c1, *c2;
  const float* bias;
  const void* resid;
  const float *fs, *fb;
  int M, N, K, L, epi, groups;
};

namespace tcd {

template <typename T, int EPI>
void gemm_entry(const GemmArgs& a, cudaStream_t st) {
  const T* as[3] = {(const T*)a.a0, (const T*)a.a1, (const T*)a.a2};
  const T* ws[3] = {(const T*)a.w0, (const T*)a.w1, (const T*)a.w2};
  void* cs[3] = {a.c0, a.c1, a.c2};
  gemm_group<T, EPI>(a.groups, as, ws, cs, a.M, a.N, a.K, epi(nullptr, a.bias, a.resid, a.fs, a.fb, a.L), st);
}

template <typename T>
int gemm_epi(const GemmArgs& a, cudaStream_t st) {
  switch (a.epi) {
    case EPI_STORE: gemm_entry<T, EPI_STORE>(a, st); break;
    case EPI_STORE_F32: gemm_entry<T, EPI_STORE_F32>(a, st); break;
    case EPI_BIAS: gemm_entry<T, EPI_BIAS>(a, st); break;
    case EPI_BIAS_GELU: gemm_entry<T, EPI_BIAS_GELU>(a, st); break;
    case EPI_BIAS_FILM: gemm_entry<T, EPI_BIAS_FILM>(a, st); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace tcd

// dtype: 0 = float32, 1 = bfloat16; epi: a tcd::Epi value of STORE,
// STORE_F32, BIAS, BIAS_GELU or BIAS_FILM. Returns cudaGetLastError()
// after the launch, -1 for a dtype or epilogue it does not take.
extern "C" int tcd_gemm(int dtype, const GemmArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->groups < 1 || a->groups > tcd::PGROUP) return -1;
  if (dtype == 0) return tcd::gemm_epi<float>(*a, st);
  if (dtype == 1) return tcd::gemm_epi<__nv_bfloat16>(*a, st);
  return -1;
}
