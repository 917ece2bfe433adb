// The products of gemm_mma.cuh alone, for tests and measurement, in their
// three layouts: the forward projection C[g] = A[g] . W[g]^T for up to 3
// triples that share M, N, K and the epilogue (the grouped form is K1's
// q/k/v launch); the input gradient C = sum_j A[j] . B[j] (B (K, N), up to
// 2 joined pairs: K3's dr); and the split-row weight gradient dW = G^T X
// with its ordered reduction. No path of the model calls it; the kernels
// reach the same code through blocks.cuh and train_common.cuh.
#include "gemm_mma.cuh"

// Pointers, then the ints: the layout of the ctypes mirror in ops/gemm.py.
// a1, a2, w1, w2, c1, c2 are read only when groups > 1; bias, resid, fs,
// fb as the epilogue needs them (common.cuh: Epi). layout 0: forward;
// 1: input gradient, a (M, K), w (K, N), c0 (M, N), groups the joined
// pairs; 2: weight gradient, a0 = G (M, N), w0 = X (M, K) over M rows,
// c0 = dW (N, K), `part` holding `cap` floats, `splits` row chunks (0:
// the count the train kernels use).
struct GemmArgs {
  const void *a0, *a1, *a2, *w0, *w1, *w2;
  void *c0, *c1, *c2;
  const float* bias;
  const void* resid;
  const float *fs, *fb;
  float* part;
  int M, N, K, L, epi, groups, layout, splits, cap;
};

namespace tcd {

template <typename T, int EPI>
void gemm_entry(const GemmArgs& a, cudaStream_t st) {
  const T* as[3] = {(const T*)a.a0, (const T*)a.a1, (const T*)a.a2};
  const T* ws[3] = {(const T*)a.w0, (const T*)a.w1, (const T*)a.w2};
  void* cs[3] = {a.c0, a.c1, a.c2};
  if constexpr (EPI == EPI_STORE || EPI == EPI_STORE_F32 || EPI == EPI_ACC_F32) {
    if (a.layout == 1) return gemm_nn<T, EPI>(a.groups, as, ws, a.c0, a.M, a.N, a.K, st);
  }
  if constexpr (EPI != EPI_ACC_F32)
    gemm_group<T, EPI>(a.groups, as, ws, cs, a.M, a.N, a.K, epi(nullptr, a.bias, a.resid, a.fs, a.fb, a.L), st);
}

template <typename T>
int gemm_epi(const GemmArgs& a, cudaStream_t st) {
  if (a.layout == 2) {
    wgrad<T>((const T*)a.a0, (const T*)a.w0, a.M, a.N, a.K, a.part, (size_t)a.cap, (T*)a.c0, st, a.splits);
    return (int)cudaGetLastError();
  }
  // both layouts store; only the input gradient adds, only the forward takes a bias
  const bool store = a.epi == EPI_STORE || a.epi == EPI_STORE_F32;
  if (!store && (a.layout == 1) != (a.epi == EPI_ACC_F32)) return -1;
  switch (a.epi) {
    case EPI_STORE: gemm_entry<T, EPI_STORE>(a, st); break;
    case EPI_STORE_F32: gemm_entry<T, EPI_STORE_F32>(a, st); break;
    case EPI_ACC_F32: gemm_entry<T, EPI_ACC_F32>(a, st); break;
    case EPI_BIAS: gemm_entry<T, EPI_BIAS>(a, st); break;
    case EPI_BIAS_GELU: gemm_entry<T, EPI_BIAS_GELU>(a, st); break;
    case EPI_BIAS_FILM: gemm_entry<T, EPI_BIAS_FILM>(a, st); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace tcd

// dtype: 0 = float32, 1 = bfloat16; layout and epi as GemmArgs says (epi:
// a tcd::Epi value of STORE, STORE_F32, BIAS, BIAS_GELU or BIAS_FILM in
// the forward; STORE, STORE_F32 or ACC_F32 in the input gradient). Returns
// cudaGetLastError() after the launches, -1 for what it does not take.
extern "C" int tcd_gemm(int dtype, const GemmArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int most = a->layout == 0 ? tcd::PGROUP : a->layout == 1 ? 2 : 1;
  if (a->layout < 0 || a->layout > 2 || a->groups < 1 || a->groups > most) return -1;
  if (dtype == 0) return tcd::gemm_epi<float>(*a, st);
  if (dtype == 1) return tcd::gemm_epi<__nv_bfloat16>(*a, st);
  return -1;
}
