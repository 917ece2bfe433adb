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
// Wr = [Wq; Wk] (joined, or Wq and Wk apart) and Wp = Wv; the
// cross-attention query side (with the k/v cache off) passes Wr = Wq alone.
//
// What bounds it on the H100: at the serving shape (3600 rows, d = 512,
// q, k and v 512 columns each) 5.7 GFLOP against ~13 MB in bf16:
// operations, ~5.7 us at the bf16 tensor-core peak.
//
// Design, bf16: two launches. ln_rows writes y and rot(y) (the row body of
// common.cuh, one warp a row), and one launch of the wgmma + TMA body
// (gemm_wg of gemm_wgmma.cuh) runs every product, each with its own A
// (rot(y) for q and k, y for v) and its own N: 3 x 4 x 29 blocks at the
// serving shape (mma.sync where its rule sends them). The LayerNorm and
// rotary in the products' prologue (one launch, y and rot(y) never in
// device memory) measured slower on the H100 at the serving shape
// (PERF.md: a block ran its prologue, K loop and epilogue one after
// another), so the row body runs them. f32: ln_rows and one FMA projection
// per weight.
#include "gemm_wgmma.cuh"

// The layout of the ctypes mirror in ops/ln_rotary_matmul.py. x (M = B L
// rows of d), d even; cos/ssin (L, d) in T; wr0 (n0, d) and, in the
// separate form, wr1 (n1, d) rotated; wp (np, d) or null (rot-only); y, r
// (M, d) scratch (y unused without wp); o0 (M, n0), o1 (M, n1), ov (M, np).
struct LnRotArgs {
  const void* x;
  const float *s, *b;
  const void *cos, *ssin, *wr0, *wr1, *wp;
  void *y, *r, *o0, *o1, *ov;
  int M, L, d, n0, n1, np;
  float eps;
};

namespace tcd {

template <typename T>
int ln_rotary_matmul(const LnRotArgs& a, cudaStream_t st) {
  const T *x = (const T*)a.x, *cs = (const T*)a.cos, *sn = (const T*)a.ssin;
  T *y = (T*)a.y, *r = (T*)a.r;
  if (!r || (a.wp && !y)) {
    refuse();
    return launch_status();
  }
  ln_rows<T, T>(x, a.s, a.b, a.eps, a.M, a.d, a.L, cs, sn, nullptr, nullptr, nullptr, a.wp ? y : nullptr, r, st);
  if constexpr (std::is_same<T, bf16>::value) {
    const T* A[WGROUP] = {r, r, y};
    const T* W[WGROUP] = {(const T*)a.wr0, (const T*)a.wr1, (const T*)a.wp};
    void* C[WGROUP] = {a.o0, a.o1, a.ov};
    int N[WGROUP] = {a.n0, a.n1, a.np}, G = 1;
    if (a.wr1) ++G;
    if (a.wp) {  // v: the last group
      A[G] = y;
      W[G] = (const T*)a.wp;
      C[G] = a.ov;
      N[G++] = a.np;
    }
    gemm_wg<EPI_STORE>(G, A, W, C, N, a.M, a.d, epi(nullptr), st);
  } else {
    gemm<T, EPI_STORE>(r, (const T*)a.wr0, a.M, a.n0, a.d, epi(a.o0), st);
    if (a.wr1) gemm<T, EPI_STORE>(r, (const T*)a.wr1, a.M, a.n1, a.d, epi(a.o1), st);
    if (a.wp) gemm<T, EPI_STORE>(y, (const T*)a.wp, a.M, a.np, a.d, epi(a.ov), st);
  }
  return launch_status();
}

}  // namespace tcd

// dtype: 0 = float32, 1 = bfloat16. Returns the launches' status: a
// failed or refused launch (launch_status) is not 0.
extern "C" int tcd_ln_rotary_matmul(int dtype, const LnRotArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return tcd::ln_rotary_matmul<float>(*a, st);
  if (dtype == 1) return tcd::ln_rotary_matmul<tcd::bf16>(*a, st);
  return -1;
}
