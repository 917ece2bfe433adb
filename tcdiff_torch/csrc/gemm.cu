// The products of gemm_mma.cuh alone, for tests and measurement, in their
// three layouts: the forward projection C[g] = A[g] . W[g]^T for up to 3
// triples that share M, N, K and the epilogue (the grouped form is K1's
// q/k/v launch); the input gradient C = sum_j A[j] . B[j] (B (K, N), up to
// 2 joined pairs: K3's dr); and the split-row weight gradient dW = G^T X
// with its ordered reduction, up to 3 over the same rows in one launch
// (K4's dWk and dWv). Then, bf16 only, K4's memory cotangent
// (gemm_nn_rot) and K7's q projection with the LayerNorm and rotary in its
// prologue (gemm_lnrot); and the forward projection on the wgmma + TMA
// body (gemm_wg of gemm_wgmma.cuh: up to 3 products with their own N), the
// LayerNorm fold on both bodies (gemm_ln, gemm_ln_wg), the two bodies'
// dispatch rules alone (tcd_wg_plan, tcd_ln_wg_plan), with the counts of
// each body's launches and the tensor maps' host time.
// No path of the model calls it;
// the kernels reach the same code through blocks.cuh, train_common.cuh and
// gemm_wgmma.cuh.
#include "gemm_wgmma.cuh"

// Pointers, then the ints: the layout of the ctypes mirror in ops/gemm.py.
// a1, a2, w1, w2, c1, c2 are read only when groups > 1; bias, resid, fs,
// fb as the epilogue needs them (common.cuh: Epi). layout 0: forward;
// 1: input gradient, a (M, K), w (K, N), c0 (M, N), groups the joined
// pairs; 2: weight gradients, a[g] = G (M, N), w[g] = X (M, K) over M
// rows, c0 = dW (groups, N, K), `part` holding `cap` floats, `splits` row
// chunks (0: the count the train kernels use).
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
    const T* gs[3] = {(const T*)a.a0, (const T*)a.a1, (const T*)a.a2};
    const T* xs[3] = {(const T*)a.w0, (const T*)a.w1, (const T*)a.w2};
    wgrad_group<T>(a.groups, gs, xs, a.M, a.N, a.K, a.part, (size_t)a.cap, (T*)a.c0, st, a.splits);
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
    case EPI_BIAS_ROUNDED: gemm_entry<T, EPI_BIAS_ROUNDED>(a, st); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace tcd

// dtype: 0 = float32, 1 = bfloat16; layout and epi as GemmArgs says (epi:
// a tcd::Epi value of STORE, STORE_F32, BIAS, BIAS_GELU, BIAS_FILM or
// BIAS_ROUNDED in the forward; STORE, STORE_F32 or ACC_F32 in the input gradient). Returns
// cudaGetLastError() after the launches, -1 for what it does not take.
extern "C" int tcd_gemm(int dtype, const GemmArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int most = a->layout == 1 ? 2 : tcd::PGROUP;
  if (a->layout < 0 || a->layout > 2 || a->groups < 1 || a->groups > most) return -1;
  if (dtype == 0) return tcd::gemm_epi<float>(*a, st);
  if (dtype == 1) return tcd::gemm_epi<__nv_bfloat16>(*a, st);
  return -1;
}

// K4's memory cotangent and K7's q projection alone, bf16 (ops/gemm.py
// gemm_nn_rot, gemm_lnrot): the layout of the ctypes mirror there.
struct GemmRotArgs {
  const void *a0, *w0, *a1, *w1, *cos, *ssin;
  const float *s, *b;
  void* out;
  int M, N, K, L;
  float eps;
};

// out (M, N) = T(rot^T(a0 . w0) + a1 . w1), a (M, K), w (K, N), the
// tables (L, N) at row m % L. dtype 1 (bfloat16) only; returns the
// launch's status, -1 for another dtype.
extern "C" int tcd_gemm_nn_rot(int dtype, const GemmRotArgs* a, void* stream) {
  if (dtype != 1) return -1;
  using T = __nv_bfloat16;
  tcd::gemm_nn_rot<T>((const T*)a->a0, (const T*)a->w0, (const T*)a->a1, (const T*)a->w1, (const T*)a->cos,
                   (const T*)a->ssin, a->L, a->M, a->N, a->K, (T*)a->out, static_cast<cudaStream_t>(stream));
  return tcd::launch_status();
}

// out (M, N) = T(rot(LN(a0; s, b, eps))) . w0^T, a0 (M, K), w0 (N, K), the
// tables (L, K) at row m % L. dtype 1 (bfloat16) only; returns the
// launch's status, -1 for another dtype.
extern "C" int tcd_gemm_lnrot(int dtype, const GemmRotArgs* a, void* stream) {
  if (dtype != 1) return -1;
  using T = __nv_bfloat16;
  tcd::gemm_lnrot<T>((const T*)a->a0, a->s, a->b, a->eps, (const T*)a->cos, (const T*)a->ssin, a->L, (const T*)a->w0,
                  a->M, a->N, a->K, (T*)a->out, static_cast<cudaStream_t>(stream));
  return tcd::launch_status();
}

// The forward projection on the wgmma body (gemm_wg) alone, bf16: the
// layout of the ctypes mirror in ops/gemm.py. Group g: a[g] (M, K), w[g]
// (n[g], K), c[g] (M, n[g]); bias, resid, fs, fb as the epilogue needs
// them (shared by the groups).
struct GemmWgArgs {
  const void *a0, *a1, *a2, *w0, *w1, *w2;
  void *c0, *c1, *c2;
  const float* bias;
  const void* resid;
  const float *fs, *fb;
  int M, K, L, epi, groups, n0, n1, n2;
};

namespace tcd {

template <int EPI>
void gemm_wg_entry(const GemmWgArgs& a, cudaStream_t st) {
  const bf16* as[3] = {(const bf16*)a.a0, (const bf16*)a.a1, (const bf16*)a.a2};
  const bf16* ws[3] = {(const bf16*)a.w0, (const bf16*)a.w1, (const bf16*)a.w2};
  void* cs[3] = {a.c0, a.c1, a.c2};
  const int ns[3] = {a.n0, a.n1, a.n2};
  gemm_wg<EPI>(a.groups, as, ws, cs, ns, a.M, a.K, epi(nullptr, a.bias, a.resid, a.fs, a.fb, a.L), st);
}

}  // namespace tcd

// dtype 1 (bfloat16) only; epi a tcd::Epi value of STORE, STORE_F32, BIAS,
// BIAS_GELU, BIAS_FILM, BIAS_FILM_T or BIAS_ROUNDED. Returns the launch's status
// (launch_status), -1 for what it does not take.
extern "C" int tcd_gemm_wg(int dtype, const GemmWgArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1 || a->groups < 1 || a->groups > tcd::WGROUP) return -1;
  switch (a->epi) {
    case tcd::EPI_STORE: tcd::gemm_wg_entry<tcd::EPI_STORE>(*a, st); break;
    case tcd::EPI_STORE_F32: tcd::gemm_wg_entry<tcd::EPI_STORE_F32>(*a, st); break;
    case tcd::EPI_BIAS: tcd::gemm_wg_entry<tcd::EPI_BIAS>(*a, st); break;
    case tcd::EPI_BIAS_GELU: tcd::gemm_wg_entry<tcd::EPI_BIAS_GELU>(*a, st); break;
    case tcd::EPI_BIAS_FILM: tcd::gemm_wg_entry<tcd::EPI_BIAS_FILM>(*a, st); break;
    case tcd::EPI_BIAS_FILM_T: tcd::gemm_wg_entry<tcd::EPI_BIAS_FILM_T>(*a, st); break;
    case tcd::EPI_BIAS_ROUNDED: tcd::gemm_wg_entry<tcd::EPI_BIAS_ROUNDED>(*a, st); break;
    default: return -1;
  }
  return tcd::launch_status();
}

// The LayerNorm fold alone, bf16 (ops/gemm.py gemm_ln, gemm_ln_wg): the
// layout of the ctypes mirror there. out = T(LN(a . w^T)) [FiLM] or
// T(LN(resid + (fs+1) * (a . w^T + bias) + fb)) (lne, tcd::LnEpi); ln2
// (tcd::Ln2) a second LayerNorm on out into out2, rotated by the tables
// (L, N) at row m % L for LN2_ROT.
struct GemmLnArgs {
  const void *a, *w, *resid, *cos, *ssin;
  const float *s, *b, *bias, *fs, *fb, *s2, *b2;
  void *out, *out2;
  int M, N, K, L, lne, ln2;
  float eps, eps2;
};

namespace tcd {

inline LnFold ln_fold(const GemmLnArgs& a) {
  LnFold f{};
  f.out = (bf16*)a.out;
  f.s = a.s;
  f.b = a.b;
  f.eps = a.eps;
  f.bias = a.bias;
  f.resid = (const bf16*)a.resid;
  f.fs = a.fs;
  f.fb = a.fb;
  f.L = a.L;
  f.s2 = a.s2;
  f.b2 = a.b2;
  f.eps2 = a.eps2;
  f.cos = (const bf16*)a.cos;
  f.ssin = (const bf16*)a.ssin;
  f.out2 = (bf16*)a.out2;
  return f;
}

// wg: the dispatching fold (gemm_ln_wg), else gemm_ln (mma.sync). The forms
// the blocks launch: LN_POST with LN2_NONE, LN2_PLAIN or LN2_ROT;
// LN_FILM_PRE with LN2_NONE.
template <int LNE, int LN2>
void gemm_ln_entry(const GemmLnArgs& a, bool wg, cudaStream_t st) {
  const bf16 *A = (const bf16*)a.a, *W = (const bf16*)a.w;
  if (wg)
    gemm_ln_wg<LNE, LN2>(A, W, a.M, a.N, a.K, ln_fold(a), st);
  else
    gemm_ln<LNE, LN2>(A, W, a.M, a.N, a.K, ln_fold(a), st);
}

inline int gemm_ln_form(int dtype, const GemmLnArgs& a, bool wg, cudaStream_t st) {
  if (dtype != 1) return -1;
  if (a.lne == LN_POST && a.ln2 == LN2_NONE) gemm_ln_entry<LN_POST, LN2_NONE>(a, wg, st);
  else if (a.lne == LN_POST && a.ln2 == LN2_PLAIN) gemm_ln_entry<LN_POST, LN2_PLAIN>(a, wg, st);
  else if (a.lne == LN_POST && a.ln2 == LN2_ROT) gemm_ln_entry<LN_POST, LN2_ROT>(a, wg, st);
  else if (a.lne == LN_FILM_PRE && a.ln2 == LN2_NONE) gemm_ln_entry<LN_FILM_PRE, LN2_NONE>(a, wg, st);
  else return -1;
  return launch_status();
}

}  // namespace tcd

// dtype 1 (bfloat16) only. Returns the launch's status (launch_status), -1
// for what it does not take.
extern "C" int tcd_gemm_ln(int dtype, const GemmLnArgs* a, void* stream) {
  return tcd::gemm_ln_form(dtype, *a, false, static_cast<cudaStream_t>(stream));
}
extern "C" int tcd_gemm_ln_wg(int dtype, const GemmLnArgs* a, void* stream) {
  return tcd::gemm_ln_form(dtype, *a, true, static_cast<cudaStream_t>(stream));
}

// The dispatch rules alone, the one place the body of a bf16 product is
// decided (ops/gemm.gemm_plan states it in Python; a card test holds the
// two together): 1 where the wgmma body takes the products (wg_ok) or the
// fold (ln_wg_ok), 0 where mma.sync runs them. The pointers are compared
// with alignments only, never read. -1 for more products than a launch
// takes.
extern "C" int tcd_wg_plan(const GemmWgArgs* a) {
  if (a->groups < 1 || a->groups > tcd::WGROUP) return -1;
  const tcd::bf16* as[3] = {(const tcd::bf16*)a->a0, (const tcd::bf16*)a->a1, (const tcd::bf16*)a->a2};
  const tcd::bf16* ws[3] = {(const tcd::bf16*)a->w0, (const tcd::bf16*)a->w1, (const tcd::bf16*)a->w2};
  void* cs[3] = {a->c0, a->c1, a->c2};
  const int ns[3] = {a->n0, a->n1, a->n2};
  return tcd::wg_ok(a->groups, as, ws, cs, ns, a->K, tcd::epi(nullptr, a->bias, a->resid, a->fs, a->fb, a->L));
}
extern "C" int tcd_ln_wg_plan(const GemmLnArgs* a) {
  return tcd::ln_wg_ok((const tcd::bf16*)a->a, (const tcd::bf16*)a->w, a->N, a->K, tcd::ln_fold(*a));
}
