// Cross-attention block of the FiLM decoder layer in training, forward and
// backward, for Hopper (sm_90a).
//
// Replaces tcdiff_tpu/ops/fused_ca_block_train.py::fused_ca_block_train
// (forward _ca_train_fwd_kernel; backward _ca_bwd_qkv_kernel,
// _ca_bwd_projx_kernel, _ca_bwd_projm_kernel and the self-attention
// block's head and chain-top kernels):
//
//   r = rotary_x(LN(x; eps1))   rm = rotary_m(mem)
//   q = r.Wq   k = rm.Wk   v = mem.Wv
//   o = per head drop_ATTN(softmax(q.k^T / sqrt(dk))) . v       (L x Lm)
//   out = x + (fs+1) * drop_OUT(LN(drop_FC(o.Wfc); eps2)) + fb
//
// and its gradients, including the memory cotangent
//   d mem = rot_m^T(dk.Wk) + dv.Wv
// through which the cond encoder trains.
//
// What bounds it on the H100: at the train shape (b=64, L=450, Lm=152,
// d=512, 8x64 heads) the forward is 49 GFLOP (of which the attention is
// 9), the backward about twice that: compute-bound.
//
// Design: the self-attention block's (sa_block_train.cu) with the
// attention generic in Lk (train_common.cuh) and the warp-a-row row
// kernels. The memory side: its rotary is the row body with the LayerNorm
// off (rot_rows), and k = rm.Wk and v = mem.Wv are one grouped launch; in
// the backward, dWk and dWv are one grouped weight gradient (both
// products' row chunks in one wave, one ordered reduction), and in bf16
// d mem = rot_m^T(dk.Wk) + dv.Wv is one launch of the input-gradient body
// with rot_m^T applied to its f32 sums between the two products
// (gemm_nn_rot); f32 keeps the unfused sequence (both products into f32
// scratch, a row pass). bf16: 7 launches forward, 20 backward.
#include "train_common.cuh"

namespace tcd {

struct CaTrainArgs {
  // inputs
  const void *x, *mem, *cosx, *ssinx, *cosm, *ssinm, *wq, *wk, *wv, *wfc;
  const float *sx, *bx, *ss, *sb, *fs, *fb;  // norm2 affine, the block's LN affine, FiLM rows
  const void* seeds;
  // saved by the forward
  void *r, *rm, *q, *k, *v, *o;
  float *lse, *z;
  void* out;
  // backward; dwkv (2, hd, d): dWk, then dWv; drm, dvm: f32 only
  const void* g;
  void *dz, *dO, *dq, *dk, *dv, *dx, *dmem, *dwq, *dwkv, *dwfc;
  float *dr, *drm, *dvm, *part, *wpart, *Dsum, *vec;
  int B, L, Lm, d, hd, nhead, wcap, drop_on;
  float eps1, eps2, dscale;
  uint32_t thresh;
};

template <typename T>
int ca_fwd(const CaTrainArgs& a, cudaStream_t st) {
  const int M = a.B * a.L, Mm = a.B * a.Lm;
  const Drop dr = make_drop(a.seeds, a.thresh, a.dscale, a.drop_on);
  const T *x = (const T*)a.x, *mem = (const T*)a.mem;
  T *r = (T*)a.r, *rm = (T*)a.rm, *q = (T*)a.q, *k = (T*)a.k, *v = (T*)a.v, *o = (T*)a.o;
  ln_rows<T, T>(x, a.sx, a.bx, a.eps1, M, a.d, a.L, (const T*)a.cosx, (const T*)a.ssinx, nullptr, nullptr,
                nullptr, nullptr, r, st);
  rot_rows<T>(mem, (const T*)a.cosm, (const T*)a.ssinm, Mm, a.d, a.Lm, rm, st);
  gemm<T, EPI_STORE>(r, (const T*)a.wq, M, a.hd, a.d, epi(q), st);
  const T* ins[2] = {rm, mem};
  const T* wts[2] = {(const T*)a.wk, (const T*)a.wv};
  void* outs[2] = {k, v};
  gemm_group<T, EPI_STORE>(2, ins, wts, outs, Mm, a.hd, a.d, epi(nullptr), st);
  attention_fwd<T>(q, k, v, a.B, a.nhead, a.L, a.Lm, a.hd, dr, o, a.lse, st);
  gemm<T, EPI_STORE_F32>(o, (const T*)a.wfc, M, a.d, a.hd, epi(a.z), st);
  chain_top_fwd<T>(a.z, x, a.ss, a.sb, a.fs, a.fb, a.eps2, a.B, a.L, a.d, cdiv(a.L, RCH), dr, (T*)a.out, st);
  return launch_status();
}

template <typename T>
int ca_bwd(const CaTrainArgs& a, cudaStream_t st) {
  const int M = a.B * a.L, Mm = a.B * a.Lm, d = a.d, hd = a.hd, nch = cdiv(a.L, RCH);
  const size_t P = (size_t)a.B * nch * d, V = (size_t)a.B * d;
  const Drop dr = make_drop(a.seeds, a.thresh, a.dscale, a.drop_on);
  const T *x = (const T*)a.x, *mem = (const T*)a.mem, *g = (const T*)a.g;
  const T *wq = (const T*)a.wq, *wk = (const T*)a.wk, *wv = (const T*)a.wv, *wfc = (const T*)a.wfc;
  const T *r = (const T*)a.r, *rm = (const T*)a.rm, *q = (const T*)a.q, *k = (const T*)a.k,
          *v = (const T*)a.v, *o = (const T*)a.o;
  T *dz = (T*)a.dz, *dO = (T*)a.dO, *dq = (T*)a.dq, *dk = (T*)a.dk, *dv = (T*)a.dv;
  const T *cosm = (const T*)a.cosm, *ssinm = (const T*)a.ssinm;

  // chain top: partials 0 fs, 1 fb, 2 ss, 3 sb
  chain_top_bwd<T>(g, a.z, a.ss, a.sb, a.fs, a.eps2, a.B, a.L, d, nch, dr, dz, a.part, a.part + P, a.part + 2 * P,
                   a.part + 3 * P, st);
  wgrad<T>(dz, o, M, d, hd, a.wpart, a.wcap, (T*)a.dwfc, st);
  gemm_nn<T, EPI_STORE>(dz, wfc, dO, M, hd, d, st);
  attention_bwd<T>(q, k, v, o, dO, a.lse, a.B, a.nhead, a.L, a.Lm, hd, dr, a.Dsum, dq, dk, dv, st);
  wgrad<T>(dq, r, M, hd, d, a.wpart, a.wcap, (T*)a.dwq, st);
  const T* gs[2] = {dk, dv};
  const T* xs[2] = {rm, mem};
  wgrad_group<T>(2, gs, xs, Mm, hd, d, a.wpart, a.wcap, (T*)a.dwkv, st);  // dWk, dWv
  // x side: dx = g + LN2_bwd(rot_x^T(dq.Wq)): partials 4 sx, 5 bx
  gemm_nn<T, EPI_STORE_F32>(dq, wq, a.dr, M, d, hd, st);
  rows_bwd<T>(a.dr, (const T*)a.cosx, (const T*)a.ssinx, nullptr, x, a.sx, a.eps1, g, nullptr, a.B, a.L, d, nch,
              (T*)a.dx, a.part + 4 * P, a.part + 5 * P, st);
  // memory side: dmem = rot_m^T(dk.Wk) + dv.Wv
  if constexpr (std::is_same<T, bf16>::value) {
    gemm_nn_rot<T>(dk, wk, dv, wv, cosm, ssinm, a.Lm, Mm, d, hd, (T*)a.dmem, st);
  } else {
    gemm_nn<T, EPI_STORE_F32>(dk, wk, a.drm, Mm, d, hd, st);
    gemm_nn<T, EPI_STORE_F32>(dv, wv, a.dvm, Mm, d, hd, st);
    rows_bwd<T>(a.drm, cosm, ssinm, a.dvm, nullptr, nullptr, 0.f, nullptr, nullptr, a.B, a.Lm, d, cdiv(a.Lm, RCH),
                (T*)a.dmem, nullptr, nullptr, st);
  }
  reduce_per_batch(a.part, a.B, nch, d, a.vec, st);
  reduce_per_batch(a.part + P, a.B, nch, d, a.vec + V, st);
  for (int i = 2; i < 6; ++i) reduce_all(a.part + i * P, a.B, nch, d, a.vec + i * V, st);
  return launch_status();
}

}  // namespace tcd

// dtype: 0 = float32, 1 = bfloat16. Returns the launches' status (launch_status).
extern "C" int tcd_ca_train_fwd(int dtype, const tcd::CaTrainArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return tcd::ca_fwd<float>(*a, st);
  if (dtype == 1) return tcd::ca_fwd<__nv_bfloat16>(*a, st);
  return -1;
}

extern "C" int tcd_ca_train_bwd(int dtype, const tcd::CaTrainArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return tcd::ca_bwd<float>(*a, st);
  if (dtype == 1) return tcd::ca_bwd<__nv_bfloat16>(*a, st);
  return -1;
}
