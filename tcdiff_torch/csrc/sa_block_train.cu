// Self-attention block of the FiLM decoder layer in training, forward and
// backward, for Hopper (sm_90a).
//
// Replaces tcdiff_tpu/ops/fused_sa_block_train.py::fused_sa_block_train
// (forward _sa_train_fwd_kernel; backward _bwd_qkv_kernel,
// _bwd_ohead_kernel, _bwd_chain_top_kernel, _bwd_attn_head_kernel,
// _bwd_proj_ln_kernel):
//
//   y = LN(x; eps1)   r = rotary(y)   q = r.Wq  k = r.Wk  v = y.Wv
//   o = per head drop_ATTN(softmax(q.k^T / sqrt(dk))) . v
//   out = x + (fs+1) * drop_OUT(LN(drop_FC(o.Wfc); eps2)) + fb
//
// and its gradients to x, Wq/Wk/Wv/Wfc, both LayerNorms' affines and the
// FiLM rows, with the hash dropout (train_common.cuh) regenerated in the
// backward from the same seeds.
//
// What bounds it on the H100: at the train shape (b=64, L=450, d=512,
// 8x64 heads) the forward is 87 GFLOP (60 of projections, 27 of attention)
// and the backward about twice that, against ~30 MB per (b, L, d)
// activation in bf16: compute-bound.
//
// Design: the TPU program's five-kernel backward split and its o-only
// residual exist for Mosaic's 16 MB VMEM stack; here the forward saves
// what the backward reads (y, r, q, k, v, o in T; the out projection z and
// each row's softmax log-normaliser in f32), and the backward is a chain
// of launches on one stream: the chain-top row kernel, the flash-style
// attention backward (D = rowsum(dO*O); one kernel for dq over key tiles,
// one for dk/dv over query tiles, so no gradient is accumulated across
// blocks), the input gradients' GEMMs (dO, dyv, and dr = dq.Wq + dk.Wk as
// one launch over the joined 2 hd), split-row GEMMs plus an ordered
// reduction for the weight gradients (one wave of row chunks), and the
// rotary-transpose / LN1 backward row kernel. In bf16 every product runs
// on the tensor cores: the attention forward and backward
// (train_common.cuh), the forward's projections (q/k/v in one launch) and
// the backward's products (gemm_mma.cuh); f32 runs FMA bodies.
#include "train_common.cuh"

namespace tcd {

struct SaTrainArgs {
  // inputs
  const void *x, *cos_t, *ssin_t, *wq, *wk, *wv, *wfc;
  const float *s1, *b1, *s2, *b2, *fs, *fb;
  const void* seeds;
  // saved by the forward
  void *y, *r, *q, *k, *v, *o;
  float *lse, *z;
  void* out;
  // backward
  const void* g;
  void *dz, *dO, *dq, *dk, *dv, *dx, *dwq, *dwk, *dwv, *dwfc;
  float *dr, *dyv, *part, *wpart, *Dsum, *vec;
  int B, L, d, hd, nhead, wcap, drop_on;
  float eps1, eps2, dscale;
  uint32_t thresh;
};

template <typename T>
int sa_fwd(const SaTrainArgs& a, cudaStream_t st) {
  const int M = a.B * a.L;
  const Drop dr = make_drop(a.seeds, a.thresh, a.dscale, a.drop_on);
  const T *x = (const T*)a.x, *cs = (const T*)a.cos_t, *sn = (const T*)a.ssin_t;
  T *y = (T*)a.y, *r = (T*)a.r, *q = (T*)a.q, *k = (T*)a.k, *v = (T*)a.v, *o = (T*)a.o;
  ln_rows<T, T>(x, a.s1, a.b1, a.eps1, M, a.d, a.L, cs, sn, nullptr, nullptr, nullptr, y, r, st);
  const T* ins[3] = {r, r, y};
  const T* wts[3] = {(const T*)a.wq, (const T*)a.wk, (const T*)a.wv};
  void* outs[3] = {q, k, v};
  gemm_group<T, EPI_STORE>(3, ins, wts, outs, M, a.hd, a.d, epi(nullptr), st);
  attention_fwd<T>(q, k, v, a.B, a.nhead, a.L, a.L, a.hd, dr, o, a.lse, st);
  gemm<T, EPI_STORE_F32>(o, (const T*)a.wfc, M, a.d, a.hd, epi(a.z), st);
  chain_top_fwd<T>(a.z, x, a.s2, a.b2, a.fs, a.fb, a.eps2, a.B, a.L, a.d, cdiv(a.L, RCH), dr, (T*)a.out, st);
  return launch_status();
}

template <typename T>
int sa_bwd(const SaTrainArgs& a, cudaStream_t st) {
  const int M = a.B * a.L, d = a.d, hd = a.hd, nch = cdiv(a.L, RCH);
  const size_t P = (size_t)a.B * nch * d;  // one partial-sum array
  const size_t V = (size_t)a.B * d;        // one reduced vector slot
  const Drop dr = make_drop(a.seeds, a.thresh, a.dscale, a.drop_on);
  const T *x = (const T*)a.x, *g = (const T*)a.g;
  const T *wq = (const T*)a.wq, *wk = (const T*)a.wk, *wv = (const T*)a.wv, *wfc = (const T*)a.wfc;
  const T *y = (const T*)a.y, *r = (const T*)a.r, *q = (const T*)a.q, *k = (const T*)a.k,
          *v = (const T*)a.v, *o = (const T*)a.o;
  T *dz = (T*)a.dz, *dO = (T*)a.dO, *dq = (T*)a.dq, *dk = (T*)a.dk, *dv = (T*)a.dv;

  // chain top: partials 0 fs, 1 fb, 2 s2, 3 b2
  chain_top_bwd<T>(g, a.z, a.s2, a.b2, a.fs, a.eps2, a.B, a.L, d, nch, dr, dz, a.part, a.part + P, a.part + 2 * P,
                   a.part + 3 * P, st);
  wgrad<T>(dz, o, M, d, hd, a.wpart, a.wcap, (T*)a.dwfc, st);
  gemm_nn<T, EPI_STORE>(dz, wfc, dO, M, hd, d, st);  // dO = dz . Wfc
  attention_bwd<T>(q, k, v, o, dO, a.lse, a.B, a.nhead, a.L, a.L, hd, dr, a.Dsum, dq, dk, dv, st);
  wgrad<T>(dq, r, M, hd, d, a.wpart, a.wcap, (T*)a.dwq, st);
  wgrad<T>(dk, r, M, hd, d, a.wpart, a.wcap, (T*)a.dwk, st);
  wgrad<T>(dv, y, M, hd, d, a.wpart, a.wcap, (T*)a.dwv, st);
  const T* dqk[2] = {dq, dk};
  const T* wqk[2] = {wq, wk};
  gemm_nn<T, EPI_STORE_F32>(2, dqk, wqk, a.dr, M, d, hd, st);  // dr = dq.Wq + dk.Wk, the joined form
  gemm_nn<T, EPI_STORE_F32>(dv, wv, a.dyv, M, d, hd, st);
  // dx = g + LN1_bwd(rot^T(dr) + dyv): partials 4 s1, 5 b1
  rows_bwd<T>(a.dr, (const T*)a.cos_t, (const T*)a.ssin_t, a.dyv, x, a.s1, a.eps1, g, nullptr, a.B, a.L, d, nch,
              (T*)a.dx, a.part + 4 * P, a.part + 5 * P, st);
  reduce_per_batch(a.part, a.B, nch, d, a.vec, st);              // vec[0] = dfs (B, d)
  reduce_per_batch(a.part + P, a.B, nch, d, a.vec + V, st);      // vec[1] = dfb
  for (int i = 2; i < 6; ++i) reduce_all(a.part + i * P, a.B, nch, d, a.vec + i * V, st);
  return launch_status();
}

// The attention alone, forward and backward, as K3 and K4 run it: q
// (B, Lq, hd), k/v (B, Lk, hd), nhead heads of hd / nhead. Not on the
// train path (K3 and K4 launch it inside their sequences); it lets the
// attention be held against its plain version and timed by itself.
struct AttnTrainArgs {
  const void *q, *k, *v, *seeds;
  void *o, *dO, *dq, *dk, *dv;
  float *lse, *Dsum;
  int B, Lq, Lk, hd, nhead, drop_on;
  float dscale;
  uint32_t thresh;
};

template <typename T>
int attn_train_fwd(const AttnTrainArgs& a, cudaStream_t st) {
  attention_fwd<T>((const T*)a.q, (const T*)a.k, (const T*)a.v, a.B, a.nhead, a.Lq, a.Lk, a.hd,
                   make_drop(a.seeds, a.thresh, a.dscale, a.drop_on), (T*)a.o, a.lse, st);
  return launch_status();
}

template <typename T>
int attn_train_bwd(const AttnTrainArgs& a, cudaStream_t st) {
  attention_bwd<T>((const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.o, (const T*)a.dO, a.lse,
                   a.B, a.nhead, a.Lq, a.Lk, a.hd, make_drop(a.seeds, a.thresh, a.dscale, a.drop_on),
                   a.Dsum, (T*)a.dq, (T*)a.dk, (T*)a.dv, st);
  return (int)cudaGetLastError();
}

}  // namespace tcd

// dtype: 0 = float32, 1 = bfloat16. Returns the launches' status (launch_status).
extern "C" int tcd_sa_train_fwd(int dtype, const tcd::SaTrainArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return tcd::sa_fwd<float>(*a, st);
  if (dtype == 1) return tcd::sa_fwd<__nv_bfloat16>(*a, st);
  return -1;
}

extern "C" int tcd_sa_train_bwd(int dtype, const tcd::SaTrainArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return tcd::sa_bwd<float>(*a, st);
  if (dtype == 1) return tcd::sa_bwd<__nv_bfloat16>(*a, st);
  return -1;
}

extern "C" int tcd_attn_train_fwd(int dtype, const tcd::AttnTrainArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return tcd::attn_train_fwd<float>(*a, st);
  if (dtype == 1) return tcd::attn_train_fwd<__nv_bfloat16>(*a, st);
  return -1;
}

extern "C" int tcd_attn_train_bwd(int dtype, const tcd::AttnTrainArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return tcd::attn_train_bwd<float>(*a, st);
  if (dtype == 1) return tcd::attn_train_bwd<__nv_bfloat16>(*a, st);
  return -1;
}
