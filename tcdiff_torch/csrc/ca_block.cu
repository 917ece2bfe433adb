// Cross-attention block of the FiLM decoder layer on the serving path, for
// Hopper (sm_90a): K7 of the port.
//
// Replaces tcdiff_tpu/ops/fused_ca_block.py::fused_ca_block (the Pallas
// program _ca_block_kernel, one VMEM-resident program per batch element):
//
//   r  = rot(LN(x; eps1))                 on the full model vector, f32
//   q  = T(r).Wq   k = mem_rot.Wk   v = mem.Wv          (bias-free)
//   o  = per-head softmax(T(q * T(1/sqrt(dk))) . k^T) . v   (Lq x Lm)
//   ca = LN(o.Wfc; eps2)      [out = x + (fs+1)*ca + fb]   (optional FiLM)
//
// k comes from the memory rotated beforehand with its own length's angles
// (the caller's apply_rotary), v from the raw memory; there is no TRPE on
// cross-attention. It serves the configuration with the block kernel on
// and the k/v cache off (TCDIFF_PALLAS_XAB=1, TCDIFF_KV_CACHE=0).
//
// What bounds it on the H100: at the serving shape (b=8, L=450, Lm=152,
// d=512, 8x64 heads) 3.8 GFLOP of q and fc, 1.3 GFLOP of k/v and 1.1
// GFLOP of attention against ~10 MB: operations, ~6.2 us at the bf16
// tensor-core peak.
//
// Design, bf16, 4 launches: one grouped launch of the projection
// (gemm_mma.cuh) takes the memory's k and v over its B * Lm rows into T
// (the TPU kernel rounds each head's k and v to the compute dtype); q =
// T(rot(LN(x))).Wq in one launch with the LayerNorm and the rotary in its
// prologue (gemm_lnrot: the blocks of a row tile along N run as one
// cluster, each normalising a share of the tile's rows into every block's
// shared memory, so rot(LN(x)) never goes to device memory); the flash
// attention of attention.cuh with Lq != Lk (as K11 runs it); the fc GEMM
// with the post-LN and the FiLM residual in its epilogue (gemm_ln: a
// cluster along N holds whole rows). f32, 6 launches, keeps the unfused
// sequence: the LN + rotary row kernel into r, q, the attention, fc into
// an f32 scratch and a row kernel. The projections and the attention run on the tensor
// cores in bf16, on the FMA units in f32. K6 (layer.cu) runs the same
// attention and fc steps against the cached k/v.
#include "blocks.cuh"

// Pointers, then the ints, then the floats: the layout of the ctypes
// mirror in ops/ca_block.py. fs/fb null: no FiLM residual.
struct CaBlockArgs {
  const void* x;
  const float *s1, *b1;
  const void *cos, *ssin, *mem, *mrot, *wq, *wk, *wv, *wfc;
  const float *s2, *b2, *fs, *fb;
  void *r, *q, *k, *v, *o;
  float* z;
  void* out;
  int B, L, Lm, d, hd, nhead;
  float eps1, eps2;
};

namespace tcd {

template <typename T>
void ca_block(const CaBlockArgs& a, cudaStream_t st) {
  const int Mm = a.B * a.Lm;
  const T* as[2] = {(const T*)a.mrot, (const T*)a.mem};
  const T* ws[2] = {(const T*)a.wk, (const T*)a.wv};
  void* cs[2] = {a.k, a.v};
  gemm_group<T, EPI_STORE>(2, as, ws, cs, Mm, a.hd, a.d, epi(nullptr), st);
  cross_attention<T>((const T*)a.x, a.s1, a.b1, (const T*)a.cos, (const T*)a.ssin,
                     (const T*)a.k, (const T*)a.v, a.Lm, (const T*)a.wq, (const T*)a.wfc, a.s2,
                     a.b2, a.fs, a.fb, a.B, a.L, a.d, a.hd, a.nhead, a.eps1, a.eps2, (T*)a.r,
                     (T*)a.q, (T*)a.o, a.z, (T*)a.out, st);
}

}  // namespace tcd

// x (B, L, d), mem and mrot (B, Lm, d), d even; cos/ssin (L, d) in T;
// wq/wk/wv (hd, d), wfc (d, hd) in T; LN affines and FiLM rows f32;
// scratch q and o (B*L, hd), k and v (B*Lm, hd) in T; r (B*L, d) in T and
// z (B*L, d) f32, used in f32 only (null in bf16). dtype: 0 = float32, 1 = bfloat16.
// Returns the launches' status (launch_status).
extern "C" int tcd_ca_block(int dtype, const CaBlockArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    tcd::ca_block<float>(*a, st);
  } else if (dtype == 1) {
    tcd::ca_block<__nv_bfloat16>(*a, st);
  } else {
    return -1;
  }
  return tcd::launch_status();
}
