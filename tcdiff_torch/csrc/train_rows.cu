// The row kernels of the train blocks alone (train_common.cuh:
// chain_top_fwd, chain_top_bwd, rows_bwd), for tests and measurement
// (ops/train_common.py). K3 and K4 launch them inside their sequences, K5
// its rows_bwd; no path calls this entry. The backward ones' partials are
// added here as the blocks add them (reduce_kernel, in chunk order).
#include "train_common.cuh"

// Pointers, then the ints, the floats and the uint32: the layout of the
// ctypes mirror in ops/train_common.py. kind 0: out = chain_top_fwd(z, x;
// s, b, fs, fb); 1: (dz, part) = chain_top_bwd(g, z; s, b, fs), vec (4, B,
// d) = dfs, dfb per batch element, then ds, db in row 0 of slots 2 and 3;
// 2: out = rows_bwd(dr; cos, ssin, dadd, x, s, resT, res32), vec (2, d) =
// ds, db where x is given. part: (4, B * nch, d) f32.
struct RowsArgs {
  const void *z, *x, *g, *dr, *cos, *ssin, *dadd, *resT, *res32;
  const float *s, *b, *fs, *fb;
  const void* seeds;
  void* out;
  float *part, *vec;
  int kind, B, L, d, nch, drop_on;
  float eps, dscale;
  uint32_t thresh;
};

namespace tcd {

template <typename T>
void train_rows(const RowsArgs& a, cudaStream_t st) {
  const Drop dr = make_drop(a.seeds, a.thresh, a.dscale, a.drop_on);
  const size_t P = (size_t)a.B * a.nch * a.d, V = (size_t)a.B * a.d;
  if (a.kind == 0) {
    chain_top_fwd<T>((const float*)a.z, (const T*)a.x, a.s, a.b, a.fs, a.fb, a.eps, a.B, a.L, a.d, a.nch, dr,
                     (T*)a.out, st);
  } else if (a.kind == 1) {
    chain_top_bwd<T>((const T*)a.g, (const float*)a.z, a.s, a.b, a.fs, a.eps, a.B, a.L, a.d, a.nch, dr, (T*)a.out,
                     a.part, a.part + P, a.part + 2 * P, a.part + 3 * P, st);
    reduce_per_batch(a.part, a.B, a.nch, a.d, a.vec, st);
    reduce_per_batch(a.part + P, a.B, a.nch, a.d, a.vec + V, st);
    for (int i = 2; i < 4; ++i) reduce_all(a.part + i * P, a.B, a.nch, a.d, a.vec + i * V, st);
  } else {
    const bool ln = a.x != nullptr;
    rows_bwd<T>((const float*)a.dr, (const T*)a.cos, (const T*)a.ssin, (const float*)a.dadd, (const T*)a.x, a.s,
                a.eps, (const T*)a.resT, (const float*)a.res32, a.B, a.L, a.d, a.nch, (T*)a.out,
                ln ? a.part : nullptr, ln ? a.part + P : nullptr, st);
    if (ln)
      for (int i = 0; i < 2; ++i) reduce_all(a.part + i * P, a.B, a.nch, a.d, a.vec + i * a.d, st);
  }
}

}  // namespace tcd

// dtype: 0 = float32, 1 = bfloat16 (of x, g, out and the tables; z, dr,
// dadd, res32, the affines and the FiLM rows are f32). Returns the
// launches' status (launch_status), -1 for what it does not take.
extern "C" int tcd_train_rows(int dtype, const RowsArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->kind < 0 || a->kind > 2) return -1;
  if (dtype == 0) {
    tcd::train_rows<float>(*a, st);
  } else if (dtype == 1) {
    tcd::train_rows<__nv_bfloat16>(*a, st);
  } else {
    return -1;
  }
  return tcd::launch_status();
}
