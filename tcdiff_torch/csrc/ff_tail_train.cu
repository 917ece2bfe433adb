// Feed-forward block and layer tail of the FiLM decoder layer in training,
// forward and backward, for Hopper (sm_90a).
//
// Replaces tcdiff_tpu/ops/fused_ff_block_train.py::fused_ff_tail_train
// (forward _ff_train_fwd_kernel, backward _ff_train_bwd_kernel):
//
//   y   = LN3(x)                          u  = y.W1^T + b1
//   ad  = drop_FF1(gelu_erf(u))           zd = drop_FF2(ad.W2^T + b2)
//   x2  = x + (fs+1) * zd + fb  (f32)     out = LN4(x2).W3^T + b3
//
// and its gradients to x, W1/W2/W3, the biases, both LayerNorms' affines
// and the FiLM rows; d gelu(u) = Phi(u) + u phi(u).
//
// What bounds it on the H100: at the train shape (b=64, L=450, d=512,
// ff=1024) the forward is 76 GFLOP and the backward twice that, against
// ~60 MB per (b, L, ff) activation in bf16: compute-bound.
//
// Design: the forward is K2's five launches with the dropout folded into
// the GEMM epilogues; it saves y, ad, LN4's output (T) and u, zd, x2 (f32)
// for the backward, which is GEMMs for the input gradients, split-row
// GEMMs plus an ordered reduction for the weight gradients (one wave of
// row chunks; in bf16 all six products on the tensor cores, gemm_mma.cuh:
// gemm_nn and wgrad), and three row
// kernels (LN4 + FiLM + dropout backward, dropout + GELU backward, LN3
// backward with the residual), each writing per-block partial sums of its
// bias / affine / FiLM gradients. The TPU kernel's row blocking and
// recompute exist for its 16 MB VMEM stack and are not carried over.
#include "train_common.cuh"

namespace tcd {

// K5's own row kernels (ff_tail_bwd_rows, gelu_bwd_rows): a block of RT
// threads walks FF_RCH consecutive rows of one batch element (grid
// (cdiv(L, FF_RCH), B)); thread t owns columns t, t + RT, ... (at most CPT
// of them, so a width <= RT * CPT = 1024) and keeps its columns' partial
// gradient sums in registers across the rows. Its last row pass, the LN3
// backward, is the attention blocks' rows_bwd (train_common.cuh) over the
// same nch chunks, so the partials of one backward share their layout
// (ops/ff_block_train.py FF_RCH).
constexpr int RT = 128, CPT = 8, FF_RCH = 16;

// Writes a thread's column partials to row `row` of each given (rows, d) array.
__device__ __forceinline__ void store_partial(float* p, size_t row, int d, const float (&a)[CPT]) {
  if (!p) return;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = threadIdx.x + k * RT;
    if (c < d) p[row * d + c] = a[k];
  }
}

struct FfTrainArgs {
  // inputs
  const void *x;
  const float *s3, *b3;
  const void* w1;
  const float* bb1;
  const void* w2;
  const float *bb2, *fs, *fb, *s4, *b4;
  const void* w3;
  const float* bb3;
  const void* seeds;
  // saved by the forward
  void* y;
  float* u;
  void* ad;
  float *zd, *x2;
  void *y4, *out;
  // backward
  const void* g;
  float *dy4, *dx2;
  void* dz;
  float* dad;
  void* du;
  float* dy;
  void *dx, *dw1, *dw2, *dw3;
  float *part, *part_ff, *wpart, *vec, *vec_ff;
  int B, L, d, ff, wcap, drop_on;
  float eps, dscale;
  uint32_t thresh;
};

// LN4 / FiLM / dropout backward (grid (cdiv(L, FF_RCH), B)): given g = d out
// and dy4 = g.W3 (f32), recompute LN4's statistics of x2; then
//   d b3 += g;  dx2 = LN4_bwd(dy4) (f32 out), d s4 += dy4*xhat, d b4 += dy4
//   d fs += dx2 * zd, d fb += dx2                          (per batch element)
//   dz = drop_FF2(dx2 * (fs+1)) -> T;  d b2 += dz (before rounding)
// Partials: 0 fs, 1 fb, 2 b3, 3 s4, 4 b4, 5 b2 (the vec order of the wrapper).
template <typename T>
__global__ void __launch_bounds__(RT)
ff_tail_bwd_rows_kernel(const T* __restrict__ g, const float* __restrict__ dy4,
                        const float* __restrict__ x2, const float* __restrict__ zd,
                        const float* __restrict__ s4, const float* __restrict__ fs, float eps, int L,
                        int d, Drop dr, float* __restrict__ dx2, T* __restrict__ dz, float* part,
                        size_t P) {
  const int chunk = blockIdx.x, b = blockIdx.y;
  float afs[CPT], afb[CPT], ab3[CPT], as4[CPT], ab4[CPT], ab2[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) afs[k] = afb[k] = ab3[k] = as4[k] = ab4[k] = ab2[k] = 0.f;
  const int l1 = min(L, (chunk + 1) * FF_RCH);
  for (int l = chunk * FF_RCH; l < l1; ++l) {
    const size_t m = (size_t)b * L + l;
    float xh[CPT], gx[CPT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = threadIdx.x + k * RT;
      xh[k] = c < d ? x2[m * d + c] : 0.f;
      s1 += xh[k];
      s2 += xh[k] * xh[k];
    }
    block_sum2(s1, s2);
    const float mu = s1 / d, rs = rsqrtf(s2 / d - mu * mu + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = threadIdx.x + k * RT;
      gx[k] = 0.f;
      if (c >= d) continue;
      xh[k] = (xh[k] - mu) * rs;
      const float gy = dy4[m * d + c];
      ab3[k] += to_f(g[m * d + c]);
      as4[k] += gy * xh[k];
      ab4[k] += gy;
      gx[k] = gy * s4[c];
      m1 += gx[k];
      m2 += gx[k] * xh[k];
    }
    block_sum2(m1, m2);
    m1 /= d;
    m2 /= d;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = threadIdx.x + k * RT;
      if (c >= d) continue;
      const float dxv = rs * (gx[k] - m1 - xh[k] * m2);
      afs[k] += dxv * zd[m * d + c];
      afb[k] += dxv;
      const float dzv = dropv(dxv * (fs[(size_t)b * d + c] + 1.f), dr, b, SALT_FF2, (uint32_t)(l * d + c));
      ab2[k] += dzv;
      dx2[m * d + c] = dxv;
      dz[m * d + c] = from_f<T>(dzv);
    }
  }
  const size_t row = (size_t)b * gridDim.x + chunk;
  store_partial(part, row, d, afs);
  store_partial(part + P, row, d, afb);
  store_partial(part + 2 * P, row, d, ab3);
  store_partial(part + 3 * P, row, d, as4);
  store_partial(part + 4 * P, row, d, ab4);
  store_partial(part + 5 * P, row, d, ab2);
}

// Dropout + GELU backward over the (rows, ff) hidden activation:
//   du = drop_FF1(dad) * (Phi(u) + u phi(u)) -> T;  d b1 += du
template <typename T>
__global__ void __launch_bounds__(RT)
gelu_bwd_rows_kernel(const float* __restrict__ dad, const float* __restrict__ u, int L, int ff,
                     Drop dr, T* __restrict__ du, float* __restrict__ part) {
  const int chunk = blockIdx.x, b = blockIdx.y;
  float ab1[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) ab1[k] = 0.f;
  const int l1 = min(L, (chunk + 1) * FF_RCH);
  for (int l = chunk * FF_RCH; l < l1; ++l) {
    const size_t m = (size_t)b * L + l;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = threadIdx.x + k * RT;
      if (c >= ff) continue;
      const float uu = u[m * ff + c];
      const float cdf = 0.5f * (1.f + erff(uu * 0.70710678118654752f));
      const float pdf = 0.3989422804014327f * expf(-0.5f * uu * uu);
      const float v = dropv(dad[m * ff + c], dr, b, SALT_FF1, (uint32_t)(l * ff + c)) * (cdf + uu * pdf);
      ab1[k] += v;
      du[m * ff + c] = from_f<T>(v);
    }
  }
  store_partial(part, (size_t)b * gridDim.x + chunk, ff, ab1);
}

template <typename T>
int ff_fwd(const FfTrainArgs& a, cudaStream_t st) {
  const int M = a.B * a.L;
  const T* x = (const T*)a.x;
  EpiArgs e1 = epi(a.ad, a.bb1, nullptr, nullptr, nullptr, a.L);
  e1.c2 = a.u;
  e1.dr = make_drop(a.seeds, a.thresh, a.dscale, a.drop_on);
  e1.salt = SALT_FF1;
  EpiArgs e2 = epi(a.x2, a.bb2, x, a.fs, a.fb, a.L);
  e2.c2 = a.zd;
  e2.dr = e1.dr;
  e2.salt = SALT_FF2;
  ln_rows<T, T>(x, a.s3, a.b3, a.eps, M, a.d, a.L, nullptr, nullptr, nullptr, nullptr, nullptr, (T*)a.y,
                nullptr, st);
  gemm<T, EPI_BIAS_GELU>((const T*)a.y, (const T*)a.w1, M, a.ff, a.d, e1, st);
  gemm<T, EPI_BIAS_FILM>((const T*)a.ad, (const T*)a.w2, M, a.d, a.ff, e2, st);
  ln_rows<float, T>(a.x2, a.s4, a.b4, a.eps, M, a.d, a.L, nullptr, nullptr, nullptr, nullptr, nullptr,
                    (T*)a.y4, nullptr, st);
  gemm<T, EPI_BIAS>((const T*)a.y4, (const T*)a.w3, M, a.d, a.d, epi(a.out, a.bb3), st);
  return (int)cudaGetLastError();
}

template <typename T>
int ff_bwd(const FfTrainArgs& a, cudaStream_t st) {
  const int M = a.B * a.L, d = a.d, ff = a.ff, nch = cdiv(a.L, FF_RCH);
  const size_t P = (size_t)a.B * nch * d, V = (size_t)a.B * d;
  const Drop dr = make_drop(a.seeds, a.thresh, a.dscale, a.drop_on);
  const T *x = (const T*)a.x, *g = (const T*)a.g;
  const T *w1 = (const T*)a.w1, *w2 = (const T*)a.w2, *w3 = (const T*)a.w3;
  T *dz = (T*)a.dz, *du = (T*)a.du;
  const dim3 rows(nch, a.B);

  wgrad<T>(g, (const T*)a.y4, M, d, d, a.wpart, a.wcap, (T*)a.dw3, st);
  gemm_nn<T, EPI_STORE_F32>(g, w3, a.dy4, M, d, d, st);  // dy4 = g . W3
  ff_tail_bwd_rows_kernel<T><<<rows, RT, 0, st>>>(g, a.dy4, a.x2, a.zd, a.s4, a.fs, a.eps, a.L, d,
                                                  dr, a.dx2, dz, a.part, P);
  wgrad<T>(dz, (const T*)a.ad, M, d, ff, a.wpart, a.wcap, (T*)a.dw2, st);
  gemm_nn<T, EPI_STORE_F32>(dz, w2, a.dad, M, ff, d, st);  // dad = dz . W2
  gelu_bwd_rows_kernel<T><<<rows, RT, 0, st>>>(a.dad, a.u, a.L, ff, dr, du, a.part_ff);
  wgrad<T>(du, (const T*)a.y, M, ff, d, a.wpart, a.wcap, (T*)a.dw1, st);
  gemm_nn<T, EPI_STORE_F32>(du, w1, a.dy, M, d, ff, st);  // dy = du . W1
  // dx = dx2 + LN3_bwd(dy): partials 6 s3, 7 b3
  rows_bwd<T>(a.dy, nullptr, nullptr, nullptr, x, a.s3, a.eps, nullptr, a.dx2, a.B, a.L, d, nch, (T*)a.dx,
              a.part + 6 * P, a.part + 7 * P, st);
  reduce_per_batch(a.part, a.B, nch, d, a.vec, st);
  reduce_per_batch(a.part + P, a.B, nch, d, a.vec + V, st);
  for (int i = 2; i < 8; ++i) reduce_all(a.part + i * P, a.B, nch, d, a.vec + i * V, st);
  reduce_all(a.part_ff, a.B, nch, ff, a.vec_ff, st);
  return launch_status();
}

}  // namespace tcd

// dtype: 0 = float32, 1 = bfloat16. Return cudaGetLastError() after the launches.
extern "C" int tcd_ff_train_fwd(int dtype, const tcd::FfTrainArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return tcd::ff_fwd<float>(*a, st);
  if (dtype == 1) return tcd::ff_fwd<__nv_bfloat16>(*a, st);
  return -1;
}

extern "C" int tcd_ff_train_bwd(int dtype, const tcd::FfTrainArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return tcd::ff_bwd<float>(*a, st);
  if (dtype == 1) return tcd::ff_bwd<__nv_bfloat16>(*a, st);
  return -1;
}
