// The forward projections C[M, N] = A[M, K] . W[N, K]^T (W in nn.Linear
// layout) with the epilogues of common.cuh: bf16 on the tensor cores,
// f32 on the FMA body of common.cuh (the tensor cores take f32 only as
// TF32, which would break the f32 agreement with the plain versions).
//
// Replaces the FMA tiles of gemm_kernel in every bf16 forward projection:
// inside K1 (tcdiff_tpu/ops/fused_sa_block.py::fused_sa_block: q, k, v and
// fc) and K2 (tcdiff_tpu/ops/fused_ff_block.py::fused_ff_tail: W1, W2, W3),
// and so also in K2b, K6, K7, K8, K9 and the forward of K3-K5, whose TPU
// kernels run these products on the MXU.
//
// What bounds it on the H100: one 3600 x 512 x 512 product is 1.9 GFLOP
// against ~3.7 MB of operands and output in bf16, 1.9 us at the 989
// TFLOP/s bf16 peak against 1.1 us of HBM traffic: operations, and so the
// tensor cores (the FMA tiles reached ~24 TFLOP/s).
//
// Design: mma.sync.m16n8k16 (bf16 operands, f32 sums) with the building
// blocks of mma.cuh that the attention proved on this card. wgmma with TMA
// is the way to the full rate; these products are small (<= 3.8 GFLOP, a
// few waves of tiles) and the serving path around them is host-bound, so
// the simpler mma.sync body comes first.
// - A block of 8 warps owns a 128 x 128 tile of C, each warp 64 x 32 of
//   it: 16 mma per 6 ldmatrix.x4 per k16 step, 64 f32 sums a thread. The
//   tile was chosen by measurement (tools/torch_gemm_tiles.py): the
//   128 x 64 and 64 x 64 tiles moved their operands from L2 into the SMs
//   at up to ~4 TB/s, the most any tile reached, and 128 x 128 with K
//   steps of 64, which moves a third fewer bytes per product, was the
//   fastest at every serving shape, though at M = 3600, N = 512 it makes
//   29 x 4 = 116 blocks, less than one wave of 132 SMs, where 128 x 64
//   makes 232. What holds the 128 x 128 loop itself (near 200 TFLOP/s at
//   M = 28800) is not measured: no profiler of the SM's pipes runs on the
//   card here.
// - K in steps of 64 through a ring of 3 stages in dynamic shared memory
//   (108 KB, 2 blocks an SM), filled by 16-byte cp.async: two tiles are in
//   flight while one is multiplied, and a step of 64 halves the barriers
//   of a step of 32. Both operands stay bf16; rows are padded by 8
//   elements (144 bytes), so the 8 rows an ldmatrix reads fall in 8
//   different bank quads.
// - W stored (N, K) is already the mma's "col" operand: its tiles load
//   n-major like A's and feed frag_b with no transpose.
// - Ragged edges: rows past M or N and columns past K are zero-filled
//   copies (src_bytes = 0); where K % 8 != 0 or an operand is not 16-byte
//   aligned, the tiles are filled by 2-byte loads (load_tile of mma.cuh).
// - The epilogue runs on the C fragments in registers (rows g and g+8,
//   columns 2t and 2t+1 of each 16 x 8 tile) through epi_math of
//   common.cuh, so every rounding point is the FMA body's; a 16-row slice
//   at a time, its loads (bias, FiLM rows, residual) before its stores,
//   and the two columns of a thread loaded and stored together.
// - Grouped form: up to 3 (A, W, C) triples that share M, N, K and the
//   epilogue's other arguments run in one launch whose grid covers the
//   joined N, each block picking its triple from blockIdx.x (K1's q, k and
//   v: 3 x 4 x 29 = 348 blocks instead of three launches of 116).
#pragma once

#include "mma.cuh"

namespace tcd {

constexpr int PBM = 128, PBN = 128, PBK = 64;  // block tile and K step
constexpr int PWN = 4;                         // warps along N (2 along M): 64 x 32 each
constexpr int PT = 32 * 2 * PWN;               // threads of a block
constexpr int PSTAGES = 3;                     // cp.async ring depth
constexpr int PLD = PBK + 8;                   // shared row stride, elements
constexpr int PGROUP = 3;                      // most triples of one launch
constexpr int PROJ_SMEM = PSTAGES * (PBM + PBN) * PLD * (int)sizeof(bf16);

struct ProjGroup {
  const bf16* a[PGROUP];
  const bf16* w[PGROUP];
  void* c[PGROUP];
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// epi_load of elements (m, n) and (m, n + 1), n even, with pair loads; the
// bias pair is given.
template <int EPI>
__device__ __forceinline__ void epi_load2(const EpiArgs& ep, int N, int m, int n, float2 bias, EpiIn& in0,
                                          EpiIn& in1) {
  in0.bias = bias.x;
  in1.bias = bias.y;
  if (epi_film<EPI>()) {
    const size_t f = (size_t)(m / ep.L) * N + n;
    const float2 r = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(ep.resid) + (size_t)m * N + n));
    const float2 s = *reinterpret_cast<const float2*>(ep.fs + f);
    const float2 b = *reinterpret_cast<const float2*>(ep.fb + f);
    in0.resid = r.x;
    in1.resid = r.y;
    in0.fs = s.x;
    in1.fs = s.y;
    in0.fb = b.x;
    in1.fb = b.y;
  }
}

// epi_store of elements o and o + 1 of one row, o even and every output
// 8-byte aligned: the same roundings, one store per output.
template <int EPI>
__device__ __forceinline__ void epi_store2(const EpiArgs& ep, size_t o, EpiVal r0, EpiVal r1) {
  if ((EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_FILM) && ep.c2) store2(ep.c2 + o, r0.c2, r1.c2);
  store2(static_cast<EpiOut<bf16, EPI>*>(ep.c) + o, r0.c, r1.c);
}

// Grid (G * ntn, cdiv(M, PBM)): block x of triple x / ntn, columns
// (x % ntn) * PBN onwards; ep.c is replaced by the triple's C.
template <int EPI>
__global__ void __launch_bounds__(PT, 2)
gemm_mma_kernel(ProjGroup p, EpiArgs ep, int M, int N, int K, int ntn, bool vec) {
  extern __shared__ __align__(16) unsigned char tcd_smem[];
  bf16* sm = reinterpret_cast<bf16*>(tcd_smem);
  const int g = blockIdx.x / ntn, n0 = (blockIdx.x % ntn) * PBN, m0 = blockIdx.y * PBM;
  const bf16* A = g == 0 ? p.a[0] : g == 1 ? p.a[1] : p.a[2];
  const bf16* W = g == 0 ? p.w[0] : g == 1 ? p.w[1] : p.w[2];
  ep.c = g == 0 ? p.c[0] : g == 1 ? p.c[1] : p.c[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp / PWN) * 64, wn = (warp % PWN) * 32;
  const FragOff f = frag_off(lane);
  const int nk = (K + PBK - 1) / PBK;

  // K step kt into ring slot kt % PSTAGES: A's rows, then W's
  auto load = [&](int kt) {
    bf16* s = sm + (kt % PSTAGES) * (PBM + PBN) * PLD;
    const int k0 = kt * PBK;
    load_tile<PBM, PBK, PT>(s, A + k0, K, m0, M, K - k0, vec);
    load_tile<PBN, PBK, PT>(s + PBM * PLD, W + k0, K, n0, N, K - k0, vec);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < PSTAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();  // one group per step, empty or not, so the wait counts steps
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<PSTAGES - 2>();  // step kt has landed
    __syncthreads();               // ... for every thread, and slot (kt - 1) % PSTAGES is free
    if (kt + PSTAGES - 1 < nk) load(kt + PSTAGES - 1);
    cp_async_commit();
    const bf16* As = sm + (kt % PSTAGES) * (PBM + PBN) * PLD;
    const bf16* Ws = As + PBM * PLD;
#pragma unroll
    for (int kk = 0; kk < PBK; kk += 16) {
      uint32_t af[4][4], bw[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldsm_x4(af[i], As + (wm + 16 * i + f.ra) * PLD + kk + f.ca);
#pragma unroll
      for (int j = 0; j < 2; ++j) ldsm_x4(bw[j], Ws + (wn + 16 * j + f.rb) * PLD + kk + f.cb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma16816(acc[i][2 * j], af[i], bw[j][0], bw[j][1]);
          mma16816(acc[i][2 * j + 1], af[i], bw[j][2], bw[j][3]);
        }
    }
  }

  // Epilogue, one 16-row slice at a time: the slice's loads first (all in
  // flight together), its arithmetic, then its stores. Where every array
  // allows it (N even, 8-byte aligned; the residual 4-byte aligned), the
  // columns 2t and 2t+1 of a row load and store as pairs, and the bias
  // pairs load once; else element by element.
  const int gr = lane >> 2, t = lane & 3;
  auto al = [](const void* q, int b) { return reinterpret_cast<uintptr_t>(q) % b == 0; };
  const bool pairs = N % 2 == 0 && al(ep.c, 8) && al(ep.c2, 8) && al(ep.bias, 8) && al(ep.fs, 8) &&
                     al(ep.fb, 8) && al(ep.resid, 4);
  float2 bias2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + 8 * j + 2 * t;
    bias2[j] = epi_bias<EPI>() && pairs && n < N ? *reinterpret_cast<const float2*>(ep.bias + n)
                                                 : float2{0.f, 0.f};
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    EpiVal r[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + gr + 8 * h, n = n0 + wn + 8 * j + 2 * t;
        if (m >= M || n >= N) continue;  // nor is it stored
        EpiIn in0{0.f, 0.f, 0.f, 0.f}, in1 = in0;
        if (pairs) {
          epi_load2<EPI>(ep, N, m, n, bias2[j], in0, in1);
        } else {
          in0 = epi_load<bf16, EPI>(ep, N, m, n);
          if (n + 1 < N) in1 = epi_load<bf16, EPI>(ep, N, m, n + 1);
        }
        r[j][2 * h] = epi_math<bf16, EPI>(ep, N, m, n, acc[i][j][2 * h], in0);
        r[j][2 * h + 1] =
            n + 1 < N ? epi_math<bf16, EPI>(ep, N, m, n + 1, acc[i][j][2 * h + 1], in1) : EpiVal{0.f, 0.f};
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + gr + 8 * h, n = n0 + wn + 8 * j + 2 * t;
        if (m >= M || n >= N) continue;
        if (pairs) {
          epi_store2<EPI>(ep, (size_t)m * N + n, r[j][2 * h], r[j][2 * h + 1]);
        } else {
          epi_store<bf16, EPI>(ep, M, N, m, n, 0, r[j][2 * h]);
          if (n + 1 < N) epi_store<bf16, EPI>(ep, M, N, m, n + 1, 0, r[j][2 * h + 1]);
        }
      }
  }
}

// C[g] = A[g] . W[g]^T for g < G (<= PGROUP), one launch in bf16 (the
// tensor cores), one FMA launch per triple in f32.
template <typename T, int EPI>
inline void gemm_group(int G, const T* const* A, const T* const* W, void* const* C, int M, int N, int K,
                       EpiArgs ep, cudaStream_t st) {
  static_assert(EPI != EPI_PARTIAL && EPI != EPI_ACC_F32,
                "the backward's epilogues run on the FMA body (gemm_t)");
  if constexpr (std::is_same<T, bf16>::value) {
    ProjGroup p{};
    bool vec = K % 8 == 0;
    for (int g = 0; g < G; ++g) {
      p.a[g] = A[g];
      p.w[g] = W[g];
      p.c[g] = C[g];
      vec = vec && reinterpret_cast<uintptr_t>(A[g]) % 16 == 0 && reinterpret_cast<uintptr_t>(W[g]) % 16 == 0;
    }
    const int ntn = cdiv(N, PBN);
    launch_mma(gemm_mma_kernel<EPI>, dim3(G * ntn, cdiv(M, PBM)), PT, PROJ_SMEM, st, p, ep, M, N, K, ntn, vec);
  } else {
    for (int g = 0; g < G; ++g) {
      ep.c = C[g];
      gemm_t<T, false, true, EPI>(A[g], W[g], M, N, K, ep, st);
    }
  }
}

// C = A . W^T, W in nn.Linear layout (N, K): the forward projections.
template <typename T, int EPI>
inline void gemm(const T* A, const T* W, int M, int N, int K, EpiArgs ep, cudaStream_t st) {
  gemm_group<T, EPI>(1, &A, &W, &ep.c, M, N, K, ep, st);
}

}  // namespace tcd
