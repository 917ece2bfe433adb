// The bf16 products of every kernel on the tensor cores, in the three
// layouts of a linear layer y = x . W^T (W in nn.Linear layout (N, K)),
// with the epilogues of common.cuh; f32 runs the FMA body of common.cuh
// (the tensor cores take f32 only as TF32, which would break the f32
// agreement with the plain versions):
//   forward          C[M, N] = A[M, K] . W[N, K]^T      gemm, gemm_group
//   input gradient   C[M, N] = A[M, K] . B[K, N]        gemm_nn
//   weight gradient  dW[N, K] = sum_r G[r, n] . X[r, k]  wgrad
//
// Replaces the FMA tiles of gemm_kernel in every bf16 product: the forward
// projections inside K1 (tcdiff_tpu/ops/fused_sa_block.py::fused_sa_block:
// q, k, v and fc) and K2 (tcdiff_tpu/ops/fused_ff_block.py::fused_ff_tail:
// W1, W2, W3), and so also in K2b, K6, K7, K8, K9 and the forward of
// K3-K5; and the backward's products of K5
// (tcdiff_tpu/ops/fused_ff_block_train.py::_ff_train_bwd_kernel: dy4, dad,
// dy and dW3, dW2, dW1) and K3 (fused_sa_block_train.py: dO, dr, dyv and
// dWfc, dWq, dWk, dWv), and so of K4. The TPU kernels run all of them on
// the MXU, bf16 operands with f32 sums (preferred_element_type=f32).
//
// What bounds it on the H100: one 3600 x 512 x 512 product is 1.9 GFLOP
// against ~3.7 MB of operands and output in bf16, 1.9 us at the 989
// TFLOP/s bf16 peak against 1.1 us of HBM traffic: operations, and so the
// tensor cores (the FMA tiles reached ~24 TFLOP/s). The train shapes (M =
// b L = 28800) are 8x larger, further on the side of operations.
//
// Design: mma.sync.m16n8k16 (bf16 operands, f32 sums) with the building
// blocks of mma.cuh that the attention proved on this card. wgmma with TMA
// is the way to the full rate; the simpler mma.sync body comes first.
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
//   (102-108 KB, 2 blocks an SM), filled by 16-byte cp.async: two tiles
//   are in flight while one is multiplied, and a step of 64 halves the
//   barriers of a step of 32. Both operands stay bf16; rows are padded by
//   8 elements, so the 8 rows an ldmatrix reads fall in 8 different bank
//   quads.
// - One body for the three layouts. Each operand's tile is stored as the
//   operand lies in memory: "m-major" (rows along M or N, K contiguous:
//   the forward's A and W, the input gradient's A) or "k-major" (rows
//   along K: the input gradient's B = W read as (K, N), both operands of
//   the weight gradient, whose K is the b L rows). An m-major tile gives
//   its fragments through ldmatrix, a k-major one through ldmatrix.trans
//   (as the attention's p.v reads V), so no operand is transposed in
//   memory. W stored (N, K) is already the forward's "col" operand.
// - Ragged edges: rows past M, N or K and columns past them are
//   zero-filled copies (src_bytes = 0); where a row of an operand is not a
//   multiple of 8 elements or an operand is not 16-byte aligned, the tiles
//   are filled by 2-byte loads (load_tile of mma.cuh).
// - The epilogue runs on the C fragments in registers (rows g and g+8,
//   columns 2t and 2t+1 of each 16 x 8 tile) through epi_math of
//   common.cuh, so every rounding point is the FMA body's; a 16-row slice
//   at a time, its loads (bias, FiLM rows, residual) before its stores,
//   and the two columns of a thread loaded and stored together.
// - Grouped form (forward): up to 3 (A, W, C) triples that share M, N, K
//   and the epilogue's other arguments run in one launch whose grid covers
//   the joined N, each block picking its triple from blockIdx.x (K1's q, k
//   and v: 3 x 4 x 29 = 348 blocks instead of three launches of 116).
// - Joined form (input gradient): C = A0 . B0 + A1 . B1 in one launch,
//   the K loop running over both pairs into the same f32 sums (K3's
//   dr = dq . Wq + dk . Wk). This was chosen over a second launch that
//   adds into C: it saves an f32 (M, N) read and write (59 MB at M =
//   28800, N = 512), and the sum keeps one rounding, at the end.
// - Weight gradient: the b L rows are the K of the product, cut into
//   `splits` chunks (blockIdx.z) whose f32 partials (EPI_PARTIAL) a second
//   pass adds in chunk order, so a run repeats bit for bit (no atomics, no
//   sum across blocks in flight). The split count is chosen for one wave
//   of 2 blocks an SM: tiles x splits ~ WGRAD_BLOCKS = 264 (wgrad_splits);
//   at 512 x 512 that is 16 tiles x 16 chunks of 1800 rows at M = 28800,
//   where one split per 512 rows made 56 and wrote and read 56 MB of
//   partials per gradient. Measured (tools/torch_gemm_tiles.py, M =
//   28800): 512 x 512 in 67.6 us with 16 chunks, 79.0 with 8 (one block an
//   SM), 97.2 with 56; 1024 x 512 in 119 us with 8 chunks, 146 with 4.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "mma.cuh"

namespace tcd {

constexpr int PBM = 128, PBN = 128, PBK = 64;  // block tile and K step
constexpr int PWN = 4;                         // warps along N (2 along M): 64 x 32 each
constexpr int PT = 32 * 2 * PWN;               // threads of a block
constexpr int PSTAGES = 3;                     // cp.async ring depth
constexpr int PGROUP = 3;                      // most triples of one launch
constexpr int WGRAD_BLOCKS = 264;              // blocks of a weight gradient: one wave, 2 an SM of the H100

// Elements of an operand's shared tile: ROWS (M or N) rows of the K step
// (m-major) or PBK rows of ROWS (k-major), each padded by 8.
template <bool KMAJOR, int ROWS>
__host__ __device__ constexpr int tile_elems() {
  return KMAJOR ? PBK * (ROWS + 8) : ROWS * (PBK + 8);
}
template <bool KA, bool KB>
__host__ __device__ constexpr int mma_smem() {
  return PSTAGES * (tile_elems<KA, PBM>() + tile_elems<KB, PBN>()) * (int)sizeof(bf16);
}

// Up to PGROUP operand pairs and outputs: a grouped launch's triples, or
// the joined pairs of one output.
struct ProjGroup {
  const bf16* a[PGROUP];
  const bf16* w[PGROUP];
  void* c[PGROUP];
};

// p[i] for a runtime i < PGROUP, without indexing the kernel's parameters
// (which would copy them to local memory).
template <typename P>
__device__ __forceinline__ P pick(const P (&p)[PGROUP], int i) {
  return i == 0 ? p[0] : i == 1 ? p[1] : p[2];
}

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

// epi_store of elements o and o + 1 of one output, o even and every output
// 8-byte aligned: the same roundings, one store per output (EPI_ACC_F32:
// one pair load and one pair store).
template <int EPI>
__device__ __forceinline__ void epi_store2(const EpiArgs& ep, size_t o, EpiVal r0, EpiVal r1) {
  if ((EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_FILM) && ep.c2) store2(ep.c2 + o, r0.c2, r1.c2);
  EpiOut<bf16, EPI>* c = static_cast<EpiOut<bf16, EPI>*>(ep.c) + o;
  if constexpr (EPI == EPI_ACC_F32) {
    const float2 v = *reinterpret_cast<const float2*>(c);
    store2(c, v.x + r0.c, v.y + r1.c);
  } else {
    store2(c, r0.c, r1.c);
  }
}

// acc = the warp's 64 x 32 piece of this block's tile of A . B over the K
// rows [kb, ke), through the ring of PSTAGES stages at sm (layouts as
// gemm_mma_kernel's; g: the triple whose A and B the block reads; join >
// 1 runs the pairs 0 .. join-1 in turn into the same sums).
template <bool KA, bool KB>
__device__ __forceinline__ void mma_loop(bf16* sm, const ProjGroup& p, int g, int M, int N, int K, int m0, int n0,
                                         int kb, int ke, int join, bool vec, float (&acc)[4][4][4]) {
  constexpr int A_ELEMS = tile_elems<KA, PBM>(), STAGE = A_ELEMS + tile_elems<KB, PBN>();
  constexpr int LDA = KA ? PBM + 8 : PBK + 8, LDB = KB ? PBN + 8 : PBK + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp / PWN) * 64, wn = (warp % PWN) * 32;
  const FragOff f = frag_off(lane);
  const int nk = (ke - kb + PBK - 1) / PBK, steps = join * nk;

  // K step kt into ring slot kt % PSTAGES: A's tile, then B's
  auto load = [&](int kt) {
    bf16* s = sm + (kt % PSTAGES) * STAGE;
    const int j = join > 1 ? kt / nk : g, k0 = kb + (kt - (join > 1 ? j : 0) * nk) * PBK;
    const bf16 *A = pick(p.a, j), *B = pick(p.w, j);
    if constexpr (KA)
      load_tile<PBK, PBM, PT>(s, A + m0, M, k0, ke, M - m0, vec);
    else
      load_tile<PBM, PBK, PT>(s, A + k0, K, m0, M, ke - k0, vec);
    if constexpr (KB)
      load_tile<PBK, PBN, PT>(s + A_ELEMS, B + n0, N, k0, ke, N - n0, vec);
    else
      load_tile<PBN, PBK, PT>(s + A_ELEMS, B + k0, K, n0, N, ke - k0, vec);
  };

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < PSTAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();  // one group per step, empty or not, so the wait counts steps
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<PSTAGES - 2>();  // step kt has landed
    __syncthreads();               // ... for every thread, and slot (kt - 1) % PSTAGES is free
    if (kt + PSTAGES - 1 < steps) load(kt + PSTAGES - 1);
    cp_async_commit();
    const bf16* As = sm + (kt % PSTAGES) * STAGE;
    const bf16* Bs = As + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < PBK; kk += 16) {
      uint32_t af[4][4], bw[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (KA)  // k-major: the A fragment's four 8 x 8 pieces, transposed
          ldsm_x4_t(af[i], As + (kk + f.rb) * LDA + wm + 16 * i + f.cb);
        else
          ldsm_x4(af[i], As + (wm + 16 * i + f.ra) * LDA + kk + f.ca);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (KB)  // k-major: the B fragments of two n-tiles, transposed
          ldsm_x4_t(bw[j], Bs + (kk + f.ra) * LDB + wn + 16 * j + f.ca);
        else
          ldsm_x4(bw[j], Bs + (wn + 16 * j + f.rb) * LDB + kk + f.cb);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma16816(acc[i][2 * j], af[i], bw[j][0], bw[j][1]);
          mma16816(acc[i][2 * j + 1], af[i], bw[j][2], bw[j][3]);
        }
    }
  }
}

// C[M, N] = sum over the K chunk of A . B, tiles of PBM x PBN, grid
// (G * ntn, cdiv(M, PBM), splits). KA: A is stored (K, M), else (M, K);
// KB: B is stored (K, N), else (N, K); both row-major. Block x belongs to
// triple g = x / ntn, columns (x % ntn) * PBN onwards, and writes p.c[g];
// with join > 1 (and G = 1) the K loop runs over the pairs 0 .. join-1 in
// turn. Block z sums K rows [z kchunk, (z + 1) kchunk) (EPI_PARTIAL writes
// slice z of C). vec: every operand row can be copied in 16-byte pieces.
template <int EPI, bool KA, bool KB>
__global__ void __launch_bounds__(PT, 2)
gemm_mma_kernel(ProjGroup p, EpiArgs ep, int M, int N, int K, int ntn, int kchunk, int join, bool vec) {
  extern __shared__ __align__(16) unsigned char tcd_smem[];
  const int g = blockIdx.x / ntn, n0 = (blockIdx.x % ntn) * PBN, m0 = blockIdx.y * PBM;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
  ep.c = pick(p.c, g);
  float acc[4][4][4];
  mma_loop<KA, KB>(reinterpret_cast<bf16*>(tcd_smem), p, g, M, N, K, m0, n0, kb, ke, join, vec, acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp / PWN) * 64, wn = (warp % PWN) * 32;

  // Epilogue, one 16-row slice at a time: the slice's loads first (all in
  // flight together), its arithmetic, then its stores. Where every array
  // allows it (N even, 8-byte aligned; the residual 4-byte aligned), the
  // columns 2t and 2t+1 of a row load and store as pairs, and the bias
  // pairs load once; else element by element.
  const int gr = lane >> 2, t = lane & 3;
  const size_t zo = EPI == EPI_PARTIAL ? (size_t)blockIdx.z * M * N : 0;  // this chunk's slice
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
          epi_store2<EPI>(ep, zo + (size_t)m * N + n, r[j][2 * h], r[j][2 * h + 1]);
        } else {
          epi_store<bf16, EPI>(ep, M, N, m, n, blockIdx.z, r[j][2 * h]);
          if (n + 1 < N) epi_store<bf16, EPI>(ep, M, N, m, n + 1, blockIdx.z, r[j][2 * h + 1]);
        }
      }
  }
}

// Whether a pointer is 16-byte aligned.
inline bool al16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

// One launch of the tensor-core body: G triples (or one output over `join`
// pairs) of the layout <KA, KB>, `splits` chunks of `kchunk` along K.
template <int EPI, bool KA, bool KB>
inline void launch_gemm_mma(const ProjGroup& p, int G, int join, EpiArgs ep, int M, int N, int K, int kchunk,
                            int splits, cudaStream_t st) {
  bool vec = (KA ? M : K) % 8 == 0 && (KB ? N : K) % 8 == 0;
  for (int i = 0; i < std::max(G, join); ++i) vec = vec && al16(p.a[i]) && al16(p.w[i]);
  const int ntn = cdiv(N, PBN);
  launch_mma(gemm_mma_kernel<EPI, KA, KB>, dim3(G * ntn, cdiv(M, PBM), splits), PT, mma_smem<KA, KB>(), st,
             p, ep, M, N, K, ntn, kchunk, join, vec);
}

// C[g] = A[g] . W[g]^T for g < G (<= PGROUP), one launch in bf16 (the
// tensor cores), one FMA launch per triple in f32.
template <typename T, int EPI>
inline void gemm_group(int G, const T* const* A, const T* const* W, void* const* C, int M, int N, int K,
                       EpiArgs ep, cudaStream_t st) {
  static_assert(EPI != EPI_PARTIAL && EPI != EPI_ACC_F32, "the backward's epilogues: gemm_nn and wgrad");
  if constexpr (std::is_same<T, bf16>::value) {
    ProjGroup p{};
    for (int g = 0; g < G; ++g) {
      p.a[g] = A[g];
      p.w[g] = W[g];
      p.c[g] = C[g];
    }
    launch_gemm_mma<EPI, false, false>(p, G, 1, ep, M, N, K, K, 1, st);
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

// --------------------------------------- LayerNorm in the epilogue (bf16)
// A LayerNorm after a product whose N output columns are the LayerNorm's
// row (the attention blocks' fc, K2's W2) needs whole rows, and a block
// holds PBN columns of one. gemm_ln launches the product as clusters of
// cdiv(N, PBN) <= LN_CLUSTER blocks along N (4 at d = 512, so the grid of
// 29 x 4 blocks at M = 3600 stays), so a cluster holds PBM whole rows, and
// each block's epilogue:
//   1. sums its columns' (x, x^2) per row, within a quad by shuffles and
//      over the 4 warps along N in shared memory, in a fixed order;
//   2. cluster.sync(), then adds the cluster's partials of the row, read
//      through distributed shared memory in rank order, so every block of
//      the cluster gets the same statistics, and a run repeats bit for bit;
//   3. applies the LayerNorm (and the FiLM residual) to the C fragments in
//      registers and stores the result in T (bf16);
//   4. where a second LayerNorm follows on that rounded result (K6's LN2
//      with the rotary, its LN3), repeats 1-3 on it;
//   5. runs a last cluster.sync(), so that no block leaves while a peer
//      still reads its shared memory.
// The ring's shared memory is free after the K loop and holds the
// statistics. The rounding points are the unfused sequence's: the product
// (and FiLM before LN4) in f32, T after the LayerNorm, LN2 on the rounded
// output; the rotary pair (n, n + 1) lies within one thread's C fragment
// (columns 2t and 2t + 1), so the rotation needs no shuffle. What it
// saves: the f32 (M, N) store and reload of the product (z, zc, o32:
// 7.4 MB each at M = 3600, d = 512) and the row kernels' launches.
constexpr int LN_CLUSTER = 8;  // the portable cluster size: N <= 1024

enum LnEpi {
  LN_POST = 0,      // out = T(LN(acc)), or T(resid + (fs[b] + 1) * LN(acc) + fb[b]) with fs
  LN_FILM_PRE = 1,  // out = T(LN(resid + (fs[b] + 1) * (acc + bias) + fb[b]))
};
enum Ln2 {
  LN2_NONE = 0,
  LN2_PLAIN = 1,  // out2 = T(LN2(out))
  LN2_ROT = 2,    // out2 = T(LN2(out) * cos + swap_pairs(LN2(out)) * ssin)
};

struct LnFold {
  bf16* out;               // (M, N)
  const float *s, *b;      // the LayerNorm's affine (N,)
  float eps;
  const float* bias;       // LN_FILM_PRE: the product's bias (N,)
  const bf16* resid;       // FiLM residual (M, N)
  const float *fs, *fb;    // FiLM rows (M / L, N); LN_POST: null, none
  int L;                   // rows m = b L + l
  const float *s2, *b2;    // the second LayerNorm's affine (N,)
  float eps2;
  const bf16 *cos, *ssin;  // LN2_ROT: the rotary tables (L, N)
  bf16* out2;              // (M, N)
};

// The statistics of the PBM rows of this block's cluster for v, the
// threads' C-shaped values (zero past N): (mu, rsqrt(var + eps)) of row r
// of the block into stat[r], returned. red: 6 PBM float2 of shared memory
// that no other call uses (the warps' partials, the block's, stat).
__device__ __forceinline__ const float2* cluster_row_stats(const float (&v)[4][4][4], float2* red, int N,
                                                           float eps) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = (warp / PWN) * 64, wcol = warp % PWN;
  float2 *part = red, *own = red + PWN * PBM, *stat = own + PBM;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = v[i][j][2 * h + e];
          s += x;
          ss += x * x;
        }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {  // the quad of the row
        s += __shfl_xor_sync(0xffffffffu, s, o);
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      }
      if (t == 0) part[wcol * PBM + wm + 16 * i + g + 8 * h] = make_float2(s, ss);
    }
  __syncthreads();
  if (threadIdx.x < PBM) {
    float2 a = part[threadIdx.x];
    for (int w = 1; w < PWN; ++w) {
      const float2 q = part[w * PBM + threadIdx.x];
      a.x += q.x;
      a.y += q.y;
    }
    own[threadIdx.x] = a;
  }
  cluster.sync();  // every block's partials are in place
  if (threadIdx.x < PBM) {
    float s = 0.f, ss = 0.f;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r) {
      const float2 q = *cluster.map_shared_rank(own + threadIdx.x, r);
      s += q.x;
      ss += q.y;
    }
    const float mu = s / N;
    stat[threadIdx.x] = make_float2(mu, rsqrtf(ss / N - mu * mu + eps));
  }
  __syncthreads();
  return stat;
}

// Pairs of the fold's read-only operands, through the non-coherent path.
__device__ __forceinline__ float2 ld_f2(const float* q) { return __ldg(reinterpret_cast<const float2*>(q)); }
__device__ __forceinline__ float2 ld_b2(const bf16* q) {
  const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(q));
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// out (and out2) = the LayerNorm fold of A . W^T, W (N, K) in nn.Linear
// layout; grid (cdiv(N, PBN), cdiv(M, PBM)) in clusters of cdiv(N, PBN)
// along x. N is even and every epilogue operand aligned for pairs (gemm_ln
// checks). A thread holds rows wm + 16 i + g + 8 h (i < 4, h < 2) and the
// column pairs wn + 8 j + 2 t (j < 4) of the block's tile; the epilogue
// runs per row group (i, h), its loads before its arithmetic and stores.
// (Storing all groups after all groups' arithmetic, so that no store
// stands between two groups' loads, was measured no faster: at 2 blocks
// an SM it spills, at 1 it matches this order; tools/torch_ln_time.py.)
template <int LNE, int LN2>
__global__ void __launch_bounds__(PT, 2)
gemm_ln_kernel(ProjGroup p, LnFold f, int M, int N, int K, bool vec) {
  extern __shared__ __align__(16) unsigned char tcd_smem[];
  const int n0 = blockIdx.x * PBN, m0 = blockIdx.y * PBM;
  float acc[4][4][4];
  mma_loop<false, false>(reinterpret_cast<bf16*>(tcd_smem), p, 0, M, N, K, m0, n0, 0, K, 1, vec, acc);
  cp_async_wait<0>();
  __syncthreads();  // every warp is past its last ldmatrix: the ring is free
  float2* red = reinterpret_cast<float2*>(tcd_smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = (warp / PWN) * 64, wn = (warp % PWN) * 32;
  auto row = [&](int i, int h) { return m0 + wm + 16 * i + g + 8 * h; };
  auto col = [&](int j) { return n0 + wn + 8 * j + 2 * t; };
  const float2 zero2 = make_float2(0.f, 0.f);

  // The LayerNorm's input in acc: the product (zero past M and N, as the
  // zero-filled tiles make it), or LN_FILM_PRE's f32 FiLM residual.
  if constexpr (LNE == LN_FILM_PRE) {
    float2 bb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = col(j) < N ? ld_f2(f.bias + col(j)) : zero2;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row(i, h);
        float2 rr[4], f1[4], f2[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = col(j);
          const bool in = m < M && n < N;
          const size_t fr = (size_t)(m / f.L) * N + n;
          rr[j] = in ? ld_b2(f.resid + (size_t)m * N + n) : zero2;
          f1[j] = in ? ld_f2(f.fs + fr) : zero2;
          f2[j] = in ? ld_f2(f.fb + fr) : zero2;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = m < M && col(j) < N;
          float &a0 = acc[i][j][2 * h], &a1 = acc[i][j][2 * h + 1];
          a0 = in ? rr[j].x + (f1[j].x + 1.f) * (a0 + bb[j].x) + f2[j].x : 0.f;
          a1 = in ? rr[j].y + (f1[j].y + 1.f) * (a1 + bb[j].y) + f2[j].y : 0.f;
        }
      }
  }

  // LN [+ FiLM residual], stored in T; acc becomes the rounded output,
  // zero past N (the second LayerNorm's input)
  {
    const float2* stat = cluster_row_stats(acc, red, N, f.eps);
    const bool film = LNE == LN_POST && f.fs != nullptr;
    float2 sc[4], bi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sc[j] = col(j) < N ? ld_f2(f.s + col(j)) : zero2;
      bi[j] = col(j) < N ? ld_f2(f.b + col(j)) : zero2;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row(i, h);
        const float2 ms = stat[m - m0];
        float2 rr[4], f1[4], f2[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = col(j);
          const bool in = film && m < M && n < N;
          const size_t fr = (size_t)(m / f.L) * N + n;
          rr[j] = in ? ld_b2(f.resid + (size_t)m * N + n) : zero2;
          f1[j] = in ? ld_f2(f.fs + fr) : zero2;
          f2[j] = in ? ld_f2(f.fb + fr) : zero2;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = col(j);
          float &a0 = acc[i][j][2 * h], &a1 = acc[i][j][2 * h + 1];
          float y0 = (a0 - ms.x) * ms.y * sc[j].x + bi[j].x;
          float y1 = (a1 - ms.x) * ms.y * sc[j].y + bi[j].y;
          if (film) {
            y0 = rr[j].x + (f1[j].x + 1.f) * y0 + f2[j].x;
            y1 = rr[j].y + (f1[j].y + 1.f) * y1 + f2[j].y;
          }
          const __nv_bfloat162 o = __floats2bfloat162_rn(y0, y1);
          if (m < M && n < N) *reinterpret_cast<__nv_bfloat162*>(f.out + (size_t)m * N + n) = o;
          const float2 r = __bfloat1622float2(o);
          a0 = n < N ? r.x : 0.f;
          a1 = n < N ? r.y : 0.f;
        }
      }
  }

  if constexpr (LN2 != LN2_NONE) {
    const float2* stat = cluster_row_stats(acc, red + 6 * PBM, N, f.eps2);
    float2 sc[4], bi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sc[j] = col(j) < N ? ld_f2(f.s2 + col(j)) : zero2;
      bi[j] = col(j) < N ? ld_f2(f.b2 + col(j)) : zero2;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row(i, h);
        const float2 ms = stat[m - m0];
        float2 cs[4], sn[4];
        if constexpr (LN2 == LN2_ROT) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = col(j);
            const bool in = m < M && n < N;
            const size_t tr = (size_t)(m % f.L) * N + n;
            cs[j] = in ? ld_b2(f.cos + tr) : zero2;
            sn[j] = in ? ld_b2(f.ssin + tr) : zero2;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float y0 = (acc[i][j][2 * h] - ms.x) * ms.y * sc[j].x + bi[j].x;
          float y1 = (acc[i][j][2 * h + 1] - ms.x) * ms.y * sc[j].y + bi[j].y;
          if constexpr (LN2 == LN2_ROT) {
            const float r0 = y0 * cs[j].x + y1 * sn[j].x;
            const float r1 = y1 * cs[j].y + y0 * sn[j].y;
            y0 = r0;
            y1 = r1;
          }
          const int n = col(j);
          if (m < M && n < N)
            *reinterpret_cast<__nv_bfloat162*>(f.out2 + (size_t)m * N + n) = __floats2bfloat162_rn(y0, y1);
        }
      }
  }
  cooperative_groups::this_cluster().sync();  // no block leaves while a peer reads its statistics
}

// The LayerNorm fold of out = A . W^T (A (M, K), W (N, K), bf16): one
// cluster launch; refused (launch_status) where N is odd or above
// LN_CLUSTER * PBN, or an epilogue operand is not aligned for pairs.
template <int LNE, int LN2>
inline void gemm_ln(const bf16* A, const bf16* W, int M, int N, int K, const LnFold& f, cudaStream_t st) {
  const int ntn = cdiv(N, PBN);
  const bool ok = N % 2 == 0 && ntn <= LN_CLUSTER && aligned(f.out, 4) && aligned(f.out2, 4) &&
                  aligned(f.resid, 4) && aligned(f.cos, 4) && aligned(f.ssin, 4) && aligned(f.s, 8) &&
                  aligned(f.b, 8) && aligned(f.s2, 8) && aligned(f.b2, 8) && aligned(f.bias, 8) &&
                  aligned(f.fs, 8) && aligned(f.fb, 8);
  if (!ok) return refuse();
  ProjGroup p{};
  p.a[0] = A;
  p.w[0] = W;
  const bool vec = K % 8 == 0 && al16(A) && al16(W);
  const int bytes = mma_smem<false, false>();
  auto kernel = gemm_ln_kernel<LNE, LN2>;
  allow_smem(reinterpret_cast<const void*>(kernel), bytes);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ntn, cdiv(M, PBM), 1);
  cfg.blockDim = dim3(PT, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ntn;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p, f, M, N, K, vec);
  if (e != cudaSuccess) refuse(e);
}

// C[M, N] = sum_{j < J} A[j] . B[j], A[j] (M, K) and B[j] (K, N) row-major
// (B a weight in nn.Linear layout: the input gradient of y = x B^T), J <=
// 2, with EPI_STORE, EPI_STORE_F32 or EPI_ACC_F32 (C += the sum). bf16:
// one launch, the K loop over the J pairs (the joined form); f32: one FMA
// launch per pair, the later ones adding into C (so J > 1 needs an f32 C).
template <typename T, int EPI>
inline void gemm_nn(int J, const T* const* A, const T* const* B, void* C, int M, int N, int K, cudaStream_t st) {
  static_assert(EPI == EPI_STORE || EPI == EPI_STORE_F32 || EPI == EPI_ACC_F32,
                "the input gradient stores or adds its product");
  if constexpr (std::is_same<T, bf16>::value) {
    ProjGroup p{};
    for (int j = 0; j < J; ++j) {
      p.a[j] = A[j];
      p.w[j] = B[j];
    }
    p.c[0] = C;
    launch_gemm_mma<EPI, false, true>(p, 1, J, epi(C), M, N, K, K, 1, st);
  } else {
    gemm_t<T, false, false, EPI>(A[0], B[0], M, N, K, epi(C), st);
    for (int j = 1; j < J; ++j) gemm_t<T, false, false, EPI_ACC_F32>(A[j], B[j], M, N, K, epi(C), st);
  }
}
template <typename T, int EPI>
inline void gemm_nn(const T* A, const T* B, void* C, int M, int N, int K, cudaStream_t st) {
  gemm_nn<T, EPI>(1, &A, &B, C, M, N, K, st);
}

// out[g * cols + j] = sum_{i < n} part[(g * n + i) * cols + j] in f32, in a
// fixed order. A block of C columns x W row walkers (blockDim (C, W), C W
// >= 256): walker w adds rows w, w + W, w + 2W, ... into four running sums
// in turn (four loads in flight), the sums are added as (s0 + s1) + (s2 +
// s3), and then the W walkers' sums in order of w. W depends on n alone,
// so a run repeats bit for bit. With one walker per column each load
// waits on the last: the train step's reductions of b L / 16 row-chunk
// partials (2 blocks of 512 columns each) took 11 ms a step so.
template <typename TO>
__global__ void reduce_kernel(const float* __restrict__ part, int n, size_t cols, TO* __restrict__ out) {
  __shared__ float sums[32 * 33];  // W rows of C + 1: at most 32 x 33 or 1 x 257
  const int c = threadIdx.x, w = threadIdx.y, C = blockDim.x, W = blockDim.y;
  const size_t j = (size_t)blockIdx.x * C + c;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (j < cols) {
    const float* p = part + (size_t)blockIdx.y * n * cols + j;
    int i = w;
    for (; i + 3 * W < n; i += 4 * W) {
      a0 += p[(size_t)i * cols];
      a1 += p[(size_t)(i + W) * cols];
      a2 += p[(size_t)(i + 2 * W) * cols];
      a3 += p[(size_t)(i + 3 * W) * cols];
    }
    for (; i < n; i += W) a0 += p[(size_t)i * cols];
  }
  sums[w * (C + 1) + c] = (a0 + a1) + (a2 + a3);
  __syncthreads();
  if (w == 0 && j < cols) {
    float t = 0.f;
    for (int v = 0; v < W; ++v) t += sums[v * (C + 1) + c];
    out[(size_t)blockIdx.y * cols + j] = from_f<TO>(t);
  }
}

// Sum `groups` stacks of n partial rows of `cols` values each: W walkers
// of about 16 rows each (at most 32), over 256 / W columns rounded down to
// a multiple of a warp (at least 32).
template <typename TO>
inline void reduce(const float* part, int groups, int n, size_t cols, TO* out, cudaStream_t st) {
  const int W = std::min(32, std::max(1, n / 16)), C = std::max(32, 256 / W / 32 * 32);
  reduce_kernel<TO><<<dim3((unsigned)((cols + C - 1) / C), groups), dim3(C, W), 0, st>>>(part, n, cols, out);
}

// The row chunks a weight gradient over R rows aims at: about one wave
// of WGRAD_BLOCKS blocks (2 an SM) over the (N, K) gradient's 128 x 128
// tiles.
// ops/train_common.py::weight_splits computes the same (and the chunking
// of wgrad) to size the partials; a shape alone fixes the count, so a run
// repeats bit for bit.
inline int wgrad_splits(int R, int N, int K) {
  return std::max(1, std::min(WGRAD_BLOCKS / (cdiv(N, PBM) * cdiv(K, PBN)), cdiv(R, PBK)));
}

// dW (N, K) = sum_r G[r, n] * X[r, k] for G (R, N), X (R, K): the weight
// gradient of an nn.Linear layer, y = x W^T. The R rows are cut into
// chunks of a multiple of the K step (about wgrad_splits of them, or
// `splits` where given > 0) whose f32 partials go to `part`, then are
// added in order and cast to T. `cap`: the floats `part` holds; the chunks
// grow if they would not fit.
template <typename T>
inline void wgrad(const T* G, const T* X, int R, int N, int K, float* part, size_t cap, T* out, cudaStream_t st,
                  int splits = 0) {
  int n = splits > 0 ? splits : wgrad_splits(R, N, K);
  n = (int)std::max<size_t>(1, std::min<size_t>(n, cap / ((size_t)N * K)));  // what `part` holds
  const int rchunk = cdiv(cdiv(R, n), PBK) * PBK;
  n = cdiv(R, rchunk);
  if constexpr (std::is_same<T, bf16>::value) {
    ProjGroup p{};
    p.a[0] = G;
    p.w[0] = X;
    p.c[0] = part;
    launch_gemm_mma<EPI_PARTIAL, true, true>(p, 1, 1, epi(part), N, K, R, rchunk, n, st);
  } else {
    gemm_t<T, true, false, EPI_PARTIAL>(G, X, N, K, R, epi(part), st, rchunk);
  }
  reduce<T>(part, 1, n, (size_t)N * K, out, st);
}

}  // namespace tcd
