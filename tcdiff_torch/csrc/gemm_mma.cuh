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
// 1 runs the pairs 0 .. join-1 in turn into the same sums); zero = false
// adds to acc as it stands (the ring must then be free: no warp still
// reading it, no copy into it in flight).
template <bool KA, bool KB>
__device__ __forceinline__ void mma_loop(bf16* sm, const ProjGroup& p, int g, int M, int N, int K, int m0, int n0,
                                         int kb, int ke, int join, bool vec, float (&acc)[4][4][4],
                                         bool zero = true) {
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

  if (zero) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

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

// Launches of each product body in this library since it was loaded, on
// the host as they are enqueued: gemm_mma_kernel here, the wgmma body of
// gemm_wgmma.cuh there (the libraries that include it export the counts).
// Internal linkage: a static in an inline function would be one object
// for every library of the process (the dynamic linker unifies them).
enum Body { BODY_MMA = 0, BODY_WGMMA = 1 };
static inline long long* body_launches() {
  static long long n[2] = {0, 0};
  return n;
}

// One launch of the tensor-core body: G triples (or one output over `join`
// pairs) of the layout <KA, KB>, `splits` chunks of `kchunk` along K.
template <int EPI, bool KA, bool KB>
inline void launch_gemm_mma(const ProjGroup& p, int G, int join, EpiArgs ep, int M, int N, int K, int kchunk,
                            int splits, cudaStream_t st) {
  ++body_launches()[BODY_MMA];
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
  ++body_launches()[BODY_MMA];
  ProjGroup p{};
  p.a[0] = A;
  p.w[0] = W;
  const bool vec = K % 8 == 0 && al16(A) && al16(W);
  launch_mma_cluster(gemm_ln_kernel<LNE, LN2>, dim3(ntn, cdiv(M, PBM)), ntn, PT, mma_smem<false, false>(), st, p, f,
                     M, N, K, vec);
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
// tiles, times G where G gradients share the launch.
// ops/train_common.py::weight_splits computes the same (and the chunking
// of wgrad) to size the partials; a shape alone fixes the count, so a run
// repeats bit for bit.
inline int wgrad_splits(int R, int N, int K, int G = 1) {
  return std::max(1, std::min(WGRAD_BLOCKS / (G * cdiv(N, PBM) * cdiv(K, PBN)), cdiv(R, PBK)));
}

// dW[g] (N, K) = sum_r G[g][r, n] * X[g][r, k] for g < NG (<= PGROUP), G[g]
// (R, N), X[g] (R, K): the weight gradients of nn.Linear layers, y = x W^T,
// over the same R rows. The rows are cut into chunks of a multiple of the
// K step (about wgrad_splits of them, or `splits` where given > 0), whose
// f32 partials go to `part`, gradient g's n chunks at part + g n N K; then
// one reduction adds each gradient's chunks in order and casts them to T
// into out, (NG, N, K) contiguous. bf16: one launch of the NG products'
// chunks together (K4's dWk and dWv: one wave of both); f32: one FMA
// launch per product. `cap`: the floats `part` holds; the chunks grow if
// they would not fit.
template <typename T>
inline void wgrad_group(int NG, const T* const* G, const T* const* X, int R, int N, int K, float* part, size_t cap,
                        T* out, cudaStream_t st, int splits = 0) {
  int n = splits > 0 ? splits : wgrad_splits(R, N, K, NG);
  n = (int)std::max<size_t>(1, std::min<size_t>(n, cap / ((size_t)NG * N * K)));  // what `part` holds
  const int rchunk = cdiv(cdiv(R, n), PBK) * PBK;
  n = cdiv(R, rchunk);
  const size_t slice = (size_t)n * N * K;  // one gradient's partials
  if constexpr (std::is_same<T, bf16>::value) {
    ProjGroup p{};
    for (int g = 0; g < NG; ++g) {
      p.a[g] = G[g];
      p.w[g] = X[g];
      p.c[g] = part + g * slice;
    }
    launch_gemm_mma<EPI_PARTIAL, true, true>(p, NG, 1, epi(part), N, K, R, rchunk, n, st);
  } else {
    for (int g = 0; g < NG; ++g)
      gemm_t<T, true, false, EPI_PARTIAL>(G[g], X[g], N, K, R, epi(part + g * slice), st, rchunk);
  }
  reduce<T>(part, NG, n, (size_t)N * K, out, st);
}

// One weight gradient dW (N, K) = G^T X (wgrad_group of one).
template <typename T>
inline void wgrad(const T* G, const T* X, int R, int N, int K, float* part, size_t cap, T* out, cudaStream_t st,
                  int splits = 0) {
  wgrad_group<T>(1, &G, &X, R, N, K, part, cap, out, st, splits);
}

// ------------------------------------------- the memory cotangent (bf16)
// C (M, N) = T(rot^T(A0 . B0) + A1 . B1), A (M, K) and B (K, N) row-major
// (the input gradient's layout), rot^T(g) = g * cos + swap_pairs(g * ssin)
// with the tables' row m % L: K4's memory cotangent
// dmem = rot_m^T(dk . Wk) + dv . Wv, in the order of the TPU kernel
// (tcdiff_tpu/ops/fused_ca_block_train.py, _ca_bwd_projm_kernel: drm kept
// in f32, _rot_t applied, dv . Wv added, one rounding). One launch of the
// input-gradient body: the K loop over A0 . B0 into the f32 sums, rot^T on
// them in registers (the pair (2t, 2t + 1) of a row lies in one thread's C
// fragment), the K loop over A1 . B1 into the same sums, then the store.
// This replaces two products into f32 scratch (drm, dvm: 2 x 19.9 MB at
// 9728 x 512) and a row pass that read both back.
template <typename T>  // bf16
__global__ void __launch_bounds__(PT, 2)
gemm_rot_nn_kernel(ProjGroup p, const T* __restrict__ cos_t, const T* __restrict__ ssin_t, int L, int M, int N, int K,
                   bool vec, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char tcd_smem[];
  bf16* sm = reinterpret_cast<bf16*>(tcd_smem);
  const int n0 = blockIdx.x * PBN, m0 = blockIdx.y * PBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int wm = (warp / PWN) * 64, wn = (warp % PWN) * 32;
  float acc[4][4][4];
  mma_loop<false, true>(sm, p, 0, M, N, K, m0, n0, 0, K, 1, vec, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + gr + 8 * h;
      if (m >= M) continue;  // nor is it stored
      const size_t tr = (size_t)(m % L) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * t;
        if (n >= N) continue;
        const float2 cs = ld_b2(cos_t + tr + n), sn = ld_b2(ssin_t + tr + n);
        float &a0 = acc[i][j][2 * h], &a1 = acc[i][j][2 * h + 1];
        const float g0 = a0, g1 = a1;
        a0 = g0 * cs.x + g1 * sn.y;
        a1 = g1 * cs.y + g0 * sn.x;
      }
    }
  cp_async_wait<0>();
  __syncthreads();  // every warp is past its last ldmatrix: the ring is free for the second product
  mma_loop<false, true>(sm, p, 1, M, N, K, m0, n0, 0, K, 1, vec, acc, false);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + gr + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * t;
        if (n < N) store2(out + (size_t)m * N + n, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// The memory cotangent above: one launch; refused (launch_status) where N
// is odd or an output or table row is not 4-byte aligned. T: bf16 (a
// template, so that only the sources that launch it compile its kernel).
template <typename T>
inline void gemm_nn_rot(const T* A0, const T* B0, const T* A1, const T* B1, const T* cos_t, const T* ssin_t, int L,
                        int M, int N, int K, T* out, cudaStream_t st) {
  static_assert(std::is_same<T, bf16>::value, "f32 keeps the unfused sequence");
  if (N % 2 || !aligned(out, 4) || !aligned(cos_t, 4) || !aligned(ssin_t, 4)) return refuse();
  ProjGroup p{};
  p.a[0] = A0;
  p.w[0] = B0;
  p.a[1] = A1;
  p.w[1] = B1;
  const bool vec = K % 8 == 0 && N % 8 == 0 && al16(A0) && al16(B0) && al16(A1) && al16(B1);
  launch_mma(gemm_rot_nn_kernel<T>, dim3(cdiv(N, PBN), cdiv(M, PBM)), PT, mma_smem<false, true>(), st, p, cos_t,
             ssin_t, L, M, N, K, vec, out);
}

// ------------------------- LayerNorm and rotary in the prologue (bf16)
// q = T(rot(LN(x; eps))) . W^T for x (M, d) and W (N, d), W in nn.Linear
// layout, the rotary tables' row m % L: K7's q projection with the
// LayerNorm and the rotary of its input in the prologue, so that
// rot(LN(x)) (r, 3600 x 512 in T at the serving shape) never leaves the
// SMs and its row launch goes. The function of
// tcdiff_tpu/ops/fused_ln_rotary_matmul.py::fused_ln_rotary_matmul with
// w_plain=None (_kernel_rot_only).
//
// A block of PT threads owns BM = 32 MI rows (128 at d <= 512, 64 at
// d <= 1024) by PBN columns of q, each warp 16 MI rows by 32 columns. The
// cdiv(N, PBN) <= LN_CLUSTER blocks of a row tile run as one cluster along
// N (4 at N = 512, so the grid of 29 x 4 blocks at M = 3600 stays), and
// each normalises 1 / cs of the tile's rows:
//   1. cp.async: the ring's first PSTAGES - 1 K steps of W, so that those
//      loads run under 2;
//   2. one warp a row, ln_rows' arithmetic (ln_add, ln_stat, ln_y,
//      rot_pair of common.cuh) in its chunk and shuffle order, on the rows
//      r = rank + cs j of the tile; the rounded T(rot(LN)) goes to the
//      resident tile (BM rows of d) of every block of the cluster, through
//      distributed shared memory. The templated body reads each row and
//      its tables from device memory rows ahead, so that a warp's rows
//      start while the later ones are in flight; the general body
//      stages its rows of x (d padded to the K step with zeros), works in
//      place and then copies each row to the peers;
//   3. cluster.sync(): every tile is whole; the K loop of mma_loop, A's
//      fragments from the resident tile, W's through the ring;
//   4. T(acc) stored in pairs.
// With the same A values and K order as ln_rows + gemm, q is the same
// bits. Each row is normalised once, by one block of its cluster: a
// block that normalised the whole tile alone would spend 4x the prologue
// at N = 512, more than ln_rows' launch costs. BM x (d + 8) of x and the
// ring take ~184 KB (one block an SM), which the grid's single wave
// affords.
constexpr int LNROT_MAX_D = 1024;

__host__ __device__ constexpr int lnrot_kp(int d) { return (d + PBK - 1) / PBK * PBK; }  // d padded to the K step
__host__ __device__ constexpr int lnrot_ld(int d) { return lnrot_kp(d) + 8; }
inline int lnrot_smem(int d, int mi) {
  return (32 * mi * lnrot_ld(d) + PSTAGES * tile_elems<false, PBN>()) * (int)sizeof(bf16);
}

// MI: m16 tiles a warp along M (BM = 32 MI); EPL: ln_rows' elements a lane
// (d / 32 for d = 64 .. 1024, 0: its general body).
template <int MI, int EPL>
__global__ void __launch_bounds__(PT, 1)
gemm_lnrot_kernel(const bf16* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
                  float eps, const bf16* __restrict__ cos_t, const bf16* __restrict__ ssin_t, int L,
                  const bf16* __restrict__ W, int M, int N, int d, bool xvec, bool wvec, bf16* __restrict__ out) {
  constexpr int BM = 32 * MI, BSTAGE = tile_elems<false, PBN>(), LDB = PBK + 8;
  extern __shared__ __align__(16) unsigned char tcd_smem[];
  const int KP = lnrot_kp(d), LDX = KP + 8, nk = KP / PBK;
  bf16* xs = reinterpret_cast<bf16*>(tcd_smem);  // BM x LDX: x, then T(rot(LN(x)))
  bf16* ring = xs + BM * LDX;
  const int n0 = blockIdx.x * PBN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the cluster's cs blocks share the tile's rows: this block's are
  // r = rank + cs j, a warp's r = rank + cs warp + RS i
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank(), RS = cs * (PT / 32);
  cluster_arrive_relaxed();  // this block has started: its peers may write its tile (cluster_wait below)

  // 1. the ring's first steps, in flight under the prologue; the general
  // body also stages its rows of x whole (d padded to the K step with zeros)
  auto load = [&](int kt) {
    load_tile<PBN, PBK, PT>(ring + (kt % PSTAGES) * BSTAGE, W + kt * PBK, d, n0, N, d - kt * PBK, wvec);
  };
  if constexpr (EPL == 0) {
    const int cpr = KP / 8;  // 16-byte pieces a row
    for (int idx = threadIdx.x; idx < (BM - rank + cs - 1) / cs * cpr; idx += PT) {
      const int r = rank + cs * (idx / cpr), c = (idx % cpr) * 8, m = m0 + r;
      bf16* dst = xs + r * LDX + c;
      if (xvec) {
        const bool ok = m < M && c < d;
        cp_async16(dst, ok ? x + (size_t)m * d + c : x, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = m < M && c + e < d ? x[(size_t)m * d + c + e] : __float2bfloat16(0.f);
      }
    }
  }
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < PSTAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }

  // 2. the LayerNorm and the rotary, one warp a row
  if constexpr (EPL > 0) {
    // d = 32 EPL is a multiple of the K step: no padding. A warp reads its
    // rows of x from device memory, with the row's tables, PF rows ahead,
    // so that their latency runs under the rows before; rows past M are
    // zeros.
    constexpr int VW = EPL < 8 ? EPL : 8, NC = EPL / VW;
    float sc[NC][VW], bi[NC][VW];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      ld_vec<VW>(scale + (c * 32 + lane) * VW, sc[c]);
      ld_vec<VW>(bias + (c * 32 + lane) * VW, bi[c]);
    }
    // a row and its tables as raw bf16 words, PF rows ahead of the one
    // being normalised (slot i: row r + RS i); widened as ld_vec widens.
    // At d = 1024 three rows of words spill (BM = 64 there, so a warp of a
    // cluster of 4 has 2 rows): one row ahead.
    constexpr int NW = VW / 2, PF = EPL >= 32 ? 1 : 3;
    uint32_t px[PF][NC][NW], pc[PF][NC][NW], ps[PF][NC][NW];
    auto load_row = [&](int m, uint32_t (&wx)[NC][NW], uint32_t (&wc)[NC][NW], uint32_t (&ws)[NC][NW]) {
      const size_t tr = (size_t)(m % L) * d;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = (c * 32 + lane) * VW;
        ld_words<NW>(x + (size_t)m * d + col, wx[c]);
        ld_words<NW>(cos_t + tr + col, wc[c]);
        ld_words<NW>(ssin_t + tr + col, ws[c]);
      }
    };
    auto widen = [](uint32_t w, int hi) { return __uint_as_float(hi ? w & 0xffff0000u : w << 16); };
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int r = rank + cs * warp + RS * i;
      if (r < BM && m0 + r < M) load_row(m0 + r, px[i], pc[i], ps[i]);
    }
    cluster_wait();  // every peer has started
    for (int r = rank + cs * warp; r < BM; r += RS) {
      const int m = m0 + r;
      bf16* row = xs + r * LDX;
      if (m >= M) {
        const float zero[VW] = {};
        for (int q = 0; q < cs; ++q)
#pragma unroll
          for (int c = 0; c < NC; ++c) st_vec<VW>(cluster.map_shared_rank(row, q) + (c * 32 + lane) * VW, zero);
        continue;
      }
      uint32_t cx[NC][NW], cc[NC][NW], cn[NC][NW];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          cx[c][k] = px[0][c][k];
          cc[c][k] = pc[0][c][k];
          cn[c][k] = ps[0][c][k];
#pragma unroll
          for (int i = 0; i + 1 < PF; ++i) {
            px[i][c][k] = px[i + 1][c][k];
            pc[i][c][k] = pc[i + 1][c][k];
            ps[i][c][k] = ps[i + 1][c][k];
          }
        }
      if (r + RS * PF < BM && m + RS * PF < M) load_row(m + RS * PF, px[PF - 1], pc[PF - 1], ps[PF - 1]);
      float v[NC][VW];
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          v[c][e] = widen(cx[c][e / 2], e & 1);
          ln_add(v[c][e], s, ss);
        }
      const LnStat st = ln_stat(s, ss, d, eps);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float y[VW], o[VW];
#pragma unroll
        for (int e = 0; e < VW; ++e) y[e] = ln_y(v[c][e], st, sc[c][e], bi[c][e]);
#pragma unroll
        for (int e = 0; e < VW; e += 2)
          rot_pair(y[e], y[e + 1], widen(cc[c][e / 2], 0), widen(cc[c][e / 2], 1), widen(cn[c][e / 2], 0),
                   widen(cn[c][e / 2], 1), o[e], o[e + 1]);
        for (int q = 0; q < cs; ++q) st_vec<VW>(cluster.map_shared_rank(row, q) + (c * 32 + lane) * VW, o);
      }
    }
  } else {
    cp_async_wait<PSTAGES - 1>();  // x has landed
    __syncthreads();
    cluster_wait();  // every peer has started
    for (int r = rank + cs * warp; r < BM; r += RS) {
      const int m = m0 + r;
      bf16* row = xs + r * LDX;
      if (m < M) {
        float s = 0.f, ss = 0.f;
        for (int c = lane; c < d; c += 32) ln_add(__bfloat162float(row[c]), s, ss);
        const LnStat st = ln_stat(s, ss, d, eps);
        const size_t tr = (size_t)(m % L) * d;
        for (int q = lane; q < d / 2; q += 32) {
          const int c0 = 2 * q, c1 = c0 + 1;
          const float y0 = ln_y(__bfloat162float(row[c0]), st, scale[c0], bias[c0]);
          const float y1 = ln_y(__bfloat162float(row[c1]), st, scale[c1], bias[c1]);
          float r0, r1;
          rot_pair(y0, y1, __bfloat162float(cos_t[tr + c0]), __bfloat162float(cos_t[tr + c1]),
                   __bfloat162float(ssin_t[tr + c0]), __bfloat162float(ssin_t[tr + c1]), r0, r1);
          row[c0] = __float2bfloat16(r0);
          row[c1] = __float2bfloat16(r1);
        }
      }
      __syncwarp();  // the row (zeros past M) to the peers' tiles, in 16-byte pieces
      for (int q = 1; q < cs; ++q) {
        uint4* dst = reinterpret_cast<uint4*>(cluster.map_shared_rank(row, (rank + q) % cs));
        for (int c = lane; c < KP / 8; c += 32) dst[c] = reinterpret_cast<const uint4*>(row)[c];
      }
    }
  }
  cluster.sync();  // every block's A is in place

  // 3. the K loop: A from the resident tile, W through the ring
  const int wm = (warp / PWN) * 16 * MI, wn = (warp % PWN) * 32;
  const FragOff f = frag_off(lane);
  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<PSTAGES - 2>();  // step kt has landed
    __syncthreads();               // ... for every thread, and slot (kt - 1) % PSTAGES is free
    if (kt + PSTAGES - 1 < nk) load(kt + PSTAGES - 1);
    cp_async_commit();
    const bf16* Bs = ring + (kt % PSTAGES) * BSTAGE;
#pragma unroll
    for (int kk = 0; kk < PBK; kk += 16) {
      uint32_t af[MI][4], bw[2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) ldsm_x4(af[i], xs + (wm + 16 * i + f.ra) * LDX + kt * PBK + kk + f.ca);
#pragma unroll
      for (int j = 0; j < 2; ++j) ldsm_x4(bw[j], Bs + (wn + 16 * j + f.rb) * LDB + kk + f.cb);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma16816(acc[i][2 * j], af[i], bw[j][0], bw[j][1]);
          mma16816(acc[i][2 * j + 1], af[i], bw[j][2], bw[j][3]);
        }
    }
  }

  // 4. the store
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + gr + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * t;
        if (n < N) store2(out + (size_t)m * N + n, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// out (M, N) = T(rot(LN(x; eps))) . W^T, one cluster launch (above);
// refused (launch_status) for an odd d or N, d > LNROT_MAX_D, N above
// LN_CLUSTER * PBN, or an output not 4-byte aligned, as a LayerNorm fold
// is. The LayerNorm's order is
// ln_rows': its templated body where d is 64 .. 1024 and the affine and
// the tables are 16-byte aligned, else its general one. T: bf16 (a
// template, so that only the sources that launch it compile its kernels).
template <typename T>
inline void gemm_lnrot(const T* x, const float* scale, const float* bias, float eps, const T* cos_t, const T* ssin_t,
                       int L, const T* W, int M, int N, int d, T* out, cudaStream_t st) {
  static_assert(std::is_same<T, bf16>::value, "f32 keeps the unfused sequence");
  const int ntn = cdiv(N, PBN);
  if (d % 2 || N % 2 || d > LNROT_MAX_D || ntn > LN_CLUSTER || !aligned(out, 4)) return refuse();
  const bool xvec = d % 8 == 0 && al16(x), wvec = d % 8 == 0 && al16(W);
  const bool tvec = xvec && aligned(scale, 16) && aligned(bias, 16) && aligned(cos_t, 16) && aligned(ssin_t, 16);
  const int mi = lnrot_kp(d) <= 512 ? 4 : 2, bytes = lnrot_smem(d, mi);
#define TCD_LNROT(MI, EPL)                                                                                      \
  do {                                                                                                         \
    launch_mma_cluster(gemm_lnrot_kernel<MI, EPL>, dim3(ntn, cdiv(M, 32 * MI)), ntn, PT, bytes, st, x, scale,  \
                       bias, eps, cos_t, ssin_t, L, W, M, N, d, xvec, wvec, out);                              \
    return;                                                                                                    \
  } while (0)
  switch (tvec ? d : 0) {
    case 64: TCD_LNROT(4, 2);
    case 128: TCD_LNROT(4, 4);
    case 256: TCD_LNROT(4, 8);
    case 512: TCD_LNROT(4, 16);
    case 1024: TCD_LNROT(2, 32);
    default:
      if (mi == 4) TCD_LNROT(4, 0);
      TCD_LNROT(2, 0);
  }
#undef TCD_LNROT
}

}  // namespace tcd
