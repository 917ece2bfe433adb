// Tile shapes of the bf16 projection's mma.sync main loop, measured side
// by side (tools/torch_gemm_tiles.py): the loop of csrc/gemm_mma.cuh with
// the block tile BM x BN, the K step BK, WM x WN warps, an ST-stage
// cp.async ring, and a plain bf16 store as the epilogue. PRE loads a K
// step's fragments before its mma instead of per k16 step. A measurement
// tool; the port does not call it.
#include "../tcdiff_torch/csrc/mma.cuh"

namespace tcd {

template <int BM, int BN, int BK, int WM, int WN, int ST, int MINB, bool PRE>
struct Cfg {
  static constexpr int THREADS = 32 * WM * WN, LD = BK + 8, TM = BM / WM, TN = BN / WN, MI = TM / 16,
                       NJ = TN / 16;
  static constexpr int SMEM = ST * (BM + BN) * LD * 2;
};

template <int ROWS, int BK, int THREADS>
__device__ __forceinline__ void ld_tile(bf16* sm, const bf16* gp, int K, int r0, int R, int k0) {
  constexpr int LD = BK + 8, CH = BK / 8;
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx % CH) * 8, gr = r0 + r, gk = k0 + c;
    const bool ok = gr < R && gk < K;
    cp_async16(sm + r * LD + c, ok ? gp + (size_t)gr * K + gk : gp, ok ? 16 : 0);
  }
}

template <class C, int BM, int BN, int BK, int WM, int WN, int ST, int MINB, bool PRE>
__global__ void __launch_bounds__(C::THREADS, MINB)
tile_kernel(const bf16* A, const bf16* W, bf16* Cout, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char tcd_smem[];
  bf16* sm = reinterpret_cast<bf16*>(tcd_smem);
  constexpr int LD = C::LD, MI = C::MI, NJ = C::NJ;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp / WN) * C::TM, wn = (warp % WN) * C::TN;
  const FragOff f = frag_off(lane);
  const int nk = (K + BK - 1) / BK;
  auto load = [&](int kt) {
    bf16* s = sm + (kt % ST) * (BM + BN) * LD;
    ld_tile<BM, BK, C::THREADS>(s, A, K, m0, M, kt * BK);
    ld_tile<BN, BK, C::THREADS>(s + BM * LD, W, K, n0, N, kt * BK);
  };
  float acc[MI][2 * NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (kt + ST - 1 < nk) load(kt + ST - 1);
    cp_async_commit();
    const bf16* As = sm + (kt % ST) * (BM + BN) * LD;
    const bf16* Ws = As + BM * LD;
    if (PRE) {
      uint32_t af[BK / 16][MI][4], bw[BK / 16][NJ][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < MI; ++i) ldsm_x4(af[kk][i], As + (wm + 16 * i + f.ra) * LD + 16 * kk + f.ca);
#pragma unroll
        for (int j = 0; j < NJ; ++j) ldsm_x4(bw[kk][j], Ws + (wn + 16 * j + f.rb) * LD + 16 * kk + f.cb);
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            mma16816(acc[i][2 * j], af[kk][i], bw[kk][j][0], bw[kk][j][1]);
            mma16816(acc[i][2 * j + 1], af[kk][i], bw[kk][j][2], bw[kk][j][3]);
          }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[MI][4], bw[NJ][4];
#pragma unroll
        for (int i = 0; i < MI; ++i) ldsm_x4(af[i], As + (wm + 16 * i + f.ra) * LD + kk + f.ca);
#pragma unroll
        for (int j = 0; j < NJ; ++j) ldsm_x4(bw[j], Ws + (wn + 16 * j + f.rb) * LD + kk + f.cb);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            mma16816(acc[i][2 * j], af[i], bw[j][0], bw[j][1]);
            mma16816(acc[i][2 * j + 1], af[i], bw[j][2], bw[j][3]);
          }
      }
    }
  }
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + gr + 8 * h, n = n0 + wn + 8 * j + 2 * t;
        if (m < M && n + 1 < N)
          *reinterpret_cast<uint32_t*>(Cout + (size_t)m * N + n) = pack_bf16(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

template <int BM, int BN, int BK, int WM, int WN, int ST, int MINB, bool PRE>
int run(const bf16* A, const bf16* W, bf16* Cout, int M, int N, int K, cudaStream_t st, int* occ) {
  using C = Cfg<BM, BN, BK, WM, WN, ST, MINB, PRE>;
  auto k = tile_kernel<C, BM, BN, BK, WM, WN, ST, MINB, PRE>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (occ) cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, k, C::THREADS, C::SMEM);
  k<<<dim3(cdiv(N, BN), cdiv(M, BM)), C::THREADS, C::SMEM, st>>>(A, W, Cout, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace tcd

using tcd::bf16;
// Variant v (the table in tools/torch_gemm_tiles.py) on C = A . W^T; occ
// (if given) receives the blocks an SM can hold. Returns cudaGetLastError().
extern "C" int tile_gemm(int v, const void* A, const void* W, void* C, int M, int N, int K, void* stream,
                         int* occ) {
  auto st = (cudaStream_t)stream;
  auto a = (const bf16*)A;
  auto w = (const bf16*)W;
  auto c = (bf16*)C;
  switch (v) {
    case 0: return tcd::run<128, 64, 32, 2, 2, 4, 3, false>(a, w, c, M, N, K, st, occ);
    case 1: return tcd::run<64, 64, 32, 2, 2, 4, 4, false>(a, w, c, M, N, K, st, occ);
    case 2: return tcd::run<128, 64, 64, 2, 2, 3, 2, false>(a, w, c, M, N, K, st, occ);
    case 3: return tcd::run<128, 128, 32, 2, 4, 4, 2, false>(a, w, c, M, N, K, st, occ);
    case 4: return tcd::run<128, 128, 64, 2, 4, 3, 2, false>(a, w, c, M, N, K, st, occ);
    case 5: return tcd::run<128, 128, 64, 2, 4, 3, 1, true>(a, w, c, M, N, K, st, occ);
  }
  return -1;
}
