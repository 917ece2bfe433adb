// Tensor-core building blocks of the bf16 attention kernels (attention.cuh,
// train_common.cuh) and of the bf16 forward projections (gemm_mma.cuh):
// 16-byte cp.async copies into shared tiles, ldmatrix fragment loads and
// the m16n8k16 bf16 mma with f32 accumulators.
//
// Fragment layout of mma.sync.m16n8k16.row.col (lane = 4 * g + t):
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..)
//   B (16 x 8, k x n):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16 x 8, f32):        c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// so the C fragments of two neighbouring n-tiles, rounded to bf16 pairs,
// are the A fragment of the next product over those 16 columns: no trip
// through shared memory.
//
// Shared tiles are row-major bf16 with a row stride of DKP + 8 elements
// (DKP, the head dim padded to the mma's 16): the 16 bytes of padding put
// the 8 rows an ldmatrix reads in 8 different bank quads.
#pragma once

#include <map>
#include <mutex>
#include <utility>

#include "common.cuh"

namespace tcd {

using bf16 = __nv_bfloat16;

constexpr int MT = 128;  // threads of a tensor-core attention block: 4 warps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b over one 16 x 8 x 16 tile.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to a bf16 pair, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A bf16 pair times sc, rounded back to bf16: T(q * T(scale)).
__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float sc) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(f.x * sc, f.y * sc);
}

// The A fragment of C fragments c[j] (columns 8j..8j+7) and c[j+1].
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Lane offsets (row, column) into a 16 x 16 block for ldsm_x4:
//   frag_a: matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15): an A
//           fragment of a row-major tile, or with ldsm_x4_t the B fragments (r[0..1],
//           r[2..3]) of two n-tiles of a tile stored k-major (rows = k);
//   frag_b: matrices (0-7, 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15): the B fragments
//           of two n-tiles of a tile stored n-major (rows = n, columns = k).
struct FragOff {
  int ra, ca, rb, cb;
};
__device__ __forceinline__ FragOff frag_off(int lane) {
  return FragOff{(lane & 7) + ((lane >> 3) & 1) * 8, (lane >> 4) * 8, (lane & 7) + (lane >> 4) * 8,
                 ((lane >> 3) & 1) * 8};
}

// Rows l0 .. l0+ROWS-1 of an (L, dk) bf16 operand with row stride sl into
// a shared tile of row stride DKP + 8; rows past L and columns past dk are
// zero. vec: 16-byte cp.async (the caller has checked that every row start
// is 16-byte aligned and dk % 8 == 0); else 2-byte loads. THREADS: the
// block's threads, which share the copy.
template <int ROWS, int DKP, int THREADS = MT>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* gp, long long sl, int l0, int L, int dk,
                                          bool vec) {
  constexpr int LD = DKP + 8, CH = DKP / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx % CH) * 8, gl = l0 + r;
    bf16* dst = sm + r * LD + c;
    if (vec) {
      const bool ok = gl < L && c < dk;
      cp_async16(dst, ok ? gp + gl * sl + c : gp, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gl < L && c + e < dk) ? gp[gl * sl + c + e] : __float2bfloat16(0.f);
    }
  }
}

// One warp's 16 staged rows (row stride DKP + 8) to rows l0 .. l0+15 of an
// (L, dk) operand with row stride sl; rows past L are not written.
template <int DKP>
__device__ __forceinline__ void store_rows16(const bf16* sm, bf16* gp, long long sl, int l0, int L, int dk,
                                             bool vec, int lane) {
  constexpr int LD = DKP + 8, CH = DKP / 8;
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = (idx % CH) * 8, gl = l0 + r;
    if (gl >= L || c >= dk) continue;
    const bf16* src = sm + r * LD + c;
    if (vec) {
      *reinterpret_cast<uint4*>(gp + gl * sl + c) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c + e < dk; ++e) gp[gl * sl + c + e] = src[e];
    }
  }
}

// A warp's C fragments (16 rows x DKP columns, times the row factors f0
// for rows g and f1 for rows g+8) rounded to bf16 into its staging rows.
template <int DKP>
__device__ __forceinline__ void stage_rows16(bf16* sm, const float (&acc)[DKP / 8][4], float f0, float f1,
                                             int lane) {
  constexpr int LD = DKP + 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < DKP / 8; ++n) {
    *reinterpret_cast<uint32_t*>(sm + g * LD + 8 * n + 2 * t) = pack_bf16(acc[n][0] * f0, acc[n][1] * f0);
    *reinterpret_cast<uint32_t*>(sm + (g + 8) * LD + 8 * n + 2 * t) = pack_bf16(acc[n][2] * f1, acc[n][3] * f1);
  }
}

// Whether an operand of rows (b, h, l) at p + b*sb + h*sh + l*sl can be
// copied in 16-byte pieces.
inline bool rows16(const void* p, long long sb, long long sh, long long sl, int dk) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 && sh % 8 == 0 && sl % 8 == 0 && dk % 8 == 0;
}

// Allow kernel `fn` `bytes` of dynamic shared memory (past 48 KB) on the
// current device; the attribute is set once per kernel, device and size,
// not at every launch.
inline void allow_smem(const void* fn, int bytes) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> allowed;  // (kernel, device) -> bytes
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mu);
  int& have = allowed[{fn, dev}];
  if (have != bytes) {
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    have = bytes;
  }
}

// Launch kernel<<<grid, threads, bytes>>> with its dynamic shared memory
// allowed; the caller checks cudaGetLastError().
template <typename Kernel, typename... Args>
inline void launch_mma(Kernel kernel, dim3 grid, int threads, int bytes, cudaStream_t st, Args... args) {
  allow_smem(reinterpret_cast<const void*>(kernel), bytes);
  kernel<<<grid, threads, bytes, st>>>(args...);
}

// launch_mma in clusters of cx blocks along x; a launch the card refuses
// (a cluster that does not fit) is refused as a failed one is.
template <typename... KArgs, typename... Args>
inline void launch_mma_cluster(void (*kernel)(KArgs...), dim3 grid, int cx, int threads, int bytes, cudaStream_t st,
                               Args... args) {
  allow_smem(reinterpret_cast<const void*>(kernel), bytes);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cx;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  if (e != cudaSuccess) refuse(e);
}

// The cluster barrier in two halves: arrive (relaxed: it orders no
// memory) as soon as a block has started, wait where its peers' shared
// memory is about to be written.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

}  // namespace tcd
