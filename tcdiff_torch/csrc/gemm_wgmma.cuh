// The bf16 forward projection on Hopper's warpgroup MMA (wgmma), its
// operands brought by the Tensor Memory Accelerator (TMA): the serving
// blocks' products (K1's q/k/v and fc, K2's W1, W2 and W3, K7's fc, K6's
// products but its cross-attention q) and K2b's, K8's and K9's.
//
// Replaces, in bf16, gemm_mma_kernel and gemm_ln_kernel (gemm_mma.cuh) in
// the products of K1 (tcdiff_tpu/ops/fused_sa_block.py::fused_sa_block:
// q, k, v, then fc with the post-LN), K2
// (tcdiff_tpu/ops/fused_ff_block.py::fused_ff_tail: W1 with GELU, W2 with
// the FiLM residual and LN4, W3), K2b
// (tcdiff_tpu/ops/fused_ff_block.py::fused_ff_block, _ff_kernel: h =
// gelu(LN3(x).W1^T + b1), then h.W2^T + b2 with or without the FiLM
// residual), K8 (tcdiff_tpu/ops/fused_ln_rotary_matmul.py, _kernel and
// _kernel_rot_only: q, k from rot(LN(x)), v from LN(x)) and K9
// (tcdiff_tpu/ops/fused_ln_matmul.py, _lnmm_kernel: T(LN(x).W^T) + T(b),
// the product rounded before the bias). The TPU kernels run these products
// on the MXU with bf16 operands and f32 sums; so does this body.
//
// What bounds it on the H100: operations. At the serving shape (M = b L =
// 3600) one 3600 x 512 x 512 product is 1.9 GFLOP against ~3.7 MB of
// operands and output: 1.9 us at the 989 TFLOP/s bf16 peak against 1.1 us
// of HBM traffic. mma.sync reaches about 110-170 TFLOP/s there
// (gemm_mma.cuh); the card's bf16 rate is reachable only through wgmma.
// With 128 x 128 tiles a block streams 32 KB of operands from L2 a K step
// for 2 MFLOP, and the SMs' shared L2 rate, not the tensor cores, sets the
// pace of the K loop (PERF.md).
//
// Design:
// - C = A . W^T with A (M, K) and W (N, K) row-major (nn.Linear layout):
//   both K-major, wgmma's natural bf16 layout, so nothing is transposed.
// - 128 x 128 tiles (WBM x WBN), one block an SM: two consumer warpgroups,
//   each owning 64 rows, and one producer warpgroup; K steps of WBK = 64
//   (one 128-byte line of bf16, the width of the 128-byte swizzle). 64-row
//   tiles (one consumer warpgroup, two blocks an SM) were no faster at any
//   serving shape measured (PERF.md); 128 x 256 tiles were not built: at
//   M = 3600, N = 512 they make 58 blocks for 132 SMs.
// - The producer's first thread keeps TMA loads in flight into a ring of
//   WG_STAGES stages, each guarded by a full and an empty mbarrier; a tile
//   lands in the 128-byte swizzle the wgmma descriptors read. Rows past M
//   or N and columns past K arrive as zeros (TMA's fill past the edge), so
//   ragged shapes need no masks until the stores.
// - Each consumer warpgroup runs wgmma.m64n128k16 (4 a K step) on a stage
//   that has landed, keeps that step's group in flight while it waits for
//   the one before (wait_group 1) and then frees the earlier stage.
// - setmaxnreg moves registers from the producer (40) to the consumers
//   (232); the roles split once and never share code again (the fold's
//   producer only passes the cluster's barriers on its own path).
// - The epilogue: wgmma's m64nN accumulator gives each warp 16 rows, laid
//   out per 8 columns as mma.sync's C fragment (rows g and g + 8, columns
//   2t and 2t + 1). Each warpgroup writes its 64 rows of f32 sums into the
//   free ring, then its threads walk the rows' 8-column pieces in 16-byte
//   loads and stores along the rows, with epi_math's arithmetic and
//   rounding points (wg_math).
// - Grouped form: up to WGROUP products in one launch, each with its own
//   A, W, N and output (K1's and K8's q, k and v in one launch without a
//   joined weight).
// - The LayerNorm fold (gemm_ln_wg, gemm_wg_ln_kernel): gemm_ln's epilogue
//   on this body, the column tiles of a row tile one cluster; described
//   where it is defined.
// - Dispatch (gemm_wg): the body runs a product where TMA can read its
//   operands (every A and W 16-byte aligned, K % 8 == 0: rows a multiple
//   of 16 bytes apart) and its epilogue moves in 16-byte pieces (every N %
//   8 == 0; the outputs, bias, residual and FiLM rows 16-byte aligned);
//   else gemm_mma_kernel runs it, by that rule alone (ops/gemm.gemm_plan
//   states it; tcd_wg_plan exports this decision). The fold's rule
//   (ln_wg_ok, exported by tcd_ln_wg_plan) adds a row a cluster holds;
//   else gemm_ln runs it. A launch or a tensor-map encode that fails is
//   refused (launch_status) and raises; it never reruns on the old body.
// - Tensor maps are encoded on the host with cuTensorMapEncodeTiled,
//   obtained through cudaGetDriverEntryPoint (the library links no
//   libcuda), passed as __grid_constant__ kernel parameters and cached by
//   (pointer, shape, box): a map is a function of those alone.
#pragma once

#include <cuda.h>

#include <array>
#include <chrono>
#include <map>
#include <mutex>
#include <tuple>

#include "gemm_mma.cuh"

namespace tcd {

constexpr int WBM = 128, WBN = 128, WBK = 64;  // block tile rows and columns; K step (one 128-byte swizzle line)
constexpr int WG_STAGES = 4;                   // TMA ring depth
constexpr int WGROUP = 3;                      // most products of one launch
constexpr int WG_THREADS = 384;                // two consumer warpgroups and the producer's
// setmaxnreg: one block an SM, 168 registers a thread at launch
constexpr int WG_PRODUCER_REGS = 40, WG_CONSUMER_REGS = 232;
static_assert(WGROUP == PGROUP, "pick() selects among PGROUP entries");

// Bytes of one K step of A (WBM rows of 128 bytes) and of W (WBN rows).
constexpr int WG_A_BYTES = WBM * 128, WG_B_BYTES = WBN * 128;
// Dynamic shared memory of a launch: 1024 bytes of slack to align the
// swizzled tiles, the ring's A and W stages, its full and empty barriers.
constexpr int WG_SMEM = 1024 + WG_STAGES * (WG_A_BYTES + WG_B_BYTES) + 2 * WG_STAGES * 8;

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Wait until the phase of parity `parity` has completed. A wait that
// outlasts ~2^28 polls (seconds) traps: a fault the launch reports, not a
// card that hangs.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// A box of the 2-D tensor map at column c0, row r0 into shared memory at
// dst, completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int r0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(smem_addr(bar))
      : "memory");
}

// A box of a 4-D tensor map at coordinates (c0, c1, c2, c3), as tma_load.
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}
// A box of shared memory at src to a 4-D tensor map at (c0, c1, c2, c3);
// the parts of the box past the tensor's edges are not written. The
// caller commits (bulk_commit) and waits for the read (bulk_wait_read)
// before it writes src again.
__device__ __forceinline__ void tma_store4(const CUtensorMap* map, const void* src, int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Wait until at most N of this thread's bulk stores still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Wait until at most N of this thread's bulk stores are still in flight.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// Order this thread's generic shared-memory writes before a later TMA read of them.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// The wgmma descriptor of a K-major bf16 tile with the 128-byte swizzle at
// a 1024-byte aligned shared address: 8-row groups 1024 bytes apart. The
// k16 slices of a K step lie 32 bytes apart: + 2 in the address field.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator accesses across an async MMA.
__device__ __forceinline__ void wg_fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32, the warpgroup's accumulator) = A (64 x 16) . B (16 x 128)
// + (scale_d ? d : 0), both K-major bf16 in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ----------------------------------------------------------- epilogue
// epi_math of common.cuh for the body's epilogue, which runs without
// dropout (gemm_wg refuses it): the same arithmetic and rounding points
// without the dropout index (a division and a remainder by L an element).
// The inputs of 8 contiguous elements (m, n .. n + 7) besides their sums,
// in 16-byte loads (the staged epilogue's pieces).
template <int EPI>
__device__ __forceinline__ void wg_load8(const EpiArgs& ep, int N, int m, int n, EpiIn (&in)[8]) {
  float b[8] = {}, r[8] = {}, s[8] = {}, f[8] = {};
  if (epi_bias<EPI>()) ld_vec<8>(ep.bias + n, b);
  if (epi_film<EPI>()) {
    const size_t fr = (size_t)(m / ep.L) * N + n;
    ld_vec<8>(static_cast<const bf16*>(ep.resid) + (size_t)m * N + n, r);
    ld_vec<8>(ep.fs + fr, s);
    ld_vec<8>(ep.fb + fr, f);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) in[e] = EpiIn{b[e], r[e], s[e], f[e]};
}
template <int EPI>
__device__ __forceinline__ EpiVal wg_math(float v, const EpiIn& in) {
  if (EPI == EPI_BIAS) return {v + in.bias, 0.f};
  if (EPI == EPI_BIAS_GELU) {
    const float u = v + in.bias;
    return {0.5f * u * (1.f + erff(u * 0.70710678118654752f)), u};
  }
  if (EPI == EPI_BIAS_FILM) {
    const float zd = v + in.bias;
    return {in.resid + (in.fs + 1.f) * zd + in.fb, zd};
  }
  if (EPI == EPI_BIAS_FILM_T) return {in.resid + (in.fs + 1.f) * (v + in.bias) + in.fb, 0.f};
  if (EPI == EPI_BIAS_ROUNDED) return {round_t<bf16>(v) + round_t<bf16>(in.bias), 0.f};
  return {v, 0.f};  // EPI_STORE, EPI_STORE_F32
}

// --------------------------------------------------------- the kernel
struct WgMaps {
  CUtensorMap a[WGROUP];  // A (M, K) of each group, in boxes of WBM rows
  CUtensorMap w[WGROUP];  // W (N_g, K) of each group, in boxes of WBN rows
};
struct WgGroups {
  void* c[WGROUP];        // outputs (M, N_g)
  int n[WGROUP];          // N of each group
  int tile0[WGROUP + 1];  // first column tile of each group; tile0[g] = the grid's x for g >= G
};

// The ring of a launch in dynamic shared memory (1024-byte aligned, as the
// 128-byte swizzle wants): the A and W stages, their full and empty
// barriers.
struct WgRing {
  unsigned char *a, *b;
  uint64_t *full, *empty;
};
__device__ __forceinline__ WgRing wg_ring(unsigned char* smem) {
  unsigned char* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  WgRing r;
  r.a = base;
  r.b = base + WG_STAGES * WG_A_BYTES;
  r.full = reinterpret_cast<uint64_t*>(r.b + WG_STAGES * WG_B_BYTES);
  r.empty = r.full + WG_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(r.full + s, 1);
      mbar_init(r.empty + s, 8);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer warpgroup's part of a tile's K loop: registers to the
// consumers; its first thread keeps K step kt of A's rows m0.. and W's rows
// n0.. in ring stage kt % WG_STAGES, once the consumers have freed it.
__device__ __forceinline__ void wg_produce(const WgRing& r, const CUtensorMap* amap, const CUtensorMap* wmap,
                                           int nk, int m0, int n0) {
  constexpr int S = WG_STAGES;
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
  if (threadIdx.x == 256)
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % S;
      if (kt >= S) mbar_wait(r.empty + s, (kt / S - 1) & 1);
      mbar_expect_tx(r.full + s, WG_A_BYTES + WG_B_BYTES);
      tma_load(r.b + s * WG_B_BYTES, wmap, kt * WBK, n0, r.full + s);
      tma_load(r.a + s * WG_A_BYTES, amap, kt * WBK, m0, r.full + s);
    }
}

// A consumer warpgroup's part: d = its 64 rows (warpgroup wg) of the tile's
// sums over nk >= 1 K steps, in wgmma's accumulator layout; on return
// every stage this warpgroup reads has been multiplied. The first wgmma
// starts the sums (scale-d 0), and nothing but the wgmmas touches d until
// the last group is done: a zero fill before the loop, or a compiler fence
// on d between the groups in flight, makes ptxas serialise the wgmmas
// (its warning C7515; PERF.md: 350 -> 377 TFLOP/s at K1's q/k/v without).
__device__ __forceinline__ void wg_consume(const WgRing& r, int nk, int wg, float (&d)[64]) {
  constexpr int S = WG_STAGES;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    mbar_wait(r.full + s, (kt / S) & 1);
    const uint64_t da = wg_desc(smem_addr(r.a + s * WG_A_BYTES + wg * 64 * 128));
    const uint64_t db = wg_desc(smem_addr(r.b + s * WG_B_BYTES));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WBK / 16; ++kk) wgmma_m64n128k16(d, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // step kt - 1 is done: its stage is free
    if (kt > 0 && (threadIdx.x & 31) == 0) mbar_arrive(r.empty + (kt - 1) % S);
  }
  wgmma_wait<0>();
  wg_fence_acc(d);
}

// A staged f32 row of the tile, bytes: padded, so that a fragment's 8 rows
// use 8 bank quads.
constexpr int WG_FROW = WBN * 4 + 16;
static_assert(WBM * WG_FROW <= WG_STAGES * (WG_A_BYTES + WG_B_BYTES), "the staged rows fit in the ring");

// Each consumer warpgroup writes its 64 rows of sums d into the ring (free
// once both warpgroups are past the K loop) as the fragments hold them:
// rows wr and wr + 8, columns 8 j + 2t, 2t + 1. Returns the warpgroup's
// staged rows, complete for all its threads.
__device__ __forceinline__ unsigned char* wg_stage(const WgRing& r, int wg, const float (&d)[64]) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3, wr = ((threadIdx.x >> 5) & 3) * 16 + gr;
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both warpgroups are past the ring
  unsigned char* stage = r.a + wg * 64 * WG_FROW;    // this warpgroup's rows
#pragma unroll
  for (int j = 0; j < WBN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(stage + (wr + 8 * h) * WG_FROW + (8 * j + 2 * t) * 4) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");  // this warpgroup's rows are staged
  return stage;
}

// C[g] = A[g] . W[g]^T with the epilogue EPI, bf16 operands, f32 sums. Grid
// (tile0[G], cdiv(M, WBM)); block x belongs to group g (tile0[g] <= x <
// tile0[g + 1]), columns (x - tile0[g]) WBN onwards.
template <int EPI>
__global__ void __launch_bounds__(WG_THREADS, 1)
gemm_wg_kernel(const __grid_constant__ WgMaps maps, WgGroups gp, EpiArgs ep, int M, int K) {
  extern __shared__ __align__(16) unsigned char tcd_smem[];
  const WgRing ring = wg_ring(tcd_smem);
  const int nk = (K + WBK - 1) / WBK;
  const int bx = blockIdx.x, g = bx >= gp.tile0[2] ? 2 : bx >= gp.tile0[1] ? 1 : 0;
  const int t0 = g == 0 ? 0 : g == 1 ? gp.tile0[1] : gp.tile0[2];
  const int n0 = (bx - t0) * WBN, m0 = blockIdx.y * WBM, N = pick(gp.n, g);
  const CUtensorMap* wmap = g == 0 ? &maps.w[0] : g == 1 ? &maps.w[1] : &maps.w[2];
  const CUtensorMap* amap = g == 0 ? &maps.a[0] : g == 1 ? &maps.a[1] : &maps.a[2];

  if (threadIdx.x >= 256) {
    wg_produce(ring, amap, wmap, nk, m0, n0);
  } else {
    const int wg = threadIdx.x >> 7;
    using TO = EpiOut<bf16, EPI>;
    TO* const c = static_cast<TO*>(pick(gp.c, g));
    float d[64];
    wg_consume(ring, nk, wg, d);

    // Epilogue: the sums staged as rows (wg_stage); then the warpgroup's
    // threads walk the rows' 8-column pieces (a loop kept rolled, so that
    // its code stays small: unrolled over the 64 sums, the bias+GELU and
    // FiLM epilogues took 4-5 us more a block than the plain store), each
    // piece's operands and output in 16-byte loads and stores along the row.
    const unsigned char* stage = wg_stage(ring, wg, d);
    constexpr int PPR = WBN / 8;  // pieces a row
#pragma unroll 1
    for (int i = threadIdx.x & 127; i < 64 * PPR; i += 128) {
      const int rr = i / PPR, m = m0 + wg * 64 + rr, n = n0 + 8 * (i % PPR);
      if (m >= M || n >= N) continue;
      float v[8], o[8];
      ld_vec<8>(reinterpret_cast<const float*>(stage + rr * WG_FROW) + 8 * (i % PPR), v);
      EpiIn in[8];
      wg_load8<EPI>(ep, N, m, n, in);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = wg_math<EPI>(v[e], in[e]).c;
      st_vec<8>(c + (size_t)m * N + n, o);
    }
  }
}

// ------------------------------------------ the LayerNorm fold on wgmma
// gemm_ln's LayerNorm fold (gemm_mma.cuh: LN_POST with or without FiLM
// rows, LN_FILM_PRE; LN2_PLAIN and LN2_ROT after it) on this body: the
// cdiv(N, WBN) <= LN_CLUSTER column tiles of a 128-row tile launch as one
// cluster along x, so the cluster holds whole rows. Each block, after its
// K loop:
//   1. stages its sums as rows (wg_stage) and reads them back as 8-column
//      pieces: thread i of a warpgroup holds piece i % 16 of its rows
//      i / 16 + 8 k (k < 8), 64 values, in registers; LN_FILM_PRE turns
//      them into the f32 FiLM residual there;
//   2. adds each row's (x, x^2) over its 16 pieces by shuffles among the
//      16 lanes that hold them, in a fixed order, into shared memory;
//   3. cluster.sync(); each warpgroup's first 64 threads add the cluster's
//      partials of their rows, read through distributed shared memory in
//      rank order, so every block of the cluster gets the same statistics
//      and a run repeats bit for bit;
//   4. applies the LayerNorm (ln_y, as ln_rows) and the FiLM residual to
//      its pieces and stores them in bf16 in 16-byte pieces;
//   5. LN2: repeats 2-4 on the rounded output (the rotary pairs lie in a
//      piece), then a last cluster.sync() (no block leaves while a peer
//      reads its partials).
// The rounding points are gemm_ln's: the product (and FiLM before the
// LayerNorm) in f32, bf16 after it, LN2 on the rounded output. Rows past M
// and columns past N hold zeros (TMA's fill), which add nothing to a row's
// sums; nothing past them is loaded or stored.

// 8 bf16 values packed in 16 bytes, widened to f32.
__device__ __forceinline__ void unpack8(const uint4& u, float (&r)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {  // element 2e in the low half of word e
    r[2 * e] = __uint_as_float(w[e] << 16);
    r[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

struct LnSmem {
  float2 *own, *stat;  // the block's partial of each of its WBM rows; the rows' statistics
};

// The partial (x, x^2) sums of this thread's 8 rows of v over the block's
// columns into own (the block's partial of each of its WBM rows).
__device__ __forceinline__ void wg_ln_partials(const float (&v)[8][8], float2* own, int wg) {
  const int i = threadIdx.x & 127;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) ln_add(v[k][e], s, ss);
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {  // the 16 lanes of the row
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
    }
    if ((i & 15) == 0) own[wg * 64 + i / 16 + 8 * k] = make_float2(s, ss);
  }
}

// After the cluster's barrier: (mu, rsqrt(E[x^2] - mu^2 + eps)) of this
// warpgroup's rows into stat, from the cluster's partials added in rank
// order.
__device__ __forceinline__ void wg_ln_stats(float2* own, float2* stat, int wg, int N, float eps) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int i = threadIdx.x & 127;
  if (i < 64) {
    const int row = wg * 64 + i;
    const unsigned nb = cluster.num_blocks();
    float2 q[LN_CLUSTER];
#pragma unroll
    for (unsigned r = 0; r < LN_CLUSTER; ++r)  // the loads in flight together
      if (r < nb) q[r] = *cluster.map_shared_rank(own + row, r);
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (unsigned r = 0; r < LN_CLUSTER; ++r)  // the sums in rank order
      if (r < nb) {
        s = __fadd_rn(s, q[r].x);
        ss = __fadd_rn(ss, q[r].y);
      }
    const float mu = __fdiv_rn(s, (float)N);
    stat[row] = make_float2(mu, rsqrtf(__fadd_rn(__fsub_rn(__fdiv_rn(ss, (float)N), __fmul_rn(mu, mu)), eps)));
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");  // the warpgroup's statistics are in place
}

// out (and out2) = the LayerNorm fold of A . W^T, W (N, K) in nn.Linear
// layout; grid (cdiv(N, WBN), cdiv(M, WBM)) in clusters of cdiv(N, WBN)
// along x; N % 8 == 0 and every operand 16-byte aligned (ln_wg_ok).
template <int LNE, int LN2>
__global__ void __launch_bounds__(WG_THREADS, 1)
gemm_wg_ln_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap, LnFold f,
                  int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char tcd_smem[];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const WgRing ring = wg_ring(tcd_smem);
  const int nk = (K + WBK - 1) / WBK, n0 = blockIdx.x * WBN, m0 = blockIdx.y * WBM;
  // the statistics after the staged rows; LN2's apart from LN's, which a
  // peer may still read
  float2* red = reinterpret_cast<float2*>(ring.a + WBM * WG_FROW);
  const LnSmem ln1{red, red + WBM}, ln2{red + 2 * WBM, red + 3 * WBM};

  if (threadIdx.x >= 256) {  // the producer: its K loop, then the cluster's barriers, apart from the consumers'
    wg_produce(ring, &amap, &wmap, nk, m0, n0);
    cluster.sync();
    if constexpr (LN2 != LN2_NONE) cluster.sync();
    cluster.sync();
    return;
  }
  const int wg = threadIdx.x >> 7, i = threadIdx.x & 127;
  const int n = n0 + 8 * (i & 15), rr0 = wg * 64 + i / 16;  // this thread's columns; its first row in the tile
  const bool ncol = n < N;
  auto row = [&](int k) { return m0 + rr0 + 8 * k; };

  float v[8][8];  // this thread's pieces: rows rr0 + 8 k, columns n .. n + 7
  {
    float d[64];
    wg_consume(ring, nk, wg, d);
    const unsigned char* stage = wg_stage(ring, wg, d);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      ld_vec<8>(reinterpret_cast<const float*>(stage + (i / 16 + 8 * k) * WG_FROW) + 8 * (i & 15), v[k]);
  }
  // The FiLM residual of the pieces, all 8 rows' loads in flight at once
  // (a row of it is read once, from HBM; loaded a row at a time beside the
  // stores, a block waited out 8 round trips); the FiLM rows (a few rows
  // a tile, in L1) as they are used.
  const bool film = f.fs != nullptr;
  uint4 rp[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    rp[k] = film && ncol && row(k) < M ? __ldg(reinterpret_cast<const uint4*>(f.resid + (size_t)row(k) * N + n))
                                       : make_uint4(0u, 0u, 0u, 0u);
  if constexpr (LNE == LN_FILM_PRE) {
    float bb[8] = {};
    if (ncol) ld_vec<8>(f.bias + n, bb);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int m = row(k);
      float r[8], s[8] = {}, b[8] = {};
      const bool in = ncol && m < M;
      unpack8(rp[k], r);
      if (in) {
        const size_t fr = (size_t)(m / f.L) * N + n;
        ld_vec<8>(f.fs + fr, s);
        ld_vec<8>(f.fb + fr, b);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) v[k][e] = in ? r[e] + (s[e] + 1.f) * (v[k][e] + bb[e]) + b[e] : 0.f;
    }
  }
  wg_ln_partials(v, ln1.own, wg);
  cluster.sync();  // every block's partials are in place

  // LN [+ FiLM residual], stored in bf16; v becomes the rounded output,
  // zero past N (LN2's input)
  wg_ln_stats(ln1.own, ln1.stat, wg, N, f.eps);
  {
    const bool post_film = LNE == LN_POST && film;
    float sc[8] = {}, bi[8] = {};
    if (ncol) {
      ld_vec<8>(f.s + n, sc);
      ld_vec<8>(f.b + n, bi);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int m = row(k);
      const float2 ms = ln1.stat[rr0 + 8 * k];
      const LnStat st{ms.x, ms.y};
      const bool in = ncol && m < M;
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = ln_y(v[k][e], st, sc[e], bi[e]);
      if (post_film && in) {
        const size_t fr = (size_t)(m / f.L) * N + n;
        float r[8], s[8], b[8];
        unpack8(rp[k], r);
        ld_vec<8>(f.fs + fr, s);
        ld_vec<8>(f.fb + fr, b);
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = r[e] + (s[e] + 1.f) * y[e] + b[e];
      }
      if (in) st_vec<8>(f.out + (size_t)m * N + n, y);
      if constexpr (LN2 != LN2_NONE) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[k][e] = ncol ? round_t<bf16>(y[e]) : 0.f;
      }
    }
  }

  if constexpr (LN2 != LN2_NONE) {
    wg_ln_partials(v, ln2.own, wg);
    cluster.sync();  // every block's LN2 partials are in place
    wg_ln_stats(ln2.own, ln2.stat, wg, N, f.eps2);
    float sc[8] = {}, bi[8] = {};
    if (ncol) {
      ld_vec<8>(f.s2 + n, sc);
      ld_vec<8>(f.b2 + n, bi);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int m = row(k);
      if (!ncol || m >= M) continue;
      const float2 ms = ln2.stat[rr0 + 8 * k];
      const LnStat st{ms.x, ms.y};
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = ln_y(v[k][e], st, sc[e], bi[e]);
      if constexpr (LN2 == LN2_ROT) {
        const size_t tr = (size_t)(m % f.L) * N + n;
        float cs[8], sn[8], o[8];
        ld_vec<8>(f.cos + tr, cs);
        ld_vec<8>(f.ssin + tr, sn);
#pragma unroll
        for (int e = 0; e < 8; e += 2) rot_pair(y[e], y[e + 1], cs[e], cs[e + 1], sn[e], sn[e + 1], o[e], o[e + 1]);
        st_vec<8>(f.out2 + (size_t)m * N + n, o);
      } else {
        st_vec<8>(f.out2 + (size_t)m * N + n, y);
      }
    }
  }
  cluster.sync();  // no block leaves while a peer reads its partials
}

// ---------------------------------------------------------------- host
// Host time this library spent on tensor maps (lookups and encodes), for
// measurement (internal linkage, as body_launches).
struct TmaStats {
  long long lookups = 0, encodes = 0;
  double us = 0.0;
};
static inline TmaStats& tma_stats() {
  static TmaStats s;
  return s;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// Whether TMA can read a row-major bf16 operand of row stride ld elements:
// a 16-byte aligned base and rows a multiple of 16 bytes apart.
inline bool tma_ok(const void* p, int ld) { return al16(p) && ld > 0 && ld % 8 == 0; }

// The map of a bf16 tensor of rank <= 5 dimensions (dims[0] contiguous,
// strides[i] the byte stride of dimension i + 1), read or written in boxes
// of box[i] elements with the 128-byte swizzle and zeros past its edges;
// false where cuTensorMapEncodeTiled does not encode it. Cached by
// (pointer, dims, strides, box): a map is a function of those alone.
static inline bool tma_map_nd(CUtensorMap* out, const void* p, int rank, const cuuint64_t* dims,
                              const cuuint64_t* strides, const cuuint32_t* box) {
  using Key = std::tuple<const void*, int, std::array<cuuint64_t, 5>, std::array<cuuint64_t, 4>,
                         std::array<cuuint32_t, 5>>;
  static std::mutex mu;
  static std::map<Key, CUtensorMap> cache;
  const auto t0 = std::chrono::steady_clock::now();
  std::lock_guard<std::mutex> lock(mu);
  TmaStats& stats = tma_stats();
  ++stats.lookups;
  Key key{p, rank, {}, {}, {}};
  for (int i = 0; i < rank; ++i) {
    std::get<2>(key)[i] = dims[i];
    std::get<4>(key)[i] = box[i];
    if (i > 0) std::get<3>(key)[i - 1] = strides[i - 1];
  }
  const auto it = cache.find(key);
  bool ok = true;
  if (it != cache.end()) {
    *out = it->second;
  } else {
    const EncodeTiled fn = encode_tiled();
    const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
    ok = fn && fn(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(p), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
    if (ok) {
      if (cache.size() >= 4096) cache.clear();
      cache.emplace(key, *out);
      ++stats.encodes;
    }
  }
  stats.us += std::chrono::duration<double, std::micro>(std::chrono::steady_clock::now() - t0).count();
  return ok;
}

// The map of a row-major (rows, cols) bf16 operand of row stride ld, read
// in boxes of WBK columns by box_rows rows (tma_map_nd).
static inline bool tma_map(CUtensorMap* out, const void* p, int rows, int cols, int ld, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows}, strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {WBK, (cuuint32_t)box_rows};
  return tma_map_nd(out, p, 2, dims, strides, box);
}

// The groups' column tiles (tile0) and the grid's x; false past WGROUP.
inline bool wg_tiles(WgGroups& gp, int G, const int* N, void* const* C) {
  if (G < 1 || G > WGROUP) return false;
  gp = WgGroups{};
  int x = 0;
  for (int g = 0; g < WGROUP; ++g) {
    gp.tile0[g] = x;
    if (g < G) {
      gp.c[g] = C[g];
      gp.n[g] = N[g];
      x += cdiv(N[g], WBN);
    }
  }
  gp.tile0[WGROUP] = x;
  return true;
}

// Whether the wgmma body takes the G products (the dispatch rule): TMA
// reads every A and W (tma_ok), and the epilogue moves in 16-byte pieces
// (every N % 8 == 0, the outputs and the epilogue's operands 16-byte
// aligned; a null operand is).
inline bool wg_ok(int G, const bf16* const* A, const bf16* const* W, void* const* C, const int* N, int K,
                  const EpiArgs& ep) {
  bool ok = al16(ep.bias) && al16(ep.resid) && al16(ep.fs) && al16(ep.fb);
  for (int g = 0; g < G; ++g) ok = ok && tma_ok(A[g], K) && tma_ok(W[g], K) && N[g] % 8 == 0 && al16(C[g]);
  return ok;
}

// C[g] = A[g] . W[g]^T for g < G (<= WGROUP), A[g] (M, K), W[g] (N[g], K),
// C[g] (M, N[g]), bf16, the epilogue's other operands shared. One wgmma
// launch where wg_ok holds, else one gemm_mma_kernel launch per group.
// Refused: a second output or dropout in the epilogue (no caller asks the
// forward projection for either).
template <int EPI>
inline void gemm_wg(int G, const bf16* const* A, const bf16* const* W, void* const* C, const int* N, int M, int K,
                    EpiArgs ep, cudaStream_t st) {
  static_assert(EPI == EPI_STORE || EPI == EPI_STORE_F32 || EPI == EPI_BIAS || EPI == EPI_BIAS_GELU ||
                    EPI == EPI_BIAS_FILM || EPI == EPI_BIAS_FILM_T || EPI == EPI_BIAS_ROUNDED,
                "the forward's epilogues");
  WgGroups gp;
  if (!wg_tiles(gp, G, N, C) || ep.c2 || ep.dr.on) return refuse();
  if (!wg_ok(G, A, W, C, N, K, ep)) {
    for (int g = 0; g < G; ++g) {
      ProjGroup p{};
      p.a[0] = A[g];
      p.w[0] = W[g];
      p.c[0] = C[g];
      launch_gemm_mma<EPI, false, false>(p, 1, 1, ep, M, N[g], K, K, 1, st);
    }
    return;
  }
  WgMaps maps{};
  for (int g = 0; g < G; ++g)
    if (!tma_map(&maps.a[g], A[g], M, K, K, WBM) || !tma_map(&maps.w[g], W[g], N[g], K, K, WBN)) return refuse();
  ++body_launches()[BODY_WGMMA];
  launch_mma(gemm_wg_kernel<EPI>, dim3(gp.tile0[WGROUP], cdiv(M, WBM)), WG_THREADS, WG_SMEM, st, maps, gp, ep, M, K);
}

// Whether the wgmma body takes a LayerNorm fold (the fold's dispatch rule):
// TMA reads A and W (tma_ok), a cluster holds the rows (cdiv(N, WBN) <=
// LN_CLUSTER), the epilogue moves in 16-byte pieces (N % 8 == 0, every
// operand 16-byte aligned; a null operand is).
inline bool ln_wg_ok(const bf16* A, const bf16* W, int N, int K, const LnFold& f) {
  return tma_ok(A, K) && tma_ok(W, K) && N > 0 && N % 8 == 0 && cdiv(N, WBN) <= LN_CLUSTER && al16(f.out) &&
         al16(f.out2) && al16(f.resid) && al16(f.cos) && al16(f.ssin) && al16(f.s) && al16(f.b) && al16(f.s2) &&
         al16(f.b2) && al16(f.bias) && al16(f.fs) && al16(f.fb);
}

// The LayerNorm fold of out = A . W^T (A (M, K), W (N, K), bf16): one
// cluster launch of the wgmma body where ln_wg_ok holds, else gemm_ln's
// (mma.sync, which refuses an odd N or one above LN_CLUSTER * PBN). A
// launch or a map encode that fails is refused and raises.
template <int LNE, int LN2>
inline void gemm_ln_wg(const bf16* A, const bf16* W, int M, int N, int K, const LnFold& f, cudaStream_t st) {
  if (!ln_wg_ok(A, W, N, K, f)) return gemm_ln<LNE, LN2>(A, W, M, N, K, f, st);
  CUtensorMap amap, wmap;
  if (!tma_map(&amap, A, M, K, K, WBM) || !tma_map(&wmap, W, N, K, K, WBN)) return refuse();
  ++body_launches()[BODY_WGMMA];
  const int ntn = cdiv(N, WBN);
  launch_mma_cluster(gemm_wg_ln_kernel<LNE, LN2>, dim3(ntn, cdiv(M, WBM)), ntn, WG_THREADS, WG_SMEM, st, amap, wmap,
                     f, M, N, K);
}

}  // namespace tcd

// The counts of each product body this library has launched ({mma.sync,
// wgmma}) and the host time its tensor maps took ({lookups, encodes, us}),
// for tests and measurement.
extern "C" void tcd_body_launches(long long* out) {
  out[0] = tcd::body_launches()[tcd::BODY_MMA];
  out[1] = tcd::body_launches()[tcd::BODY_WGMMA];
}
extern "C" void tcd_tma_stats(double* out) {
  const tcd::TmaStats& s = tcd::tma_stats();
  out[0] = (double)s.lookups;
  out[1] = (double)s.encodes;
  out[2] = s.us;
}
