// Flash-style softmax attention with the optional TRPE bias, shared by the
// serving blocks (blocks.cuh: K1, K6, K7), the standalone attention
// (attention.cu, K11) and the train blocks' forward (train_common.cuh: K3,
// K4, with dropout on the probabilities and the log-normaliser saved).
//
//   o = softmax(T(q * T(scale)) . k^T [+ bias]) . v      per (batch, head)
//   bias[i, j] = q_unscaled[i] . table[dist[i, j], head]  where 0 <= dist < 10
//
// as the TPU kernels (fused_sa_block.py, fused_attention.py): the scaled q
// is rounded to T before the logits, the logits and softmax run in f32, and
// the probabilities enter the product with v in T. The TPU keeps a head's
// whole (Lq, Lk) logits in VMEM; a Hopper block has 227 KB of shared memory
// (810 KB would be one 450 x 450 f32 head), so here one block owns 64
// queries of one head and streams key tiles with an online softmax: no
// logit row leaves the block.
//
// What bounds it on the H100: at the serving shapes (b = 8, 8 heads of 64)
// 3.3 GFLOP against 14.7 MB at 450 x 450: 3.3 us of bf16 tensor-core work
// and 4.4 us of HBM traffic; at the benchmark's 256 rows 106 GFLOP against
// 472 MB (0.107 and 0.141 ms). So the products have to run on the tensor
// cores, the tiles have to arrive while the previous one is used, and at
// head width 64 the softmax's exponentials (one a logit, on the SFU at 16 a
// clock an SM) take about as long as the products: neither may wait for
// the other.
//
// bf16 runs one of two bodies of attn_mma_kernel<DKP, WG>, by what the call
// holds (attn_plan; ops/attention.attention_plan writes the rule out):
//
// wgmma (WG = true): every call of head width 64 without a TRPE table whose
// q, k, v and o TMA can address (16-byte aligned, every stride a positive
// multiple of 16 bytes). A persistent grid, one block an SM, walks tiles of
// 128 queries of one (row, head), the query tiles of a head on
// neighbouring blocks, so that a head's k and v come from L2. A producer
// warpgroup's first thread keeps TMA loads in flight: q once a tile, k and
// v in stages of 128 keys through an AW_STAGES ring, each stage guarded by
// a full and an empty mbarrier, over 4-D maps (dk, L, H, B), so that a box
// never crosses into another row's tokens and keys past L arrive as zeros.
// Two consumer warpgroups own 64 queries each (setmaxnreg moves registers
// to them):
// - q is loaded once into registers as wgmma's A (ldmatrix from the
//   swizzled tile) and scaled and rounded there as the mma.sync body does
//   (T(q * T(scale)), for any scale), so the logits are that body's;
// - S = q.k^T by wgmma.m64n64k16 over a 64-key half of a stage, k K-major;
//   its accumulator is mma.sync's C fragment (rows g and g + 8, columns 2t
//   and 2t + 1), and a half is the mma.sync body's 64-key tile, so the key
//   mask, the online softmax in f32, the dropout hash and the lse are that
//   body's, with each row's max, normaliser and sums taken in its order;
// - o += p.v: p rounded to bf16 in registers is wgmma's A, v the B operand
//   in its own (key, dk) layout, read through the descriptor's transpose;
// - each half's S is issued before the previous half's p.v, so the softmax
//   of one half runs while the tensor cores multiply the other, and the
//   two consumer warpgroups take turns to issue (named barriers), so that
//   one's softmax runs while the other's products do;
// - the halves go in pairs, a stage a pair, so that the code of a half
//   holds no branch (a branch there, or a second copy of the softmax for
//   the last half, measured 9-16% slower), and the exponentials are the
//   SFU's alone (aw_exp2);
// - the epilogue stages o in the warpgroup's own swizzled tile and one TMA
//   store writes its rows (rows past Lq are not written).
// A second S buffer (S of the next half in flight through the softmax)
// and a producer warp in place of a warpgroup measured slower: 168
// registers a thread is the compiler's limit either way (PERF.md).
//
// mma.sync (WG = false): every other bf16 call (the TRPE bias, head widths
// 4-60, views TMA cannot address). FlashAttention-2's forward on
// mma.sync.m16n8k16 (mma.cuh). A block of 4 warps owns 64 queries, 16 per
// warp; q is loaded once, scaled and rounded in registers and kept as A
// fragments; 64-key tiles of k and v stream through a 2-stage shared ring
// filled by 16-byte cp.async, the next tile in flight while this one is
// used; S = q.k^T, the key mask, the TRPE bias (q.table^T is one more
// small mma) and the online softmax stay in registers, with quad shuffles
// for the row max; the probabilities are rounded to bf16 and repacked from
// C to A fragments for o += p.v (v through ldmatrix.trans); the epilogue
// stages o in shared memory and writes 16-byte rows.
//
// f32: attn_fma_kernel, the FMA units over f32 tiles (32-key tiles, 4
// threads per query). The tensor cores take f32 only as TF32, which would
// break the f32 agreement with the plain version; so f32 keeps this body.
//
// Tensors are addressed through strides, so q, k and v may be views: a
// head split (b, L, h*dk) or a (b, h, L, dk) array alike. dk <= 64 and a
// multiple of 4; the mma.sync body pads it to 16, 32, 48 or 64 in shared
// memory, and copies 16-byte pieces where every row start is 16-byte
// aligned and dk % 8 == 0, else 2-byte elements. Each library counts the
// launches of each bf16 body (tcd_attn_body_launches) and exports the
// rule (tcd_attn_plan).
#pragma once

#include <type_traits>

#include "gemm_wgmma.cuh"

namespace tcd {

constexpr int FQ = 64;     // f32: queries per block (4 threads per query)
constexpr int FK = 32;     // f32: keys per tile
constexpr int FDK = 64;    // largest head dim
constexpr int NB = 10;     // TRPE buckets
constexpr int MQ = 64;     // bf16: queries per block, 16 per warp
constexpr int MK = 64;     // bf16: keys per tile

// Element (b, h, l, c) of an operand lies at b * sb + h * sh + l * sl + c.
struct Strides {
  long long sb, sh, sl;
};

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides qs, ks, vs, os;
  int Lq, Lk, dk;
  float scale;
  const void* table;     // bucket n of head h at n * tn + h * th (null: no bias)
  long long tn, th;
  const int32_t* dist;   // (B, Lq, Lk) bucket ids
};

// The train forward's options; all zero when serving.
struct AttnTrain {
  Drop dr;     // hash dropout on the probabilities: salt SALT_ATTN + h, index i * Lk + j
  float* lse;  // (B, H, Lq): each row's log softmax normaliser, or null
};

// The probability that enters the product with v: dropped where the train
// forward drops it (the normaliser sums the undropped p).
// key = drop_key(tr.dr, b, SALT_ATTN + h).
__device__ __forceinline__ float drop_p(float p, const AttnTrain& tr, bool valid, uint32_t key, uint32_t idx) {
  if (!tr.dr.on) return p;
  return valid && keep_key(tr.dr, key, idx) ? p * tr.dr.scale : 0.f;
}

__global__ void __launch_bounds__(256) attn_fma_kernel(AttnArgs a, AttnTrain tr) {
  __shared__ float Qs[FQ][FDK + 1];
  __shared__ float Ks[FK][FDK + 1];
  __shared__ float Vs[FK][FDK];
  __shared__ float Ps[FQ][FK + 1];
  __shared__ float Ix[FQ][NB];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FQ;
  const int tid = threadIdx.x, r = tid >> 2, cg = tid & 3;  // 4 threads per query row
  const int Lq = a.Lq, Lk = a.Lk, dk = a.dk;
  const float* q = static_cast<const float*>(a.q) + b * a.qs.sb + h * a.qs.sh;
  const float* k = static_cast<const float*>(a.k) + b * a.ks.sb + h * a.ks.sh;
  const float* v = static_cast<const float*>(a.v) + b * a.vs.sb + h * a.vs.sh;
  float* o = static_cast<float*>(a.o) + b * a.os.sb + h * a.os.sh;
  const float* table = static_cast<const float*>(a.table);
  const uint32_t dkey = drop_key(tr.dr, b, SALT_ATTN + h);

  for (int idx = tid; idx < FQ * dk; idx += 256) {
    const int rr = idx / dk, c = idx % dk, gq = q0 + rr;
    Qs[rr][c] = gq < Lq ? q[gq * a.qs.sl + c] : 0.f;
  }
  __syncthreads();
  if (table) {  // (rows, buckets) of UNSCALED q against this head's table slice
    for (int idx = tid; idx < FQ * NB; idx += 256) {
      const int rr = idx / NB, n = idx % NB;
      const float* tb = table + n * a.tn + h * a.th;
      float s = 0.f;
      for (int c = 0; c < dk; ++c) s = fmaf(Qs[rr][c], tb[c], s);
      Ix[rr][n] = s;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < FQ * dk; idx += 256) {
    const int rr = idx / dk, c = idx % dk;
    Qs[rr][c] *= a.scale;
  }
  __syncthreads();

  const int gq = q0 + r;
  const int dpt = dk / 4;  // output columns per thread
  const int32_t* drow = table ? a.dist + ((size_t)b * Lq + min(gq, Lq - 1)) * Lk : nullptr;
  float m_i = -INFINITY, l_i = 0.f;
  float acc[FDK / 4];
#pragma unroll
  for (int i = 0; i < FDK / 4; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += FK) {
    for (int idx = tid; idx < FK * dk; idx += 256) {
      const int kk = idx / dk, c = idx % dk, gk = k0 + kk;
      const bool ok = gk < Lk;
      Ks[kk][c] = ok ? k[gk * a.ks.sl + c] : 0.f;
      Vs[kk][c] = ok ? v[gk * a.vs.sl + c] : 0.f;
    }
    __syncthreads();

    float s[FK / 4];
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < FK / 4; ++jj) {
      const int j = cg * (FK / 4) + jj, gk = k0 + j;
      float acc_s = 0.f;
      for (int c = 0; c < dk; ++c) acc_s = fmaf(Qs[r][c], Ks[j][c], acc_s);
      if (drow && gk < Lk) {
        const int n = drow[gk];
        if (n >= 0 && n < NB) acc_s += Ix[r][n];
      }
      s[jj] = gk < Lk ? acc_s : -INFINITY;
      tmax = fmaxf(tmax, s[jj]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_i, tmax);  // finite: key k0 is always valid
    const float corr = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < FK / 4; ++jj) {
      const int j = cg * (FK / 4) + jj, gk = k0 + j;
      const float p = expf(s[jj] - m_new);
      psum += p;
      Ps[r][j] = drop_p(p, tr, gq < Lq && gk < Lk, dkey, (uint32_t)gq * Lk + gk);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * corr + psum;
    m_i = m_new;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < FDK / 4; ++i) {
      if (i < dpt) {
        const int c = cg * dpt + i;
        float acc_o = acc[i] * corr;
        for (int j = 0; j < FK; ++j) acc_o = fmaf(Ps[r][j], Vs[j][c], acc_o);
        acc[i] = acc_o;
      }
    }
    __syncthreads();
  }

  if (gq < Lq) {
    const float inv = 1.f / l_i;
#pragma unroll
    for (int i = 0; i < FDK / 4; ++i)
      if (i < dpt) o[gq * a.os.sl + cg * dpt + i] = acc[i] * inv;
    if (tr.lse && cg == 0) tr.lse[((size_t)b * gridDim.y + h) * Lq + gq] = m_i + logf(l_i);
  }
}

// Dynamic shared memory of the mma.sync body: q, 2 stages of k and v,
// the TRPE table's buckets (16 rows), then q.table (MQ, 16) in f32.
template <int DKP>
constexpr int attn_mma_smem() {
  return (MQ + 4 * MK + 16) * (DKP + 8) * 2 + MQ * 16 * 4;
}

// The mma.sync body: a block of MT threads owns MQ queries of head
// blockIdx.y of row blockIdx.z. vec bits: 16-byte copies of q (1), k (2),
// v (4), o (8), the table (16).
template <int DKP>
__device__ __forceinline__ void attn_sync_body(const AttnArgs& a, const AttnTrain& tr, unsigned vec) {
  constexpr int LD = DKP + 8, KS = DKP / 16, NT = DKP / 8;
  extern __shared__ __align__(16) unsigned char tcd_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tcd_smem);  // o is staged here at the end
  bf16* Ks = Qs + MQ * LD;
  bf16* Vs = Ks + 2 * MK * LD;
  bf16* Ts = Vs + 2 * MK * LD;
  float* Ix = reinterpret_cast<float*>(Ts + 16 * LD);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * MQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int Lq = a.Lq, Lk = a.Lk, dk = a.dk;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qs.sb + h * a.qs.sh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ks.sb + h * a.ks.sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.vs.sb + h * a.vs.sh;
  bf16* o = static_cast<bf16*>(a.o) + b * a.os.sb + h * a.os.sh;
  const bool bias = a.table != nullptr;
  const FragOff f = frag_off(lane);

  load_tile<MQ, DKP>(Qs, q, a.qs.sl, q0, Lq, dk, vec & 1);
  load_tile<MK, DKP>(Ks, k, a.ks.sl, 0, Lk, dk, vec & 2);
  load_tile<MK, DKP>(Vs, v, a.vs.sl, 0, Lk, dk, vec & 4);
  if (bias) load_tile<16, DKP>(Ts, static_cast<const bf16*>(a.table) + h * a.th, a.tn, 0, NB, dk, vec & 16);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldsm_x4(qf[kk], Qs + (warp * 16 + f.ra) * LD + kk * 16 + f.ca);
  float* ix = Ix + warp * 16 * 16;  // this warp's rows of q.table, buckets 0..15
  if (bias) {  // of the UNSCALED q
    float c[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t tb[4];
      ldsm_x4(tb, Ts + f.rb * LD + kk * 16 + f.cb);
      mma16816(c[0], qf[kk], tb[0], tb[1]);
      mma16816(c[1], qf[kk], tb[2], tb[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ix[g * 16 + 8 * j + 2 * t] = c[j][0];
      ix[g * 16 + 8 * j + 2 * t + 1] = c[j][1];
      ix[(g + 8) * 16 + 8 * j + 2 * t] = c[j][2];
      ix[(g + 8) * 16 + 8 * j + 2 * t + 1] = c[j][3];
    }
    __syncwarp();
  }
  const float sc = __bfloat162float(__float2bfloat16(a.scale));
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) qf[kk][i] = scale_pair(qf[kk][i], sc);

  // this thread's rows: g and g + 8 of the warp's 16
  int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int32_t* drow[2] = {nullptr, nullptr};
  if (bias)
    for (int i = 0; i < 2; ++i) drow[i] = a.dist + ((size_t)b * Lq + min(row[i], Lq - 1)) * Lk;
  const uint32_t dkey = drop_key(tr.dr, b, SALT_ATTN + h);
  constexpr float LOG2E = 1.4426950408889634f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  const int nk = (Lk + MK - 1) / MK;
  for (int it = 0; it < nk; ++it) {
    const bf16* Kst = Ks + (it & 1) * MK * LD;
    const bf16* Vst = Vs + (it & 1) * MK * LD;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1
    if (it + 1 < nk) {
      load_tile<MK, DKP>(Ks + ((it + 1) & 1) * MK * LD, k, a.ks.sl, (it + 1) * MK, Lk, dk, vec & 2);
      load_tile<MK, DKP>(Vs + ((it + 1) & 1) * MK * LD, v, a.vs.sl, (it + 1) * MK, Lk, dk, vec & 4);
    }
    cp_async_commit();

    float s[MK / 8][4];
#pragma unroll
    for (int j = 0; j < MK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < MK / 16; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, Kst + (np * 16 + f.rb) * LD + kk * 16 + f.cb);
        mma16816(s[2 * np], qf[kk], kb[0], kb[1]);
        mma16816(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }

    const int k0 = it * MK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < MK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1), i = e >> 1;
        float x = s[j][e];
        if (key >= Lk) {
          x = -INFINITY;
        } else if (bias) {
          const int n = drow[i][key];
          if (n >= 0 && n < NB) x += ix[(g + 8 * i) * 16 + n];
        }
        s[j][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float corr[2], ms[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);  // finite: key k0 is always valid
      corr[i] = exp2f((m[i] - m_new) * LOG2E);
      m[i] = m_new;
      ms[i] = m_new * LOG2E;
    }
#pragma unroll
    for (int j = 0; j < MK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1), i = e >> 1;
        const float p = exp2f(fmaf(s[j][e], LOG2E, -ms[i]));
        ps[i] += p;
        s[j][e] = drop_p(p, tr, row[i] < Lq && key < Lk, dkey, (uint32_t)row[i] * Lk + key);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + ps[i];  // this thread's share of the row sum
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, Vst + (kk * 16 + f.ra) * LD + dp * 16 + f.ca);
        mma16816(acc[2 * dp], pa, vb[0], vb[1]);
        mma16816(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (tr.lse && t == 0 && row[i] < Lq)
      tr.lse[((size_t)b * gridDim.y + h) * Lq + row[i]] = m[i] + logf(l[i]);
  }
  bf16* stg = Qs + warp * 16 * LD;  // this warp's q rows, read only before the loop
  stage_rows16<DKP>(stg, acc, 1.f / l[0], 1.f / l[1], lane);
  __syncwarp();
  store_rows16<DKP>(stg, o, a.os.sl, q0 + warp * 16, Lq, dk, vec & 8, lane);
}

// ------------------------------------------------ bf16 at dk = 64: wgmma
constexpr int AWQ = 128;            // queries a tile: two consumer warpgroups of 64
constexpr int AWK = 128;            // keys a ring stage, taken as two halves of 64
constexpr int AW_STAGES = 4;        // the k/v ring's depth
constexpr int AW_THREADS = 384;     // two consumer warpgroups and the producer's
constexpr int AW_TILE = AWQ * 128;  // bytes of 128 rows of 64 bf16 columns (128-byte swizzled rows)
// Dynamic shared memory of the wgmma body: 1024 bytes of slack to align the
// swizzled tiles; q; o (64 rows a consumer warpgroup); the k and v stages;
// the barriers (q full and empty, each stage's full and empty).
constexpr int AW_SMEM = 1024 + 2 * AW_TILE + 2 * AW_STAGES * AW_TILE + (2 + 2 * AW_STAGES) * 8;

// The tensor maps of a wgmma call: q, k, v, o as (dk, L, H, B), q, k and v
// in boxes of 128 rows, o in boxes of 64 (a consumer warpgroup's rows).
struct AttnMaps {
  CUtensorMap q, k, v, o;
};

// d (64 x 64 f32, the warpgroup's accumulator) = A (64 x 16: each warp's
// 16 rows in registers, laid out as mma.sync's A fragment) . B (16 x 64 in
// shared memory at descriptor db) + (scale_d ? d : 0). TB: B K-major (0)
// or N-major (1, read through the descriptor's transpose).
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// Row r, 16-byte piece c of a tile of 128-byte rows in the 128-byte swizzle
// (TMA's layout: piece c of row r lies at piece c ^ (r % 8)).
__device__ __forceinline__ unsigned char* sw128(unsigned char* tile, int r, int c) {
  return tile + r * 128 + ((c ^ (r & 7)) << 4);
}

struct AwSmem {
  unsigned char *q, *o, *k, *v;  // 1024-byte aligned tiles
  uint64_t *q_full, *q_empty, *kv_full, *kv_empty;
};

// The tile walk of a block: tile t is query tile t % nqt of head (t / nqt)
// % H of row t / (nqt H), so the query tiles of a head run on neighbouring
// blocks at about the same time.
struct AwTile {
  int qt, h, b;
};
__device__ __forceinline__ AwTile aw_tile(int t, int nqt, int H) {
  const int bh = t / nqt;
  return AwTile{t - bh * nqt, bh % H, bh / H};
}

// The producer warpgroup: registers to the consumers; its first thread
// loads each tile's q once the consumers hold the previous one in
// registers, and its k and v stages into the ring as the consumers free
// them, running ahead into the next tile.
__device__ __forceinline__ void attn_wg_produce(const AttnMaps& mp, const AttnArgs& a, int H, int B,
                                                const AwSmem& sm) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
  if (threadIdx.x != 2 * 128) return;
  const int nqt = (a.Lq + AWQ - 1) / AWQ, nkt = (a.Lk + AWK - 1) / AWK, tiles = nqt * H * B;
  int kv = 0;  // stages loaded so far
  for (int t = blockIdx.x, it = 0; t < tiles; t += gridDim.x, ++it) {
    const AwTile w = aw_tile(t, nqt, H);
    if (it > 0) mbar_wait(sm.q_empty, (it - 1) & 1);
    mbar_expect_tx(sm.q_full, AW_TILE);
    tma_load4(sm.q, &mp.q, 0, w.qt * AWQ, w.h, w.b, sm.q_full);
    for (int kt = 0; kt < nkt; ++kt, ++kv) {
      const int st = kv % AW_STAGES;
      if (kv >= AW_STAGES) mbar_wait(sm.kv_empty + st, (kv / AW_STAGES - 1) & 1);
      mbar_expect_tx(sm.kv_full + st, 2 * AW_TILE);
      tma_load4(sm.k + st * AW_TILE, &mp.k, 0, kt * AWK, w.h, w.b, sm.kv_full + st);
      tma_load4(sm.v + st * AW_TILE, &mp.v, 0, kt * AWK, w.h, w.b, sm.kv_full + st);
    }
  }
}

// The descriptor of half u of a tile's keys (64 u .. 64 u + 63) in the
// ring of k or v tiles, kv the ring stages consumed before the tile: stage
// (kv + u / 2) % AW_STAGES, rows 64 (u % 2) onwards.
__device__ __forceinline__ uint64_t aw_half(unsigned char* ring, int kv, int u) {
  return wg_desc(smem_addr(ring + ((kv + u / 2) % AW_STAGES) * AW_TILE + (u & 1) * 64 * 128));
}
// S = q . k^T over a half (k K-major: its 16-column slices 32 bytes apart).
__device__ __forceinline__ void aw_qk(float (&s)[32], const uint32_t (&qf)[4][4], uint64_t d) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs<0>(s, qf[kk], d + 2 * kk, kk > 0);
}
// o (+)= p . v over a half (v N-major: 16 keys 2048 bytes apart); the
// first half starts the sums.
__device__ __forceinline__ void aw_pv(float (&o)[32], const uint32_t (&p)[4][4], uint64_t d, bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs<1>(o, p[kk], d + kk * (2048 >> 4), !first || kk > 0);
}

// The f32 softmax of the half of keys k0 .. k0 + 63 in s, the mma.sync
// body's of its 64-key tile step for step: the key mask, the running max
// m (exact in any order, so taken as a tree), the normaliser l (this
// thread's share, summed in that body's order); s becomes the
// probabilities that enter the product with v (dropped where the train
// forward drops them, DROP), corr the factor of the earlier sums.
// 2^x as the SFU computes it (MUFU.EX2), results below 2^-126 flushed to
// zero: exp2f is the same instruction plus 4 more that keep such results
// as subnormals, which change no sum here (each row's normaliser is at
// least 1, each output at least its largest term's bf16 ulp), and the
// body took 12% less time without them (PERF.md).
__device__ __forceinline__ float aw_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <bool DROP>
__device__ __forceinline__ void aw_softmax(float (&s)[32], float (&m)[2], float (&l)[2], float (&corr)[2], int k0,
                                           int Lq, int Lk, const int (&row)[2], int t, const AttnTrain& tr,
                                           uint32_t dkey) {
  constexpr float LOG2E = 1.4426950408889634f;
  float ms[2], ps[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k0 + 8 * j + 2 * t + (e & 1) >= Lk) s[4 * j + e] = -INFINITY;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
#pragma unroll
    for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) v[j] = fmaxf(v[j], v[j + w]);
    float mx = fmaxf(v[0], __shfl_xor_sync(0xffffffffu, v[0], 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);  // finite: key k0 is always valid
    corr[i] = aw_exp2((m[i] - m_new) * LOG2E);
    m[i] = m_new;
    ms[i] = m_new * LOG2E;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1, key = k0 + 8 * j + 2 * t + (e & 1);
      const float pe = aw_exp2(fmaf(s[4 * j + e], LOG2E, -ms[i]));
      ps[i] += pe;
      s[4 * j + e] = DROP ? drop_p(pe, tr, row[i] < Lq && key < Lk, dkey, (uint32_t)row[i] * Lk + key) : pe;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + ps[i];
}

// p, wgmma's A over a half's 4 slices of 16 keys, from s rounded to bf16
// (c_to_a of each slice's two 8-key fragments).
__device__ __forceinline__ void aw_pack(uint32_t (&p)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// The consumer warpgroups take turns to issue their wgmmas (named barriers
// 4 and 5): warpgroup wg waits for its turn (aw_turn), issues, and passes
// the turn to the other (aw_pass), so that one's softmax runs while the
// tensor cores work through the other's products (measured 4% faster
// than issuing freely, PERF.md).
__device__ __forceinline__ void aw_turn(int wg) { asm volatile("bar.sync %0, 256;\n" ::"r"(4 + wg) : "memory"); }
__device__ __forceinline__ void aw_pass(int wg) { asm volatile("bar.arrive %0, 256;\n" ::"r"(5 - wg) : "memory"); }

// Half u >= 1 of a tile: S of half u and p.v of half u - 1 on the tensor
// cores, then half u's softmax while the p.v runs; o then holds the
// halves before u at half u's max, p half u's probabilities. No branch:
// one inside the softmax's region measured 9% slower (PERF.md).
template <bool DROP>
__device__ __forceinline__ void aw_step(int u, float (&s)[32], float (&o)[32], uint32_t (&p)[4][4],
                                        const uint32_t (&qf)[4][4], float (&m)[2], float (&l)[2], float (&corr)[2],
                                        const AwSmem& sm, int kv, int Lq, int Lk, const int (&row)[2], int t, int wg,
                                        const AttnTrain& tr, uint32_t dkey) {
  aw_turn(wg);
  wgmma_fence();
  aw_qk(s, qf, aw_half(sm.k, kv, u));
  wgmma_commit();
  aw_pv(o, p, aw_half(sm.v, kv, u - 1), u == 1);  // in flight while half u's softmax runs
  wgmma_commit();
  aw_pass(wg);
  wgmma_wait<1>();
  aw_softmax<DROP>(s, m, l, corr, 64 * u, Lq, Lk, row, t, tr, dkey);
  wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    o[4 * n] *= corr[0];
    o[4 * n + 1] *= corr[0];
    o[4 * n + 2] *= corr[1];
    o[4 * n + 3] *= corr[1];
  }
  aw_pack(p, s);
}

// A consumer warpgroup (wg): 64 queries of each tile of the block's walk,
// over the halves of its keys; DROP: the train forward's dropout.
template <bool DROP>
__device__ __forceinline__ void attn_wg_consume(const AttnMaps& mp, const AttnArgs& a, const AttnTrain& tr, int H,
                                                int B, const AwSmem& sm) {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2,
            t = lane & 3;
  const int Lq = a.Lq, Lk = a.Lk, nqt = (Lq + AWQ - 1) / AWQ, nkt = (Lk + AWK - 1) / AWK, nh = (Lk + 63) / 64;
  const int tiles = nqt * H * B;
  const FragOff f = frag_off(lane);
  const float sc = __bfloat162float(__float2bfloat16(a.scale));
  unsigned char* const ob = sm.o + wg * 64 * 128;  // this warpgroup's o rows
  const int wr = warp * 16 + g;                    // this thread's first row of the warpgroup's 64
  int kv = 0;                                      // ring stages consumed before this tile
  if (wg == 1) aw_pass(wg);                        // warpgroup 0 issues first

  for (int tile = blockIdx.x, it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const AwTile w = aw_tile(tile, nqt, H);
    const int r0 = w.qt * AWQ + wg * 64;  // the warpgroup's first query
    // q: this warp's 16 rows as A fragments, T(q * T(scale)) as the mma.sync body
    uint32_t qf[4][4];
    mbar_wait(sm.q_full, it & 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldsm_x4(qf[kk], reinterpret_cast<const bf16*>(sw128(sm.q, wg * 64 + warp * 16 + f.ra, 2 * kk + (f.ca >> 3))));
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[kk][i] = scale_pair(qf[kk][i], sc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.q_empty);

    const int row[2] = {r0 + wr, r0 + wr + 8};
    const uint32_t dkey = drop_key(tr.dr, w.b, SALT_ATTN + w.h);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
    float s[32], o[32];
    uint32_t p[4][4];
    mbar_wait(sm.kv_full + kv % AW_STAGES, (kv / AW_STAGES) & 1);
    aw_turn(wg);
    wgmma_fence();
    aw_qk(s, qf, aw_half(sm.k, kv, 0));
    wgmma_commit();
    aw_pass(wg);
    wgmma_wait<0>();
    aw_softmax<DROP>(s, m, l, corr, 0, Lq, Lk, row, t, tr, dkey);
    aw_pack(p, s);
    // halves 1 .. nh - 1 in pairs, one stage a pair: an odd half shares its
    // stage with the half before it; an even half waits for its own, and
    // once its step is done (the odd half's p.v among it) the odd half's
    // stage is free
    for (int u = 1; u + 1 < nh; u += 2) {
      aw_step<DROP>(u, s, o, p, qf, m, l, corr, sm, kv, Lq, Lk, row, t, wg, tr, dkey);
      mbar_wait(sm.kv_full + (kv + (u + 1) / 2) % AW_STAGES, ((kv + (u + 1) / 2) / AW_STAGES) & 1);
      aw_step<DROP>(u + 1, s, o, p, qf, m, l, corr, sm, kv, Lq, Lk, row, t, wg, tr, dkey);
      if (lane == 0) mbar_arrive(sm.kv_empty + (kv + u / 2) % AW_STAGES);
    }
    if (nh > 1 && !(nh & 1)) aw_step<DROP>(nh - 1, s, o, p, qf, m, l, corr, sm, kv, Lq, Lk, row, t, wg, tr, dkey);
    aw_turn(wg);
    wgmma_fence();
    aw_pv(o, p, aw_half(sm.v, kv, nh - 1), nh == 1);
    wgmma_commit();
    if (wg == 0 || tile + (int)gridDim.x < tiles) aw_pass(wg);  // no turn is left to pass after the last
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(sm.kv_empty + (kv + (nh - 1) / 2) % AW_STAGES);
    kv += nkt;

    // Epilogue: the lse; o / l rounded to bf16 into the warpgroup's swizzled
    // tile (once its previous store has read it), then one TMA store.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      if (tr.lse && t == 0 && row[i] < Lq) tr.lse[((size_t)w.b * H + w.h) * Lq + row[i]] = m[i] + logf(l[i]);
    }
    const float f0 = 1.f / l[0], f1 = 1.f / l[1];
    if ((threadIdx.x & 127) == 0) bulk_wait_read<0>();
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");  // the tile is free
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(sw128(ob, wr, n) + 4 * t) = pack_bf16(o[4 * n] * f0, o[4 * n + 1] * f0);
      *reinterpret_cast<uint32_t*>(sw128(ob, wr + 8, n) + 4 * t) = pack_bf16(o[4 * n + 2] * f1, o[4 * n + 3] * f1);
    }
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");  // the tile is written
    if ((threadIdx.x & 127) == 0 && r0 < Lq) {
      tma_store4(&mp.o, ob, 0, r0, w.h, w.b);
      bulk_commit();
    }
  }
  if ((threadIdx.x & 127) == 0) bulk_wait<0>();
}

// The wgmma body: the ring in dynamic shared memory, then the roles.
__device__ __forceinline__ void attn_wg_body(const AttnMaps& mp, const AttnArgs& a, const AttnTrain& tr, int H,
                                             int B) {
  extern __shared__ __align__(16) unsigned char tcd_smem[];
  unsigned char* base = tcd_smem + ((1024 - (smem_addr(tcd_smem) & 1023)) & 1023);
  AwSmem sm;
  sm.q = base;
  sm.o = base + AW_TILE;
  sm.k = base + 2 * AW_TILE;
  sm.v = sm.k + AW_STAGES * AW_TILE;
  sm.q_full = reinterpret_cast<uint64_t*>(sm.v + AW_STAGES * AW_TILE);
  sm.q_empty = sm.q_full + 1;
  sm.kv_full = sm.q_full + 2;
  sm.kv_empty = sm.kv_full + AW_STAGES;
  if (threadIdx.x == 0) {
    mbar_init(sm.q_full, 1);
    mbar_init(sm.q_empty, 8);  // lane 0 of every consumer warp
    for (int st = 0; st < AW_STAGES; ++st) {
      mbar_init(sm.kv_full + st, 1);
      mbar_init(sm.kv_empty + st, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 256)
    attn_wg_produce(mp, a, H, B, sm);
  else if (tr.dr.on)
    attn_wg_consume<true>(mp, a, tr, H, B, sm);
  else
    attn_wg_consume<false>(mp, a, tr, H, B, sm);
}

// The bf16 attention kernel: the wgmma body (WG, DKP = 64) or the mma.sync
// body; one launch a call either way. H heads, B rows (the wgmma body's
// persistent grid walks them; the mma.sync body's grid holds them).
// The mma.sync body is held to 3, 4, 4 and 5 blocks an SM at DKP 64, 48,
// 32 and 16: left free, ptxas gives it 126-173 registers in this kernel
// and a block an SM less, up to 27% slower (PERF.md).
template <int DKP, bool WG>
__global__ void __launch_bounds__(WG ? AW_THREADS : MT, WG ? 1 : DKP == 64 ? 3 : DKP == 16 ? 5 : 4)
    attn_mma_kernel(const __grid_constant__ AttnMaps maps, AttnArgs a, AttnTrain tr, unsigned vec, int H, int B) {
  if constexpr (WG) {
    static_assert(DKP == 64, "the wgmma body reads 128-byte rows: dk = 64");
    attn_wg_body(maps, a, tr, H, B);
  } else {
    attn_sync_body<DKP>(a, tr, vec);
  }
}

// ------------------------------------------------------------------ host
enum AttnBody { ATTN_FMA = 0, ATTN_MMA = 1, ATTN_WGMMA = 2 };

// Launches of each bf16 body in this library since it was loaded
// ({mma.sync, wgmma}), counted on the host as they are enqueued; internal
// linkage, as body_launches.
static inline long long* attn_body_launches() {
  static long long n[2] = {0, 0};
  return n;
}

// Whether TMA can address an operand of rows (b, h, l) at p + b*sb + h*sh +
// l*sl with 64 columns: a 16-byte aligned base and every stride a positive
// multiple of 16 bytes.
inline bool attn_tma_ok(const void* p, const Strides& s) {
  return al16(p) && s.sb > 0 && s.sh > 0 && s.sl > 0 && s.sb % 8 == 0 && s.sh % 8 == 0 && s.sl % 8 == 0;
}

// The plan of a call (the dispatch rule): the body, the queries a block
// (or a tile) holds, the keys a tile holds, the grid. bf16 calls of head
// width 64 with no TRPE table whose operands TMA addresses (aligned) run
// the wgmma body, a persistent grid of min(tiles, sms) blocks; other bf16
// calls the mma.sync body, f32 the FMA body, a block for each (query
// tile, head, row).
struct AttnPlan {
  int body, q_block, k_tile, grid[3];
};
inline AttnPlan attn_plan(bool bf16_call, int dk, bool has_table, bool aligned, int Lq, int rows, int heads,
                          int sms) {
  if (!bf16_call) return AttnPlan{ATTN_FMA, FQ, FK, {cdiv(Lq, FQ), heads, rows}};
  if (dk == 64 && !has_table && aligned) {
    const long long tiles = (long long)cdiv(Lq, AWQ) * heads * rows;
    return AttnPlan{ATTN_WGMMA, AWQ, AWK, {(int)std::min<long long>(tiles, sms), 1, 1}};
  }
  return AttnPlan{ATTN_MMA, MQ, MK, {cdiv(Lq, MQ), heads, rows}};
}

// The map of a (dk = 64, L, H, B) operand in boxes of box_rows rows.
inline bool attn_map(CUtensorMap* out, const void* p, const Strides& s, int L, int H, int B, int box_rows) {
  const cuuint64_t dims[4] = {64, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.sl * 2, (cuuint64_t)s.sh * 2, (cuuint64_t)s.sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  return tma_map_nd(out, p, 4, dims, strides, box);
}

template <int DKP>
inline void attention_mma(const AttnArgs& a, const AttnTrain& tr, int B, int H, cudaStream_t st) {
  const unsigned vec = (rows16(a.q, a.qs.sb, a.qs.sh, a.qs.sl, a.dk) ? 1u : 0u) |
                       (rows16(a.k, a.ks.sb, a.ks.sh, a.ks.sl, a.dk) ? 2u : 0u) |
                       (rows16(a.v, a.vs.sb, a.vs.sh, a.vs.sl, a.dk) ? 4u : 0u) |
                       (rows16(a.o, a.os.sb, a.os.sh, a.os.sl, a.dk) ? 8u : 0u) |
                       (a.table && rows16(a.table, 0, a.th, a.tn, a.dk) ? 16u : 0u);
  ++attn_body_launches()[0];
  launch_mma(attn_mma_kernel<DKP, false>, dim3(cdiv(a.Lq, MQ), H, B), MT, attn_mma_smem<DKP>(), st, AttnMaps{}, a,
             tr, vec, H, B);
}

// The wgmma body's launch; a map that cuTensorMapEncodeTiled does not
// encode is refused (the wrapper raises).
inline void attention_wg(const AttnArgs& a, const AttnTrain& tr, int B, int H, int grid, cudaStream_t st) {
  AttnMaps m;
  if (!attn_map(&m.q, a.q, a.qs, a.Lq, H, B, AWQ) || !attn_map(&m.k, a.k, a.ks, a.Lk, H, B, AWK) ||
      !attn_map(&m.v, a.v, a.vs, a.Lk, H, B, AWK) || !attn_map(&m.o, a.o, a.os, a.Lq, H, B, 64))
    return refuse();
  ++attn_body_launches()[1];
  launch_mma(attn_mma_kernel<64, true>, dim3(grid), AW_THREADS, AW_SMEM, st, m, a, tr, 0u, H, B);
}

// B batch elements x H heads; the caller has checked dk (<= 64, a multiple
// of 4). float takes the FMA kernel, bf16 the wgmma or the mma.sync body
// by attn_plan.
template <typename T>
inline void attention(const AttnArgs& a, int B, int H, cudaStream_t st, const AttnTrain& tr = AttnTrain{}) {
  if constexpr (std::is_same<T, float>::value) {
    attn_fma_kernel<<<dim3(cdiv(a.Lq, FQ), H, B), 256, 0, st>>>(a, tr);
  } else {
    static_assert(std::is_same<T, bf16>::value, "attention takes float or bfloat16");
    const bool aligned = attn_tma_ok(a.q, a.qs) && attn_tma_ok(a.k, a.ks) && attn_tma_ok(a.v, a.vs) &&
                         attn_tma_ok(a.o, a.os);
    const AttnPlan plan = attn_plan(true, a.dk, a.table != nullptr, aligned, a.Lq, B, H, device_sms());
    if (plan.body == ATTN_WGMMA) return attention_wg(a, tr, B, H, plan.grid[0], st);
    switch ((a.dk + 15) / 16) {
      case 1: attention_mma<16>(a, tr, B, H, st); break;
      case 2: attention_mma<32>(a, tr, B, H, st); break;
      case 3: attention_mma<48>(a, tr, B, H, st); break;
      default: attention_mma<64>(a, tr, B, H, st); break;
    }
  }
}

// softmax(T(q * T(1/sqrt(dk))) . k^T [+ TRPE bias]) . v per head, with
// q, o (B, Lq, hd) and k, v (B, Lk, hd), head h in columns [h*dk, (h+1)*dk);
// table (10, hd) and dist (B, Lq, Lk), or null for no bias.
template <typename T>
inline void heads_attention(const T* q, const T* k, const T* v, T* o, int B, int Lq, int Lk, int hd,
                            int nhead, const T* table, const int32_t* dist, cudaStream_t st,
                            const AttnTrain& tr = AttnTrain{}) {
  const int dk = hd / nhead;
  AttnArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.qs = a.os = Strides{(long long)Lq * hd, dk, hd};
  a.ks = a.vs = Strides{(long long)Lk * hd, dk, hd};
  a.Lq = Lq;
  a.Lk = Lk;
  a.dk = dk;
  a.scale = 1.f / sqrtf((float)dk);
  a.table = table;
  a.tn = hd;
  a.th = dk;
  a.dist = dist;
  attention<T>(a, B, nhead, st, tr);
}

}  // namespace tcd

// The launches of each bf16 attention body this library has enqueued
// ({mma.sync, wgmma}), for tests and measurement.
extern "C" void tcd_attn_body_launches(long long* out) {
  out[0] = tcd::attn_body_launches()[0];
  out[1] = tcd::attn_body_launches()[1];
}
// The dispatch rule's plan of a call (tcd::attn_plan), for tests: out =
// {body (0 FMA, 1 mma.sync, 2 wgmma), queries a block, keys a tile, grid x,
// y, z}. dtype: 0 = float32, 1 = bfloat16.
extern "C" void tcd_attn_plan(int dtype, int dk, int has_table, int aligned, int Lq, int rows, int heads, int sms,
                              int* out) {
  const tcd::AttnPlan p = tcd::attn_plan(dtype == 1, dk, has_table != 0, aligned != 0, Lq, rows, heads, sms);
  const int v[6] = {p.body, p.q_block, p.k_tile, p.grid[0], p.grid[1], p.grid[2]};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}
