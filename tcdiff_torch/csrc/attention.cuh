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
// and 4.4 us of HBM traffic. So the products have to run on the tensor
// cores, and the tiles have to arrive while the previous one is used.
//
// bf16: attn_mma_kernel, FlashAttention-2's forward on mma.sync.m16n8k16
// (mma.cuh). A block of 4 warps owns 64 queries, 16 per warp; q is loaded
// once, scaled and rounded in registers and kept as A fragments; 64-key
// tiles of k and v stream through a 2-stage shared ring filled by 16-byte
// cp.async, the next tile in flight while this one is used; S = q.k^T, the
// key mask, the TRPE bias (q.table^T is one more small mma) and the online
// softmax stay in registers, with quad shuffles for the row max; the
// probabilities are rounded to bf16 and repacked from C to A fragments for
// o += p.v (v through ldmatrix.trans); the epilogue stages o in shared
// memory and writes 16-byte rows.
//
// f32: attn_fma_kernel, the FMA units over f32 tiles (32-key tiles, 4
// threads per query). The tensor cores take f32 only as TF32, which would
// break the f32 agreement with the plain version; so f32 keeps this body.
//
// Tensors are addressed through strides, so q, k and v may be views: a
// head split (b, L, h*dk) or a (b, h, L, dk) array alike. dk <= 64 and a
// multiple of 4; the bf16 kernel pads it to 16, 32, 48 or 64 in shared
// memory, and copies 16-byte pieces where every row start is 16-byte
// aligned and dk % 8 == 0, else 2-byte elements.
#pragma once

#include <type_traits>

#include "mma.cuh"

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

// Dynamic shared memory of attn_mma_kernel<DKP>: q, 2 stages of k and v,
// the TRPE table's buckets (16 rows), then q.table (MQ, 16) in f32.
template <int DKP>
constexpr int attn_mma_smem() {
  return (MQ + 4 * MK + 16) * (DKP + 8) * 2 + MQ * 16 * 4;
}

// vec bits: 16-byte copies of q (1), k (2), v (4), o (8), the table (16).
template <int DKP>
__global__ void __launch_bounds__(MT) attn_mma_kernel(AttnArgs a, AttnTrain tr, unsigned vec) {
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

template <int DKP>
inline void attention_mma(const AttnArgs& a, const AttnTrain& tr, int B, int H, cudaStream_t st) {
  const unsigned vec = (rows16(a.q, a.qs.sb, a.qs.sh, a.qs.sl, a.dk) ? 1u : 0u) |
                       (rows16(a.k, a.ks.sb, a.ks.sh, a.ks.sl, a.dk) ? 2u : 0u) |
                       (rows16(a.v, a.vs.sb, a.vs.sh, a.vs.sl, a.dk) ? 4u : 0u) |
                       (rows16(a.o, a.os.sb, a.os.sh, a.os.sl, a.dk) ? 8u : 0u) |
                       (a.table && rows16(a.table, 0, a.th, a.tn, a.dk) ? 16u : 0u);
  launch_mma(attn_mma_kernel<DKP>, dim3(cdiv(a.Lq, MQ), H, B), MT, attn_mma_smem<DKP>(), st, a, tr, vec);
}

// B batch elements x H heads; the caller has checked dk (<= 64, a multiple
// of 4). float takes the FMA kernel, bf16 the tensor-core one.
template <typename T>
inline void attention(const AttnArgs& a, int B, int H, cudaStream_t st, const AttnTrain& tr = AttnTrain{}) {
  if constexpr (std::is_same<T, float>::value) {
    attn_fma_kernel<<<dim3(cdiv(a.Lq, FQ), H, B), 256, 0, st>>>(a, tr);
  } else {
    static_assert(std::is_same<T, bf16>::value, "attention takes float or bfloat16");
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
