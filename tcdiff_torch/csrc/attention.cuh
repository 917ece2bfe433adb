// Flash-style softmax attention with the optional TRPE bias, shared by the
// self-attention block (sa_block.cu, K1) and the standalone attention
// (attention.cu, K11).
//
//   o = softmax(T(q * T(scale)) . k^T [+ bias]) . v      per (batch, head)
//   bias[i, j] = q_unscaled[i] . table[dist[i, j], head]  where 0 <= dist < 10
//
// as the TPU kernels (fused_sa_block.py, fused_attention.py): the scaled q
// is rounded to T before the logits, the logits and softmax run in f32, and
// the probabilities enter the product with v in T. The TPU keeps a head's
// whole (Lq, Lk) logits in VMEM; a Hopper block has 227 KB of shared memory
// (810 KB would be one 450 x 450 f32 head), so here one block owns 64
// queries of one head and streams 32-key tiles with an online softmax: no
// logit row leaves the block and shared memory stays under 48 KB.
//
// Tensors are addressed through strides, so q, k and v may be views: a
// head split (b, L, h*dk) or a (b, h, L, dk) array alike. dk <= 64 and a
// multiple of 4 (4 threads own a query, dk / 4 output columns each).
#pragma once

#include "common.cuh"

namespace tcd {

constexpr int FQ = 64;     // queries per block
constexpr int FK = 32;     // keys per tile
constexpr int FDK = 64;    // largest head dim
constexpr int NB = 10;     // TRPE buckets

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

template <typename T>
__global__ void __launch_bounds__(256) attn_kernel(AttnArgs a) {
  __shared__ float Qs[FQ][FDK + 1];
  __shared__ float Ks[FK][FDK + 1];
  __shared__ float Vs[FK][FDK];
  __shared__ float Ps[FQ][FK + 1];
  __shared__ float Ix[FQ][NB];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FQ;
  const int tid = threadIdx.x, r = tid >> 2, cg = tid & 3;  // 4 threads per query row
  const int Lq = a.Lq, Lk = a.Lk, dk = a.dk;
  const T* q = static_cast<const T*>(a.q) + b * a.qs.sb + h * a.qs.sh;
  const T* k = static_cast<const T*>(a.k) + b * a.ks.sb + h * a.ks.sh;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.sb + h * a.vs.sh;
  T* o = static_cast<T*>(a.o) + b * a.os.sb + h * a.os.sh;
  const T* table = static_cast<const T*>(a.table);

  for (int idx = tid; idx < FQ * dk; idx += 256) {
    const int rr = idx / dk, c = idx % dk, gq = q0 + rr;
    Qs[rr][c] = gq < Lq ? to_f(q[gq * a.qs.sl + c]) : 0.f;
  }
  __syncthreads();
  if (table) {  // (rows, buckets) of UNSCALED q against this head's table slice
    for (int idx = tid; idx < FQ * NB; idx += 256) {
      const int rr = idx / NB, n = idx % NB;
      const T* tb = table + n * a.tn + h * a.th;
      float s = 0.f;
      for (int c = 0; c < dk; ++c) s = fmaf(Qs[rr][c], to_f(tb[c]), s);
      Ix[rr][n] = s;
    }
  }
  __syncthreads();
  const float sc = round_t<T>(a.scale);
  for (int idx = tid; idx < FQ * dk; idx += 256) {
    const int rr = idx / dk, c = idx % dk;
    Qs[rr][c] = round_t<T>(Qs[rr][c] * sc);  // q * scale, rounded like the TPU kernel's
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
      Ks[kk][c] = ok ? to_f(k[gk * a.ks.sl + c]) : 0.f;
      Vs[kk][c] = ok ? to_f(v[gk * a.vs.sl + c]) : 0.f;
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
      const float p = expf(s[jj] - m_new);
      psum += p;
      Ps[r][cg * (FK / 4) + jj] = round_t<T>(p);  // p enters the PV product in T
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
      if (i < dpt) o[gq * a.os.sl + cg * dpt + i] = from_f<T>(acc[i] * inv);
  }
}

// B batch elements x H heads; the caller has checked dk.
template <typename T>
inline void attention(const AttnArgs& a, int B, int H, cudaStream_t st) {
  attn_kernel<T><<<dim3(cdiv(a.Lq, FQ), H, B), 256, 0, st>>>(a);
}

}  // namespace tcd
