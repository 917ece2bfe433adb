// Cross-attention block of the FiLM decoder layer on the serving path, for
// Hopper (sm_90a): K7 of the port, in two forms.
//
// tcd_ca_block replaces tcdiff_tpu/ops/fused_ca_block.py::fused_ca_block
// (the Pallas program _ca_block_kernel, one VMEM-resident program per
// batch element):
//
//   r  = rot(LN(x; eps1))                 on the full model vector, f32
//   q  = T(r).Wq   k = mem_rot.Wk   v = mem.Wv          (bias-free)
//   o  = per-head softmax(T(q * T(1/sqrt(dk))) . k^T) . v   (Lq x Lm)
//   ca = LN(o.Wfc; eps2)      [out = x + (fs+1)*ca + fb]   (optional FiLM)
//
// k comes from the memory rotated beforehand with its own length's angles
// (the caller's apply_rotary), v from the raw memory; there is no TRPE on
// cross-attention. It serves the configuration with the block kernel on
// and the k/v cache off (TCDIFF_PALLAS_XAB=1, TCDIFF_KV_CACHE=0).
//
// What bounds it on the H100: at the serving shape (b=8, L=450, Lm=152,
// d=512, 8x64 heads) 3.8 GFLOP of q and fc, 1.3 GFLOP of k/v and 1.1
// GFLOP of attention against ~10 MB: operations, ~6.2 us at the bf16
// tensor-core peak.
//
// Design, bf16, 4 launches: one grouped launch of the projection
// (gemm_mma.cuh) takes the memory's k and v over its B * Lm rows into T
// (the TPU kernel rounds each head's k and v to the compute dtype); q =
// T(rot(LN(x))).Wq in one launch with the LayerNorm and the rotary in its
// prologue (gemm_lnrot: the blocks of a row tile along N run as one
// cluster, each normalising a share of the tile's rows into every block's
// shared memory, so rot(LN(x)) never goes to device memory); the flash
// attention of attention.cuh with Lq != Lk (as K11 runs it); the fc GEMM
// with the post-LN and the FiLM residual in its epilogue (gemm_ln_wg of
// gemm_wgmma.cuh on the wgmma body: a cluster along N holds whole rows).
// f32, 6 launches, keeps the unfused sequence: the LN + rotary row kernel
// into r, q, the attention, fc into an f32 scratch and a row kernel. The
// projections and the attention run on the tensor cores in bf16, on the
// FMA units in f32. K6 (layer.cu) runs the same attention and fc steps
// against the cached k/v.
//
// tcd_ca_kv is the same block over k/v projected beforehand, the serving
// default where the k/v are hoisted (the cond cache's music rows of the
// layer and the step's two time-token rows, each in its own tensor), with
// the FiLM residual inside:
//
//   out = x + (fs+1) * LN(attn(q = T(rot(LN(x))).Wq; k, v) . Wfc; eps2) + fb
//
// The TPU has no kernel for it: there the JAX package's XLA code runs this
// site. What bounds it on the H100: at the benchmark's 256 rows (128 clips
// under CFG), L = 450, Lm = 150 + 2, d = 512, 8 x 64 heads, q and fc are
// 60.4 GFLOP each and the attention 35.8 against ~0.4 GB a layer:
// operations, ~0.16 ms a layer at the bf16 peak. Design, 3 launches: q by
// cross_q (gemm_lnrot in bf16), the attention by xattn_short_kernel below,
// fc by fc_post_ln (gemm_ln_wg with the post-LN and the FiLM rows in f32
// in its epilogue). No k/v row is copied: the attention reads the two sources
// where they lie.
//
// xattn_short_kernel (bf16): the memory is short (Lk <= 256), so a block
// holds one head's whole k and v (152 x 64 each, 39 KB) in shared memory
// beside 128 queries, and the softmax takes one pass: S = q.k^T of a warp's
// 16 rows against every key stays in registers (NKT m16 key tiles), the
// row max and sum by quad shuffles, the probabilities normalised and then
// rounded to bf16 (as the plain version rounds softmax's output), and o =
// p.v on mma.sync.m16n8k16; no online rescaling and no partial key tile
// to stream. 4 warps of 2 m16 query tiles each; k and v arrive once a
// block by 16-byte cp.async with q; o is staged over the warp's q rows and
// stored in 16-byte rows. Its name keeps out of the attn_ prefix, which
// names the self-attention's kernels. f32: xattn_short_fma_kernel, the same
// one pass on the FMA units (a warp a query row, a lane a key then an
// output column), as the f32 attention of attention.cuh keeps f32 off
// TF32.
#include "blocks.cuh"

// Pointers, then the ints, then the floats: the layout of the ctypes
// mirror in ops/ca_block.py. fs/fb null: no FiLM residual.
struct CaBlockArgs {
  const void* x;
  const float *s1, *b1;
  const void *cos, *ssin, *mem, *mrot, *wq, *wk, *wv, *wfc;
  const float *s2, *b2, *fs, *fb;
  void *r, *q, *k, *v, *o;
  float* z;
  void* out;
  int B, L, Lm, d, hd, nhead;
  float eps1, eps2;
};

// tcd_ca_kv's: k and v of the Lm music rows (km, vm) and the Lt time rows
// (kt, vt), row l of batch b at p + b * *_sb + l * *_sl (elements).
struct CaKvArgs {
  const void* x;
  const float *s1, *b1;
  const void *cos, *ssin, *km, *vm, *kt, *vt, *wq, *wfc;
  const float *s2, *b2, *fs, *fb;
  void *r, *q, *o;
  float* z;
  void* out;
  int B, L, Lm, Lt, d, hd, nhead, km_sb, km_sl, vm_sb, vm_sl, kt_sb, kt_sl, vt_sb, vt_sl;
  float eps1, eps2;
};

namespace tcd {

template <typename T>
void ca_block(const CaBlockArgs& a, cudaStream_t st) {
  const int Mm = a.B * a.Lm;
  const T* as[2] = {(const T*)a.mrot, (const T*)a.mem};
  const T* ws[2] = {(const T*)a.wk, (const T*)a.wv};
  void* cs[2] = {a.k, a.v};
  gemm_group<T, EPI_STORE>(2, as, ws, cs, Mm, a.hd, a.d, epi(nullptr), st);
  cross_attention<T>((const T*)a.x, a.s1, a.b1, (const T*)a.cos, (const T*)a.ssin,
                     (const T*)a.k, (const T*)a.v, a.Lm, (const T*)a.wq, (const T*)a.wfc, a.s2,
                     a.b2, a.fs, a.fb, a.B, a.L, a.d, a.hd, a.nhead, a.eps1, a.eps2, (T*)a.r,
                     (T*)a.q, (T*)a.o, a.z, (T*)a.out, st);
}

// ------------------------------------------------ the short-memory attention
constexpr int XQ = 128;         // bf16: queries a block, 2 m16 tiles a warp
constexpr int XQF = 32;         // f32: queries a block, 8 a warp
constexpr int XDKP = 64;        // the head dim padded in shared memory (dk <= 64)
constexpr int XLD = XDKP + 8;   // bf16 tiles' row stride (bank quads apart, as mma.cuh's)
constexpr int XMAX_KEYS = 256;  // keys a block holds whole

// One key or value source: row l of batch b at p + b * sb + l * sl, head h
// in columns [h * dk, (h + 1) * dk).
struct KvSrc {
  const void* p;
  long long sb, sl;
};

// o = softmax(T(q * T(scale)) . k^T) . v per (batch, head); q and o (B, Lq,
// hd) rows; the keys are rows [0, L0) of source 0, then rows [0, L1) of
// source 1.
struct XattnArgs {
  const void* q;
  void* o;
  KvSrc k[2], v[2];
  int Lq, L0, L1, dk, hd;
  float scale;
};

// Rows [0, ROWS) of a head's keys (or values) from the two sources into a
// shared tile of row stride XLD; rows past L0 + L1 and columns past dk are
// zero. vec: 16-byte cp.async (every row start 16-byte aligned, dk % 8 == 0).
template <int ROWS>
__device__ __forceinline__ void load_keys(bf16* sm, const KvSrc (&s)[2], int b, int h, int L0, int L1, int dk,
                                          bool vec) {
  constexpr int CH = XDKP / 8;
  const bf16* p0 = static_cast<const bf16*>(s[0].p) + b * s[0].sb + h * dk;
  const bf16* p1 = static_cast<const bf16*>(s[1].p) + b * s[1].sb + h * dk;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += MT) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const bf16* src = r < L0 ? p0 + r * s[0].sl : p1 + (r - L0) * s[1].sl;
    const bool ok = r < L0 + L1;
    bf16* dst = sm + r * XLD + c;
    if (vec) {
      cp_async16(dst, ok && c < dk ? src + c : p0, ok && c < dk ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = (ok && c + e < dk) ? src[c + e] : __float2bfloat16(0.f);
    }
  }
}

template <int NKT>
constexpr int xattn_smem() {
  return (XQ + 2 * NKT * 16) * XLD * (int)sizeof(bf16);
}

// NKT: m16 tiles of keys (Lk padded to 16 NKT). vec bits: 16-byte copies of
// q (1), k (2), v (4), o (8).
template <int NKT>
__global__ void __launch_bounds__(MT, NKT <= 10 ? 3 : 2) xattn_short_kernel(XattnArgs a, unsigned vec) {
  constexpr int KR = NKT * 16, KS = XDKP / 16;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char tcd_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tcd_smem);  // XQ rows; a tile's o is staged over its q
  bf16* Ks = Qs + XQ * XLD;
  bf16* Vs = Ks + KR * XLD;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * XQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int Lk = a.L0 + a.L1, dk = a.dk;
  const long long off = (long long)b * a.Lq * a.hd + h * dk;
  const bf16* q = static_cast<const bf16*>(a.q) + off;
  bf16* o = static_cast<bf16*>(a.o) + off;
  load_tile<XQ, XDKP>(Qs, q, a.hd, q0, a.Lq, dk, vec & 1);
  load_keys<KR>(Ks, a.k, b, h, a.L0, a.L1, dk, vec & 2);
  load_keys<KR>(Vs, a.v, b, h, a.L0, a.L1, dk, vec & 4);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const FragOff f = frag_off(lane);
  const float sc = __bfloat162float(__float2bfloat16(a.scale));
  for (int tile = warp; tile < XQ / 16; tile += MT / 32) {
    const int r0 = q0 + tile * 16;
    if (r0 >= a.Lq) break;  // the warp's later tiles lie past Lq too
    bf16* Qt = Qs + tile * 16 * XLD;
    uint32_t qf[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldsm_x4(qf[kk], Qt + f.ra * XLD + kk * 16 + f.ca);
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[kk][i] = scale_pair(qf[kk][i], sc);
    }

    float s[2 * NKT][4];
#pragma unroll
    for (int j = 0; j < 2 * NKT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < NKT; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, Ks + (np * 16 + f.rb) * XLD + kk * 16 + f.cb);
        mma16816(s[2 * np], qf[kk], kb[0], kb[1]);
        mma16816(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }

    // one pass: this thread's rows g (i = 0) and g + 8 (i = 1) hold every key
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2 * NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (8 * j + 2 * t + (e & 1) >= Lk) s[j][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float ms[2], l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      ms[i] = mx[i] * LOG2E;  // finite: key 0 is always valid
    }
#pragma unroll
    for (int j = 0; j < 2 * NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(fmaf(s[j][e], LOG2E, -ms[e >> 1]));
        l[e >> 1] += s[j][e];
      }
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = 1.f / l[i];
    }

    float acc[XDKP / 8][4];
#pragma unroll
    for (int n = 0; n < XDKP / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKT; ++kk) {
      float p0[4], p1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p0[e] = s[2 * kk][e] * inv[e >> 1];
        p1[e] = s[2 * kk + 1][e] * inv[e >> 1];
      }
      uint32_t pa[4];
      c_to_a(pa, p0, p1);
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, Vs + (kk * 16 + f.ra) * XLD + dp * 16 + f.ca);
        mma16816(acc[2 * dp], pa, vb[0], vb[1]);
        mma16816(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncwarp();
    stage_rows16<XDKP>(Qt, acc, 1.f, 1.f, lane);
    __syncwarp();
    store_rows16<XDKP>(Qt, o, a.hd, r0, a.Lq, dk, vec & 8, lane);
  }
}

// f32: a block owns XQF queries of one head; k (row stride dk + 1, so that
// the lanes' keys fall in different banks) and v whole in shared memory, a
// warp's probabilities and scaled q row beside them.
inline int xattn_fma_smem(int Lk, int dk) {
  return (Lk * (2 * dk + 1) + (MT / 32) * (Lk + XDKP)) * (int)sizeof(float);
}

__global__ void __launch_bounds__(MT) xattn_short_fma_kernel(XattnArgs a) {
  extern __shared__ __align__(16) unsigned char tcd_smem[];
  const int Lk = a.L0 + a.L1, dk = a.dk, ldk = dk + 1;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * XQF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Ks = reinterpret_cast<float*>(tcd_smem);
  float* Vs = Ks + Lk * ldk;
  float* Ps = Vs + Lk * dk + warp * Lk;
  float* Qw = Vs + Lk * dk + (MT / 32) * Lk + warp * XDKP;

  for (int idx = threadIdx.x; idx < Lk * dk; idx += MT) {
    const int r = idx / dk, c = idx % dk, i = r < a.L0 ? 0 : 1, l = r - i * a.L0;
    const long long at = b * a.k[i].sb + l * a.k[i].sl + h * dk + c;
    const long long av = b * a.v[i].sb + l * a.v[i].sl + h * dk + c;
    Ks[r * ldk + c] = static_cast<const float*>(a.k[i].p)[at];
    Vs[r * dk + c] = static_cast<const float*>(a.v[i].p)[av];
  }
  __syncthreads();

  const long long off = (long long)b * a.Lq * a.hd + h * dk;
  const float* q = static_cast<const float*>(a.q) + off;
  float* o = static_cast<float*>(a.o) + off;
  for (int i = warp; i < XQF; i += MT / 32) {
    const int row = q0 + i;
    if (row >= a.Lq) break;
    for (int c = lane; c < dk; c += 32) Qw[c] = q[(long long)row * a.hd + c] * a.scale;
    __syncwarp();
    float s[XMAX_KEYS / 32], mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < XMAX_KEYS / 32; ++jj) {
      const int j = lane + 32 * jj;
      float acc = -INFINITY;
      if (j < Lk) {
        acc = 0.f;
        for (int c = 0; c < dk; ++c) acc = fmaf(Qw[c], Ks[j * ldk + c], acc);
      }
      s[jj] = acc;
      mx = fmaxf(mx, acc);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, m));
    float l = 0.f;
#pragma unroll
    for (int jj = 0; jj < XMAX_KEYS / 32; ++jj) {
      const int j = lane + 32 * jj;
      if (j < Lk) {
        const float p = expf(s[jj] - mx);
        Ps[j] = p;
        l += p;
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) l += __shfl_xor_sync(0xffffffffu, l, m);
    __syncwarp();
    const float inv = 1.f / l;
    for (int c = lane; c < dk; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < Lk; ++j) acc = fmaf(Ps[j], Vs[j * dk + c], acc);
      o[(long long)row * a.hd + c] = acc * inv;
    }
    __syncwarp();  // Qw and Ps are the next row's
  }
}

template <int NKT>
inline void xattn_launch(const XattnArgs& a, int B, int H, unsigned vec, cudaStream_t st) {
  launch_mma(xattn_short_kernel<NKT>, dim3(cdiv(a.Lq, XQ), H, B), MT, xattn_smem<NKT>(), st, a, vec);
}

// B batch elements x H heads; refused for dk past 64 or more keys than a
// block holds. float takes the FMA kernel, bf16 the tensor-core one with
// the keys padded to a multiple of 32.
template <typename T>
inline void short_attention(const XattnArgs& a, int B, int H, cudaStream_t st) {
  const int Lk = a.L0 + a.L1;
  if (a.dk < 1 || a.dk > XDKP || Lk < 1 || Lk > XMAX_KEYS) return refuse();
  if constexpr (std::is_same<T, float>::value) {
    const int bytes = xattn_fma_smem(Lk, a.dk);
    launch_mma(xattn_short_fma_kernel, dim3(cdiv(a.Lq, XQF), H, B), MT, bytes, st, a);
  } else {
    static_assert(std::is_same<T, bf16>::value, "short_attention takes float or bfloat16");
    const long long qsb = (long long)a.Lq * a.hd;
    auto src16 = [&](const KvSrc (&s)[2]) {
      return rows16(s[0].p, s[0].sb, a.dk, s[0].sl, a.dk) && (a.L1 == 0 || rows16(s[1].p, s[1].sb, a.dk, s[1].sl, a.dk));
    };
    const unsigned vec = (rows16(a.q, qsb, a.dk, a.hd, a.dk) ? 1u : 0u) | (src16(a.k) ? 2u : 0u) |
                         (src16(a.v) ? 4u : 0u) | (rows16(a.o, qsb, a.dk, a.hd, a.dk) ? 8u : 0u);
    switch ((Lk + 31) / 32) {
      case 1: xattn_launch<2>(a, B, H, vec, st); break;
      case 2: xattn_launch<4>(a, B, H, vec, st); break;
      case 3: xattn_launch<6>(a, B, H, vec, st); break;
      case 4: xattn_launch<8>(a, B, H, vec, st); break;
      case 5: xattn_launch<10>(a, B, H, vec, st); break;
      case 6: xattn_launch<12>(a, B, H, vec, st); break;
      case 7: xattn_launch<14>(a, B, H, vec, st); break;
      default: xattn_launch<16>(a, B, H, vec, st); break;
    }
  }
}

template <typename T>
void ca_kv(const CaKvArgs& a, cudaStream_t st) {
  cross_q<T>((const T*)a.x, a.s1, a.b1, a.eps1, (const T*)a.cos, (const T*)a.ssin, (const T*)a.wq, a.B * a.L,
             a.L, a.d, a.hd, (T*)a.r, (T*)a.q, st);
  XattnArgs x;
  x.q = a.q;
  x.o = a.o;
  x.k[0] = KvSrc{a.km, a.km_sb, a.km_sl};
  x.k[1] = KvSrc{a.kt, a.kt_sb, a.kt_sl};
  x.v[0] = KvSrc{a.vm, a.vm_sb, a.vm_sl};
  x.v[1] = KvSrc{a.vt, a.vt_sb, a.vt_sl};
  x.Lq = a.L;
  x.L0 = a.Lm;
  x.L1 = a.Lt;
  x.hd = a.hd;
  x.dk = a.hd / a.nhead;
  x.scale = 1.f / sqrtf((float)x.dk);
  short_attention<T>(x, a.B, a.nhead, st);
  fc_post_ln<T>((const T*)a.o, (const T*)a.wfc, a.s2, a.b2, (const T*)a.x, a.fs, a.fb, a.B, a.L, a.d, a.hd,
                a.eps2, a.z, (T*)a.out, st);
}

}  // namespace tcd

// x (B, L, d), mem and mrot (B, Lm, d), d even; cos/ssin (L, d) in T;
// wq/wk/wv (hd, d), wfc (d, hd) in T; LN affines and FiLM rows f32;
// scratch q and o (B*L, hd), k and v (B*Lm, hd) in T; r (B*L, d) in T and
// z (B*L, d) f32, used in f32 only (null in bf16). dtype: 0 = float32, 1 = bfloat16.
// Returns the launches' status (launch_status).
extern "C" int tcd_ca_block(int dtype, const CaBlockArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    tcd::ca_block<float>(*a, st);
  } else if (dtype == 1) {
    tcd::ca_block<__nv_bfloat16>(*a, st);
  } else {
    return -1;
  }
  return tcd::launch_status();
}

// x (B, L, d), d even; km/vm (B, Lm, hd) and kt/vt (B, Lt, hd) in T, each
// with its strides (the last dim contiguous), Lm + Lt <= 256; cos/ssin
// (L, d) in T; wq (hd, d), wfc (d, hd) in T; LN affines and FiLM rows
// (B, d) f32; scratch q and o (B*L, hd) in T; r (B*L, d) in T and z (B*L,
// d) f32, used in f32 only (null in bf16). dtype as above. Returns the
// launches' status (launch_status).
extern "C" int tcd_ca_kv(int dtype, const CaKvArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    tcd::ca_kv<float>(*a, st);
  } else if (dtype == 1) {
    tcd::ca_kv<__nv_bfloat16>(*a, st);
  } else {
    return -1;
  }
  return tcd::launch_status();
}
