// Standalone softmax attention, for Hopper (sm_90a): K11 of the port.
//
// Replaces the three Pallas programs of tcdiff_tpu/ops/fused_attention.py:
// `fused_attention` per (batch, head) (_attn_kernel), with the TRPE bias
// (_attn_bias_kernel), and `fused_attention_batched` with all heads of a
// batch element in one program (_attn_kernel_allheads). They compute the
// same function, so one kernel serves all three: the flash attention of
// attention.cuh that K1, K6 and K7 run too, here on (b, h, L, dk) views
// with Lq != Lk and a (h, 10, dk) bucket table.
//
// What bounds it on the H100: at the serving shapes (b = 8, 8 heads of 64;
// 450 x 450 self-attention, 450 x 152 cross-attention, 150 x 150 in the
// cond encoder) 3.3, 1.1 and 0.4 GFLOP against 14.7, 9.9 and 4.9 MB of
// q, k, v and o in bf16 (TRPE adds 6.5 MB of int32 bucket ids): the bytes,
// 1.5-6.3 us at 3.35 TB/s, just above the 0.4-3.3 us of the bf16 tensor
// cores; on the FMA units the products alone would take ~50 us at 450 x
// 450, so they have to run on the tensor cores.
//
// Design: attention.cuh's bf16 bodies: at head width 64 without TRPE,
// wherever TMA can address the views, the wgmma body (a persistent grid of
// 128-query tiles, a TMA producer warpgroup feeding a ring of k/v stages,
// two consumer warpgroups on wgmma with the online softmax in registers);
// otherwise FlashAttention-2 on mma.sync (64 queries per block of 4 warps,
// q in registers, 64-key tiles of k and v double-buffered by cp.async, S
// and the online softmax in registers, p repacked into A fragments for
// p.v); f32 keeps the FMA body, since the tensor cores would take it only
// as TF32. The all-heads grid of the TPU is only a launch granularity,
// which a Hopper grid covers with the same blocks.
#include "attention.cuh"

// dtype: 0 = float32, 1 = bfloat16; a->dk <= 64 and a multiple of 4.
// Returns the launch's status (launch_status): a tensor map that
// cuTensorMapEncodeTiled does not encode is refused.
extern "C" int tcd_attention(int dtype, const tcd::AttnArgs* a, int B, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    tcd::attention<float>(*a, B, H, st);
  } else if (dtype == 1) {
    tcd::attention<__nv_bfloat16>(*a, B, H, st);
  } else {
    return -1;
  }
  return tcd::launch_status();
}
