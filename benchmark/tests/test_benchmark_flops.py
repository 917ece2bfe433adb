"""The analytic counts of `benchmark/flops.py` against a count by hand at
a small configuration: d 4, 2 heads of 2, ff 8, 1 layer, 2 frames of 1
dancer, music width 2, 3 features; multiply-adds (MACs), 2 FLOPs each."""

import pytest

from benchmark import flops

M = dict(latent_dim=4, num_heads=2, head_dim=2, ff_size=8, num_layers=1, seq_len=2, dancer_num=1,
         cond_feature_dim=2, nfeats=3)
# a sample, by hand
ENCODER = 2 * (4 * 2 + 2 * 4) + 2 * (4 * 2 * 16 + 2 * 2 * 2 * 4 + 2 * 2 * 4 * 8) + 2 * 16  # 640
SELF_ATTN = 3 * 2 * 16 + 2 * 2 * 2 * 4 + 2 * 16  # q/k/v, the two products, fc: 160
PREFIX = 2 * 3 * 4 + 2 * (4 * 8 + 8 * 8 + 8 * 4) + SELF_ATTN  # input projection, fusion MLP: 440


def cross_ff(memory_rows):  # q, memory k/v, the two products over 4 memory rows, fc; FF; linear3; 3 FiLMs
    return 2 * 16 + memory_rows * 2 * 16 + 2 * 2 * 4 * 4 + 2 * 16 + 2 * 2 * 4 * 8 + 2 * 16 + 3 * 4 * 8


HEAD = 4 * 16 + 16 * 4 + 16 * 8 + 2 * 4 * 3  # time MLP, FiLM condition, time tokens, final layer: 280


def test_hand_counts():
    assert flops.encoder_macs(M) == ENCODER == 640
    assert flops.prefix_macs(M) == PREFIX == 440
    # a request of 1 clip and 1 step: the encoder for the conditional half,
    # the 2 music rows' k/v of both halves once; the prefix once; each half
    # the layer's cross/FF part (the 2 time rows' k/v) and the head
    once = ENCODER + 2 * 2 * 2 * 16
    assert flops.sample_request_flops(M, 1, 1) == 2 * (once + PREFIX + 2 * (cross_ff(2) + HEAD)) == 5328
    assert flops.sample_request_flops(M, 3, 5) == 2 * (3 * once + 5 * 3 * (PREFIX + 2 * (cross_ff(2) + HEAD)))
    # a train sample: 3 forwards, the memory's 4 rows, the encoder for 3/4
    assert flops.train_step_flops(M, 1, 0.25) == 6 * (PREFIX + cross_ff(4) + HEAD + 0.75 * ENCODER) == 10272


def test_attention_bound():
    # forward over 2 x 2 positions, h*dk 4: 2 products of 16 MACs (64 FLOPs)
    # and q, k, v, o of 8 bf16 values each (64 bytes)
    assert flops._call_bound(1, 2, 2, 4, False, 64.0, 1.0) == pytest.approx(64.0)
    assert flops._call_bound(1, 2, 2, 4, False, 1.0, 64.0) == pytest.approx(64.0)
    # backward: 4 products (128 FLOPs); q, k, v, o, dO in, dq, dk, dv out (128 bytes)
    assert flops._call_bound(1, 2, 2, 4, True, 1.0, 1e9) == pytest.approx(128.0)
    assert flops._call_bound(1, 2, 2, 4, True, 1e9, 1.0) == pytest.approx(128.0)
    per_step = flops._call_bound(1, 2, 2, 4, False, 1.0, 1e9)  # layer 0 only, at half the doubled batch
    assert flops.attention_bound_s(M, 1, 3, 1.0, 1e9, train=False) == pytest.approx(3 * per_step)
    train = sum(flops._call_bound(2, 2, lk, 4, b, 1.0, 1e9) for lk in (2, 4) for b in (False, True))
    assert flops.attention_bound_s(M, 2, 3, 1.0, 1e9, train=True) == pytest.approx(train)
