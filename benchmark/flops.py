"""Operations and bytes of the work TCDiff's math needs at a cell's shapes,
whatever implements it: the yardstick of the `mfu.*` and `*_roofline`
metrics.

Counted: the products (projections, attention's two products) at 2
FLOPs a multiply-add; elementwise work, LayerNorms, softmax, the FK loss
and the optimizer are left out, which can only lower a share of the peak.

- A serving request (`sample_request_flops`): 50 guided steps of the doubled
  (unconditional | conditional) batch. Work that the math needs once is
  counted once: the music encoder once a request for the conditional
  half (the unconditional half takes the null embedding), the 150 music
  rows' cross-attention k/v once a request for both halves, the x-only
  prefix (input projection, fusion, layer 0's self-attention block) once a
  step for the shared x; the 2 time tokens' k/v every step.
- A train step (`train_step_flops`): forward + backward = 3 forwards (the
  backward's input and weight gradients), no recompute; the music encoder
  for the rows that keep their condition (1 - cond_drop_prob of them) and
  the memory's k/v (music + time rows) in every layer every step.
- The attention's bound (`attention_bound_s`): for each call, the larger
  of its products at the peak rate and its inputs and outputs read or
  written once at the HBM rate: q, k, v and o forward; q, k, v, o and dO
  in and dq, dk, dv out backward (4 and 8 of the L x Lk x h*dk products).
"""

from __future__ import annotations


def _dims(m: dict):
    d, hd = m["latent_dim"], m["num_heads"] * m["head_dim"]
    seq, dn = m["seq_len"], m["dancer_num"]
    lc = seq  # music frames paired: (2 seq + 1) // 2
    return d, hd, m["ff_size"], m["num_layers"], seq, dn, seq * dn, lc, m["cond_feature_dim"], m["nfeats"]


def encoder_macs(m: dict) -> int:
    """The music encoder a sample: the paired-frame MLP, 2 encoder layers,
    the pooled MLP."""
    d, _, ff, _, _, _, _, lc, cf, _ = _dims(m)
    layer = 4 * lc * d * d + 2 * lc * lc * d + 2 * lc * d * ff
    return lc * (2 * cf * cf + cf * d) + 2 * layer + 2 * d * d


def prefix_macs(m: dict) -> int:
    """The x-only work a sample before layer 0's FiLM: input projection,
    the fusion MLP over a frame's dancers, layer 0's self-attention block."""
    d, hd, _, _, seq, dn, tokens, _, _, c = _dims(m)
    fusion = seq * (d * dn * 2 * d + 2 * d * 2 * d + 2 * d * d * dn)
    return tokens * c * d + fusion + self_attention_macs(m)


def self_attention_macs(m: dict) -> int:
    d, hd, *_ = _dims(m)
    tokens = _dims(m)[6]
    return 3 * tokens * d * hd + 2 * tokens * tokens * hd + tokens * hd * d


def layer_macs(m: dict, memory_rows: int, with_self_attention: bool = True) -> int:
    """One decoder layer a sample, the memory's k/v over `memory_rows`
    rows."""
    d, hd, ff, _, _, _, tokens, lc, _, _ = _dims(m)
    sa = self_attention_macs(m) if with_self_attention else 0
    ca = tokens * d * hd + memory_rows * 2 * d * hd + 2 * tokens * (lc + 2) * hd + tokens * hd * d
    return sa + ca + 2 * tokens * d * ff + tokens * d * d + 3 * d * 2 * d


def head_macs(m: dict) -> int:
    """Time MLP, FiLM condition and time tokens, the final layer, a sample."""
    d, _, _, _, _, _, tokens, _, _, c = _dims(m)
    return d * 4 * d + 4 * d * d + 4 * d * 2 * d + tokens * d * c


def sample_request_flops(m: dict, batch: int, steps: int) -> float:
    d, hd, _, nl, *_ = _dims(m)
    lc = _dims(m)[7]
    once = batch * encoder_macs(m) + 2 * batch * nl * lc * 2 * d * hd
    half = (layer_macs(m, 2, with_self_attention=False) + (nl - 1) * layer_macs(m, 2) + head_macs(m))
    step = batch * prefix_macs(m) + 2 * batch * half
    return 2.0 * (once + steps * step)


def train_step_flops(m: dict, batch: int, cond_drop_prob: float) -> float:
    _, _, _, nl, _, _, _, lc, _, _ = _dims(m)
    fwd = (prefix_macs(m) + layer_macs(m, lc + 2, with_self_attention=False) + (nl - 1) * layer_macs(m, lc + 2)
           + head_macs(m) + (1.0 - cond_drop_prob) * encoder_macs(m))
    return 2.0 * 3.0 * batch * fwd


def _call_bound(rows: int, lq: int, lk: int, hd: int, backward: bool, peak_flops: float, hbm: float,
                elem: int = 2) -> float:
    products = 4 if backward else 2
    flops = 2.0 * products * rows * lq * lk * hd
    tensors = (3 * lq + 2 * lk) + (lq + 2 * lk) if backward else 2 * lq + 2 * lk  # rows of hd
    return max(flops / peak_flops, rows * tensors * hd * elem / hbm)


def attention_bound_s(m: dict, batch: int, steps: int, peak_flops: float, hbm: float, train: bool) -> float:
    """Least seconds of the attention calls of one request (serving: the
    decoder's self-attention, layer 0 at half the doubled batch) or one
    train step (the self- and cross-attention forward and backward)."""
    _, hd, _, nl, _, _, tokens, lc, _, _ = _dims(m)
    if not train:
        per_step = (_call_bound(batch, tokens, tokens, hd, False, peak_flops, hbm)
                    + (nl - 1) * _call_bound(2 * batch, tokens, tokens, hd, False, peak_flops, hbm))
        return steps * per_step
    return nl * sum(_call_bound(batch, tokens, lk, hd, bwd, peak_flops, hbm)
                    for lk in (tokens, lc + 2) for bwd in (False, True))
