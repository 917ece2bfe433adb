"""The plain reference of the TCDiff denoiser (DanceDecoder), in float32.

Written from the model's definition, not from the measured package: it
imports nothing of `tcdiff_torch`, `tcdiff_tpu` or JAX. Module and
parameter names are the upstream state-dict layout (so one set of weights,
made by `benchmark/weights.py`, loads into both). No kernel, no cond cache,
no k/v hoist, no CFG dedup: every forward computes the whole network.

    cond (B, 301, 438) -> frames paired (B, 150, 876) -> MLP -> 2 pre-norm
        encoder layers (rotary on the normed vector, 8 heads) -> ct;
        unconditional rows take the null embedding; cond_hidden from the
        mean of ct
    x (b, 150*dn, 151) -> input projection, fused over the dancers of a
        frame; XY deltas -> trajectory embedding (unused without TRPE);
        t -> sinusoidal -> MLP -> FiLM condition t (+ cond_hidden) and
        2 time tokens; memory = LN(cat(ct, time tokens))
    8 decoder layers: x += FiLM1(SA(x)); x += FiLM2(CA(x, memory));
        x += FiLM3(FF(x)); x = linear3(LN4(x))
        SA/CA: q,k from the rotated LN input, v from the LN input,
        bias-free projections, softmax attention, fc, LayerNorm(1e-6)
    final linear -> (b, tokens, 151)

The train path adds dropout at the upstream sites: the encoder's four
(masks drawn with torch.rand from the step's generator, in the order the
layers run), and in each decoder layer the hash masks of the train blocks:
one uint32 seed per batch element and site group, drawn with
torch.randint before the layer runs (self-attention, cross-attention,
feed-forward), the keep bit a murmur3 finalizer of (index, seed, salt).

`mm` is the product every projection and attention matrix goes through;
the control of the benchmark (`benchmark/tools/control.py`) replaces it by
one whose operands are rounded to a lower precision.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5  # norm1..norm4 and the encoder's norms
ATTN_LN_EPS = 1e-6  # the attention blocks' LayerNorm, norm_cond, the pooled-cond LayerNorm

# dropout hash salts: attention probabilities (+ head), after the out
# projection, after the block LayerNorm, after the GELU, after linear2
SALT_ATTN, SALT_FC, SALT_OUT, SALT_FF1, SALT_FF2 = 0x100, 0x200, 0x300, 0x400, 0x500
_M32 = 0xFFFFFFFF


def plain_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


# ----------------------------------------------------------------- pieces
@functools.lru_cache(maxsize=16)
def _cos_sin(n: int, dim: int, device: torch.device):
    inv = 1.0 / (10000.0 ** (np.arange(0, dim, 2) / dim))
    ang = torch.tensor(np.outer(np.arange(n), inv), dtype=torch.float32, device=device)
    return torch.cos(ang), torch.sin(ang)


def rotate(x: torch.Tensor) -> torch.Tensor:
    """Rotary embedding on the full last axis: channel pair (2i, 2i+1) of
    position p turned by the angle p / 10000^(2i/D)."""
    c, s = _cos_sin(x.shape[-2], x.shape[-1], x.device)
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * c - b * s, b * c + a * s], dim=-1).flatten(-2)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * (-math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def ln(x: torch.Tensor, mod: nn.LayerNorm, eps: float) -> torch.Tensor:
    return F.layer_norm(x, mod.normalized_shape, mod.weight, mod.bias, eps)


def hash_keep(seeds: torch.Tensor, salt, rows: int, cols: int, rate: float) -> torch.Tensor:
    """Keep bits of the train blocks' dropout over (rows, cols) arrays, one
    array per seed (int64 (b,) holding uint32) and, for a tensor salt (h,),
    per head: (b, [h,] rows, cols). uint32 arithmetic done in int64, each
    32-bit product split in 16-bit halves."""
    def mul(a, k):
        return ((a * (k & 0xFFFF)) + (((a * (k >> 16)) & 0xFFFF) << 16)) & _M32

    dev = seeds.device
    idx = (torch.arange(rows, dtype=torch.int64, device=dev)[:, None] * cols
           + torch.arange(cols, dtype=torch.int64, device=dev)[None]) & _M32
    salt_t = torch.as_tensor(salt, dtype=torch.int64, device=dev).reshape(1, -1)
    key = (seeds.to(torch.int64)[:, None] + mul(salt_t, 0x9E3779B9)) & _M32
    h = idx[None, None] ^ key[:, :, None, None]
    h = mul(h ^ (h >> 16), 0x7FEB352D)
    h = mul(h ^ (h >> 15), 0x846CA68B)
    h = h ^ (h >> 16)
    keep = h >= min(int(round(rate * 2**32)), 2**32 - 1)
    return keep if torch.as_tensor(salt).dim() else keep[:, 0]


def dropped(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    return x if keep is None else torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


# ----------------------------------------------------------------- modules
class MHA(nn.Module):
    """The encoder's attention: packed in_proj, out_proj."""

    def __init__(self, d: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = nn.Linear(d, d)


class EncoderLayer(nn.Module):
    def __init__(self, d: int, ff: int):
        super().__init__()
        self.rotary = _Freqs(d)
        self.self_attn = MHA(d)
        self.linear1 = nn.Linear(d, ff)
        self.linear2 = nn.Linear(ff, d)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)


class Attention(nn.Module):
    """SBI-MSA: bias-free q/k/v/fc, LayerNorm after fc."""

    def __init__(self, d: int, hd: int):
        super().__init__()
        self.w_qs = nn.Linear(d, hd, bias=False)
        self.w_ks = nn.Linear(d, hd, bias=False)
        self.w_vs = nn.Linear(d, hd, bias=False)
        self.fc = nn.Linear(hd, d, bias=False)
        self.layer_norm = nn.LayerNorm(d, eps=ATTN_LN_EPS)


class FiLM(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.block = nn.Sequential(nn.Mish(), nn.Linear(d, 2 * d))


class ConcatSquash(nn.Module):
    """Upstream's trajectory modulation (computed and dropped upstream, so
    unused here; its parameters exist and only decay under Adan)."""

    def __init__(self, dim_in: int, dim_out: int, dim_ctx: int):
        super().__init__()
        self._layer = nn.Linear(dim_in, dim_out)
        self._hyper_bias = nn.Linear(dim_ctx, dim_out, bias=False)
        self._hyper_gate = nn.Linear(dim_ctx, dim_out)


class DecoderLayer(nn.Module):
    def __init__(self, d: int, ff: int, hd: int):
        super().__init__()
        self.rotary = _Freqs(d)
        self.self_attn = Attention(d, hd)
        self.multihead_attn = Attention(d, hd)
        self.linear1 = nn.Linear(d, ff)
        self.linear2 = nn.Linear(ff, d)
        self.linear3 = nn.Linear(d, d)
        for i in range(1, 5):
            setattr(self, f"norm{i}", nn.LayerNorm(d))
        for i in range(1, 4):
            setattr(self, f"film{i}", FiLM(d))
        self.traj_Modulation = nn.ModuleList([ConcatSquash(d, 128, d), ConcatSquash(128, 128, d),
                                              ConcatSquash(128, d, d)])


class _Freqs(nn.Module):
    """Holds upstream's rotary `freqs` buffer so that the layouts match."""

    def __init__(self, d: int):
        super().__init__()
        self.register_buffer("freqs", torch.tensor(1.0 / 10000.0 ** (np.arange(0, d, 2) / d), dtype=torch.float32))


class _Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.stack = nn.ModuleList(layers)


class ReferenceDecoder(nn.Module):
    """The denoiser's parameters in the upstream layout and its two forwards
    in float32: `forward` (serving, no dropout) and `forward_train`."""

    def __init__(self, cfg: dict, mm: Callable = plain_mm):
        super().__init__()
        self.cfg = cfg
        self.mm = mm
        d, ff, dn = cfg["latent_dim"], cfg["ff_size"], cfg["dancer_num"]
        hd, cf, seq = cfg["num_heads"] * cfg["head_dim"], cfg["cond_feature_dim"], cfg["seq_len"]
        self.rotary = _Freqs(d)
        self.null_cond_embed = nn.Parameter(torch.empty(1, seq, d))
        self.null_cond_hidden = nn.Parameter(torch.empty(1, d))
        self.input_projection = nn.Linear(cfg["nfeats"], d)
        self.final_layer = nn.Linear(d, cfg["nfeats"])
        self.traj_embedding = nn.Sequential(nn.Linear(2, 64), nn.ReLU(), nn.Linear(64, d))
        self.relative_projection_layer = nn.Sequential(
            nn.Linear(d * dn, 2 * d), nn.ReLU(), nn.Linear(2 * d, 2 * d), nn.ReLU(), nn.Linear(2 * d, d * dn))
        self.cond_projection = nn.Sequential(nn.Linear(2 * cf, cf), nn.ReLU(), nn.Linear(cf, d))
        self.non_attn_cond_projection = nn.Sequential(nn.LayerNorm(d, eps=ATTN_LN_EPS), nn.Linear(d, d), nn.SiLU(),
                                                      nn.Linear(d, d))
        self.time_mlp = nn.Sequential(nn.Identity(), nn.Linear(d, 4 * d), nn.Mish())
        self.to_time_cond = nn.Sequential(nn.Linear(4 * d, d))
        self.to_time_tokens = nn.Sequential(nn.Linear(4 * d, 2 * d))
        self.norm_cond = nn.LayerNorm(d, eps=ATTN_LN_EPS)
        self.embeddings_table = nn.Embedding(cfg["max_dancers"], hd)
        self.cond_encoder = nn.Sequential(*[EncoderLayer(d, ff) for _ in range(2)])
        self.seqTransDecoder = _Stack([DecoderLayer(d, ff, hd) for _ in range(cfg["num_layers"])])

    # -------------------------------------------------------------- helpers
    def lin(self, mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        y = self.mm(x, mod.weight.t())
        return y if mod.bias is None else y + mod.bias

    def attend(self, q, k, v, nhead: int, keep=None, rate: float = 0.0) -> torch.Tensor:
        """Softmax attention of (b, L, h*dk) projections over `nhead` heads;
        `keep` (b, h, Lq, Lk) drops probabilities."""
        b, lq, hd = q.shape
        dk = hd // nhead
        heads = lambda t: t.reshape(b, t.shape[1], nhead, dk).transpose(1, 2)
        p = torch.softmax(self.mm(heads(q), heads(k).transpose(-1, -2)) / math.sqrt(dk), dim=-1)
        o = self.mm(dropped(p, keep, rate), heads(v))
        return o.transpose(1, 2).reshape(b, lq, hd)

    # ----------------------------------------------------------- cond side
    def encode_cond(self, cond, keep_mask, masks: Optional[List] = None, rate: float = 0.0):
        """(ct (B, 150, d), cond_hidden (B, d)); `masks`: the encoder's keep
        masks, four a layer in the order they apply."""
        b = cond.shape[0]
        c = cond[:, : cond.shape[1] // 2 * 2]
        c = c.reshape(b, c.shape[1] // 2, c.shape[2] * 2)
        cp = self.cond_projection
        ct = self.lin(cp[2], F.relu(self.lin(cp[0], c)))
        nh = self.cfg["num_heads"]
        for i, layer in enumerate(self.cond_encoder):
            m = (None,) * 4 if masks is None else masks[4 * i: 4 * i + 4]
            h = ln(ct, layer.norm1, LN_EPS)
            qk = rotate(h)
            w, bias = layer.self_attn.in_proj_weight, layer.self_attn.in_proj_bias
            (wq, wk, wv), (bq, bk, bv) = w.chunk(3), bias.chunk(3)
            q, k, v = (self.mm(u, wi.t()) + bi for u, wi, bi in ((qk, wq, bq), (qk, wk, bk), (h, wv, bv)))
            a = self.lin(layer.self_attn.out_proj, self.attend(q, k, v, nh, m[0], rate))
            ct = ct + dropped(a, m[1], rate)
            f = dropped(F.gelu(self.lin(layer.linear1, ln(ct, layer.norm2, LN_EPS))), m[2], rate)
            ct = ct + dropped(self.lin(layer.linear2, f), m[3], rate)
        km = keep_mask.bool()
        ct = torch.where(km[:, None, None], ct, self.null_cond_embed)
        na = self.non_attn_cond_projection
        ch = self.lin(na[3], F.silu(self.lin(na[1], ln(ct.mean(dim=1), na[0], ATTN_LN_EPS))))
        return ct, torch.where(km[:, None], ch, self.null_cond_hidden)

    def embed(self, x, times, cond_hidden):
        """Token embeddings h, the FiLM condition t and the 2 time tokens."""
        cfg = self.cfg
        b, tokens, _ = x.shape
        d, seq = cfg["latent_dim"], cfg["seq_len"]
        rp = self.relative_projection_layer
        f = self.lin(self.input_projection, x).reshape(b, seq, d * (tokens // seq))
        h = self.lin(rp[4], F.relu(self.lin(rp[2], F.relu(self.lin(rp[0], f))))).reshape(b, tokens, d)
        th = F.mish(self.lin(self.time_mlp[1], timestep_embedding(times, d)))
        t = self.lin(self.to_time_cond[0], th) + cond_hidden
        t_tokens = self.lin(self.to_time_tokens[0], th).reshape(times.shape[0], 2, d)
        return h, t, t_tokens

    # -------------------------------------------------------------- layers
    def film(self, mod: FiLM, t):
        scale, shift = self.lin(mod.block[1], F.mish(t)).chunk(2, dim=-1)
        return scale[:, None] + 1.0, shift[:, None]

    def attn_block(self, att: Attention, x_in, mem, mem_rot, nhead, seeds, rate):
        """fc(attention) -> drop_FC -> LayerNorm -> drop_OUT; q from the
        rotated x_in, k from mem_rot, v from mem."""
        b, lq, _ = x_in.shape
        drop = seeds is not None and rate > 0
        keep_p = hash_keep(seeds, SALT_ATTN + torch.arange(nhead), lq, mem.shape[1], rate) if drop else None
        o = self.attend(self.lin(att.w_qs, rotate(x_in)), self.lin(att.w_ks, mem_rot), self.lin(att.w_vs, mem),
                        nhead, keep_p, rate)
        z = self.lin(att.fc, o)
        d = z.shape[-1]
        if drop:
            z = dropped(z, hash_keep(seeds, SALT_FC, lq, d, rate), rate)
        s = ln(z, att.layer_norm, ATTN_LN_EPS)
        return dropped(s, hash_keep(seeds, SALT_OUT, lq, d, rate), rate) if drop else s

    def layer(self, lay: DecoderLayer, x, memory, t, seeds=(None, None, None), rate: float = 0.0):
        nh = self.cfg["num_heads"]
        sa_seeds, ca_seeds, ff_seeds = seeds
        drop = ff_seeds is not None and rate > 0
        y = ln(x, lay.norm1, LN_EPS)
        fs, fb = self.film(lay.film1, t)
        x = x + fs * self.attn_block(lay.self_attn, y, y, rotate(y), nh, sa_seeds, rate) + fb
        fs, fb = self.film(lay.film2, t)
        x = x + fs * self.attn_block(lay.multihead_attn, ln(x, lay.norm2, LN_EPS), memory, rotate(memory), nh,
                                     ca_seeds, rate) + fb
        lq = x.shape[1]
        a = F.gelu(self.lin(lay.linear1, ln(x, lay.norm3, LN_EPS)))
        if drop:
            a = dropped(a, hash_keep(ff_seeds, SALT_FF1, lq, a.shape[-1], rate), rate)
        z = self.lin(lay.linear2, a)
        if drop:
            z = dropped(z, hash_keep(ff_seeds, SALT_FF2, lq, z.shape[-1], rate), rate)
        fs, fb = self.film(lay.film3, t)
        return self.lin(lay.linear3, ln(x + fs * z + fb, lay.norm4, LN_EPS))

    # ------------------------------------------------------------- forwards
    def forward(self, x, cond, times, keep_mask):
        """Serving forward (no dropout) of x (b, tokens, nfeats)."""
        ct, ch = self.encode_cond(cond, keep_mask)
        h, t, t_tokens = self.embed(x, times, ch)
        memory = ln(torch.cat([ct, t_tokens], dim=1), self.norm_cond, ATTN_LN_EPS)
        for lay in self.seqTransDecoder.stack:
            h = self.layer(lay, h, memory, t)
        return self.lin(self.final_layer, h)

    def forward_train(self, x, cond, times, keep_mask, enc_masks, layer_seeds, rate: float):
        """The train forward: `enc_masks` the encoder's 8 keep masks,
        `layer_seeds` each decoder layer's (sa, ca, ff) seeds."""
        ct, ch = self.encode_cond(cond, keep_mask, enc_masks, rate)
        h, t, t_tokens = self.embed(x, times, ch)
        memory = ln(torch.cat([ct, t_tokens], dim=1), self.norm_cond, ATTN_LN_EPS)
        for lay, seeds in zip(self.seqTransDecoder.stack, layer_seeds):
            h = self.layer(lay, h, memory, t, seeds, rate)
        return self.lin(self.final_layer, h)


def linear_weight_names(model: nn.Module) -> set:
    """Names of the parameters that are weights of a linear map (drawn with
    std 1/sqrt(fan_in) by `benchmark/weights.py`)."""
    names = set()
    for prefix, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            names.add(f"{prefix}.weight")
        elif isinstance(mod, MHA):
            names.add(f"{prefix}.in_proj_weight")
    return names
