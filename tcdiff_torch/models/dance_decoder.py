"""DanceDecoder — the multi-dancer diffusion denoiser.

PyTorch counterpart of `tcdiff_tpu/models/dance_decoder.py`. `forward` is
the deterministic (serving) path, with the exact-math hoists the JAX
package turns on by default:

  * the cond cache: the music encoding is independent of x and t, so it is
    computed once per request (`cond_cache`);
  * the cross-attention k/v hoist: the 150 music rows' k/v of every layer
    are computed once; each step projects only the 2 time-token rows, for
    all layers at once;
  * CFG-prefix dedup (`cfg_pair=True`): x arrives at half batch and the
    x-only prefix (input, fusion and trajectory projections and layer 0's
    self-attention block) runs once before it is tiled to the doubled batch.

`forward_train` is the train path (the JAX package's deterministic=False):
dropout at every reference site, drawn from an explicit torch.Generator;
no cond cache and no CFG dedup, the cross-attention memory is
norm_cond(cat(music tokens, time tokens)). Each decoder layer's randomness
is drawn before the layer runs (`TrainDraws`), so that with `remat` (the
JAX package's nn.remat) a layer run under `torch.utils.checkpoint`
recomputes its forward in the backward on the same dropout.

Module and parameter names follow the reference state-dict layout
(`tcdiff_torch.interop.from_jax.params_to_state_dict` maps a flax tree onto
it), so `load_state_dict(..., strict=True)` takes a reference checkpoint.
Parameters are float32 and live on `device` (the GPU unless the caller asks
for the CPU); activations run in `dtype` (float32 or bfloat16), with
weights cast per use and LayerNorm statistics in f32, as the flax modules
do; with `ln_bf16` (TCDIFF_LN_BF16) the LayerNorm sites outside the
kernels keep their statistics in `dtype`, as flax's
force_float32_reductions=False (the kernels' LayerNorms stay f32).

Each decoder layer's blocks run through `tcdiff_torch.ops` (CUDA kernels
for CUDA tensors, plain versions for CPU tensors). On serving,
`ServingKernels` (the model's `kernels`) chooses per site, as the JAX
package's flags do: by default the self-attention block (K1), the
cross-attention block (K7) over the hoisted k/v (`ca_kv`: the music rows'
and the time rows' k/v read apart, the FiLM residual inside) and the FF
block + tail (K2); the FF block without its tail (K2b); K7 over the memory
where the k/v are not hoisted; the whole layer (K6) over the hoisted k/v;
in the per-op configuration LN -> rotary -> q/k/v (K8), attention (K11,
also in the cond encoder), the post-attention LayerNorms (K10) and the
LN -> projections of the FF chain (K9). A site whose kernel is off runs
as plain PyTorch math, the counterpart of the JAX package's XLA code;
with `kernels.int8` its decoder-layer projections run through
`ops.int8.int8_dense`, at the sites where the JAX package's TCDIFF_INT8
quantizes. In training the self-attention (K3), cross-attention (K4) and
FF + tail (K5) blocks run, forward and backward; with a `trj_dist` (TRPE)
the self-attention block runs as plain PyTorch math, as the JAX package
sends it to XLA, and K4 and K5 still run.

While a torch.profiler session records (`utils/profiling.span`), each
decoder layer is the span `decoder.layer` (attr `i`), the plain
cross-attention (int8, per-op, TCDIFF_PALLAS_XAB=0) `ca.plain`, and each kernel's entry
in `tcdiff_torch.ops` its own span, whichever path it takes
(`k1.sa_block`, `k2.ff_tail`, `k2b.ff_block`, `k6.layer`, `k7.ca_block`,
`k8.ln_rotary_matmul`, `k9.ln_matmul`, `k10.layernorm`, `k11.attention`;
in training `k3.sa_block_train`, `k4.ca_block_train`, `k5.ff_tail_train`,
each with a `.bwd` span over its backward).

Tensor parallelism: once `parallel.sharding_rules.shard_train_state` has
split the weights over a mesh's tp ranks (`tp_mesh`; each split parameter
carries its `Shard`), the train path runs each decoder layer over this
rank's shards through the blocks' plain versions, given the mesh (no
train kernel, as the JAX package's default under tp; see
`FiLMTransformerDecoderLayer.forward_train`) and every other split linear through
`_split_linear`, so that each rank computes what one process does, its
products split; the serving path refuses split weights (sampling runs on a
whole model holding the gathered ones).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tcdiff_torch.config import DanceDecoderConfig, ServingKernels
from tcdiff_torch.models.rotary import RotaryEmbedding, angle_table, apply_rotary
from tcdiff_torch.ops import (
    attention, ca_block, ca_block_train, ff_block, ff_block_train, int8, layernorm, ln_matmul, ln_rotary_matmul,
    sa_block, sa_block_train,
)
from tcdiff_torch.ops._common import mm_f32
from tcdiff_torch.ops.attention import N_TRJ_BUCKETS, trpe_bias
from tcdiff_torch.ops.ca_block_train import ca_block_train_plain
from tcdiff_torch.ops.ff_block_train import ff_tail_train_plain
from tcdiff_torch.ops.layer import layer as fused_layer
from tcdiff_torch.ops.sa_block_train import sa_block_train_plain
from tcdiff_torch.ops.train_common import local_bias, local_heads, mm_whole
from tcdiff_torch.parallel.comm import tp_gather, tp_reduce, tp_slice
from tcdiff_torch.parallel.mesh import Mesh, Rows, draw
from tcdiff_torch.utils.profiling import span


class CondCache(NamedTuple):
    """The per-request cond encoding, replayed through every step."""

    ct: torch.Tensor  # (B, Lc, d) encoded music tokens
    cond_hidden: torch.Tensor  # (B, d)
    # per layer (kct, vct), (B, Lc, hd), and the (layers, hd, d) k and v
    # weights in dtype; None with the k/v cache off
    kv: Optional[Tuple[Tuple[torch.Tensor, torch.Tensor], ...]]
    w_stack: Optional[Tuple[torch.Tensor, torch.Tensor]]


def _lin(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """nn.Dense(dtype=x.dtype) on f32 params: weights cast per use. A
    weight split over the tensor-parallel ranks runs `_split_linear`."""
    shard = getattr(mod.weight, "tp_shard", None)
    if shard is not None:
        return _split_linear(x, mod.weight, mod.bias, shard)
    b = None if mod.bias is None else mod.bias.to(x.dtype)
    return F.linear(x, mod.weight.to(x.dtype), b)


def _split_linear(x, w, b, shard) -> torch.Tensor:
    """x . w^T + b where w is this tp rank's shard of a split weight (a
    `parallel.sharding_rules.Shard`; each packed chunk is passed alone) and
    b whole; every rank returns the whole output, in x's dtype. Split on
    the output (dim 0): this rank's columns, x entering whole (`mm_whole`)
    with its bias entries, rounded and gathered. Split on the input (dim
    1): this rank's slice of x meets its rows, the f32 partial sums are
    reduced, the bias added and the sum rounded. Either way the products
    are f32 sums of the operands rounded to x's dtype, as F.linear in that
    dtype computes them, the bias rounded to it too."""
    mesh, dt = shard.mesh, x.dtype
    if shard.dim == 0:
        y = mm_whole(x, w, mesh)
        if b is not None:
            y = y + local_bias(b, w.shape[0], mesh).to(dt).float()
        return tp_gather(y.to(dt), mesh)
    y = tp_reduce(mm_f32(tp_slice(x, mesh), w), mesh)
    return (y if b is None else y + b.to(dt).float()).to(dt)


def _table(p: torch.Tensor) -> torch.Tensor:
    """A parameter table whole: gathered where it is split over the tp
    ranks (on its last dim, as the rule splits the model's tables)."""
    shard = getattr(p, "tp_shard", None)
    if shard is None:
        return p
    if shard.dim != p.dim() - 1:
        raise ValueError(f"a table split on dim {shard.dim} of {p.dim()}; only the last is gathered")
    return tp_gather(p, shard.mesh)


def _proj(mod: nn.Linear, x: torch.Tensor, quantized: bool) -> torch.Tensor:
    """`_lin`, or where `quantized` the int8 projection from the f32
    weight's codes (the JAX package's `int8_dense(x, kernel, bias)`)."""
    if quantized:
        return int8.int8_dense(x, *int8.quantized_weight(mod.weight), mod.bias)
    return _lin(mod, x)


def _ln(mod: nn.LayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """flax LayerNorm: f32 statistics, output in x's dtype. Where the model
    set `mod.ln_bf16` (TCDIFF_LN_BF16) and x is below f32, the statistics
    stay in x's dtype, in flax 0.12's order (force_float32_reductions=False):
    the mean and E[x^2] each an f32 sum rounded to the dtype, var = E[x^2]
    - mean^2 clipped at 0 and rsqrt(var + eps) in the dtype, then the f32
    affine."""
    if x.dtype == torch.float32 or not getattr(mod, "ln_bf16", False):
        return F.layer_norm(x.float(), mod.normalized_shape, mod.weight.float(), mod.bias.float(), eps).to(x.dtype)
    dt = x.dtype
    mu = x.float().mean(-1, keepdim=True).to(dt)
    mu2 = (x * x).float().mean(-1, keepdim=True).to(dt)
    var = torch.clamp_min(mu2 - mu * mu, 0.0)
    mul = torch.rsqrt(var + eps).float() * mod.weight.float()
    return ((x - mu).float() * mul + mod.bias.float()).to(dt)


def _identity(t):
    return t


def dropout_keep(generator: Optional[torch.Generator], shape, device, rate: float,
                 rows: Optional[Rows] = None) -> Optional[torch.Tensor]:
    """The keep mask (bool, True = kept with probability 1-rate) of one
    dropout site of `shape`, drawn from `generator`; None at rate 0. With
    `rows` it is drawn at the global batch and this rank's rows kept
    (`parallel.mesh.draw`)."""
    if rate == 0.0:
        return None
    if generator is None:
        raise ValueError("dropout > 0 in training needs a torch.Generator")
    return draw(lambda s: torch.rand(s, generator=generator, device=device), tuple(shape), rows) >= rate


def apply_keep(t: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """flax-style dropout of t under a `dropout_keep` mask: kept values
    scaled by 1/(1-rate), the others 0; t itself where keep is None."""
    if keep is None:
        return t
    return torch.where(keep, t / (1.0 - rate), torch.zeros((), dtype=t.dtype, device=t.device))


def dropout_fn(rate: float, generator: Optional[torch.Generator], rows: Optional[Rows] = None):
    """flax-style dropout drawing each call's mask from `generator`
    (`dropout_keep`, `apply_keep`); identity at rate 0."""
    if rate == 0.0:
        return _identity
    if generator is None:
        raise ValueError("dropout > 0 in training needs a torch.Generator")
    return lambda t: apply_keep(t, dropout_keep(generator, t.shape, t.device, rate, rows), rate)


def block_seeds(generator: Optional[torch.Generator], b: int, device, rate: float,
                rows: Optional[Rows] = None) -> torch.Tensor:
    """One uint32 dropout seed per batch element for a train-block op
    (int64 (b,)); zeros at rate 0, as the JAX package passes. With `rows`
    the seeds are drawn for the global batch and this rank's kept, so the
    kernels' hash sees the seeds a single process would give these rows."""
    if rate == 0.0:
        return torch.zeros(b, dtype=torch.int64, device=device)
    return draw(lambda s: torch.randint(0, 2**32, s, generator=generator, device=device, dtype=torch.int64),
                (b,), rows)


class TrainDraws(NamedTuple):
    """One decoder layer's randomness on the train path, drawn before the
    layer runs, so that a forward recomputed under remat sees the same:
    the (b,) dropout seeds of K3 (None under TRPE), K4 and K5 and, under
    TRPE, the plain self-attention block's keep masks (attention
    probabilities, fc output, block output; None at rate 0)."""

    sa: Optional[torch.Tensor]
    ca: torch.Tensor
    ff: torch.Tensor
    sa_keep: Optional[Tuple[Optional[torch.Tensor], ...]] = None


def _joined(kv):
    """(k, v) over the music rows, then the time rows, of a layer's hoisted
    kv = (k_mem, v_mem, k_time, v_time)."""
    k_mem, v_mem, k_time, v_time = kv
    return torch.cat([k_mem, k_time], dim=1), torch.cat([v_mem, v_time], dim=1)


def _heads(t: torch.Tensor, nhead: int) -> torch.Tensor:
    """(b, L, h*dk) -> (b, h, L, dk), a view."""
    return t.unflatten(-1, (nhead, -1)).transpose(1, 2)


def _merge(o: torch.Tensor) -> torch.Tensor:
    """(b, h, L, dk) -> (b, L, h*dk)."""
    return o.transpose(1, 2).flatten(2)


def _attend(q, k, v, scale: float, table=None, trj_dist=None, drop=_identity) -> torch.Tensor:
    """Plain softmax attention over (b, h, L, dk) heads in their dtype, as
    the JAX package's XLA path, with the optional TRPE bias (table (h, 10,
    dk), UNSCALED q); `drop` acts on the attention probabilities."""
    logits = torch.matmul(q * scale, k.transpose(-1, -2))
    if table is not None and trj_dist is not None:
        logits = logits + trpe_bias(torch.einsum("bhqd,hnd->bhqn", q, table.to(q.dtype)), trj_dist)
    return torch.matmul(drop(torch.softmax(logits, dim=-1)), v)


def sinusoidal_pos_emb(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Timestep embedding with the reference's half-1 denominator and
    [sin | cos] order."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device) * (-math.log(10000.0) / (half - 1)))
    args = x.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return sinusoidal_pos_emb(x, self.dim)


class DenseFiLM(nn.Module):
    """FiLM generator: Mish -> Linear(2d) -> (scale, shift), each (b, d)."""

    def __init__(self, dim: int):
        super().__init__()
        self.block = nn.Sequential(nn.Mish(), nn.Linear(dim, dim * 2))

    def forward(self, t):
        return _lin(self.block[1], F.mish(t)).chunk(2, dim=-1)


def featurewise_affine(x, scale_shift):
    scale, shift = scale_shift
    return (scale[:, None, :] + 1.0) * x + shift[:, None, :]


class ConcatSquashLinear(nn.Module):
    """Context-gated linear: layer(x) * sigmoid(hyper_gate(ctx)) + hyper_bias(ctx)."""

    def __init__(self, dim_in: int, dim_out: int, dim_ctx: int):
        super().__init__()
        self._layer = nn.Linear(dim_in, dim_out)
        self._hyper_bias = nn.Linear(dim_ctx, dim_out, bias=False)
        self._hyper_gate = nn.Linear(dim_ctx, dim_out)

    def forward(self, ctx, x):
        gate = torch.sigmoid(_lin(self._hyper_gate, ctx))
        return _lin(self._layer, x) * gate + _lin(self._hyper_bias, ctx)


class TorchMHA(nn.Module):
    """Explicit matmul+softmax attention with nn.MultiheadAttention's
    parameter names (packed in_proj, out_proj). `attention_fn` is K11's
    wrapper, called where `kernels.attention` is on (serving only)."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        self.attention_fn = attention.attention

    def forward(self, q_in, k_in, v_in, drop=_identity, kernels: Optional[ServingKernels] = None):
        dt = q_in.dtype
        shard = getattr(self.in_proj_weight, "tp_shard", None)
        if shard is None:
            w, b = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
            proj = lambda t, wi, bi: F.linear(t, wi, bi)  # noqa: E731
        else:  # each of q, k, v split alike, the packed chunks cut alike
            w, b = self.in_proj_weight, self.in_proj_bias
            proj = lambda t, wi, bi: _split_linear(t, wi, bi, shard)  # noqa: E731
        wq, wk, wv = w.chunk(3)
        bq, bk, bv = b.chunk(3)
        q, k, v = (_heads(proj(t, wi, bi), self.n_head)
                   for t, wi, bi in ((q_in, wq, bq), (k_in, wk, bk), (v_in, wv, bv)))
        scale = 1.0 / math.sqrt(q.shape[-1])
        if kernels is not None and kernels.attention:
            o = self.attention_fn(q, k, v, scale)  # per head (1) or all heads (2): one kernel
        else:
            o = _attend(q, k, v, scale, drop=drop)
        return _lin(self.out_proj, _merge(o))


class TransformerEncoderLayer(nn.Module):
    """Pre-norm cond-encoder layer with rotary on the full vector."""

    def __init__(self, d_model: int, n_head: int, ff_size: int):
        super().__init__()
        self.rotary = RotaryEmbedding(d_model)
        self.self_attn = TorchMHA(d_model, n_head)
        self.linear1 = nn.Linear(d_model, ff_size)
        self.linear2 = nn.Linear(ff_size, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, x, drop=_identity, kernels: Optional[ServingKernels] = None):
        """`drop`: the dropout of the train path, at the reference's four
        sites (attention probabilities, after attention, after the GELU,
        after linear2). `kernels`: the serving configuration (None on the
        train path)."""
        h = _ln(self.norm1, x, 1e-5)
        qk = apply_rotary(h, angle_table(x.shape[-2], x.shape[-1], x.device))
        x = x + drop(self.self_attn(qk, qk, h, drop, kernels))
        h = drop(F.gelu(_lin(self.linear1, _ln(self.norm2, x, 1e-5)), approximate="none"))
        return x + drop(_lin(self.linear2, h))


class SBIMSA(nn.Module):
    """Trajectory-aware multi-head attention: bias-free q/k/v/fc projections
    and a post-attention LayerNorm (eps 1e-6). With the self-attention block
    kernel on, the layer runs the whole self-attention form as
    `ops.sa_block` instead.

    `ln_rotary_fn` (K8), `attention_fn` (K11) and `layernorm_fn` (K10) are
    the kernel wrappers this module calls where `kernels` turns them on."""

    def __init__(self, d_model: int, n_head: int, head_dim: int):
        super().__init__()
        hd = n_head * head_dim
        self.n_head = n_head
        self.head_dim = head_dim
        self.w_qs = nn.Linear(d_model, hd, bias=False)
        self.w_ks = nn.Linear(d_model, hd, bias=False)
        self.w_vs = nn.Linear(d_model, hd, bias=False)
        self.fc = nn.Linear(hd, d_model, bias=False)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-6)
        self.ln_rotary_fn = ln_rotary_matmul.ln_rotary_matmul
        self.attention_fn = attention.attention
        self.layernorm_fn = layernorm.layernorm

    def self_qkv(self, x, norm: nn.LayerNorm, angles, kernels: ServingKernels, mesh: Optional[Mesh] = None):
        """Self-attention q, k, v from the raw residual x: q/k from the
        rotated norm(x), v from norm(x); one K8 launch where
        `kernels.ln_rotary`. With a tp `mesh` (the train path's plain
        math), this rank's heads' q, k, v from its shards."""
        if kernels.ln_rotary:
            w = lambda m: m.weight.to(x.dtype)
            (q, k), v = self.ln_rotary_fn(x, norm.weight, norm.bias, angles, (w(self.w_qs), w(self.w_ks)),
                                          w(self.w_vs), 1e-5)
            return q, k, v
        h = _ln(norm, x, 1e-5)
        r = apply_rotary(h, angles)
        if mesh is not None:
            return tuple(mm_whole(u, m.weight, mesh).to(x.dtype) for u, m in ((r, self.w_qs), (r, self.w_ks),
                                                                             (h, self.w_vs)))
        q8 = kernels.int8
        return _proj(self.w_qs, r, q8), _proj(self.w_ks, r, q8), _proj(self.w_vs, h, q8)

    def cross_q(self, x, norm: nn.LayerNorm, angles, kernels: ServingKernels, fused: bool):
        """Cross-attention q from the raw residual x: rotated norm(x)
        projected; K8's rot-only form where `fused` and `kernels.ln_rotary`
        (the JAX package fuses it only without the k/v cache). With int8,
        q is quantized only where `fused` (over the hoisted k/v the JAX
        package keeps it float)."""
        if fused and kernels.ln_rotary:
            return self.ln_rotary_fn(x, norm.weight, norm.bias, angles, self.w_qs.weight.to(x.dtype), None, 1e-5)
        return _proj(self.w_qs, apply_rotary(_ln(norm, x, 1e-5), angles), fused and kernels.int8)

    def attend(self, q, k, v, kernels: ServingKernels, shared_emb=None, trj_dist=None, drop_attn=_identity,
               drop_fc=_identity, mesh: Optional[Mesh] = None):
        """softmax attention of (b, L, h*dk) projections [+ TRPE], fc, then
        the post-attention LayerNorm; K11 and K10 where `kernels` turns
        them on, fc in int8 with `kernels.int8`. `drop_attn` / `drop_fc`:
        the train path's dropout of the attention probabilities and of the
        fc output (plain math only). With a tp `mesh` (plain math), over
        this rank's heads and its columns of the TRPE table, fc's f32
        partial sums reduced."""
        h, dk = local_heads(self.n_head, mesh)[0], self.head_dim
        q, k, v = _heads(q, h), _heads(k.to(q.dtype), h), _heads(v.to(q.dtype), h)
        scale = 1.0 / math.sqrt(dk)
        table = None if trj_dist is None else shared_emb.reshape(N_TRJ_BUCKETS, h, dk).transpose(0, 1)
        if kernels.attention:
            # the JAX package's per-head program (always with TRPE) and its
            # all-heads one (attention=2) are one kernel here
            o = self.attention_fn(q, k, v, scale, table, trj_dist)
        else:
            o = _attend(q, k, v, scale, table, trj_dist, drop_attn)
        if mesh is None:
            o = drop_fc(_proj(self.fc, _merge(o), kernels.int8))
        else:
            o = drop_fc(tp_reduce(mm_f32(_merge(o), self.fc.weight), mesh).to(q.dtype))
        if kernels.layernorm:
            return self.layernorm_fn(o, self.layer_norm.weight, self.layer_norm.bias, 1e-6)
        return _ln(self.layer_norm, o, 1e-6)


class FiLMTransformerDecoderLayer(nn.Module):
    """FiLM-conditioned decoder layer: `forward` (deterministic) and
    `forward_train`.

    `sa_block_fn` / `ff_tail_fn` / `ff_block_fn` / `ca_block_fn` /
    `ca_kv_fn` / `layer_fn` / `ln_matmul_fn` (serving) and
    `sa_train_fn` / `ca_train_fn` / `ff_train_fn` (training) are the kernel
    functions this layer calls; they default to the dispatching wrappers of
    `tcdiff_torch.ops`.
    """

    def __init__(self, d_model: int, n_head: int, ff_size: int, head_dim: int = 64,
                 use_traj_modulation: bool = False):
        super().__init__()
        self.n_head = n_head
        self.use_traj_modulation = use_traj_modulation
        self.rotary = RotaryEmbedding(d_model)
        self.self_attn = SBIMSA(d_model, n_head, head_dim)
        self.multihead_attn = SBIMSA(d_model, n_head, head_dim)
        self.linear1 = nn.Linear(d_model, ff_size)
        self.linear2 = nn.Linear(ff_size, d_model)
        self.linear3 = nn.Linear(d_model, d_model)
        for i in range(1, 5):
            setattr(self, f"norm{i}", nn.LayerNorm(d_model))
        for i in range(1, 4):
            setattr(self, f"film{i}", DenseFiLM(d_model))
        self.traj_Modulation = nn.ModuleList([
            ConcatSquashLinear(d_model, 128, d_model),
            ConcatSquashLinear(128, 128, d_model),
            ConcatSquashLinear(128, d_model, d_model),
        ])
        self.sa_block_fn = sa_block.sa_block
        self.ff_tail_fn = ff_block.ff_tail
        self.ff_block_fn = ff_block.ff_block
        self.ca_block_fn = ca_block.ca_block
        self.ca_kv_fn = ca_block.ca_kv
        self.layer_fn = fused_layer
        self.ln_matmul_fn = ln_matmul.ln_matmul
        self.sa_train_fn = sa_block_train.sa_block_train
        self.ca_train_fn = ca_block_train.ca_block_train
        self.ff_train_fn = ff_block_train.ff_tail_train

    def forward(self, x, memory, t, traj_emb, shared_emb, trj_dist=None, *,
                kv=None, tile_sa=False, kernels: ServingKernels = ServingKernels()):
        """x (b, L, d); t (B, d); memory (B, Lm, d) or None with kv = (k of
        the music rows, their v, k of the time rows, their v), the layer's
        cross-attention projections (B, rows, h*dk). tile_sa: x,
        traj_emb and trj_dist arrive at half batch (CFG dedup). `kernels`
        chooses the kernel or the plain math at each site, as the JAX
        package's layer does (`tcdiff_tpu/models/dance_decoder.py:715-1062`)."""
        angles = angle_table(x.shape[-2], x.shape[-1], x.device)
        if kernels.layer_fuse and kv is not None and trj_dist is None and not tile_sa:
            x = self._fused_layer(x, t, kv, angles, kernels)
        else:
            # a block kernel takes the FiLM rows only at the doubled batch:
            # the CFG-dedup layer adds them outside
            fuse_film = kernels.fuse_film and not tile_sa
            x, traj_emb = self._self_attention(x, t, traj_emb, shared_emb, trj_dist, angles, tile_sa,
                                               fuse_film, kernels)
            x = self._cross_attention(x, memory, t, kv, angles, fuse_film, kernels)
            x = self._feed_forward(x, t, fuse_film, kernels)
        return self._traj_modulation(x, t, traj_emb)

    def _fused_layer(self, x, t, kv, angles, kernels: ServingKernels):
        """The whole layer as K6 over the hoisted k/v, every FiLM residual
        inside; with `layer_fuse_ff` off K6 stops after cross-attention and
        K2 finishes the layer."""
        sa, ca = self.self_attn, self.multihead_attn
        w = lambda m: m.weight.to(x.dtype)
        head = (x, angles, self.norm1.weight, self.norm1.bias, w(sa.w_qs), w(sa.w_ks), w(sa.w_vs), w(sa.fc),
                sa.layer_norm.weight, sa.layer_norm.bias, *self.film1(t),
                self.norm2.weight, self.norm2.bias, w(ca.w_qs), w(ca.fc), ca.layer_norm.weight,
                ca.layer_norm.bias, *_joined(kv), *self.film2(t))
        ff = (self.norm3.weight, self.norm3.bias, w(self.linear1), self.linear1.bias, w(self.linear2),
              self.linear2.bias, *self.film3(t), self.norm4.weight, self.norm4.bias, w(self.linear3),
              self.linear3.bias)
        if kernels.layer_fuse_ff:
            return self.layer_fn(*head, *ff, nhead=self.n_head)
        return self.ff_tail_fn(self.layer_fn(*head, nhead=self.n_head, include_ff=False), *ff)

    def _self_attention(self, x, t, traj_emb, shared_emb, trj_dist, angles, tile_sa, fuse_film,
                        kernels: ServingKernels):
        """x + FiLM(self-attention block): K1, with the FiLM residual
        inside where `fuse_film`, or the per-op / plain math. With tile_sa
        the block runs at half batch, then x and traj_emb are tiled."""
        sa = self.self_attn
        fs, fb = self.film1(t)
        w = lambda m: m.weight.to(x.dtype)
        sa_args = (
            x, self.norm1.weight, self.norm1.bias, angles, w(sa.w_qs), w(sa.w_ks), w(sa.w_vs), w(sa.fc),
            sa.layer_norm.weight, sa.layer_norm.bias, shared_emb if trj_dist is not None else None, trj_dist,
        )
        if kernels.sa_block and fuse_film:
            return self.sa_block_fn(*sa_args, fs, fb, nhead=self.n_head), traj_emb
        if kernels.sa_block:
            s = self.sa_block_fn(*sa_args, nhead=self.n_head)
        else:
            s = sa.attend(*sa.self_qkv(x, self.norm1, angles, kernels), kernels, shared_emb, trj_dist)
        if tile_sa:
            # the two CFG halves share x: the block ran at half batch; tile
            s, x, traj_emb = (torch.cat([a, a], dim=0) for a in (s, x, traj_emb))
        return x + featurewise_affine(s, (fs, fb)), traj_emb

    def _cross_attention(self, x, memory, t, kv, angles, fuse_film, kernels: ServingKernels):
        """x + FiLM(cross-attention to the music/time tokens): K7 where
        `kernels.ca_block`, over the hoisted k/v where given (FiLM inside)
        or else over the memory; else the plain math, with K8's rot-only
        query where `kernels.ln_rotary` and no k/v are given."""
        ca = self.multihead_attn
        fs, fb = self.film2(t)
        w = lambda m: m.weight.to(x.dtype)
        if kv is not None and kernels.ca_block:
            return self.ca_kv_fn(x, self.norm2.weight, self.norm2.bias, angles, *kv, w(ca.w_qs), w(ca.fc),
                                 ca.layer_norm.weight, ca.layer_norm.bias, fs, fb, nhead=self.n_head)
        if kv is None:
            rot_mem = apply_rotary(memory, angle_table(memory.shape[-2], memory.shape[-1], x.device))
            if kernels.ca_block:
                args = (x, self.norm2.weight, self.norm2.bias, angles, memory, rot_mem,
                        w(ca.w_qs), w(ca.w_ks), w(ca.w_vs), w(ca.fc), ca.layer_norm.weight, ca.layer_norm.bias)
                if fuse_film:
                    return self.ca_block_fn(*args, fs, fb, nhead=self.n_head)
                return x + featurewise_affine(self.ca_block_fn(*args, nhead=self.n_head), (fs, fb))
        with span("ca.plain"):
            q = ca.cross_q(x, self.norm2, angles, kernels, fused=kv is None)
            if kv is None:
                # int8 k/v where q is not K8's (the JAX package's plain SBI-MSA)
                q8 = kernels.int8 and not kernels.ln_rotary
                k, v = _proj(ca.w_ks, rot_mem, q8), _proj(ca.w_vs, memory, q8)
            else:
                k, v = _joined(kv)
            return x + featurewise_affine(ca.attend(q, k, v, kernels), (fs, fb))

    def _feed_forward(self, x, t, fuse_film, kernels: ServingKernels):
        """The FF block + FiLM and the layer tail linear3(norm4(.)): K2 for
        both; or K2b (FiLM inside where `fuse_film`), or the plain math
        with K9 where `kernels.ln_matmul`, then the tail, through K9 where
        `kernels.ln_matmul`."""
        fs, fb = self.film3(t)
        w = lambda m: m.weight.to(x.dtype)
        if kernels.ff_block:
            ff_args = (x, self.norm3.weight, self.norm3.bias, w(self.linear1), self.linear1.bias,
                       w(self.linear2), self.linear2.bias)
            if kernels.ff_tail:
                return self.ff_tail_fn(*ff_args, fs, fb, self.norm4.weight, self.norm4.bias, w(self.linear3),
                                       self.linear3.bias)
            if fuse_film:
                x = self.ff_block_fn(*ff_args, fs, fb)
            else:
                x = x + featurewise_affine(self.ff_block_fn(*ff_args), (fs, fb))
        else:
            if kernels.ln_matmul:
                h = self.ln_matmul_fn(x, self.norm3.weight, self.norm3.bias, w(self.linear1),
                                      self.linear1.bias, 1e-5)
            else:
                h = _proj(self.linear1, _ln(self.norm3, x, 1e-5), kernels.int8)
            h = _proj(self.linear2, F.gelu(h, approximate="none"), kernels.int8)
            x = x + featurewise_affine(h, (fs, fb))
        if kernels.ln_matmul:
            return self.ln_matmul_fn(x, self.norm4.weight, self.norm4.bias, w(self.linear3), self.linear3.bias, 1e-5)
        return _proj(self.linear3, _ln(self.norm4, x, 1e-5), kernels.int8)

    def _traj_modulation(self, x, t, traj_emb):
        if self.use_traj_modulation:
            # ConcatSquash trajectory modulation; the reference computes it
            # and drops it, so it runs only when asked for
            ctx = torch.cat([t[:, None, :], traj_emb], dim=-2)
            out = F.leaky_relu(self.traj_Modulation[0](ctx, x))
            out = F.leaky_relu(self.traj_Modulation[1](ctx, out))
            x = self.traj_Modulation[2](ctx, out)
        return x

    def train_draws(self, generator: Optional[torch.Generator], shape, rate: float, rows: Optional[Rows] = None,
                    trpe: bool = False) -> TrainDraws:
        """This layer's randomness for an x of `shape` (b, L, d), drawn from
        `generator` in the order of its sites (at the global batch of
        `rows`, where given): the self-attention block's (K3's seeds, or
        under `trpe` the plain block's three keep masks), then K4's and
        K5's seeds."""
        b, L, d = shape
        dev = self.norm1.weight.device
        seeds = lambda: block_seeds(generator, b, dev, rate, rows)
        if trpe:
            keep = lambda *s: dropout_keep(generator, s, dev, rate, rows)
            masks = (keep(b, self.n_head, L, L), keep(b, L, d), keep(b, L, d))
            return TrainDraws(None, seeds(), seeds(), masks)
        return TrainDraws(seeds(), seeds(), seeds())

    def forward_train(self, x, memory, t, traj_emb, draws: TrainDraws, rate: float, shared_emb=None,
                      trj_dist=None, mesh: Optional[Mesh] = None):
        """The train path: x (b, L, d); memory (b, Lm, d); t (b, d); `draws`
        from `train_draws`. With `trj_dist` (b, L, L) and `shared_emb` the
        self-attention block runs as plain math with the TRPE bias, as the
        JAX package's XLA path; K4 and K5 run either way.

        With a `mesh` of tp > 1 the layer's weights are this rank's shards
        (`parallel/sharding_rules.py`) and each block runs its plain
        version over this rank's heads or feed-forward columns, split at
        its one all-reduce (`ops/train_common.py`): K3-K5 take whole-d
        weights and stay off, as the JAX package's default under tp
        (`tcdiff_tpu/models/dance_decoder.py:156-170`). The FiLM rows run
        as split linears (`_split_linear`)."""
        if mesh is not None and mesh.tp > 1:
            sa_fn, ca_fn, ff_fn = (functools.partial(f, mesh=mesh) for f in (
                sa_block_train_plain, ca_block_train_plain, ff_tail_train_plain))
        else:
            sa_fn, ca_fn, ff_fn, mesh = self.sa_train_fn, self.ca_train_fn, self.ff_train_fn, None
        dt, dev = x.dtype, x.device
        b, L, d = x.shape
        w = lambda m: m.weight.to(dt)
        angles = angle_table(L, d, dev)

        sa = self.self_attn
        fs, fb = self.film1(t)
        if trj_dist is None:
            x = sa_fn(
                x, self.norm1.weight, self.norm1.bias, angles, w(sa.w_qs), w(sa.w_ks), w(sa.w_vs),
                w(sa.fc), sa.layer_norm.weight, sa.layer_norm.bias, fs, fb, draws.sa,
                nhead=self.n_head, rate=rate,
            )
        else:
            keep_attn, keep_fc, keep_out = draws.sa_keep
            nh, head0 = local_heads(self.n_head, mesh)
            if keep_attn is not None:  # this rank's heads
                keep_attn = keep_attn.narrow(1, head0, nh)
            drop = lambda keep: lambda u: apply_keep(u, keep, rate)
            s = sa.attend(*sa.self_qkv(x, self.norm1, angles, _PLAIN, mesh), _PLAIN, shared_emb, trj_dist,
                          drop(keep_attn), drop(keep_fc), mesh)
            x = x + featurewise_affine(apply_keep(s, keep_out, rate), (fs, fb))
        ca = self.multihead_attn
        fs, fb = self.film2(t)
        x = ca_fn(
            x, memory, self.norm2.weight, self.norm2.bias, angles,
            angle_table(memory.shape[1], d, dev), w(ca.w_qs), w(ca.w_ks), w(ca.w_vs), w(ca.fc),
            ca.layer_norm.weight, ca.layer_norm.bias, fs, fb, draws.ca, nhead=self.n_head, rate=rate,
        )
        fs, fb = self.film3(t)
        x = ff_fn(
            x, self.norm3.weight, self.norm3.bias, w(self.linear1), self.linear1.bias,
            w(self.linear2), self.linear2.bias, fs, fb, self.norm4.weight, self.norm4.bias,
            w(self.linear3), self.linear3.bias, draws.ff, rate=rate,
        )
        return self._traj_modulation(x, t, traj_emb)


# the train path's plain sites (TRPE self-attention): no serving kernel, no int8
_PLAIN = ServingKernels(sa_block=False, ff_block=False, kv_cache=False, ca_block=False)


class _DecoderStack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.stack = nn.ModuleList(layers)


class DanceDecoder(nn.Module):
    """Full denoiser. forward(x, cond, times, keep_mask) with
      x: (b, seq_len*dn, nfeats) noised motion, time-major token order;
      cond: (B, 301, cond_feature_dim) music features (unused with cond_cache);
      times: (B,) timesteps; keep_mask: (B,) bool, True = real condition.
    Returns (B, tokens, nfeats) float32. B == b, or 2b with cfg_pair.
    `kernels` (a ServingKernels; may be replaced between calls) chooses the
    serving path's kernels. `remat` (the JAX package's remat): the train
    path runs each decoder layer under `torch.utils.checkpoint`, so that
    its activations are recomputed in the backward instead of kept; the
    serving path is the same with or without it. `ln_bf16`
    (TCDIFF_LN_BF16; may be set between calls): see `_ln`.
    """

    def __init__(self, cfg: DanceDecoderConfig, dtype: torch.dtype = torch.float32,
                 use_traj_modulation: bool = False, device="cuda",
                 kernels: ServingKernels = ServingKernels(), remat: bool = False, ln_bf16: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.kernels = kernels
        self.remat = remat
        d, dn, cf = cfg.latent_dim, cfg.dancer_num, cfg.cond_feature_dim
        hd = cfg.num_heads * cfg.head_dim
        self.rotary = RotaryEmbedding(d)
        self.input_projection = nn.Linear(cfg.nfeats, d)
        self.final_layer = nn.Linear(d, cfg.nfeats)
        self.traj_embedding = nn.Sequential(nn.Linear(2, 64), nn.ReLU(), nn.Linear(64, d))
        self.relative_projection_layer = nn.Sequential(
            nn.Linear(d * dn, d * 2), nn.ReLU(), nn.Linear(d * 2, d * 2), nn.ReLU(),
            nn.Linear(d * 2, d * dn),
        )
        self.cond_projection = nn.Sequential(nn.Linear(cf * 2, cf), nn.ReLU(), nn.Linear(cf, d))
        self.non_attn_cond_projection = nn.Sequential(
            nn.LayerNorm(d, eps=1e-6), nn.Linear(d, d), nn.SiLU(), nn.Linear(d, d),
        )
        self.time_mlp = nn.Sequential(SinusoidalPosEmb(d), nn.Linear(d, d * 4), nn.Mish())
        self.to_time_cond = nn.Sequential(nn.Linear(d * 4, d))
        self.to_time_tokens = nn.Sequential(nn.Linear(d * 4, d * 2), nn.Unflatten(-1, (2, d)))
        self.norm_cond = nn.LayerNorm(d, eps=1e-6)
        self.null_cond_embed = nn.Parameter(torch.zeros(1, cfg.seq_len, d))
        self.null_cond_hidden = nn.Parameter(torch.zeros(1, d))
        self.embeddings_table = nn.Embedding(cfg.max_dancers, hd)
        self.cond_encoder = nn.Sequential(
            *[TransformerEncoderLayer(d, cfg.num_heads, cfg.ff_size) for _ in range(2)]
        )
        self.seqTransDecoder = _DecoderStack([
            FiLMTransformerDecoderLayer(d, cfg.num_heads, cfg.ff_size, cfg.head_dim, use_traj_modulation)
            for _ in range(cfg.num_layers)
        ])
        self.to(device)  # raises where the device does not exist: no quiet CPU fallback
        self.ln_bf16 = ln_bf16
        self.tp_mesh: Optional[Mesh] = None  # set where the weights are split (`shard_train_state`)

    @property
    def layers(self):
        return self.seqTransDecoder.stack

    @property
    def ln_bf16(self) -> bool:
        return self._ln_bf16

    @ln_bf16.setter
    def ln_bf16(self, on: bool) -> None:
        """Set the flag on every LayerNorm the model computes through `_ln`."""
        self._ln_bf16 = bool(on)
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.ln_bf16 = self._ln_bf16

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "DanceDecoder":
        """Random weights from `generator` in the flax layout's spirit:
        Linear weights N(0, 1/fan_in), biases 0, LayerNorms (1, 0), the
        null embeddings and TRPE table N(0, 1)."""
        normal = lambda p, std: p.copy_(torch.randn(p.shape, generator=generator) * std)
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (nn.Linear, TorchMHA)):
                w, b = (m.weight, m.bias) if isinstance(m, nn.Linear) else (m.in_proj_weight, m.in_proj_bias)
                normal(w, 1.0 / math.sqrt(w.shape[1]))
                if b is not None:
                    b.zero_()
        for p in (self.null_cond_embed, self.null_cond_hidden, self.embeddings_table.weight):
            normal(p, 1.0)
        return self

    # ------------------------------------------------------------ cond side
    def encode_cond(self, cond, keep_mask, drop=_identity, kernels: Optional[ServingKernels] = None):
        """Music condition -> (ct (B, Lc, d), cond_hidden (B, d)); `drop`
        is the cond encoder's dropout on the train path, `kernels` the
        serving configuration (None: plain math, as on the train path)."""
        dt = self.dtype
        cond = cond.to(dt)
        b = cond.shape[0]
        if cond.shape[1] % 2 == 1:
            cond = cond[:, :-1]
        cond2 = cond.reshape(b, cond.shape[1] // 2, cond.shape[2] * 2)
        cp = self.cond_projection
        ct = _lin(cp[2], F.relu(_lin(cp[0], cond2)))
        for layer in self.cond_encoder:
            ct = layer(ct, drop, kernels)
        km = keep_mask.to(torch.bool)
        ct = torch.where(km[:, None, None], ct, self.null_cond_embed.to(dt))
        na = self.non_attn_cond_projection
        ch = _ln(na[0], ct.mean(dim=-2), 1e-6)
        ch = _lin(na[3], F.silu(_lin(na[1], ch)))
        cond_hidden = torch.where(km[:, None], ch, _table(self.null_cond_hidden).to(dt))
        return ct, cond_hidden

    def cond_cache(self, cond, keep_mask) -> CondCache:
        """encode_cond plus, with `kernels.kv_cache`, the hoisted
        cross-attention k/v of the music rows of every layer: row-wise
        norm_cond, rotary and projections are independent of the
        timestep."""
        self._whole("the cond cache")
        dt = self.dtype
        ct, cond_hidden = self.encode_cond(cond, keep_mask, kernels=self.kernels)
        if not self.kernels.kv_cache:
            return CondCache(ct, cond_hidden, None, None)
        d = ct.shape[-1]
        norm_ct = _ln(self.norm_cond, ct, 1e-6)
        rot_ct = apply_rotary(norm_ct, angle_table(ct.shape[1] + 2, d, ct.device)[: ct.shape[1]])
        wk = torch.stack([layer.multihead_attn.w_ks.weight for layer in self.layers]).to(dt)
        wv = torch.stack([layer.multihead_attn.w_vs.weight for layer in self.layers]).to(dt)
        kv = tuple((F.linear(rot_ct, wk[i]), F.linear(norm_ct, wv[i])) for i in range(len(self.layers)))
        return CondCache(ct, cond_hidden, kv, (wk, wv))

    # --------------------------------------------------------------- forward
    def _embed(self, x, times, cond_hidden):
        """The x and t side before the decoder layers: token embeddings h
        (b, tokens, d), the trajectory embedding (b, tokens-1, d), the
        FiLM condition t (B, d) and the 2 time tokens (B, 2, d)."""
        cfg, dt = self.cfg, self.dtype
        b, tokens, nfeats = x.shape
        dn = tokens // cfg.seq_len
        d = cfg.latent_dim
        x = x.to(dt)

        # per-token XY deltas -> trajectory embedding (crosses dancer
        # boundaries on the flat token axis, as the reference)
        xy = x[:, :, 4:6]
        te = self.traj_embedding
        traj_emb = _lin(te[2], F.relu(_lin(te[0], xy[:, 1:] - xy[:, :-1])))

        # input projection + fusion over the dancers of each frame
        rp = self.relative_projection_layer
        f = _lin(self.input_projection, x).reshape(b, cfg.seq_len, d * dn)
        f = F.relu(_lin(rp[2], F.relu(_lin(rp[0], f))))
        h = _lin(rp[4], f).reshape(b, tokens, d)

        # timestep embedding
        t_hidden = F.mish(_lin(self.time_mlp[1], sinusoidal_pos_emb(times, d).to(dt)))
        t = _lin(self.to_time_cond[0], t_hidden) + cond_hidden
        t_tokens = _lin(self.to_time_tokens[0], t_hidden).reshape(times.shape[0], 2, d)
        return h, traj_emb, t, t_tokens

    def forward_train(self, x, cond, times, keep_mask=None, generator: Optional[torch.Generator] = None,
                      rows: Optional[Rows] = None, trj_dist: Optional[torch.Tensor] = None):
        """The train path (the JAX package's deterministic=False), with
        dropout cfg.dropout drawn from `generator`: x (b, tokens, nfeats),
        cond (b, 301, cond_dim), times (b,), keep_mask (b,) bool, trj_dist
        (b, tokens, tokens) integer TRPE buckets or None. With `rows` (a
        data-parallel rank's rows of the global batch; trj_dist, like x,
        holds these rows) every dropout draw is made at the global batch
        and these rows kept. With `remat` each layer runs under
        `torch.utils.checkpoint` on draws made before it (under tp its
        recompute makes the same collectives, in the same order, on every
        rank). With weights split over tp ranks (`tp_mesh`) each layer runs
        over this rank's shards. Returns (b, tokens, nfeats) float32."""
        rate = self.cfg.dropout
        if keep_mask is None:
            keep_mask = torch.ones(times.shape[0], dtype=torch.bool, device=times.device)
        ct, cond_hidden = self.encode_cond(cond, keep_mask, dropout_fn(rate, generator, rows))
        h, traj_emb, t, t_tokens = self._embed(x, times, cond_hidden)
        memory = _ln(self.norm_cond, torch.cat([ct, t_tokens], dim=-2), 1e-6)
        shared_emb = self.embeddings_table.weight  # split: this rank's heads' columns, read by its heads alone
        for i, layer in enumerate(self.layers):
            with span("decoder.layer", i=i):
                draws = layer.train_draws(generator, h.shape, rate, rows, trpe=trj_dist is not None)
                args = (h, memory, t, traj_emb, draws, rate, shared_emb, trj_dist, self.tp_mesh)
                if self.remat:
                    # the layer draws nothing itself: no RNG state to stash
                    h = checkpoint(layer.forward_train, *args, use_reentrant=False, preserve_rng_state=False)
                else:
                    h = layer.forward_train(*args)
        return _lin(self.final_layer, h).float()

    def _whole(self, what: str) -> None:
        if self.tp_mesh is not None:
            raise ValueError(f"{what} runs on whole weights: this model's are split over tp ranks; sample from a "
                             f"whole model holding the gathered ones (parallel.sharding_rules.gather_train_state)")

    def forward(self, x, cond, times, keep_mask=None, trj_dist=None, *,
                cond_cache: Optional[CondCache] = None, cfg_pair: bool = False):
        self._whole("the serving path")
        cfg, dt = self.cfg, self.dtype
        if keep_mask is None:
            keep_mask = torch.ones(times.shape[0], dtype=torch.bool, device=times.device)
        if cond_cache is None:
            ct, cond_hidden = self.encode_cond(cond, keep_mask, kernels=self.kernels)
        else:
            ct, cond_hidden = cond_cache.ct.to(dt), cond_cache.cond_hidden.to(dt)

        d = cfg.latent_dim
        h, traj_emb, t, t_tokens = self._embed(x, times, cond_hidden)

        memory = kt_all = vt_all = None
        hoisted = cond_cache is not None and cond_cache.kv is not None
        if hoisted:
            # only the 2 time-token rows need norm + rotary + k/v per step,
            # projected for all layers at once
            norm_t = _ln(self.norm_cond, t_tokens, 1e-6)
            rot_t = apply_rotary(norm_t, angle_table(ct.shape[1] + 2, d, x.device)[ct.shape[1]:])
            wk_all, wv_all = cond_cache.w_stack
            kt_all = torch.einsum("btd,lhd->lbth", rot_t, wk_all.to(dt))
            vt_all = torch.einsum("btd,lhd->lbth", norm_t, wv_all.to(dt))
        else:
            memory = _ln(self.norm_cond, torch.cat([ct, t_tokens], dim=-2), 1e-6)

        shared_emb = self.embeddings_table.weight
        for i, layer in enumerate(self.layers):
            with span("decoder.layer", i=i):
                kv = None
                if hoisted:
                    kct, vct = cond_cache.kv[i]
                    kv = (kct.to(dt), vct.to(dt), kt_all[i], vt_all[i])
                tile = cfg_pair and i == 0
                h = layer(h, memory, t, traj_emb, shared_emb, trj_dist, kv=kv, tile_sa=tile, kernels=self.kernels)
                if tile:
                    traj_emb = torch.cat([traj_emb, traj_emb], dim=0)
                    if trj_dist is not None:
                        trj_dist = torch.cat([trj_dist, trj_dist], dim=0)

        return _lin(self.final_layer, h).float()
