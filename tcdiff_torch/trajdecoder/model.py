"""TrajDecoder: the Dance-Beat Navigator (DBN) trajectory network.

The port of `tcdiff_tpu/trajdecoder/model.py:32-189`, which rebuilds the
reference's `TrajDecoder/model/traj_model.py:11-200`: a 3-layer LSTM over
the flattened (dancer-major) XY tokens, a music MLP (2-frame packed
876 -> 438 -> 438 -> 64), a transformer over the concatenated
[music, traj] 128-d features, and a 4-layer MLP decoder. Parameter names
are the reference's, so its `{'net': state_dict}` checkpoints load.

Reference quirks, kept deliberately:
  * The reference's LSTM is built WITHOUT batch_first (`traj_model.py:139`)
    yet fed (batch, tokens, 2), so its recurrence runs over the BATCH axis,
    vectorised over the tokens. `_lstm` writes that recurrence out (a loop
    over axis 0) with `nn.LSTM`'s parameters: at b = 1 it has one step, at
    b > 1 it really recurs.
  * The attention registers a causal mask but never applies it
    (`traj_model.py:26,37-39`): attention is full.
  * `trans_extractor.traj_emb` is a dead parameter (`traj_model.py:80`),
    kept for checkpoint compatibility.
  * Sinusoidal positions go on the trajectory features only
    (`traj_model.py:106`, `model/utils.py:11-32`).
  * The odd music frame is dropped and two frames are packed into one
    876-channel row; the condition tokens come from the first `seq` packed
    rows and the decoder's music context from the last `seq`, each tiled
    over the dancers.
  * Exact GELU, leaky ReLU (slope 0.01).

The network computes in float32 whatever the caller's TF32 flags: its
rollout feeds its output back ~20 times, so rounding compounds. `forward`
turns TF32 off for its own duration where a caller turned it on.

`forward` is the serving path: no gradient, no dropout. `forward_train`
is the trainer's: gradients, and the JAX model's dropout at its
1 + 3 x trans_layer sites (the trajectory features after the positional
encoding, `tcdiff_tpu/trajdecoder/model.py:167`; in each block the
attention probabilities, the projection's output and the MLP's output,
`:117,121,128`), its masks drawn from the caller's generator.

No Pallas kernel of the JAX package runs here; the network is ordinary
PyTorch on whatever device holds its parameters.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tcdiff_torch.config import TrajDecoderConfig
from tcdiff_torch.models.dance_decoder import _identity, dropout_fn
from tcdiff_torch.parallel.comm import all_gather_rows
from tcdiff_torch.parallel.mesh import Mesh, Rows


def positional_encoding(length: int, dim: int) -> np.ndarray:
    """The reference's `model/utils.py:18-22` table, truncated to length."""
    position = np.arange(length)[:, None]
    div_term = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    pe = np.zeros((length, dim), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


@contextlib.contextmanager
def f32_math():
    """TF32 off (cuBLAS and cuDNN) for the duration, where it was on; the
    caller's flags are restored afterwards."""
    cuda_mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    was = (cuda_mm.allow_tf32, cudnn.allow_tf32)
    if not any(was):
        yield
        return
    cuda_mm.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda_mm.allow_tf32, cudnn.allow_tf32 = was


def _lstm(lstm: nn.LSTM, xs: torch.Tensor) -> torch.Tensor:
    """xs (T, N, C): the recurrence over axis 0, vectorised over axis 1,
    with the gate order and biases of nn.LSTM ([i, f, g, o]). (T, N, H)."""
    h = xs
    hidden = lstm.hidden_size
    for layer in range(lstm.num_layers):
        wi, wh = getattr(lstm, f"weight_ih_l{layer}"), getattr(lstm, f"weight_hh_l{layer}")
        bi, bh = getattr(lstm, f"bias_ih_l{layer}"), getattr(lstm, f"bias_hh_l{layer}")
        hprev = cprev = torch.zeros(h.shape[1], hidden, dtype=h.dtype, device=h.device)
        outs = []
        for xt in h:
            gates = F.linear(xt, wi, bi) + F.linear(hprev, wh, bh)
            i, f, g, o = gates.chunk(4, dim=-1)
            cprev = torch.sigmoid(f) * cprev + torch.sigmoid(i) * torch.tanh(g)
            hprev = torch.sigmoid(o) * torch.tanh(cprev)
            outs.append(hprev)
        h = torch.stack(outs)
    return h


class CrossCondAttention(nn.Module):
    """Full multi-head self-attention (the reference's causal mask is never
    applied)."""

    def __init__(self, dim: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query, self.key, self.value = nn.Linear(dim, dim), nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, drop=_identity) -> torch.Tensor:
        b, t, c = x.shape
        heads = lambda y: y.reshape(b, t, self.n_head, c // self.n_head).transpose(1, 2)
        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        att = drop(torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(c // self.n_head), dim=-1))
        return self.proj((att @ v).transpose(1, 2).reshape(b, t, c))


class Block(nn.Module):
    """Pre-LN transformer block (`traj_model.py:48-65`)."""

    def __init__(self, dim: int, n_head: int, fc_rate: int = 4):
        super().__init__()
        self.ln1, self.ln2 = nn.LayerNorm(dim), nn.LayerNorm(dim)
        self.attn = CrossCondAttention(dim, n_head)
        self.mlp = nn.Sequential(nn.Linear(dim, fc_rate * dim), nn.GELU(), nn.Linear(fc_rate * dim, dim))

    def forward(self, x: torch.Tensor, drop=_identity) -> torch.Tensor:
        x = x + drop(self.attn(self.ln1(x), drop))
        return x + drop(self.mlp(self.ln2(x)))


class Music2TrajTransformer(nn.Module):
    """The reference's `music2traj_Transformer`: the condition embedding,
    the dead `traj_emb` and the blocks over [music ‖ traj]."""

    def __init__(self, cfg: TrajDecoderConfig):
        super().__init__()
        d = cfg.latent_dim
        self.cond_emb = nn.Linear(d, d)
        self.traj_emb = nn.Linear(3, d)  # dead (`traj_model.py:80`)
        self.blocks = nn.ModuleList([Block(2 * d, cfg.n_head) for _ in range(cfg.trans_layer)])


class TrajDecoder(nn.Module):
    """forward(x, music_feat):
      x: (b, dn, seq, 2) XY windows; music_feat: (b, 2*(seq+step), 438).
    Returns (b, dn, seq, 2) float32: the window shifted `step` frames on.
    `forward` evaluates (no dropout, no gradient); `forward_train` trains."""

    def __init__(self, cfg: TrajDecoderConfig = TrajDecoderConfig(), device="cuda"):
        super().__init__()
        self.cfg = cfg
        d, cf = cfg.latent_dim, cfg.cond_feature_dim
        self.lstm = nn.LSTM(cfg.nfeats, d, 3)
        self.music_projection = nn.Sequential(
            nn.Linear(cf * 2, cf), nn.LeakyReLU(), nn.Linear(cf, cf), nn.LeakyReLU(), nn.Linear(cf, d),
        )
        self.trans_extractor = Music2TrajTransformer(cfg)
        self.Decoder = nn.Sequential(
            nn.Linear(3 * d, 2 * d), nn.LeakyReLU(), nn.Linear(2 * d, 2 * d), nn.LeakyReLU(),
            nn.Linear(2 * d, d), nn.LeakyReLU(), nn.Linear(d, cfg.nfeats),
        )
        self._pe: dict = {}
        self.to(device)  # raises where the device does not exist: no quiet CPU fallback

    @property
    def device(self) -> torch.device:
        return self.Decoder[0].weight.device

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "TrajDecoder":
        """Random weights from `generator`: Linear weights N(0, 1/fan_in),
        biases 0, LayerNorms (1, 0), the LSTM's weights U(-1/sqrt(H),
        1/sqrt(H)) and its biases 0."""
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) / math.sqrt(m.weight.shape[1]))
                m.bias.zero_()
        bound = 1.0 / math.sqrt(self.lstm.hidden_size)
        for name, p in self.lstm.named_parameters():
            if name.startswith("weight"):
                p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
            else:
                p.zero_()
        return self

    def _pos(self, length: int) -> torch.Tensor:
        key = (length, self.device)
        if key not in self._pe:
            self._pe[key] = torch.from_numpy(positional_encoding(length, self.cfg.latent_dim)).to(self.device)
        return self._pe[key]

    @torch.no_grad()
    def forward(self, x: torch.Tensor, music_feat: torch.Tensor) -> torch.Tensor:
        with f32_math():
            return self._forward(x.float(), music_feat.float())

    def forward_train(self, x: torch.Tensor, music_feat: torch.Tensor,
                      generator: Optional[torch.Generator] = None, mesh: Optional[Mesh] = None) -> torch.Tensor:
        """The forward with gradients and the config's dropout, its masks
        drawn from `generator` (needed where the rate is above 0; at rate 0
        the dropout is the identity), in the parameters' dtype. The caller
        runs the backward under `f32_math()` too where its TF32 flags are
        on.

        With a data-parallel `mesh`, x and music_feat are this rank's rows
        of the global batch: the dropout masks are drawn at the global
        batch and these rows kept, and since the LSTM recurs over the batch
        axis, its input is gathered from every rank and the recurrence run
        over the whole global batch (these rows' outputs kept), so that the
        function is the single process's."""
        rows = None if mesh is None else mesh.rows(x.shape[0] * mesh.world)
        drop = dropout_fn(self.cfg.dropout, generator, rows)
        dt = self.Decoder[0].weight.dtype  # float32, unless the caller converted the network
        with f32_math():
            return self._forward(x.to(dt), music_feat.to(dt), drop, mesh, rows)

    def _forward(self, x: torch.Tensor, m: torch.Tensor, drop=_identity, mesh: Optional[Mesh] = None,
                 rows: Optional[Rows] = None) -> torch.Tensor:
        cfg = self.cfg
        b, dn, seq, c = x.shape
        tokens = x.reshape(b, dn * seq, c)
        if rows is None:
            h = _lstm(self.lstm, tokens)  # recurrence over the batch axis
        else:
            h = rows.take(_lstm(self.lstm, all_gather_rows(tokens, mesh)))

        if m.shape[1] % 2 == 1:
            m = m[:, :-1]
        m = self.music_projection(m.reshape(b, m.shape[1] // 2, cfg.cond_feature_dim * 2))

        traj_feat = drop(h + self._pos(dn * seq)[None])
        cond_tok = self.trans_extractor.cond_emb(m[:, :seq]).repeat(1, dn, 1)
        feat = torch.cat([cond_tok, traj_feat], dim=2)
        for block in self.trans_extractor.blocks:
            feat = block(feat, drop)

        feat = torch.cat([feat, m[:, -seq:].repeat(1, dn, 1)], dim=2)  # (b, dn*seq, 3d)
        return self.Decoder(feat).reshape(b, dn, seq, c)
