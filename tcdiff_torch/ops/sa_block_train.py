"""The decoder layer's self-attention block in training: K3 of the port.

Counterpart of `tcdiff_tpu/ops/fused_sa_block_train.py::fused_sa_block_train`
(forward and backward):

    y  = LN(x; eps1)          r = rotary(y) on the full model vector
    q  = r.Wq   k = r.Wk   v = y.Wv                       (bias-free)
    o  = per head drop_ATTN(softmax(q.k^T/sqrt(dk))) . v
    sa = drop_OUT(LN(drop_FC(o.Wfc); eps2))
    out = x + (fs+1) * sa + fb                            (FiLM residual)

with the hash dropout of `ops/train_common.py` at the three sites, one seed
per batch element. Weights are in nn.Linear layout (out, in): wq/wk/wv
(h*dk, d), wfc (d, h*dk); angles the (L, d) rotary angle table; film rows
(b, d); seeds int64 (b,). Numerics follow the TPU kernel: LN statistics,
softmax and product sums in f32; q/k/v, the dropped probabilities and o
rounded to the compute dtype (x.dtype).

`sa_block_train` runs the CUDA kernels of `csrc/sa_block_train.cu` for a
CUDA x, forward and backward (a `torch.autograd.Function`), and
`sa_block_train_plain`, differentiated by autograd, for a CPU x; with a
tensor-parallel `mesh` the plain version runs over this rank's heads (see
`ops/train_common.py`).
"""

from __future__ import annotations

import torch

from tcdiff_torch.models.rotary import swap_pairs
from tcdiff_torch.ops._common import args_struct, as_t, check_cuda, launch, ln_f32, mm_f32
from tcdiff_torch.ops.sa_block import cached_rotary_tables, rotary_tables
from tcdiff_torch.ops.train_common import (
    RCH, SALT_ATTN, as_uint32_int32, chain_top_fwd_plain, count_kernel, drop, local_heads, mm_whole,
    save_tensors, saved_tensors, threshold, weight_scratch,
)
from tcdiff_torch.parallel.comm import tp_reduce
from tcdiff_torch.utils.profiling import traced


def rot(y: torch.Tensor, cos: torch.Tensor, ssin: torch.Tensor) -> torch.Tensor:
    """f32 rotary on the full vector with the (cos, signed sin) tables."""
    return y * cos.float() + swap_pairs(y) * ssin.float()


def attention_plain(q, k, v, seeds, nhead: int, rate: float, head0: int = 0):
    """Per-head softmax attention with dropout on the f32 probabilities:
    q (b, Lq, h*dk), k/v (b, Lk, h*dk) in the compute dtype. `head0`: the
    global index of the first of these heads (a tensor-parallel rank's),
    whose dropout salts are SALT_ATTN + its global head."""
    dt = q.dtype
    b, lq, hd = q.shape
    dk = hd // nhead
    heads = lambda t: t.reshape(b, t.shape[1], nhead, dk).transpose(1, 2)
    qs = heads(q) * torch.tensor(1.0 / dk**0.5, dtype=dt)  # scaled in the compute dtype
    p = torch.softmax(torch.matmul(qs.float(), heads(k).float().transpose(-1, -2)), dim=-1)
    salts = SALT_ATTN + head0 + torch.arange(nhead, dtype=torch.int64)
    pd = drop(p, seeds, salts, rate).to(dt)
    o = torch.matmul(pd.float(), heads(v).float()).to(dt)
    return o.transpose(1, 2).reshape(b, lq, hd)


def chain_top_plain(o, x, wfc, s2, b2, film_scale, film_shift, seeds, rate: float, eps2: float, mesh=None):
    """out projection (its f32 partial sums reduced over a tp `mesh`) ->
    drop_FC -> LN(eps2) -> drop_OUT -> FiLM residual."""
    z = tp_reduce(mm_f32(o, wfc), mesh)
    return chain_top_fwd_plain(z, x, s2, b2, film_scale, film_shift, seeds, rate=rate, eps=eps2)


def sa_block_train_plain(x, s1, b1, angles, wq, wk, wv, wfc, s2, b2, film_scale, film_shift, seeds,
                         *, nhead: int, rate: float, eps1: float = 1e-5, eps2: float = 1e-6, mesh=None):
    """Plain PyTorch version of the block; the oracle of the kernels. With
    a tp `mesh`, wq/wk/wv/wfc are this rank's shards of the weights of
    `nhead` heads, and the block runs over its heads."""
    dt = x.dtype
    cos, ssin = rotary_tables(angles, dt)
    y = ln_f32(x, s1, b1, eps1)
    rc, yc = rot(y, cos, ssin).to(dt), y.to(dt)
    q, k, v = mm_whole(rc, wq, mesh).to(dt), mm_whole(rc, wk, mesh).to(dt), mm_whole(yc, wv, mesh).to(dt)
    nh, head0 = local_heads(nhead, mesh)
    o = attention_plain(q, k, v, seeds, nh, rate, head0)
    return chain_top_plain(o, x, wfc, s2, b2, film_scale, film_shift, seeds, rate, eps2, mesh)


# ------------------------------------------------------------------ CUDA path
_Args = args_struct(  # SaTrainArgs in csrc/sa_block_train.cu
    "SaTrainArgs",
    ("x", "cos_t", "ssin_t", "wq", "wk", "wv", "wfc", "s1", "b1", "s2", "b2", "fs", "fb", "seeds",
     "y", "r", "q", "k", "v", "o", "lse", "z", "out",
     "g", "dz", "dO", "dq", "dk", "dv", "dx", "dwq", "dwk", "dwv", "dwfc",
     "dr", "dyv", "part", "wpart", "Dsum", "vec"),
    ("B", "L", "d", "hd", "nhead", "wcap", "drop_on"),
    ("eps1", "eps2", "dscale"),
    ("thresh",),
)
N_VEC = 6  # reduced vectors: dfs, dfb (per batch element), ds2, db2, ds1, db1


class _SaBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s1, b1, angles, wq, wk, wv, wfc, s2, b2, fs, fb, seeds, nhead, rate, eps1, eps2):
        check_cuda(x, s1=s1, b1=b1, angles=angles, wq=wq, wk=wk, wv=wv, wfc=wfc, s2=s2, b2=b2,
                   film_scale=fs, film_shift=fb, seeds=seeds)
        B, L, d = x.shape
        hd = wq.shape[0]
        dk = hd // nhead
        if d % 2 or d > 1024 or hd % nhead or dk > 64 or dk % 8:
            raise ValueError(f"unsupported widths d={d}, h*dk={hd}, nhead={nhead}")
        for name, t, shape in (("wq", wq, (hd, d)), ("wk", wk, (hd, d)), ("wv", wv, (hd, d)),
                               ("wfc", wfc, (d, hd)), ("angles", angles, (L, d)),
                               ("film_scale", fs, (B, d)), ("film_shift", fb, (B, d)), ("seeds", seeds, (B,))):
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        dt, dev = x.dtype, x.device
        f32 = lambda t: as_t(t, torch.float32)
        cos, ssin = cached_rotary_tables(angles, dt)
        ten = dict(
            x=x, cos_t=cos, ssin_t=ssin,
            wq=as_t(wq, dt), wk=as_t(wk, dt), wv=as_t(wv, dt), wfc=as_t(wfc, dt),
            s1=f32(s1), b1=f32(b1), s2=f32(s2), b2=f32(b2), fs=f32(fs), fb=f32(fb),
            seeds=as_uint32_int32(seeds),
        )
        e = lambda *shape, t=dt: torch.empty(shape, dtype=t, device=dev)
        ten.update(y=e(B, L, d), r=e(B, L, d), q=e(B, L, hd), k=e(B, L, hd), v=e(B, L, hd),
                   o=e(B, L, hd), lse=e(B, nhead, L, t=torch.float32), z=e(B, L, d, t=torch.float32),
                   out=torch.empty_like(x))
        wcap = weight_scratch((B * L, d, hd), (B * L, hd, d))  # dWfc; dWq, dWk, dWv
        dims = dict(B=B, L=L, d=d, hd=hd, nhead=nhead, wcap=wcap, drop_on=int(rate > 0),
                    eps1=eps1, eps2=eps2, dscale=1.0 / (1.0 - rate), thresh=threshold(rate))
        launch("sa_block_train", "tcd_sa_train_fwd", _Args, ten, dims, x, "sa_block_train")
        sa_block_train.launches += 1
        save_tensors(ctx, ten)
        ctx.dims, ctx.in_dtypes = dims, (s1.dtype, b1.dtype, wq.dtype, wk.dtype, wv.dtype,
                                         wfc.dtype, s2.dtype, b2.dtype, fs.dtype, fb.dtype)
        return ten["out"]

    @staticmethod
    def backward(ctx, g):
        ten, dims = saved_tensors(ctx), ctx.dims
        B, L, d, hd = dims["B"], dims["L"], dims["d"], dims["hd"]
        x = ten["x"]
        dt, dev = x.dtype, x.device
        e = lambda *shape, t=dt: torch.empty(shape, dtype=t, device=dev)
        nch = -(-L // RCH)
        ten.update(
            g=g.to(dt).contiguous(), dz=e(B, L, d), dO=e(B, L, hd), dq=e(B, L, hd), dk=e(B, L, hd),
            dv=e(B, L, hd), dx=torch.empty_like(x), dwq=e(hd, d), dwk=e(hd, d), dwv=e(hd, d),
            dwfc=e(d, hd), dr=e(B, L, d, t=torch.float32), dyv=e(B, L, d, t=torch.float32),
            part=e(N_VEC, B * nch, d, t=torch.float32),
            wpart=e(dims["wcap"], t=torch.float32),
            Dsum=e(B, dims["nhead"], L, t=torch.float32),
            vec=e(N_VEC, B, d, t=torch.float32),
        )
        launch("sa_block_train", "tcd_sa_train_bwd", _Args, ten, dims, x, "sa_block_train backward")
        sa_block_train.bwd_launches += 1
        vec = ten["vec"]
        ts1, tb1, twq, twk, twv, twfc, ts2, tb2, tfs, tfb = ctx.in_dtypes
        dfs, dfb = vec[0], vec[1]
        ds2, db2, ds1, db1 = vec[2, 0], vec[3, 0], vec[4, 0], vec[5, 0]
        return (ten["dx"], ds1.to(ts1), db1.to(tb1), None,
                ten["dwq"].to(twq), ten["dwk"].to(twk), ten["dwv"].to(twv), ten["dwfc"].to(twfc),
                ds2.to(ts2), db2.to(tb2), dfs.to(tfs), dfb.to(tfb),
                None, None, None, None, None)


@traced("k3.sa_block_train", backward=True)
def sa_block_train(x, s1, b1, angles, wq, wk, wv, wfc, s2, b2, film_scale, film_shift, seeds,
                   *, nhead: int, rate: float, eps1: float = 1e-5, eps2: float = 1e-6):
    """The train self-attention block: CUDA kernels (forward and backward)
    for a CUDA x, the plain version for a CPU x. See the module docstring."""
    args = (x, s1, b1, angles, wq, wk, wv, wfc, s2, b2, film_scale, film_shift, seeds)
    if x.device.type == "cpu":
        return sa_block_train_plain(*args, nhead=nhead, rate=rate, eps1=eps1, eps2=eps2)
    if x.device.type != "cuda":
        raise ValueError(f"sa_block_train runs on CPU or CUDA tensors, got {x.device}")
    return _SaBlockTrain.apply(*args, nhead, rate, eps1, eps2)


count_kernel(sa_block_train)


# ------------------------------------------------------ the attention alone
_AttnArgs = args_struct(  # AttnTrainArgs in csrc/sa_block_train.cu
    "AttnTrainArgs",
    ("q", "k", "v", "seeds", "o", "dO", "dq", "dk", "dv", "lse", "Dsum"),
    ("B", "Lq", "Lk", "hd", "nhead", "drop_on"),
    ("dscale",),
    ("thresh",),
)


def _attention_fwd(q, k, v, seeds, nhead: int, rate: float):
    """The train attention's forward launch: its tensors (o and the lse
    among them) and dimensions."""
    check_cuda(q, k=k, v=v, seeds=seeds)
    b, lq, hd = q.shape
    lk = k.shape[1]
    if hd % nhead or hd // nhead > 64 or (hd // nhead) % 8:
        raise ValueError(f"unsupported widths h*dk={hd}, nhead={nhead}")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, lk, hd) or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}; expected {q.dtype} {(b, lk, hd)}")
    if tuple(seeds.shape) != (b,):
        raise ValueError(f"seeds has shape {tuple(seeds.shape)}, expected {(b,)}")
    ten = dict(q=q, k=k.contiguous(), v=v.contiguous(), seeds=as_uint32_int32(seeds), o=torch.empty_like(q),
               lse=torch.empty((b, nhead, lq), dtype=torch.float32, device=q.device))
    dims = dict(B=b, Lq=lq, Lk=lk, hd=hd, nhead=nhead, drop_on=int(rate > 0), dscale=1.0 / (1.0 - rate),
                thresh=threshold(rate))
    launch("sa_block_train", "tcd_attn_train_fwd", _AttnArgs, ten, dims, q, "attention_train")
    attention_train.launches += 1
    return ten, dims


class _AttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seeds, nhead, rate):
        ten, dims = _attention_fwd(q, k, v, seeds, nhead, rate)
        save_tensors(ctx, ten)
        ctx.dims = dims
        return ten["o"]

    @staticmethod
    def backward(ctx, do):
        ten, dims = saved_tensors(ctx), ctx.dims
        q, k = ten["q"], ten["k"]
        ten.update(dO=do.to(q.dtype).contiguous(), dq=torch.empty_like(q), dk=torch.empty_like(k),
                   dv=torch.empty_like(k),
                   Dsum=torch.empty((dims["B"], dims["nhead"], dims["Lq"]), dtype=torch.float32, device=q.device))
        launch("sa_block_train", "tcd_attn_train_bwd", _AttnArgs, ten, dims, q, "attention_train backward")
        attention_train.bwd_launches += 1
        return ten["dq"], ten["dk"], ten["dv"], None, None, None


def attention_train(q, k, v, seeds, *, nhead: int, rate: float):
    """The train blocks' attention alone (the kernels K3 and K4 launch
    inside their sequences), forward and backward: q (b, Lq, h*dk), k/v
    (b, Lk, h*dk), seeds int64 (b,). CUDA kernels for CUDA tensors,
    `attention_plain` (differentiated by autograd) for CPU tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, seeds, nhead, rate)
    if q.device.type != "cuda":
        raise ValueError(f"attention_train runs on CPU or CUDA tensors, got {q.device}")
    return _AttentionTrain.apply(q, k, v, seeds, nhead, rate)


def attention_train_fwd(q, k, v, seeds, *, nhead: int, rate: float):
    """The train attention's forward alone on CUDA tensors, as
    attention_train runs it: (o, lse), lse (b, h, Lq) in f32 (each row's
    log softmax normaliser, which the backward recomputes from). For tests
    and measurement."""
    ten, _ = _attention_fwd(q, k, v, seeds, nhead, rate)
    return ten["o"], ten["lse"]


count_kernel(attention_train)
