"""The decoder layer's cross-attention block in training: K4 of the port.

Counterpart of `tcdiff_tpu/ops/fused_ca_block_train.py::fused_ca_block_train`
(forward and backward):

    r  = rotary_x(LN(x; eps1))      rm = rotary_m(mem)
    q  = r.Wq   k = rm.Wk   v = mem.Wv                    (bias-free)
    o  = per head drop_ATTN(softmax(q.k^T/sqrt(dk))) . v  (L x Lm)
    out = x + (fs+1) * drop_OUT(LN(drop_FC(o.Wfc); eps2)) + fb

The attention and the chain top are K3's (`ops/sa_block_train.py`); the
backward also returns the memory cotangent, through which the cond
encoder trains. x (b, L, d), mem (b, Lm, d); angles_x (L, d) and angles_m
(Lm, d) rotary angle tables; weights in nn.Linear layout; s2/b2 the
layer's norm2 affine, sa_s/sa_b the block's inner LayerNorm (eps2).

`ca_block_train` runs the CUDA kernels of `csrc/ca_block_train.cu` for a
CUDA x, forward and backward, and `ca_block_train_plain`, differentiated
by autograd, for a CPU x; with a tensor-parallel `mesh` the plain version
runs over this rank's heads (see `ops/train_common.py`).
"""

from __future__ import annotations

import torch

from tcdiff_torch.ops._common import args_struct, as_t, check_cuda, launch, ln_f32, mm_f32
from tcdiff_torch.ops.sa_block import cached_rotary_tables, rotary_tables
from tcdiff_torch.ops.sa_block_train import attention_plain, chain_top_plain, rot
from tcdiff_torch.ops.train_common import (
    RCH, as_uint32_int32, count_kernel, local_heads, mm_whole, save_tensors, saved_tensors, threshold,
    weight_scratch,
)
from tcdiff_torch.utils.profiling import traced


def ca_block_train_plain(x, mem, s2, b2, angles_x, angles_m, wq, wk, wv, wfc, sa_s, sa_b,
                         film_scale, film_shift, seeds, *, nhead: int, rate: float,
                         eps1: float = 1e-5, eps2: float = 1e-6, mesh=None):
    """Plain PyTorch version of the block; the oracle of the kernels. With
    a tp `mesh`, over this rank's heads (as `sa_block_train_plain`; the
    memory enters whole too)."""
    dt = x.dtype
    cosx, ssinx = rotary_tables(angles_x, dt)
    cosm, ssinm = rotary_tables(angles_m, dt)
    r = rot(ln_f32(x, s2, b2, eps1), cosx, ssinx).to(dt)
    rm = rot(mem.float(), cosm, ssinm).to(dt)
    q, k, v = mm_whole(r, wq, mesh).to(dt), mm_whole(rm, wk, mesh).to(dt), mm_whole(mem.to(dt), wv, mesh).to(dt)
    nh, head0 = local_heads(nhead, mesh)
    o = attention_plain(q, k, v, seeds, nh, rate, head0)
    return chain_top_plain(o, x, wfc, sa_s, sa_b, film_scale, film_shift, seeds, rate, eps2, mesh)


# ------------------------------------------------------------------ CUDA path
_Args = args_struct(  # CaTrainArgs in csrc/ca_block_train.cu
    "CaTrainArgs",
    ("x", "mem", "cosx", "ssinx", "cosm", "ssinm", "wq", "wk", "wv", "wfc",
     "sx", "bx", "ss", "sb", "fs", "fb", "seeds",
     "r", "rm", "q", "k", "v", "o", "lse", "z", "out",
     "g", "dz", "dO", "dq", "dk", "dv", "dx", "dmem", "dwq", "dwkv", "dwfc",
     "dr", "drm", "dvm", "part", "wpart", "Dsum", "vec"),
    ("B", "L", "Lm", "d", "hd", "nhead", "wcap", "drop_on"),
    ("eps1", "eps2", "dscale"),
    ("thresh",),
)
N_VEC = 6  # reduced vectors: dfs, dfb (per batch element), dss, dsb, ds2, db2


class _CaBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mem, s2, b2, angles_x, angles_m, wq, wk, wv, wfc, sa_s, sa_b, fs, fb, seeds,
                nhead, rate, eps1, eps2):
        check_cuda(x, mem=mem, s2=s2, b2=b2, angles_x=angles_x, angles_m=angles_m, wq=wq, wk=wk,
                   wv=wv, wfc=wfc, sa_s=sa_s, sa_b=sa_b, film_scale=fs, film_shift=fb, seeds=seeds)
        B, L, d = x.shape
        Lm = mem.shape[1]
        hd = wq.shape[0]
        dk = hd // nhead
        if d % 2 or d > 1024 or hd % nhead or dk > 64 or dk % 8:
            raise ValueError(f"unsupported widths d={d}, h*dk={hd}, nhead={nhead}")
        for name, t, shape in (("mem", mem, (B, Lm, d)), ("wq", wq, (hd, d)), ("wk", wk, (hd, d)),
                               ("wv", wv, (hd, d)), ("wfc", wfc, (d, hd)),
                               ("angles_x", angles_x, (L, d)), ("angles_m", angles_m, (Lm, d)),
                               ("film_scale", fs, (B, d)), ("film_shift", fb, (B, d)), ("seeds", seeds, (B,))):
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        dt, dev = x.dtype, x.device
        f32 = lambda t: as_t(t, torch.float32)
        cosx, ssinx = cached_rotary_tables(angles_x, dt)
        cosm, ssinm = cached_rotary_tables(angles_m, dt)
        ten = dict(
            x=x, mem=as_t(mem, dt), cosx=cosx, ssinx=ssinx, cosm=cosm, ssinm=ssinm,
            wq=as_t(wq, dt), wk=as_t(wk, dt), wv=as_t(wv, dt), wfc=as_t(wfc, dt),
            sx=f32(s2), bx=f32(b2), ss=f32(sa_s), sb=f32(sa_b), fs=f32(fs), fb=f32(fb),
            seeds=as_uint32_int32(seeds),
        )
        e = lambda *shape, t=dt: torch.empty(shape, dtype=t, device=dev)
        ten.update(r=e(B, L, d), rm=e(B, Lm, d), q=e(B, L, hd), k=e(B, Lm, hd), v=e(B, Lm, hd),
                   o=e(B, L, hd), lse=e(B, nhead, L, t=torch.float32), z=e(B, L, d, t=torch.float32),
                   out=torch.empty_like(x))
        wcap = weight_scratch((B * L, d, hd), (B * L, hd, d), (B * Lm, hd, d, 2))  # dWfc, dWq; dWk with dWv
        dims = dict(B=B, L=L, Lm=Lm, d=d, hd=hd, nhead=nhead, wcap=wcap,
                    drop_on=int(rate > 0), eps1=eps1, eps2=eps2, dscale=1.0 / (1.0 - rate),
                    thresh=threshold(rate))
        launch("ca_block_train", "tcd_ca_train_fwd", _Args, ten, dims, x, "ca_block_train")
        ca_block_train.launches += 1
        save_tensors(ctx, ten)
        ctx.dims = dims
        ctx.in_dtypes = tuple(t.dtype for t in (mem, s2, b2, wq, wk, wv, wfc, sa_s, sa_b, fs, fb))
        return ten["out"]

    @staticmethod
    def backward(ctx, g):
        ten, dims = saved_tensors(ctx), ctx.dims
        B, L, Lm, d, hd = dims["B"], dims["L"], dims["Lm"], dims["d"], dims["hd"]
        x = ten["x"]
        dt, dev = x.dtype, x.device
        e = lambda *shape, t=dt: torch.empty(shape, dtype=t, device=dev)
        nch = -(-L // RCH)
        ten.update(
            g=as_t(g, dt), dz=e(B, L, d), dO=e(B, L, hd), dq=e(B, L, hd), dk=e(B, Lm, hd),
            dv=e(B, Lm, hd), dx=torch.empty_like(x), dmem=e(B, Lm, d),
            dwq=e(hd, d), dwkv=e(2, hd, d), dwfc=e(d, hd),
            dr=e(B, L, d, t=torch.float32), part=e(N_VEC, B * nch, d, t=torch.float32),
            wpart=e(dims["wcap"], t=torch.float32), Dsum=e(B, dims["nhead"], L, t=torch.float32),
            vec=e(N_VEC, B, d, t=torch.float32),
        )
        if dt == torch.float32:  # the unfused memory side's products (bf16: one launch, no scratch)
            ten.update(drm=e(B, Lm, d), dvm=e(B, Lm, d))
        launch("ca_block_train", "tcd_ca_train_bwd", _Args, ten, dims, x, "ca_block_train backward")
        ca_block_train.bwd_launches += 1
        vec = ten["vec"]
        tmem, ts2, tb2, twq, twk, twv, twfc, tss, tsb, tfs, tfb = ctx.in_dtypes
        return (ten["dx"], ten["dmem"].to(tmem), vec[4, 0].to(ts2), vec[5, 0].to(tb2), None, None,
                ten["dwq"].to(twq), ten["dwkv"][0].to(twk), ten["dwkv"][1].to(twv), ten["dwfc"].to(twfc),
                vec[2, 0].to(tss), vec[3, 0].to(tsb), vec[0].to(tfs), vec[1].to(tfb),
                None, None, None, None, None)


@traced("k4.ca_block_train", backward=True)
def ca_block_train(x, mem, s2, b2, angles_x, angles_m, wq, wk, wv, wfc, sa_s, sa_b,
                   film_scale, film_shift, seeds, *, nhead: int, rate: float,
                   eps1: float = 1e-5, eps2: float = 1e-6):
    """The train cross-attention block: CUDA kernels (forward and backward)
    for a CUDA x, the plain version for a CPU x. See the module docstring."""
    args = (x, mem, s2, b2, angles_x, angles_m, wq, wk, wv, wfc, sa_s, sa_b, film_scale, film_shift, seeds)
    if x.device.type == "cpu":
        return ca_block_train_plain(*args, nhead=nhead, rate=rate, eps1=eps1, eps2=eps2)
    if x.device.type != "cuda":
        raise ValueError(f"ca_block_train runs on CPU or CUDA tensors, got {x.device}")
    return _CaBlockTrain.apply(*args, nhead, rate, eps1, eps2)


count_kernel(ca_block_train)
