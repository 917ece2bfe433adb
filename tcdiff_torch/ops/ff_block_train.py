"""The decoder layer's feed-forward block and tail in training: K5 of the port.

Counterpart of `tcdiff_tpu/ops/fused_ff_block_train.py::fused_ff_tail_train`
(forward and backward):

    u   = LN3(x).W1^T + b1
    z   = drop_FF1(gelu_erf(u)).W2^T + b2
    x2  = x + (fs+1) * drop_FF2(z) + fb                     (f32)
    out = LN4(x2).W3^T + b3

with the hash dropout of `ops/train_common.py` at the two sites. Weights in
nn.Linear layout: w1 (ff, d), w2 (d, ff), w3 (d, d); biases and LN affines
f32; film rows (b, d); seeds int64 (b,). The LN3 output, the dropped GELU
output and the LN4 output are rounded to the compute dtype (x.dtype), as
the TPU kernel rounds them.

`ff_tail_train` runs the CUDA kernels of `csrc/ff_tail_train.cu` for a
CUDA x, forward and backward, and `ff_tail_train_plain`, differentiated by
autograd, for a CPU x; with a tensor-parallel `mesh` the plain version runs
over this rank's feed-forward columns (see `ops/train_common.py`).
"""

from __future__ import annotations

import torch

from tcdiff_torch.ops._common import args_struct, as_t, check_cuda, launch, ln_f32, mm_f32
from tcdiff_torch.ops.train_common import (
    FF_RCH, SALT_FF1, SALT_FF2, as_uint32_int32, count_kernel, drop, film_residual, local_bias, mm_whole,
    save_tensors, saved_tensors, threshold, tp_split, weight_scratch,
)
from tcdiff_torch.parallel.comm import tp_gather, tp_reduce
from tcdiff_torch.utils.profiling import traced


def ff_tail_train_plain(x, s3, b3, w1, bb1, w2, bb2, film_scale, film_shift, s4, b4, w3, bb3, seeds,
                        *, rate: float, eps: float = 1e-5, mesh=None):
    """Plain PyTorch version of the block; the oracle of the kernels. With
    a tp `mesh`, w1/w2/w3 are this rank's shards (w1 and w3 split on the
    output, w2 on the input) and the block runs over its feed-forward
    columns, its FF1 dropout drawn at their global indices; linear3's
    columns are gathered."""
    dt = x.dtype
    tp, j = tp_split(mesh)
    n = w1.shape[0]
    y = ln_f32(x, s3, b3, eps).to(dt)
    u = mm_whole(y, w1, mesh) + local_bias(bb1, n, mesh).float()
    ad = drop(torch.nn.functional.gelu(u, approximate="none"), seeds, SALT_FF1, rate, col0=j * n,
              ncols=n * tp).to(dt)
    zd = drop(tp_reduce(mm_f32(ad, w2), mesh) + bb2.float(), seeds, SALT_FF2, rate)
    x2 = film_residual(x, zd, film_scale, film_shift)
    y4 = ln_f32(x2, s4, b4, eps).to(dt)
    return tp_gather((mm_whole(y4, w3, mesh) + local_bias(bb3, w3.shape[0], mesh).float()).to(dt), mesh)


# ------------------------------------------------------------------ CUDA path
_Args = args_struct(  # FfTrainArgs in csrc/ff_tail_train.cu
    "FfTrainArgs",
    ("x", "s3", "b3", "w1", "bb1", "w2", "bb2", "fs", "fb", "s4", "b4", "w3", "bb3", "seeds",
     "y", "u", "ad", "zd", "x2", "y4", "out",
     "g", "dy4", "dx2", "dz", "dad", "du", "dy", "dx", "dw1", "dw2", "dw3",
     "part", "part_ff", "wpart", "vec", "vec_ff"),
    ("B", "L", "d", "ff", "wcap", "drop_on"),
    ("eps", "dscale"),
    ("thresh",),
)
# reduced (d,) vectors: dfs, dfb (per batch element), dbb3, ds4, db4, dbb2, ds3, db3;
# and the (ff,) vector dbb1
N_VEC = 8


class _FfTailTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s3, b3, w1, bb1, w2, bb2, fs, fb, s4, b4, w3, bb3, seeds, rate, eps):
        check_cuda(x, s3=s3, b3=b3, w1=w1, bb1=bb1, w2=w2, bb2=bb2, film_scale=fs, film_shift=fb,
                   s4=s4, b4=b4, w3=w3, bb3=bb3, seeds=seeds)
        B, L, d = x.shape
        ff = w1.shape[0]
        if d % 2 or d > 1024 or ff > 1024:
            raise ValueError(f"unsupported widths d={d}, ff={ff}")
        for name, t, shape in (("w1", w1, (ff, d)), ("w2", w2, (d, ff)), ("w3", w3, (d, d)),
                               ("film_scale", fs, (B, d)), ("film_shift", fb, (B, d)), ("seeds", seeds, (B,))):
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        dt, dev = x.dtype, x.device
        f32 = lambda t: t.float().contiguous()
        ten = dict(
            x=x, s3=f32(s3), b3=f32(b3), w1=as_t(w1, dt), bb1=f32(bb1), w2=as_t(w2, dt), bb2=f32(bb2),
            fs=f32(fs), fb=f32(fb), s4=f32(s4), b4=f32(b4), w3=as_t(w3, dt), bb3=f32(bb3),
            seeds=as_uint32_int32(seeds),
        )
        e = lambda *shape, t=dt: torch.empty(shape, dtype=t, device=dev)
        f = torch.float32
        ten.update(y=e(B, L, d), u=e(B, L, ff, t=f), ad=e(B, L, ff), zd=e(B, L, d, t=f),
                   x2=e(B, L, d, t=f), y4=e(B, L, d), out=torch.empty_like(x))
        wcap = weight_scratch((B * L, d, d), (B * L, d, ff), (B * L, ff, d))  # dW3, dW2, dW1
        dims = dict(B=B, L=L, d=d, ff=ff, wcap=wcap, drop_on=int(rate > 0), eps=eps,
                    dscale=1.0 / (1.0 - rate), thresh=threshold(rate))
        launch("ff_tail_train", "tcd_ff_train_fwd", _Args, ten, dims, x, "ff_tail_train")
        ff_tail_train.launches += 1
        save_tensors(ctx, ten)
        ctx.dims = dims
        ctx.in_dtypes = tuple(t.dtype for t in (s3, b3, w1, bb1, w2, bb2, fs, fb, s4, b4, w3, bb3))
        return ten["out"]

    @staticmethod
    def backward(ctx, g):
        ten, dims = saved_tensors(ctx), ctx.dims
        B, L, d, ff = dims["B"], dims["L"], dims["d"], dims["ff"]
        x = ten["x"]
        dt, dev = x.dtype, x.device
        e = lambda *shape, t=dt: torch.empty(shape, dtype=t, device=dev)
        f = torch.float32
        nch = -(-L // FF_RCH)
        ten.update(
            g=g.to(dt).contiguous(), dy4=e(B, L, d, t=f), dx2=e(B, L, d, t=f), dz=e(B, L, d),
            dad=e(B, L, ff, t=f), du=e(B, L, ff), dy=e(B, L, d, t=f), dx=torch.empty_like(x),
            dw1=e(ff, d), dw2=e(d, ff), dw3=e(d, d),
            part=e(N_VEC, B * nch, d, t=f), part_ff=e(B * nch, ff, t=f),
            # split-row partials of dW3, dW2 and dW1 in turn
            wpart=e(dims["wcap"], t=f), vec=e(N_VEC, B, d, t=f), vec_ff=e(ff, t=f),
        )
        launch("ff_tail_train", "tcd_ff_train_bwd", _Args, ten, dims, x, "ff_tail_train backward")
        ff_tail_train.bwd_launches += 1
        v = ten["vec"]
        ts3, tb3, tw1, tbb1, tw2, tbb2, tfs, tfb, ts4, tb4, tw3, tbb3 = ctx.in_dtypes
        return (ten["dx"], v[6, 0].to(ts3), v[7, 0].to(tb3), ten["dw1"].to(tw1), ten["vec_ff"].to(tbb1),
                ten["dw2"].to(tw2), v[5, 0].to(tbb2), v[0].to(tfs), v[1].to(tfb),
                v[3, 0].to(ts4), v[4, 0].to(tb4), ten["dw3"].to(tw3), v[2, 0].to(tbb3),
                None, None, None)


@traced("k5.ff_tail_train", backward=True)
def ff_tail_train(x, s3, b3, w1, bb1, w2, bb2, film_scale, film_shift, s4, b4, w3, bb3, seeds,
                  *, rate: float, eps: float = 1e-5):
    """The train FF block + layer tail: CUDA kernels (forward and backward)
    for a CUDA x, the plain version for a CPU x. See the module docstring."""
    args = (x, s3, b3, w1, bb1, w2, bb2, film_scale, film_shift, s4, b4, w3, bb3, seeds)
    if x.device.type == "cpu":
        return ff_tail_train_plain(*args, rate=rate, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"ff_tail_train runs on CPU or CUDA tensors, got {x.device}")
    return _FfTailTrain.apply(*args, rate, eps)


count_kernel(ff_tail_train)
