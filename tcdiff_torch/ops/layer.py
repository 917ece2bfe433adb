"""A whole decoder layer on the serving path: K6 of the port.

Counterpart of `tcdiff_tpu/ops/fused_layer.py::fused_layer`, for the
k/v-cached serving forward without TRPE:

    x1 = x  + (f1s+1) * SA(x)  + f1b       the self-attention block (K1's)
    x2 = x1 + (f2s+1) * CA(x1) + f2b       cross-attention to kcat, vcat
    out = linear3(LN4(x2 + (f3s+1) * FF(x2) + f3b))      (include_ff)
    out = x2                                             (otherwise)

x1 and x2 are rounded to the compute dtype (x.dtype) before reuse, as the
TPU kernel rounds them where the per-block programs store the residual
stream; every FiLM residual is taken in f32. kcat/vcat (b, Lm, h*dk) are
the cross-attention k and v already projected (the cond cache's music
rows and the step's time-token rows). The arguments are `fused_layer`'s,
with weights in nn.Linear layout: wq/wk/wv/cwq (h*dk, d), wfc/cfc
(d, h*dk), w1 (ff, d), w2 (d, ff), w3 (d, d); LN affines and biases (n,);
FiLM rows (b, d). `layer` runs the hand-written CUDA kernel
(`csrc/layer.cu`: 10 launches in bf16, the LayerNorms after the fc and W2
products in their epilogues; 15 in f32) for a CUDA x and `layer_plain` for
a CPU x. In bf16 d is at most 1024.
"""

from __future__ import annotations

import torch

from tcdiff_torch.ops._common import args_struct, as_t, check_cuda, check_ln_fold, launch, scratch
from tcdiff_torch.ops.ca_block import cross_plain
from tcdiff_torch.ops.ff_block import ff_tail_plain
from tcdiff_torch.ops.sa_block import cached_rotary_tables, sa_block_plain
from tcdiff_torch.utils.profiling import traced

_WEIGHTS = ("wq", "wk", "wv", "wfc", "cwq", "cfc", "kcat", "vcat", "w1", "w2", "w3")
_FF_ARGS = ("s3", "b3", "w1", "bb1", "w2", "bb2", "f3s", "f3b", "s4", "b4", "w3", "bb3")


def layer_plain(x, angles, s1, b1, wq, wk, wv, wfc, sa_s2, sa_b2, f1s, f1b,
                n2s, n2b, cwq, cfc, ca_s2, ca_b2, kcat, vcat, f2s, f2b,
                s3=None, b3=None, w1=None, bb1=None, w2=None, bb2=None, f3s=None, f3b=None,
                s4=None, b4=None, w3=None, bb3=None,
                *, nhead: int, eps1: float = 1e-5, eps2: float = 1e-6, include_ff: bool = True):
    """Plain PyTorch version of the layer; the oracle of the kernel."""
    x1 = sa_block_plain(x, s1, b1, angles, wq, wk, wv, wfc, sa_s2, sa_b2, None, None, f1s, f1b,
                        nhead=nhead, eps1=eps1, eps2=eps2)
    x2 = cross_plain(x1, n2s, n2b, angles, kcat, vcat, cwq, cfc, ca_s2, ca_b2, f2s, f2b,
                     nhead=nhead, eps1=eps1, eps2=eps2)
    if not include_ff:
        return x2
    return ff_tail_plain(x2, s3, b3, w1, bb1, w2, bb2, f3s, f3b, s4, b4, w3, bb3, eps=eps1)


_Args = args_struct(  # LayerArgs in csrc/layer.cu
    "LayerArgs",
    ("x", "cos", "ssin", "s1", "b1", "wq", "wk", "wv", "wfc", "sa_s2", "sa_b2", "f1s", "f1b",
     "n2s", "n2b", "cwq", "cfc", "ca_s2", "ca_b2", "kcat", "vcat", "f2s", "f2b", *_FF_ARGS,
     "y", "r", "q", "k", "v", "o", "z", "x1", "x2", "h", "out"),
    ("B", "L", "Lm", "d", "hd", "nhead", "ff", "include_ff"),
    ("eps1", "eps2"),
)


def _layer_cuda(x, angles, s1, b1, wq, wk, wv, wfc, sa_s2, sa_b2, f1s, f1b,
                n2s, n2b, cwq, cfc, ca_s2, ca_b2, kcat, vcat, f2s, f2b, ff_args, *, nhead, eps1, eps2, include_ff):
    named = dict(angles=angles, s1=s1, b1=b1, wq=wq, wk=wk, wv=wv, wfc=wfc, sa_s2=sa_s2, sa_b2=sa_b2, f1s=f1s,
                 f1b=f1b, n2s=n2s, n2b=n2b, cwq=cwq, cfc=cfc, ca_s2=ca_s2, ca_b2=ca_b2, kcat=kcat, vcat=vcat,
                 f2s=f2s, f2b=f2b)
    if include_ff:
        if any(t is None for t in ff_args):
            raise ValueError("include_ff needs the FF section's " + ", ".join(_FF_ARGS))
        named.update(zip(_FF_ARGS, ff_args))
    check_cuda(x, **named)
    B, L, d = x.shape
    Lm = kcat.shape[1]
    hd = wq.shape[0]
    dk = hd // nhead
    ff = named["w1"].shape[0] if include_ff else 0
    if d % 2 or hd % nhead or dk > 64 or dk % 4:
        raise ValueError(f"unsupported widths d={d}, h*dk={hd}, nhead={nhead}")
    shapes = dict(angles=(L, d), wq=(hd, d), wk=(hd, d), wv=(hd, d), wfc=(d, hd), cwq=(hd, d), cfc=(d, hd),
                  kcat=(B, Lm, hd), vcat=(B, Lm, hd), f1s=(B, d), f1b=(B, d), f2s=(B, d), f2b=(B, d),
                  w1=(ff, d), w2=(d, ff), w3=(d, d), f3s=(B, d), f3b=(B, d))
    for name, shape in shapes.items():
        if name in named and tuple(named[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(named[name].shape)}, expected {shape}")

    check_ln_fold(d, x.dtype)

    dt, dev = x.dtype, x.device
    cos, ssin = cached_rotary_tables(angles, dt)
    ten = {name: as_t(t, dt if name in _WEIGHTS else torch.float32) for name, t in named.items() if name != "angles"}
    rows = lambda n, t=dt: ((B, L, n), t)
    ten.update(scratch(dev, dict(
        y=rows(d), r=rows(d), q=rows(hd), k=rows(hd), v=rows(hd), o=rows(hd), x1=rows(d),
        z=rows(d, torch.float32) if dt == torch.float32 else None,  # the bf16 folds keep it in the SMs
        x2=rows(d) if include_ff else None, h=rows(ff) if include_ff else None)))
    ten.update(x=x, cos=cos, ssin=ssin, out=torch.empty_like(x))
    dims = dict(B=B, L=L, Lm=Lm, d=d, hd=hd, nhead=nhead, ff=ff, include_ff=int(include_ff), eps1=eps1, eps2=eps2)
    launch("layer", "tcd_layer", _Args, {k: t for k, t in ten.items() if t is not None}, dims, x, "layer")
    layer.launches += 1
    return ten["out"]


@traced("k6.layer")
def layer(x, angles, s1, b1, wq, wk, wv, wfc, sa_s2, sa_b2, f1s, f1b,
          n2s, n2b, cwq, cfc, ca_s2, ca_b2, kcat, vcat, f2s, f2b,
          s3=None, b3=None, w1=None, bb1=None, w2=None, bb2=None, f3s=None, f3b=None,
          s4=None, b4=None, w3=None, bb3=None,
          *, nhead: int, eps1: float = 1e-5, eps2: float = 1e-6, include_ff: bool = True):
    """One decoder layer: CUDA kernel for a CUDA x, plain version for a CPU
    x. See the module docstring for shapes."""
    head = (x, angles, s1, b1, wq, wk, wv, wfc, sa_s2, sa_b2, f1s, f1b,
            n2s, n2b, cwq, cfc, ca_s2, ca_b2, kcat, vcat, f2s, f2b)
    ff_args = (s3, b3, w1, bb1, w2, bb2, f3s, f3b, s4, b4, w3, bb3)
    kw = dict(nhead=nhead, eps1=eps1, eps2=eps2, include_ff=include_ff)
    if x.device.type == "cpu":
        return layer_plain(*head, *ff_args, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"layer runs on CPU or CUDA tensors, got {x.device}")
    return _layer_cuda(*head, ff_args, **kw)


layer.launches = 0  # kernel launches; the plain path does not count
