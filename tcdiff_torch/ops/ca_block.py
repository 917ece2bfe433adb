"""The decoder layer's cross-attention block on the serving path: K7 of the
port, in two forms.

`ca_block` is the counterpart of `tcdiff_tpu/ops/fused_ca_block.py::fused_ca_block`:

    q  = rot(LN(x; eps1)).Wq   k = memory_rot.Wk   v = memory.Wv   (bias-free)
    o  = per-head softmax(q.k^T/sqrt(dk)) . v                      (L x Lm)
    ca = LN(o.Wfc; eps2)  [-> x + (fs+1)*ca + fb]

x (b, L, d); memory (b, Lm, d) and memory_rot, the memory rotated with
the angle table of its own length (the caller's apply_rotary); angles
(L, d) for the query side. Weights in nn.Linear layout: wq/wk/wv (h*dk, d),
wfc (d, h*dk); LN affines (d,); film rows (b, d). LN statistics, rotary,
logits, softmax and every product sum in f32; q, k, v, the probabilities
and the attention output rounded to the compute dtype (x.dtype) where the
TPU kernel rounds them. `ca_block` runs the hand-written CUDA kernel
(`csrc/ca_block.cu`: 4 launches in bf16, the LayerNorm and the rotary of
the q side in the q projection's prologue and the post-LN in fc's
epilogue; 6 in f32) for a CUDA x and `ca_block_plain` for a CPU x; in bf16
d and h*dk are at most 1024.

`ca_kv` is the same block over k/v projected beforehand, the serving
default where the k/v are hoisted: the keys and values are the cond
cache's music rows of the layer (k_mem, v_mem (b, Lm, h*dk)) followed by
the step's time-token rows (k_time, v_time (b, Lt, h*dk)), each read where
it lies (the last dim contiguous, any batch and row strides), and the FiLM
residual is taken inside: x + (fs+1) * LN(o.Wfc; eps2) + fb in f32. The
CUDA kernel (`csrc/ca_block.cu`, `tcd_ca_kv`) makes 3 launches in bf16 (q
with its LayerNorm prologue, a one-pass attention over the whole short
memory, fc with its LayerNorm and FiLM fold; Lm + Lt <= 256) and 5 in
f32; a CPU x takes `ca_kv_plain`. Both forms count in `ca_block.launches`.

`cross_plain` is the query side against projected k/v, which the
whole-layer kernel's plain version (`ops/layer.py`) and `ca_kv_plain`
share.
"""

from __future__ import annotations

import torch

from tcdiff_torch.ops._common import args_struct, as_t, check_cuda, check_ln_fold, launch, ln_f32, mm_f32, scratch
from tcdiff_torch.ops.attention import attention_plain
from tcdiff_torch.ops.sa_block import cached_rotary_tables, rotary_tables
from tcdiff_torch.ops.sa_block_train import rot
from tcdiff_torch.ops.train_common import film_residual
from tcdiff_torch.utils.profiling import traced


def cross_plain(x, s1, b1, angles, k, v, wq, wfc, s2, b2, film_scale=None, film_shift=None,
                *, nhead: int, eps1: float = 1e-5, eps2: float = 1e-6):
    """The cross-attention block from projected k, v (b, Lm, h*dk), which
    are rounded to x.dtype per head as the TPU kernels do."""
    dt = x.dtype
    cos, ssin = rotary_tables(angles, dt)
    q = mm_f32(rot(ln_f32(x, s1, b1, eps1), cos, ssin).to(dt), wq)
    heads = lambda t: t.to(dt).unflatten(-1, (nhead, -1)).transpose(1, 2)  # (b, h, L, dk)
    dk = wq.shape[0] // nhead
    o = attention_plain(heads(q), heads(k), heads(v), dk**-0.5).transpose(1, 2).flatten(2)
    ca = ln_f32(mm_f32(o, wfc), s2, b2, eps2)
    if film_scale is not None:
        ca = film_residual(x, ca, film_scale, film_shift)
    return ca.to(dt)


def ca_block_plain(x, s1, b1, angles, memory, memory_rot, wq, wk, wv, wfc, s2, b2,
                   film_scale=None, film_shift=None, *, nhead: int, eps1: float = 1e-5, eps2: float = 1e-6):
    """Plain PyTorch version of the block; the oracle of the kernel."""
    dt = x.dtype
    k, v = mm_f32(memory_rot.to(dt), wk), mm_f32(memory.to(dt), wv)
    return cross_plain(x, s1, b1, angles, k, v, wq, wfc, s2, b2, film_scale, film_shift,
                       nhead=nhead, eps1=eps1, eps2=eps2)


_Args = args_struct(  # CaBlockArgs in csrc/ca_block.cu
    "CaBlockArgs",
    ("x", "s1", "b1", "cos", "ssin", "mem", "mrot", "wq", "wk", "wv", "wfc", "s2", "b2", "fs", "fb",
     "r", "q", "k", "v", "o", "z", "out"),
    ("B", "L", "Lm", "d", "hd", "nhead"),
    ("eps1", "eps2"),
)


def _ca_block_cuda(x, s1, b1, angles, memory, memory_rot, wq, wk, wv, wfc, s2, b2, film_scale, film_shift,
                   *, nhead, eps1, eps2):
    check_cuda(x, s1=s1, b1=b1, angles=angles, memory=memory, memory_rot=memory_rot, wq=wq, wk=wk, wv=wv,
               wfc=wfc, s2=s2, b2=b2, film_scale=film_scale, film_shift=film_shift)
    B, L, d = x.shape
    Lm = memory.shape[1]
    hd = wq.shape[0]
    dk = hd // nhead
    if d % 2 or hd % nhead or dk > 64 or dk % 4:
        raise ValueError(f"unsupported widths d={d}, h*dk={hd}, nhead={nhead}")
    check_ln_fold(max(d, hd), x.dtype)  # fc's fold holds rows of d, q's cluster rows of hd
    film = film_scale is not None
    if film != (film_shift is not None):
        raise ValueError("give both film rows or neither")
    shapes = [("memory", memory, (B, Lm, d)), ("memory_rot", memory_rot, (B, Lm, d)), ("wq", wq, (hd, d)),
              ("wk", wk, (hd, d)), ("wv", wv, (hd, d)), ("wfc", wfc, (d, hd)), ("angles", angles, (L, d)),
              ("film_scale", film_scale, (B, d)), ("film_shift", film_shift, (B, d))]
    for name, t, shape in shapes:
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")

    # host work only: no cast of what is already in its dtype, the rotary
    # tables once per angle table, the scratch in one allocation
    dt, dev = x.dtype, x.device
    f32 = lambda t: None if t is None else as_t(t, torch.float32)
    cos, ssin = cached_rotary_tables(angles, dt)
    unfused = dt == torch.float32  # r and z: the f32 sequence's row kernel inputs (bf16: in the SMs)
    rows = lambda n, length=L, t=dt: ((B, length, n), t)
    ten = scratch(dev, dict(r=rows(d) if unfused else None, q=rows(hd), k=rows(hd, Lm), v=rows(hd, Lm), o=rows(hd),
                            z=rows(d, t=torch.float32) if unfused else None))
    ten.update(x=x, s1=f32(s1), b1=f32(b1), cos=cos, ssin=ssin, mem=as_t(memory, dt), mrot=as_t(memory_rot, dt),
               wq=as_t(wq, dt), wk=as_t(wk, dt), wv=as_t(wv, dt), wfc=as_t(wfc, dt), s2=f32(s2), b2=f32(b2),
               fs=f32(film_scale), fb=f32(film_shift), out=torch.empty_like(x))
    dims = dict(B=B, L=L, Lm=Lm, d=d, hd=hd, nhead=nhead, eps1=eps1, eps2=eps2)
    launch("ca_block", "tcd_ca_block", _Args, {k: t for k, t in ten.items() if t is not None}, dims, x, "ca_block")
    ca_block.launches += 1
    return ten["out"]


@traced("k7.ca_block")
def ca_block(x, s1, b1, angles, memory, memory_rot, wq, wk, wv, wfc, s2, b2,
             film_scale=None, film_shift=None, *, nhead: int, eps1: float = 1e-5, eps2: float = 1e-6):
    """The serving cross-attention block: CUDA kernel for a CUDA x, plain
    version for a CPU x. See the module docstring for shapes."""
    args = (x, s1, b1, angles, memory, memory_rot, wq, wk, wv, wfc, s2, b2, film_scale, film_shift)
    if x.device.type == "cpu":
        return ca_block_plain(*args, nhead=nhead, eps1=eps1, eps2=eps2)
    if x.device.type != "cuda":
        raise ValueError(f"ca_block runs on CPU or CUDA tensors, got {x.device}")
    return _ca_block_cuda(*args, nhead=nhead, eps1=eps1, eps2=eps2)


ca_block.launches = 0  # kernel launches of both forms; the plain path does not count


def ca_kv_plain(x, s1, b1, angles, k_mem, v_mem, k_time, v_time, wq, wfc, s2, b2, film_scale, film_shift,
                *, nhead: int, eps1: float = 1e-5, eps2: float = 1e-6):
    """Plain PyTorch version of `ca_kv`; the oracle of its kernel."""
    k, v = torch.cat([k_mem, k_time], dim=1), torch.cat([v_mem, v_time], dim=1)
    return cross_plain(x, s1, b1, angles, k, v, wq, wfc, s2, b2, film_scale, film_shift,
                       nhead=nhead, eps1=eps1, eps2=eps2)


_KV = ("km", "vm", "kt", "vt")
_KvArgs = args_struct(  # CaKvArgs in csrc/ca_block.cu
    "CaKvArgs",
    ("x", "s1", "b1", "cos", "ssin", *_KV, "wq", "wfc", "s2", "b2", "fs", "fb", "r", "q", "o", "z", "out"),
    ("B", "L", "Lm", "Lt", "d", "hd", "nhead", *(f"{n}_{s}" for n in _KV for s in ("sb", "sl"))),
    ("eps1", "eps2"),
)
CA_KV_MAX_KEYS = 256  # keys a block of the short-memory attention holds whole (csrc/ca_block.cu)


def _rows(name, t, dtype, batch, hd):
    """A k or v source as the kernel reads it: in dtype with its last dim
    contiguous (a copy only where it is not so); the kernel takes its
    (batch, row) strides."""
    if t.dim() != 3 or t.shape[0] != batch or t.shape[2] != hd:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected ({batch}, rows, {hd})")
    if t.dtype != dtype or t.stride(2) != 1:
        t = t.to(dtype).contiguous()
    return t


def _ca_kv_cuda(x, s1, b1, angles, k_mem, v_mem, k_time, v_time, wq, wfc, s2, b2, film_scale, film_shift,
                *, nhead, eps1, eps2):
    check_cuda(x, s1=s1, b1=b1, angles=angles, k_mem=k_mem, v_mem=v_mem, k_time=k_time, v_time=v_time, wq=wq,
               wfc=wfc, s2=s2, b2=b2, film_scale=film_scale, film_shift=film_shift)
    B, L, d = x.shape
    hd = wq.shape[0]
    dk = hd // nhead
    if d % 2 or hd % nhead or dk > 64 or dk % 4:
        raise ValueError(f"unsupported widths d={d}, h*dk={hd}, nhead={nhead}")
    check_ln_fold(max(d, hd), x.dtype)
    dt, dev = x.dtype, x.device
    src = dict(zip(_KV, (_rows(n, t, dt, B, hd) for n, t in
                         (("k_mem", k_mem), ("v_mem", v_mem), ("k_time", k_time), ("v_time", v_time)))))
    Lm, Lt = src["km"].shape[1], src["kt"].shape[1]
    if src["vm"].shape[1] != Lm or src["vt"].shape[1] != Lt:
        raise ValueError("k and v of a source must have the same rows")
    if not 1 <= Lm + Lt <= CA_KV_MAX_KEYS:
        raise ValueError(f"{Lm} + {Lt} keys: the kernel holds 1 to {CA_KV_MAX_KEYS}")
    shapes = [("wq", wq, (hd, d)), ("wfc", wfc, (d, hd)), ("angles", angles, (L, d)),
              ("film_scale", film_scale, (B, d)), ("film_shift", film_shift, (B, d))]
    for name, t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")

    # host work only, as in _ca_block_cuda
    f32 = lambda t: as_t(t, torch.float32)
    cos, ssin = cached_rotary_tables(angles, dt)
    unfused = dt == torch.float32
    rows = lambda n, t=dt: ((B, L, n), t)
    ten = scratch(dev, dict(r=rows(d) if unfused else None, q=rows(hd), o=rows(hd),
                            z=rows(d, torch.float32) if unfused else None))
    ten.update(src, x=x, s1=f32(s1), b1=f32(b1), cos=cos, ssin=ssin, wq=as_t(wq, dt), wfc=as_t(wfc, dt),
               s2=f32(s2), b2=f32(b2), fs=f32(film_scale), fb=f32(film_shift), out=torch.empty_like(x))
    dims = dict(B=B, L=L, Lm=Lm, Lt=Lt, d=d, hd=hd, nhead=nhead, eps1=eps1, eps2=eps2,
                **{f"{n}_{s}": src[n].stride(i) for n in _KV for i, s in ((0, "sb"), (1, "sl"))})
    launch("ca_block", "tcd_ca_kv", _KvArgs, {k: t for k, t in ten.items() if t is not None}, dims, x, "ca_kv")
    ca_block.launches += 1
    return ten["out"]


@traced("k7.ca_block")
def ca_kv(x, s1, b1, angles, k_mem, v_mem, k_time, v_time, wq, wfc, s2, b2, film_scale, film_shift,
          *, nhead: int, eps1: float = 1e-5, eps2: float = 1e-6):
    """The serving cross-attention block over hoisted k/v, FiLM inside:
    CUDA kernel for a CUDA x, plain version for a CPU x. See the module
    docstring for shapes."""
    args = (x, s1, b1, angles, k_mem, v_mem, k_time, v_time, wq, wfc, s2, b2, film_scale, film_shift)
    if x.device.type == "cpu":
        return ca_kv_plain(*args, nhead=nhead, eps1=eps1, eps2=eps2)
    if x.device.type != "cuda":
        raise ValueError(f"ca_kv runs on CPU or CUDA tensors, got {x.device}")
    return _ca_kv_cuda(*args, nhead=nhead, eps1=eps1, eps2=eps2)
