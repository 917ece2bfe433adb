"""The decoder layer's feed-forward block and tail: K2 of the port.

Counterpart of `tcdiff_tpu/ops/fused_ff_block.py`:

    ff_tail:  linear3(LN4(x + (fs+1)*(linear2(gelu(linear1(LN3(x)))) ) + fb))
    ff_block: linear2(gelu(linear1(LN(x))))  [-> x + (fs+1)*ff + fb]

`ff_tail` (K2) runs the hand-written CUDA kernel `csrc/ff_tail.cu` for a
CUDA tensor and `ff_tail_plain` for a CPU tensor; `ff_block` (K2b, the
chain without the tail, on the serving path with the FF block kernel on
and the tail off) runs `csrc/ff_block.cu` or `ff_block_plain` alike (in
bf16 the row body for LN3 and both products on the wgmma + TMA body).
Weights are in nn.Linear layout: w1 (ff, d),
w2 (d, ff), w3 (d, d); biases and LN affines (n,); film rows (b, d).
GELU is the exact erf form. LN statistics, GELU, FiLM and every product
sum run in f32; operands are rounded to the compute dtype (x.dtype) where
the TPU kernel rounds them.
"""

from __future__ import annotations

import ctypes

import torch

from tcdiff_torch.ops import _build
from tcdiff_torch.ops._common import (
    as_t, check_cuda, check_ln_fold, ln_f32, mm_f32, ptr, raise_on, scratch, stream_ptr,
)
from tcdiff_torch.utils.profiling import traced


def _gelu(h):
    return torch.nn.functional.gelu(h, approximate="none")


def _ff(x, scale, bias, w1, b1, w2, b2, eps):
    """f32 linear2(gelu(linear1(LN(x)))) with the TPU kernel's roundings."""
    dt = x.dtype
    y = ln_f32(x, scale, bias, eps).to(dt)
    h = _gelu(mm_f32(y, w1) + b1.float()).to(dt)
    return mm_f32(h, w2) + b2.float()


def _film(x, o, fs, fb):
    return x.float() + (fs.float()[:, None, :] + 1.0) * o + fb.float()[:, None, :]


def ff_block_plain(x, scale, bias, w1, b1, w2, b2, film_scale=None, film_shift=None, eps: float = 1e-5):
    """Plain PyTorch version of the FF block; the oracle of its kernel."""
    o = _ff(x, scale, bias, w1, b1, w2, b2, eps)
    if film_scale is not None:
        o = _film(x, o, film_scale, film_shift)
    return o.to(x.dtype)


def ff_tail_plain(x, scale, bias, w1, b1, w2, b2, film_scale, film_shift, s4, b4, w3, b3,
                  eps: float = 1e-5):
    """Plain PyTorch version of the FF block + tail; the oracle of the kernel."""
    o = _film(x, _ff(x, scale, bias, w1, b1, w2, b2, eps), film_scale, film_shift)
    z = ln_f32(o, s4, b4, eps).to(x.dtype)
    return (mm_f32(z, w3) + b3.float()).to(x.dtype)


_ARGTYPES = {  # tcd_<name>: dtype, the pointers, the ints, eps, the scratch and output, the stream
    "ff_block": ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float]
                 + [ctypes.c_void_p] * 4),
    "ff_tail": ([ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_float]
                + [ctypes.c_void_p] * 6),
}


def _fn(name: str):
    fn = getattr(_build.load(name), f"tcd_{name}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_shapes(x, w1, w2, film_scale, film_shift, w3=None):
    """Raise unless the weights and FiLM rows fit x (B, L, d); returns
    (B, L, d, ff)."""
    B, L, d = x.shape
    ff = w1.shape[0]
    if d % 2:
        raise ValueError(f"d={d} must be even")
    shapes = [("w1", w1, (ff, d)), ("w2", w2, (d, ff)), ("w3", w3, (d, d)),
              ("film_scale", film_scale, (B, d)), ("film_shift", film_shift, (B, d))]
    for name, t, shape in shapes:
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    return B, L, d, ff


def _ff_block_cuda(x, scale, bias, w1, b1, w2, b2, film_scale, film_shift, eps):
    code = check_cuda(x, scale=scale, bias=bias, w1=w1, b1=b1, w2=w2, b2=b2,
                      film_scale=film_scale, film_shift=film_shift)
    if (film_scale is None) != (film_shift is None):
        raise ValueError("give both film rows or neither")
    B, L, d, ff = _check_shapes(x, w1, w2, film_scale, film_shift)
    # host work only: no cast of what is already in its dtype, LN3's
    # output, the hidden activation and the output from one allocation
    dt = x.dtype
    f32 = lambda t: None if t is None else as_t(t, torch.float32)
    w1c, w2c = as_t(w1, dt), as_t(w2, dt)
    s3f, b3f, bb1, bb2, fs, fb = (f32(t) for t in (scale, bias, b1, b2, film_scale, film_shift))
    ten = scratch(x.device, dict(y=((B, L, d), dt), h=((B, L, ff), dt), out=((B, L, d), dt)))
    y, h, out = ten["y"], ten["h"], ten["out"]
    rc = _fn("ff_block")(
        code, ptr(x), ptr(s3f), ptr(b3f), ptr(w1c), ptr(bb1), ptr(w2c), ptr(bb2), ptr(fs), ptr(fb),
        B, L, d, ff, eps, ptr(y), ptr(h), ptr(out), stream_ptr(x.device),
    )
    raise_on(rc, "ff_block")
    ff_block.launches += 1
    return out


@traced("k2b.ff_block")
def ff_block(x, scale, bias, w1, b1, w2, b2, film_scale=None, film_shift=None, eps: float = 1e-5):
    """The FF block without the tail: CUDA kernel for a CUDA x, plain
    version for a CPU x. See the module docstring for shapes."""
    args = (x, scale, bias, w1, b1, w2, b2, film_scale, film_shift)
    if x.device.type == "cpu":
        return ff_block_plain(*args, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"ff_block runs on CPU or CUDA tensors, got {x.device}")
    return _ff_block_cuda(*args, eps)


ff_block.launches = 0  # kernel launches; the plain path does not count


def _ff_tail_cuda(x, scale, bias, w1, b1, w2, b2, film_scale, film_shift, s4, b4, w3, b3, eps):
    code = check_cuda(x, scale=scale, bias=bias, w1=w1, b1=b1, w2=w2, b2=b2,
                      film_scale=film_scale, film_shift=film_shift, s4=s4, b4=b4, w3=w3, b3=b3)
    B, L, d, ff = _check_shapes(x, w1, w2, film_scale, film_shift, w3)
    check_ln_fold(d, x.dtype)
    dt = x.dtype
    f32 = lambda t: t.float().contiguous()
    w1c, w2c, w3c = as_t(w1, dt), as_t(w2, dt), as_t(w3, dt)
    vecs = [f32(t) for t in (scale, bias, b1, b2, film_scale, film_shift, s4, b4, b3)]
    s3f, b3f, bb1, bb2, fs, fb, s4f, b4f, bb3 = vecs
    empty = lambda n, t=dt: torch.empty((B, L, n), dtype=t, device=x.device)
    y, h, o32, z = empty(d), empty(ff), empty(d, torch.float32), empty(d)
    out = torch.empty_like(x)
    rc = _fn("ff_tail")(
        code, ptr(x), ptr(s3f), ptr(b3f), ptr(w1c), ptr(bb1), ptr(w2c), ptr(bb2), ptr(fs),
        ptr(fb), ptr(s4f), ptr(b4f), ptr(w3c), ptr(bb3), B, L, d, ff, eps,
        ptr(y), ptr(h), ptr(o32), ptr(z), ptr(out), stream_ptr(x.device),
    )
    raise_on(rc, "ff_tail")
    ff_tail.launches += 1
    return out


@traced("k2.ff_tail")
def ff_tail(x, scale, bias, w1, b1, w2, b2, film_scale, film_shift, s4, b4, w3, b3,
            eps: float = 1e-5):
    """The FF block + layer tail: CUDA kernel for a CUDA x, plain version
    for a CPU x. See the module docstring for shapes."""
    args = (x, scale, bias, w1, b1, w2, b2, film_scale, film_shift, s4, b4, w3, b3)
    if x.device.type == "cpu":
        return ff_tail_plain(*args, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"ff_tail runs on CPU or CUDA tensors, got {x.device}")
    return _ff_tail_cuda(*args, eps)


ff_tail.launches = 0  # kernel launches; the plain path does not count
