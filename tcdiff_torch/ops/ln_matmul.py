"""LayerNorm into a biased projection: K9 of the port.

Counterpart of `tcdiff_tpu/ops/fused_ln_matmul.py::fused_ln_matmul`
(Pallas `_lnmm_kernel`), the per-op serving path's norm3 -> linear1 and
norm4 -> linear3:

    y = LN(x) in f32, rounded to the compute dtype (x.dtype)
    out = T(y . w^T) + T(b)        (f32 sums; the bias added in T)

The product is rounded to the output dtype BEFORE the bias is added in
that dtype, as the TPU kernel does; in bf16 that differs from F.linear's
fused bias. x (..., d); w (n, d) in nn.Linear layout, in the compute
dtype; b (n,). `ln_matmul` runs the CUDA kernel (`csrc/ln_matmul.cu`) for
a CUDA tensor and `ln_matmul_plain` for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from tcdiff_torch.ops import _build
from tcdiff_torch.ops._common import as_t, check_cuda, ln_f32, mm_f32, ptr, raise_on, stream_ptr


def ln_matmul_plain(x, scale, bias, w, b, eps: float = 1e-5):
    """Plain PyTorch version of the kernel; its oracle."""
    dt = x.dtype
    y = ln_f32(x, scale, bias, eps).to(dt)
    return mm_f32(y, w).to(dt) + b.to(dt)


def _fn():
    fn = _build.load("ln_matmul").tcd_ln_matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float]
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
    return fn


def _ln_matmul_cuda(x, scale, bias, w, b, eps):
    code = check_cuda(x, scale=scale, bias=bias, w=w, b=b)
    d = x.shape[-1]
    n = w.shape[0]
    if d % 2:
        raise ValueError(f"d={d} must be even")
    for name, t, shape in (("scale", scale, (d,)), ("bias", bias, (d,)), ("w", w, (n, d)), ("b", b, (n,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    s, sb, bb = scale.float().contiguous(), bias.float().contiguous(), b.float().contiguous()
    wc = as_t(w, x.dtype)
    m = x.numel() // d
    y = torch.empty((m, d), dtype=x.dtype, device=x.device)
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    rc = _fn()(code, ptr(x), ptr(s), ptr(sb), ptr(wc), ptr(bb), m, d, n, eps, ptr(y), ptr(out),
               stream_ptr(x.device))
    raise_on(rc, "ln_matmul")
    ln_matmul.launches += 1
    return out


def ln_matmul(x, scale, bias, w, b, eps: float = 1e-5):
    """LN -> projection + bias: CUDA kernel for a CUDA x, plain version for
    a CPU x. See the module docstring for shapes."""
    if x.device.type == "cpu":
        return ln_matmul_plain(x, scale, bias, w, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_matmul runs on CPU or CUDA tensors, got {x.device}")
    return _ln_matmul_cuda(x, scale, bias, w, b, eps)


ln_matmul.launches = 0  # kernel launches; the plain path does not count
