"""Row LayerNorm: K10 of the port.

Counterpart of `tcdiff_tpu/ops/fused_layernorm.py::fused_layernorm`
(Pallas `_ln_kernel`), which the per-op serving path uses for the SBI-MSA
post-attention LayerNorms: LayerNorm over the last dim of x (..., d), with
f32 statistics (var = E[x^2] - mu^2) and affine, the output in x's dtype.
`layernorm` runs the CUDA kernel (`csrc/layernorm.cu`) for a CUDA tensor
and `layernorm_plain` for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from tcdiff_torch.ops import _build
from tcdiff_torch.ops._common import check_cuda, ln_f32, ptr, raise_on, stream_ptr


def layernorm_plain(x, scale, bias, eps: float = 1e-6):
    """Plain PyTorch version of the kernel; its oracle."""
    return ln_f32(x, scale, bias, eps).to(x.dtype)


def _fn():
    fn = _build.load("layernorm").tcd_layernorm
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float]
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def _layernorm_cuda(x, scale, bias, eps):
    code = check_cuda(x, scale=scale, bias=bias)
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"d={d} must be even")
    if tuple(scale.shape) != (d,) or tuple(bias.shape) != (d,):
        raise ValueError(f"scale and bias must be ({d},)")
    s, b = scale.float().contiguous(), bias.float().contiguous()
    out = torch.empty_like(x)
    rc = _fn()(code, ptr(x), ptr(s), ptr(b), x.numel() // d, d, eps, ptr(out), stream_ptr(x.device))
    raise_on(rc, "layernorm")
    layernorm.launches += 1
    return out


def layernorm(x, scale, bias, eps: float = 1e-6):
    """Row LayerNorm: CUDA kernel for a CUDA x, plain version for a CPU x.
    x (..., d); scale, bias (d,)."""
    if x.device.type == "cpu":
        return layernorm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm runs on CPU or CUDA tensors, got {x.device}")
    return _layernorm_cuda(x, scale, bias, eps)


layernorm.launches = 0  # kernel launches; the plain path does not count
