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
a CUDA tensor and `ln_matmul_plain` for a CPU tensor. In bf16 the kernel
is two launches, the row body writing y and the product with its
rounded-bias epilogue on the wgmma + TMA body.
"""

from __future__ import annotations

import torch

from tcdiff_torch.ops._common import args_struct, as_t, check_cuda, launch, ln_f32, mm_f32, scratch
from tcdiff_torch.utils.profiling import traced


def ln_matmul_plain(x, scale, bias, w, b, eps: float = 1e-5):
    """Plain PyTorch version of the kernel; its oracle."""
    dt = x.dtype
    y = ln_f32(x, scale, bias, eps).to(dt)
    return mm_f32(y, w).to(dt) + b.to(dt)


_Args = args_struct(  # LnMatmulArgs in csrc/ln_matmul.cu
    "LnMatmulArgs", ("x", "s", "b", "w", "bias", "y", "out"), ("M", "d", "N"), ("eps",))


def _ln_matmul_cuda(x, scale, bias, w, b, eps):
    check_cuda(x, scale=scale, bias=bias, w=w, b=b)
    d = x.shape[-1]
    n = w.shape[0]
    if d % 2:
        raise ValueError(f"d={d} must be even")
    for name, t, shape in (("scale", scale, (d,)), ("bias", bias, (d,)), ("w", w, (n, d)), ("b", b, (n,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")

    # host work only: no cast of what is already in its dtype, y and the
    # output from one allocation
    dt, m = x.dtype, x.numel() // d
    ten = scratch(x.device, dict(y=((m, d), dt), out=(x.shape[:-1] + (n,), dt)))
    ten.update(x=x, s=as_t(scale, torch.float32), b=as_t(bias, torch.float32), w=as_t(w, dt),
               bias=as_t(b, torch.float32))
    launch("ln_matmul", "tcd_ln_matmul", _Args, ten, dict(M=m, d=d, N=n, eps=eps), x, "ln_matmul")
    ln_matmul.launches += 1
    return ten["out"]


@traced("k9.ln_matmul")
def ln_matmul(x, scale, bias, w, b, eps: float = 1e-5):
    """LN -> projection + bias: CUDA kernel for a CUDA x, plain version for
    a CPU x. See the module docstring for shapes."""
    if x.device.type == "cpu":
        return ln_matmul_plain(x, scale, bias, w, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_matmul runs on CPU or CUDA tensors, got {x.device}")
    return _ln_matmul_cuda(x, scale, bias, w, b, eps)


ln_matmul.launches = 0  # kernel launches; the plain path does not count
