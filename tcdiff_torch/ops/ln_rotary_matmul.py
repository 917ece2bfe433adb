"""LayerNorm -> rotary -> projections: K8 of the port.

Counterpart of `tcdiff_tpu/ops/fused_ln_rotary_matmul.py::
fused_ln_rotary_matmul`, both of its Pallas programs:

    y = LN(x) (f32)      r = y * cos + swap_pairs(y) * ssin (f32)
    _kernel:           (T(r) . w_rot^T, T(y) . w_plain^T)
    _kernel_rot_only:  T(r) . w_rot^T                       (w_plain None)

with cos and the sign-folded sin rounded to x's dtype T first (the TPU
kernel's `_tables`, `sa_block.rotary_tables` here) and f32 sums. The
per-op serving path calls it for the self-attention q/k/v (w_rot = [w_q;
w_k], w_plain = w_v) and, with the k/v cache off, for the cross-attention
query (w_rot = w_q). x (b, L, d); angles (L, d) f32; weights in nn.Linear
layout (n, d), in the compute dtype. `ln_rotary_matmul` runs the CUDA
kernel (`csrc/ln_rotary_matmul.cu`) for a CUDA tensor and
`ln_rotary_matmul_plain` for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from tcdiff_torch.models.rotary import swap_pairs
from tcdiff_torch.ops import _build
from tcdiff_torch.ops._common import as_t, check_cuda, ln_f32, mm_f32, ptr, raise_on, stream_ptr
from tcdiff_torch.ops.sa_block import rotary_tables


def ln_rotary_matmul_plain(x, scale, bias, angles, w_rot, w_plain=None, eps: float = 1e-5):
    """Plain PyTorch version of the kernel; its oracle."""
    dt = x.dtype
    cos, ssin = rotary_tables(angles, dt)
    y = ln_f32(x, scale, bias, eps)
    r = (y * cos.float() + swap_pairs(y) * ssin.float()).to(dt)
    qk = mm_f32(r, w_rot).to(dt)
    if w_plain is None:
        return qk
    return qk, mm_f32(y.to(dt), w_plain).to(dt)


def _fn():
    fn = _build.load("ln_rotary_matmul").tcd_ln_rotary_matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float]
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
    return fn


def _ln_rotary_matmul_cuda(x, scale, bias, angles, w_rot, w_plain, eps):
    code = check_cuda(x, scale=scale, bias=bias, angles=angles, w_rot=w_rot, w_plain=w_plain)
    B, L, d = x.shape
    fr = w_rot.shape[0]
    fp = 0 if w_plain is None else w_plain.shape[0]
    if d % 2:
        raise ValueError(f"d={d} must be even")
    shapes = [("scale", scale, (d,)), ("bias", bias, (d,)), ("angles", angles, (L, d)), ("w_rot", w_rot, (fr, d))]
    if w_plain is not None:
        shapes.append(("w_plain", w_plain, (fp, d)))
    for name, t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    dt = x.dtype
    cos, ssin = rotary_tables(angles, dt)
    s, b = scale.float().contiguous(), bias.float().contiguous()
    wr = as_t(w_rot, dt)
    wp = None if w_plain is None else as_t(w_plain, dt)
    empty = lambda n: torch.empty((B, L, n), dtype=dt, device=x.device)
    r, qk = empty(d), empty(fr)
    y, v = (None, None) if wp is None else (empty(d), empty(fp))
    rc = _fn()(code, ptr(x), ptr(s), ptr(b), ptr(cos), ptr(ssin), ptr(wr), ptr(wp), B * L, L, d, fr, fp,
               eps, ptr(y), ptr(r), ptr(qk), ptr(v), stream_ptr(x.device))
    raise_on(rc, "ln_rotary_matmul")
    ln_rotary_matmul.launches += 1
    return qk if v is None else (qk, v)


def ln_rotary_matmul(x, scale, bias, angles, w_rot, w_plain=None, eps: float = 1e-5):
    """LN -> rotary -> projection(s): CUDA kernel for a CUDA x, plain
    version for a CPU x. Returns (qk, v), or qk alone without w_plain."""
    if x.device.type == "cpu":
        return ln_rotary_matmul_plain(x, scale, bias, angles, w_rot, w_plain, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_rotary_matmul runs on CPU or CUDA tensors, got {x.device}")
    return _ln_rotary_matmul_cuda(x, scale, bias, angles, w_rot, w_plain, eps)


ln_rotary_matmul.launches = 0  # kernel launches; the plain path does not count
