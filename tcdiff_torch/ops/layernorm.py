"""Row LayerNorm: K10 of the port.

Counterpart of `tcdiff_tpu/ops/fused_layernorm.py::fused_layernorm`
(Pallas `_ln_kernel`), which the per-op serving path uses for the SBI-MSA
post-attention LayerNorms: LayerNorm over the last dim of x (..., d), with
f32 statistics (var = E[x^2] - mu^2) and affine, the output in x's dtype.
`layernorm` runs the CUDA kernel (`csrc/layernorm.cu`) for a CUDA tensor
and `layernorm_plain` for a CPU tensor.

`ln_rows` runs the same row body (`csrc/common.cuh`, the LayerNorm stage
of every kernel of the port) alone with each of its options: an f32 input
with an output in the compute dtype, the rotary output, the FiLM residual.
Tests and `chip_smoke.py` measure it through this entry; no path calls it.
"""

from __future__ import annotations

import ctypes

import torch

from tcdiff_torch.ops import _build
from tcdiff_torch.models.rotary import swap_pairs
from tcdiff_torch.ops._common import DTYPE_CODE, check_cuda, ln_f32, ptr, raise_on, stream_ptr
from tcdiff_torch.ops.sa_block import rotary_tables
from tcdiff_torch.utils.profiling import traced


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


@traced("k10.layernorm")
def layernorm(x, scale, bias, eps: float = 1e-6):
    """Row LayerNorm: CUDA kernel for a CUDA x, plain version for a CPU x.
    x (..., d); scale, bias (d,)."""
    if x.device.type == "cpu":
        return layernorm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm runs on CPU or CUDA tensors, got {x.device}")
    return _layernorm_cuda(x, scale, bias, eps)


layernorm.launches = 0  # kernel launches; the plain path does not count


def ln_rows_plain(x, scale, bias, eps: float = 1e-6, *, dtype=None, angles=None, film_scale=None,
                  film_shift=None, resid=None, normed: bool = True):
    """Plain PyTorch version of `ln_rows`; its oracle."""
    dt = dtype or x.dtype
    y = ln_f32(x, scale, bias, eps)
    out = rot = None
    if normed:
        if film_scale is not None:
            y_out = resid.float() + (film_scale.float()[:, None, :] + 1.0) * y + film_shift.float()[:, None, :]
        else:
            y_out = y
        out = y_out.to(dt)
    if angles is not None:
        cos, ssin = rotary_tables(angles, dt)
        rot = (y * cos.float() + swap_pairs(y) * ssin.float()).to(dt)
    return out, rot


def _ln_rows_fn():
    fn = _build.load("layernorm").tcd_ln_rows
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float]
                       + [ctypes.c_void_p] * 8)
        fn.restype = ctypes.c_int
    return fn


def _ln_rows_cuda(x, scale, bias, eps, dt, angles, film_scale, film_shift, resid, normed):
    check_cuda(x, scale=scale, bias=bias, angles=angles, film_scale=film_scale, film_shift=film_shift, resid=resid)
    B, L, d = x.shape
    if d % 2 or dt not in DTYPE_CODE or (x.dtype == torch.bfloat16 and dt != torch.bfloat16):
        raise ValueError(f"ln_rows takes an even d and a bf16 input only with a bf16 output (d={d}, {x.dtype})")
    film = film_scale is not None
    if film and (resid is None or tuple(resid.shape) != tuple(x.shape) or tuple(film_scale.shape) != (B, d)
                 or tuple(film_shift.shape) != (B, d)):
        raise ValueError("the FiLM residual takes resid (b, L, d) and film rows (b, d)")
    if not normed and angles is None:
        raise ValueError("ln_rows needs an output")
    f32 = lambda t: None if t is None else t.float().contiguous()
    cos, ssin = rotary_tables(angles, dt) if angles is not None else (None, None)
    res = resid.to(dt).contiguous() if film else None
    out = torch.empty(x.shape, dtype=dt, device=x.device) if normed else None
    rot = torch.empty(x.shape, dtype=dt, device=x.device) if angles is not None else None
    rc = _ln_rows_fn()(DTYPE_CODE[x.dtype], DTYPE_CODE[dt], ptr(x), ptr(f32(scale)), ptr(f32(bias)), B * L, d, L,
                       eps, ptr(cos), ptr(ssin), ptr(res), ptr(f32(film_scale)), ptr(f32(film_shift)), ptr(out),
                       ptr(rot), stream_ptr(x.device))
    raise_on(rc, "ln_rows")
    ln_rows.launches += 1
    return out, rot


def ln_rows(x, scale, bias, eps: float = 1e-6, *, dtype=None, angles=None, film_scale=None, film_shift=None,
            resid=None, normed: bool = True):
    """The LayerNorm row body with its options: x (b, L, d) in f32 or the
    output dtype `dtype` (x.dtype by default); scale, bias (d,). Returns
    (out, rot): out = T(LN(x)), or T(resid + (fs+1) * LN(x) + fb) with film
    rows (b, d) and resid (b, L, d), None where not `normed`; rot =
    T(rot(LN(x))) with the angle table (L, d), else None. CUDA kernel for a
    CUDA x, plain version for a CPU x."""
    kw = dict(dtype=dtype or x.dtype, angles=angles, film_scale=film_scale, film_shift=film_shift, resid=resid,
              normed=normed)
    if x.device.type == "cpu":
        return ln_rows_plain(x, scale, bias, eps, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"ln_rows runs on CPU or CUDA tensors, got {x.device}")
    return _ln_rows_cuda(x, scale, bias, eps, kw["dtype"], angles, film_scale, film_shift, resid, normed)


ln_rows.launches = 0  # kernel launches; the plain path does not count
