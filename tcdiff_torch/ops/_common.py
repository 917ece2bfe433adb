"""Helpers shared by the block wrappers: the f32 LayerNorm of the plain
versions, and the argument checks, scratch and ctypes plumbing of the CUDA
path."""

from __future__ import annotations

import ctypes

import torch

from tcdiff_torch.ops import _build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ln_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm in f32 with var = E[x^2] - mu^2, as the TPU kernels'."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mu * mu
    return (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a . w^T with f32 products and sums (w in nn.Linear layout, rounded
    to a's dtype first, as the TPU kernels take weights in the compute
    dtype)."""
    return torch.nn.functional.linear(a.float(), w.to(a.dtype).float())


def check_cuda(x: torch.Tensor, **tensors) -> int:
    """Raise unless x is a contiguous CUDA float32/bfloat16 tensor and every
    other given tensor lies on its device. Returns the dtype code."""
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"unsupported dtype {x.dtype}: the kernels take float32 or bfloat16")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x.device}, the current CUDA device is {torch.cuda.current_device()}")
    for name, t in tensors.items():
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    return DTYPE_CODE[x.dtype]


# The widest row a bf16 LayerNorm in a product's epilogue holds: a cluster
# of at most 8 blocks of 128 columns (csrc/gemm_wgmma.cuh gemm_ln_wg,
# csrc/gemm_mma.cuh gemm_ln).
LN_FOLD_MAX_D = 1024


def check_ln_fold(d: int, dtype: torch.dtype) -> None:
    """Raise where a block's bf16 post-attention or FF LayerNorm, which runs
    in its product's epilogue, cannot hold a row of d."""
    if dtype == torch.bfloat16 and d > LN_FOLD_MAX_D:
        raise ValueError(f"d={d}: the bf16 kernels take d <= {LN_FOLD_MAX_D}")


def scratch(device, specs: dict) -> dict:
    """{name: tensor} of the given {name: (shape, dtype)}, carved from one
    allocation, each on a 256-byte boundary; a spec of None gives None."""
    offsets, total = {}, 0
    for name, spec in specs.items():
        if spec is not None:
            shape, dtype = spec
            offsets[name] = total
            total += -(-torch.Size(shape).numel() * dtype.itemsize // 256) * 256
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    out = dict.fromkeys(specs)
    for name, off in offsets.items():
        shape, dtype = specs[name]
        n = torch.Size(shape).numel() * dtype.itemsize
        out[name] = buf[off:off + n].view(dtype).view(shape)
    return out


def as_t(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t as a contiguous tensor of dtype: t itself where it already is one
    (checked without a dispatch, as a wrapper's per-call host work)."""
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def args_struct(name: str, ptrs, ints, floats, uints=()):
    """A ctypes mirror of a C argument struct laid out as: the pointers, the
    ints, the floats, then the uint32s (the train kernels' `thresh`)."""
    fields = ([(n, ctypes.c_void_p) for n in ptrs] + [(n, ctypes.c_int) for n in ints]
              + [(n, ctypes.c_float) for n in floats] + [(n, ctypes.c_uint32) for n in uints])
    return type(name, (ctypes.Structure,), {"_fields_": fields})


def launch(lib: str, fn_name: str, struct, tensors: dict, dims: dict, x: torch.Tensor, what: str) -> None:
    """Call `extern "C" int fn_name(int dtype, const Struct*, void* stream)`
    of csrc/<lib>.cu with the tensors' pointers and the dims filled in by
    name (fields not given are null or 0); raise if the launch failed."""
    fn = getattr(_build.load(lib), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(struct), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    args = struct(**{k: t.data_ptr() for k, t in tensors.items()}, **dims)
    raise_on(fn(DTYPE_CODE[x.dtype], ctypes.byref(args), stream_ptr(x.device)), what)
