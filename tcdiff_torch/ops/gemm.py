"""The forward projection of the hand-written kernels alone, for tests and
measurement: C = A . W^T (W in nn.Linear layout) with a fused epilogue.

`csrc/gemm.cu` exposes the projection of `csrc/gemm_mma.cuh` that K1, K2
and every other kernel's forward projections run: bf16 on the tensor
cores (mma.sync), f32 on the FMA tiles. No path of the model calls this
module; `chip_smoke.py` times K1's and K2's products through it and
`tests/test_torch_cuda.py` holds it against `gemm_plain`.

Epilogues, with acc the f32 sum and T the dtype of a:

    store      T(acc)
    store_f32  acc
    bias       T(acc + bias)
    bias_gelu  T(gelu_erf(acc + bias))
    bias_film  resid + (fs[m // L] + 1) * (acc + bias) + fb[m // L], in f32

a (M, K), w (N, K), bias (N,) f32, resid (M, N) in T, film rows
(M / L, N). A list of up to three a and as many w that share M, N and K
is the grouped form (K1's q/k/v): one launch, a list of outputs; bias and
the FiLM arguments are shared by the group.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tcdiff_torch.ops._common import args_struct, as_t, check_cuda, launch, mm_f32

EPILOGUES = {"store": 0, "store_f32": 1, "bias": 2, "bias_gelu": 3, "bias_film": 4}  # tcd::Epi
F32_OUT = ("store_f32", "bias_film")
GROUP_MAX = 3


def _epilogue_plain(acc, dt, epilogue, bias, resid, film_scale, film_shift, L):
    if epilogue != "store" and epilogue != "store_f32":
        acc = acc + bias.float()
    if epilogue == "store_f32":
        return acc
    if epilogue == "bias_film":
        rows = lambda t: t.float().repeat_interleave(L, dim=0)
        return resid.float() + (rows(film_scale) + 1.0) * acc + rows(film_shift)
    if epilogue == "bias_gelu":
        acc = F.gelu(acc)
    return acc.to(dt)


def gemm_plain(a, w, epilogue: str = "store", bias=None, resid=None, film_scale=None, film_shift=None,
               L: int = 1):
    """Plain PyTorch version: mm_f32 and the epilogue in f32; the oracle."""
    grouped = isinstance(a, (list, tuple))
    outs = [_epilogue_plain(mm_f32(ai, wi), ai.dtype, epilogue, bias, resid, film_scale, film_shift, L)
            for ai, wi in zip(*((a, w) if grouped else ((a,), (w,))))]
    return outs if grouped else outs[0]


_Args = args_struct(  # GemmArgs in csrc/gemm.cu
    "GemmArgs",
    ("a0", "a1", "a2", "w0", "w1", "w2", "c0", "c1", "c2", "bias", "resid", "fs", "fb"),
    ("M", "N", "K", "L", "epi", "groups"),
    (),
)


def _gemm_cuda(a, w, epilogue, bias, resid, film_scale, film_shift, L):
    x = a[0]
    check_cuda(x, bias=bias, resid=resid, film_scale=film_scale, film_shift=film_shift)
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; one of {sorted(EPILOGUES)}")
    if not 1 <= len(a) <= GROUP_MAX or len(w) != len(a):
        raise ValueError(f"give 1 to {GROUP_MAX} a and as many w, got {len(a)} and {len(w)}")
    if x.dim() != 2:
        raise ValueError(f"a must be (M, K), got {tuple(x.shape)}")
    M, K = x.shape
    N = w[0].shape[0]
    for ai, wi in zip(a, w):
        check_cuda(ai, w=wi)
        if ai.dtype != x.dtype or tuple(ai.shape) != (M, K) or tuple(wi.shape) != (N, K):
            raise ValueError(f"a group shares dtype, a (M, K) = {(M, K)} and w (N, K) = {(N, K)}")
    if epilogue not in ("store", "store_f32") and (bias is None or tuple(bias.shape) != (N,)):
        raise ValueError(f"epilogue {epilogue} needs bias (N,) = ({N},)")
    if epilogue == "bias_film":
        if M % L or resid is None or tuple(resid.shape) != (M, N):
            raise ValueError(f"bias_film needs resid (M, N) = {(M, N)} and L dividing M = {M}")
        for name, t in (("film_scale", film_scale), ("film_shift", film_shift)):
            if t is None or tuple(t.shape) != (M // L, N):
                raise ValueError(f"bias_film needs {name} (M / L, N) = {(M // L, N)}")

    dt = x.dtype
    out_dt = torch.float32 if epilogue in F32_OUT else dt
    outs = [torch.empty((M, N), dtype=out_dt, device=x.device) for _ in a]
    ten = {}
    for i, (ai, wi, ci) in enumerate(zip(a, w, outs)):
        ten.update({f"a{i}": ai, f"w{i}": as_t(wi, dt), f"c{i}": ci})
    if bias is not None and epilogue not in ("store", "store_f32"):
        ten["bias"] = bias.float().contiguous()
    if epilogue == "bias_film":
        ten.update(resid=as_t(resid, dt), fs=film_scale.float().contiguous(), fb=film_shift.float().contiguous())
    dims = dict(M=M, N=N, K=K, L=L, epi=EPILOGUES[epilogue], groups=len(a))
    launch("gemm", "tcd_gemm", _Args, ten, dims, x, "gemm")
    gemm.launches += 1
    return outs


def gemm(a, w, epilogue: str = "store", bias=None, resid=None, film_scale=None, film_shift=None, L: int = 1):
    """C = a . w^T with the epilogue: the CUDA kernel for a CUDA a, the
    plain version for a CPU a. a and w are tensors, or lists of up to three
    (the grouped form, one launch). See the module docstring."""
    grouped = isinstance(a, (list, tuple))
    first = a[0] if grouped else a
    if first.device.type == "cpu":
        return gemm_plain(a, w, epilogue, bias, resid, film_scale, film_shift, L)
    if first.device.type != "cuda":
        raise ValueError(f"gemm runs on CPU or CUDA tensors, got {first.device}")
    outs = _gemm_cuda(list(a) if grouped else [a], list(w) if grouped else [w], epilogue, bias, resid,
                      film_scale, film_shift, L)
    return outs if grouped else outs[0]


gemm.launches = 0  # kernel launches; the plain path does not count
