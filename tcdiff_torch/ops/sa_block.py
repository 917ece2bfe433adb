"""The decoder layer's whole self-attention block: K1 of the port.

Counterpart of `tcdiff_tpu/ops/fused_sa_block.py::fused_sa_block`:

    LN(eps1) -> rotary on the full d -> q/k from the rotated, v from the
    un-rotated LN output (bias-free) -> per-head softmax(q.k^T/sqrt(dk)
    [+ TRPE bias]) . v -> fc -> LN(eps2) [-> x + (fs+1)*sa + fb]

`sa_block` runs the hand-written CUDA kernel (`csrc/sa_block.cu`) for a
CUDA tensor and `sa_block_plain` for a CPU tensor. Weights are in
nn.Linear layout (out, in): wq/wk/wv (h*dk, d), wfc (d, h*dk); table is
(10, h*dk); trj_dist (b, L, L) integer buckets; film rows (b, d).
Numerics follow the TPU kernel: LN statistics, rotary, logits, softmax and
every product sum in f32, operands rounded to the compute dtype (x.dtype)
where the TPU kernel rounds them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tcdiff_torch.models.rotary import signed_pairs, swap_pairs
from tcdiff_torch.ops import _build
from tcdiff_torch.ops._common import (
    as_t, check_cuda, check_ln_fold, ln_f32, mm_f32, ptr, raise_on, stream_ptr,
)
from tcdiff_torch.ops.attention import N_TRJ_BUCKETS, trpe_bias
from tcdiff_torch.utils.profiling import traced


def rotary_tables(angles: torch.Tensor, dtype: torch.dtype):
    """cos and sign-folded sin of the f32 angle table, rounded to dtype
    (as `tcdiff_tpu/ops/fused_ln_rotary_matmul.py::_tables`)."""
    a = angles.float()
    return torch.cos(a).to(dtype), signed_pairs(torch.sin(a)).to(dtype)


@functools.lru_cache(maxsize=32)
def cached_rotary_tables(angles: torch.Tensor, dtype: torch.dtype):
    """rotary_tables(angles, dtype) once per angle table and dtype, for the
    CUDA wrappers: the model passes the same shared, never written
    `angle_table` tensor at every call (the cache holds it by identity), so
    a call enqueues no table kernels."""
    return rotary_tables(angles, dtype)


def sa_block_plain(
    x, s1, b1, angles, wq, wk, wv, wfc, s2, b2,
    table=None, trj_dist=None, film_scale=None, film_shift=None,
    *, nhead: int, eps1: float = 1e-5, eps2: float = 1e-6,
):
    """Plain PyTorch version of the block; the oracle of the kernel."""
    dt = x.dtype
    b, L, _ = x.shape
    hd = wq.shape[0]
    dk = hd // nhead
    cos, ssin = rotary_tables(angles, dt)
    y = ln_f32(x, s1, b1, eps1)
    r = y * cos.float() + swap_pairs(y) * ssin.float()
    rc, yc = r.to(dt), y.to(dt)
    heads = lambda t: t.to(dt).reshape(b, L, nhead, dk).transpose(1, 2)  # (b, h, L, dk)
    q, k, v = heads(mm_f32(rc, wq)), heads(mm_f32(rc, wk)), heads(mm_f32(yc, wv))
    logits = torch.matmul((q * (1.0 / dk**0.5)).float(), k.float().transpose(-1, -2))
    if table is not None and trj_dist is not None:
        # UNSCALED q against every bucket of this head: (b, h, L, 10)
        tab = table.to(dt).float().reshape(N_TRJ_BUCKETS, nhead, dk).transpose(0, 1)
        logits = logits + trpe_bias(torch.einsum("bhqd,hnd->bhqn", q.float(), tab), trj_dist)
    p = torch.softmax(logits, dim=-1).to(dt)
    o = torch.matmul(p.float(), v.float()).transpose(1, 2).reshape(b, L, hd)
    sa = ln_f32(mm_f32(o.to(dt), wfc), s2, b2, eps2)
    if film_scale is not None:
        sa = x.float() + (film_scale.float()[:, None, :] + 1.0) * sa + film_shift.float()[:, None, :]
    return sa.to(dt)


_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
    + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 9
)


def _lib():
    lib = _build.load("sa_block")
    fn = lib.tcd_sa_block
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _sa_block_cuda(
    x, s1, b1, angles, wq, wk, wv, wfc, s2, b2, table, trj_dist, film_scale, film_shift,
    *, nhead, eps1, eps2,
):
    code = check_cuda(x, s1=s1, b1=b1, angles=angles, wq=wq, wk=wk, wv=wv, wfc=wfc,
                      s2=s2, b2=b2, table=table, trj_dist=trj_dist,
                      film_scale=film_scale, film_shift=film_shift)
    B, L, d = x.shape
    hd = wq.shape[0]
    dk = hd // nhead
    if d % 2 or hd % nhead or dk > 64 or dk % 4:
        raise ValueError(f"unsupported widths d={d}, h*dk={hd}, nhead={nhead}")
    check_ln_fold(d, x.dtype)
    for name, w, shape in (("wq", wq, (hd, d)), ("wk", wk, (hd, d)), ("wv", wv, (hd, d)),
                           ("wfc", wfc, (d, hd)), ("angles", angles, (L, d))):
        if tuple(w.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(w.shape)}, expected {shape}")
    bias = table is not None and trj_dist is not None
    if bias and (tuple(table.shape) != (N_TRJ_BUCKETS, hd) or tuple(trj_dist.shape) != (B, L, L)):
        raise ValueError("TRPE needs table (10, h*dk) and trj_dist (b, L, L)")
    film = film_scale is not None
    if film and (tuple(film_scale.shape) != (B, d) or tuple(film_shift.shape) != (B, d)):
        raise ValueError("film rows must be (b, d)")

    dt = x.dtype
    f32 = lambda t: t.float().contiguous()
    cos, ssin = rotary_tables(angles, dt)
    ws = [as_t(w, dt) for w in (wq, wk, wv, wfc)]
    tab = as_t(table, dt) if bias else None
    dist = trj_dist.to(torch.int32).contiguous() if bias else None
    fs, fb = (f32(film_scale), f32(film_shift)) if film else (None, None)
    s1f, b1f, s2f, b2f = f32(s1), f32(b1), f32(s2), f32(b2)
    empty = lambda n, t=dt: torch.empty((B, L, n), dtype=t, device=x.device)
    y, r, z = empty(d), empty(d), empty(d, torch.float32)
    q, k, v, o = empty(hd), empty(hd), empty(hd), empty(hd)
    out = torch.empty_like(x)
    rc = _lib()(
        code, ptr(x), ptr(s1f), ptr(b1f), ptr(cos), ptr(ssin), *map(ptr, ws), ptr(s2f),
        ptr(b2f), ptr(tab), ptr(dist), ptr(fs), ptr(fb), B, L, d, hd, nhead, eps1, eps2,
        ptr(y), ptr(r), ptr(q), ptr(k), ptr(v), ptr(o), ptr(z), ptr(out), stream_ptr(x.device),
    )
    raise_on(rc, "sa_block")
    sa_block.launches += 1
    return out


@traced("k1.sa_block")
def sa_block(
    x, s1, b1, angles, wq, wk, wv, wfc, s2, b2,
    table=None, trj_dist=None, film_scale=None, film_shift=None,
    *, nhead: int, eps1: float = 1e-5, eps2: float = 1e-6,
):
    """The self-attention block: CUDA kernel for a CUDA x, plain version
    for a CPU x. See the module docstring for shapes."""
    args = (x, s1, b1, angles, wq, wk, wv, wfc, s2, b2, table, trj_dist, film_scale, film_shift)
    if x.device.type == "cpu":
        return sa_block_plain(*args, nhead=nhead, eps1=eps1, eps2=eps2)
    if x.device.type != "cuda":
        raise ValueError(f"sa_block runs on CPU or CUDA tensors, got {x.device}")
    return _sa_block_cuda(*args, nhead=nhead, eps1=eps1, eps2=eps2)


sa_block.launches = 0  # kernel launches; the plain path does not count
