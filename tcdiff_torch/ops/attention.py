"""Softmax attention with the optional TRPE bias: K11 of the port.

Counterpart of `tcdiff_tpu/ops/fused_attention.py`: `fused_attention` (per
batch and head, with the TRPE bias when given a table and bucket ids) and
`fused_attention_batched` (all heads of a batch element in one TPU program)
compute the same function, and here one CUDA kernel (`csrc/attention.cu`)
serves both through `attention` (the all-heads grid of the TPU is a launch
granularity only).

    o = softmax(T(q * T(scale)) . k^T [+ bias]) . v
    bias[b, h, i, j] = q_unscaled[b, h, i] . table[h, dist[b, i, j]]

q, k, v are (b, h, L, dk) in float32 or bfloat16 (T), Lq and Lk may
differ; table is (h, 10, dk); trj_dist (b, Lq, Lk) integer buckets, of
which those outside [0, 10) add nothing. The logits and softmax run in
f32; the probabilities are rounded to T before the product with v, as the
TPU kernel does. A CUDA tensor takes the kernel, a CPU tensor the plain
version.

The kernel has three bodies (`csrc/attention.cuh`), chosen in C by what a
call holds: `attention_plan` writes that rule out (no wrapper calls it;
`c_plan` asks the C code, `attn_body_launches` reads a library's count of
launches of each bf16 body).
"""

from __future__ import annotations

import ctypes

import torch

from tcdiff_torch.ops import _build
from tcdiff_torch.ops._common import DTYPE_CODE, as_t, raise_on, stream_ptr
from tcdiff_torch.utils.profiling import traced

N_TRJ_BUCKETS = 10  # rows of the shared TRPE embedding table


def trpe_bias(indexed: torch.Tensor, trj_dist: torch.Tensor) -> torch.Tensor:
    """The TRPE logit bias (b, h, Lq, Lk) from q against every bucket,
    indexed (b, h, Lq, 10): bucket trj_dist[b, i, j] of row i, 0 where the
    bucket is out of range (the TPU kernels' predicated adds)."""
    b, h, lq, _ = indexed.shape
    dist = trj_dist.long()[:, None].expand(b, h, lq, trj_dist.shape[-1])
    valid = (dist >= 0) & (dist < N_TRJ_BUCKETS)
    return torch.gather(indexed, 3, dist.clamp(0, N_TRJ_BUCKETS - 1)).masked_fill(~valid, 0.0)


def attention_plain(q, k, v, scale: float, table=None, trj_dist=None):
    """Plain PyTorch version of the kernel; its oracle."""
    dt = q.dtype
    scale_t = torch.tensor(scale, dtype=dt).item()  # the scale rounded to T, as the TPU kernel's
    logits = torch.matmul((q * scale_t).float(), k.float().transpose(-1, -2))
    if table is not None and trj_dist is not None:
        indexed = torch.einsum("bhqd,hnd->bhqn", q.float(), table.to(dt).float())
        logits = logits + trpe_bias(indexed, trj_dist)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(dt)


# The bodies' tiles (csrc/attention.cuh): the FMA body's FQ queries a block
# and FK keys a tile, the mma.sync body's MQ and MK, the wgmma body's AWQ
# and AWK.
BODY_TILES = {"fma": (64, 32), "mma.sync": (64, 64), "wgmma": (128, 128)}
BODIES = ("fma", "mma.sync", "wgmma")  # tcd::AttnBody
SMS = 132  # the H100 SXM's SMs


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def attention_plan(dtype, dk: int, has_table: bool, aligned: bool, Lq: int, rows: int, heads: int,
                   sms: int = SMS) -> dict:
    """The dispatch rule of the attention kernel, as csrc/attention.cuh's
    attn_plan applies it to a call of `rows` batch rows and `heads` heads
    of width dk, Lq queries (against any number of keys): "fma" for
    float32; "wgmma" for bfloat16 at dk = 64 without a TRPE table where
    TMA can address q, k, v and o (aligned: 16-byte aligned, every stride
    a positive multiple of 16 bytes, `tma_aligned`), one persistent launch
    of min(tiles, sms) blocks over tiles of 128 queries; else "mma.sync",
    a block for each 64 queries of a head and row. One launch whatever
    the body.

    Returns dict(body, q_block (queries a block or tile), k_tile (keys a
    tile), grid (x, y, z))."""
    if dtype == torch.float32:
        body = "fma"
    elif dtype == torch.bfloat16:
        body = "wgmma" if dk == 64 and not has_table and aligned else "mma.sync"
    else:
        raise TypeError(f"unsupported dtype {dtype}: the kernel takes float32 or bfloat16")
    q_block, k_tile = BODY_TILES[body]
    if body == "wgmma":
        grid = (min(_cdiv(Lq, q_block) * heads * rows, sms), 1, 1)
    else:
        grid = (_cdiv(Lq, q_block), heads, rows)
    return dict(body=body, q_block=q_block, k_tile=k_tile, grid=grid)


def tma_aligned(*views) -> bool:
    """Whether TMA can address each (b, h, L, dk) view (attention_plan's
    `aligned`): a 16-byte aligned start and its batch, head and row
    strides positive multiples of 16 bytes."""
    return all(t.data_ptr() % 16 == 0 and all(st > 0 and (st * t.element_size()) % 16 == 0 for st in t.stride()[:3])
               for t in views)


def c_plan(dtype, dk: int, has_table: bool, aligned: bool, Lq: int, rows: int, heads: int, sms: int = SMS) -> dict:
    """attention_plan as the C code computes it (tcd_attn_plan of
    csrc/attention.cu). Needs the card's build."""
    fn = _build.load("attention").tcd_attn_plan
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    out = (ctypes.c_int * 6)()
    fn(DTYPE_CODE[dtype], dk, int(has_table), int(aligned), Lq, rows, heads, sms, out)
    return dict(body=BODIES[out[0]], q_block=out[1], k_tile=out[2], grid=(out[3], out[4], out[5]))


def attn_body_launches(lib: str = "attention") -> dict:
    """{"mma.sync": n, "wgmma": n}: the launches of each bf16 attention body
    that csrc/<lib>.cu (attention, sa_block, layer, ca_block,
    sa_block_train or ca_block_train) has enqueued since it was loaded,
    counted by the C code where it launches."""
    out = (ctypes.c_longlong * 2)()
    _build.load(lib).tcd_attn_body_launches(out)
    return {"mma.sync": out[0], "wgmma": out[1]}


class _Strides(ctypes.Structure):
    _fields_ = [("sb", ctypes.c_longlong), ("sh", ctypes.c_longlong), ("sl", ctypes.c_longlong)]


class _AttnArgs(ctypes.Structure):
    """Mirror of `tcd::AttnArgs` (csrc/attention.cuh)."""

    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p), ("v", ctypes.c_void_p), ("o", ctypes.c_void_p),
        ("qs", _Strides), ("ks", _Strides), ("vs", _Strides), ("os", _Strides),
        ("Lq", ctypes.c_int), ("Lk", ctypes.c_int), ("dk", ctypes.c_int), ("scale", ctypes.c_float),
        ("table", ctypes.c_void_p), ("tn", ctypes.c_longlong), ("th", ctypes.c_longlong),
        ("dist", ctypes.c_void_p),
    ]


def _fn():
    fn = _build.load("attention").tcd_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(_AttnArgs), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _strides(t: torch.Tensor) -> _Strides:
    return _Strides(*t.stride()[:3])


def _attention_cuda(q, k, v, scale, table, trj_dist):
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype}: the kernel takes float32 or bfloat16")
    b, h, lq, dk = q.shape
    lk = k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, h, lk, dk) or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}; expected {q.dtype} {(b, h, lk, dk)}")
    if dk > 64 or dk % 4:
        raise ValueError(f"head dim {dk}: the kernel takes a multiple of 4 up to 64")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device}, the current CUDA device is {torch.cuda.current_device()}")
    bias = table is not None and trj_dist is not None
    tab = dist = None
    if bias:
        if tuple(table.shape) != (h, N_TRJ_BUCKETS, dk) or tuple(trj_dist.shape) != (b, lq, lk):
            raise ValueError("TRPE needs table (h, 10, dk) and trj_dist (b, Lq, Lk)")
        if table.device != q.device or trj_dist.device != q.device:
            raise ValueError("table and trj_dist must lie on q's device")
        tab = as_t(table, q.dtype)
        dist = trj_dist.to(torch.int32).contiguous()
    # written as (b, Lq, h, dk), so that merging the heads back is a view
    out = torch.empty((b, lq, h, dk), dtype=q.dtype, device=q.device).transpose(1, 2)
    args = _AttnArgs(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=out.data_ptr(),
        qs=_strides(q), ks=_strides(k), vs=_strides(v), os=_strides(out),
        Lq=lq, Lk=lk, dk=dk, scale=scale,
        table=None if tab is None else tab.data_ptr(), tn=dk, th=N_TRJ_BUCKETS * dk,
        dist=None if dist is None else dist.data_ptr(),
    )
    raise_on(_fn()(DTYPE_CODE[q.dtype], ctypes.byref(args), b, h, stream_ptr(q.device)), "attention")
    attention.launches += 1
    return out


@traced("k11.attention")
def attention(q, k, v, scale: float, table=None, trj_dist=None):
    """Softmax attention ±TRPE: CUDA kernel for CUDA tensors, plain version
    for CPU tensors. See the module docstring for shapes."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, table, trj_dist)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on CPU or CUDA tensors, got {q.device}")
    return _attention_cuda(q, k, v, scale, table, trj_dist)


attention.launches = 0  # kernel launches; the plain path does not count
