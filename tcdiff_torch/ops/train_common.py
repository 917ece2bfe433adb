"""What the three train-block ops share: the dropout hash, the dropout
sites' salts, the bookkeeping of their autograd Functions, and the pieces
their plain versions take to run over a tensor-parallel rank's shards.

The dropout mask is a function of (seed, salt, element index), the same
murmur3-finalizer hash as `tcdiff_tpu/ops/fused_sa_block_train.py::
_keep_mask`, bit for bit, so that a kernel, its plain version and the JAX
package draw the same mask from the same seeds:

    i    = (row0 + r) * ncols + c                      over a (rows, ncols) array
    h    = i ^ (seed + 0x9E3779B9 * salt)
    h    = (h ^ (h >> 16)) * 0x7FEB352D
    h    = (h ^ (h >> 15)) * 0x846CA68B
    h    = h ^ (h >> 16)
    keep = h >= min(round(rate * 2^32), 2^32 - 1)

all in uint32 arithmetic that wraps mod 2^32. PyTorch has no full uint32
arithmetic on the CPU, so this version computes in int64 and masks to 32
bits after every step; a product of two 32-bit values is split in 16-bit
halves so that no int64 product overflows. Seeds are one uint32 per batch
element, carried as an int64 (b,) tensor. Kept values are scaled by
1/(1-rate) in f32; rate == 0 skips a site.

Under tensor parallelism (a `parallel.mesh.Mesh` of tp > 1, its weights
split the JAX package's way by `parallel.sharding_rules`) the plain
versions run over this rank's heads or feed-forward columns, each block
split Megatron-style at its one all-reduce: the whole input enters this
rank's products through `mm_whole`, the out projection's f32 partial sums
are reduced (`tp_reduce`), and the rest of the block runs whole on every
rank. The dropout masks stay one process's: this rank's heads' salts
(`local_heads`) and its global FF1 columns. Without a mesh each piece is
the single-process arithmetic, bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tcdiff_torch.models.rotary import swap_pairs
from tcdiff_torch.ops._common import DTYPE_CODE, args_struct, as_t, check_cuda, launch
from tcdiff_torch.parallel.comm import tp_copy
from tcdiff_torch.parallel.mesh import Mesh
from tcdiff_torch.ops.sa_block import cached_rotary_tables, rotary_tables

SALT_ATTN = 0x100  # + head index: attention probabilities
SALT_FC = 0x200  # after the attention block's out projection
SALT_OUT = 0x300  # after the attention block's LayerNorm
SALT_FF1 = 0x400  # after the FF block's GELU
SALT_FF2 = 0x500  # after the FF block's linear2

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod 2^32 for a in [0, 2^32) (int64) and a 32-bit constant k,
    without an int64 product above 2^49."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def threshold(rate: float) -> int:
    """The uint32 a hash must reach to keep its element."""
    return min(int(round(rate * 2**32)), 2**32 - 1)


def keep_mask(seeds: torch.Tensor, salt, rows: int, cols: int, rate: float, row0: int = 0, col0: int = 0,
              ncols: Optional[int] = None) -> torch.Tensor:
    """Boolean keep mask over (rows, cols) arrays, one per seed.

    seeds: int64 (b,) holding uint32 values; salt: an int, or an int64
    tensor (h,) for one mask per head. Returns (b, rows, cols), or
    (b, h, rows, cols) for a tensor salt. With `col0` and `ncols` the
    columns are [col0, col0 + cols) of an array ncols wide (a
    tensor-parallel rank's columns), drawn as in the whole array."""
    dev = seeds.device
    ncols = cols if ncols is None else ncols
    idx = (torch.arange(rows, dtype=torch.int64, device=dev)[:, None] + row0) * ncols + col0
    idx = (idx + torch.arange(cols, dtype=torch.int64, device=dev)[None, :]) & _M32
    salt = torch.as_tensor(salt, dtype=torch.int64, device=dev)
    key = (seeds.to(torch.int64)[:, None] + _mul32(salt.reshape(1, -1), _GOLDEN)) & _M32  # (b, h)
    h = idx[None, None] ^ key[:, :, None, None]
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    h = h ^ (h >> 16)
    keep = h >= threshold(rate)
    return keep if salt.dim() else keep[:, 0]


def drop(x: torch.Tensor, seeds: torch.Tensor, salt, rate: float, row0: int = 0, col0: int = 0,
         ncols: Optional[int] = None) -> torch.Tensor:
    """Dropout of f32 x (b, [h,] rows, cols) with the hash mask (its
    columns [col0, col0 + cols) of ncols, see `keep_mask`); identity at
    rate 0."""
    if rate == 0.0:
        return x
    keep = keep_mask(seeds, salt, x.shape[-2], x.shape[-1], rate, row0, col0, ncols)
    return torch.where(keep, x * torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype), torch.zeros((), dtype=x.dtype))


def tp_split(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(the tp size, this rank's tp index); (1, 0) without a mesh."""
    return (1, 0) if mesh is None else (mesh.tp, mesh.tp_rank)


def local_heads(nhead: int, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(this tp rank's heads, the global index of its first one)."""
    tp, j = tp_split(mesh)
    return nhead // tp, j * (nhead // tp)


def mm_whole(a: torch.Tensor, w: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """`mm_f32(a, w)` of a whole input a (in the compute dtype) and, under a
    tp mesh, this rank's rows of w: a enters through `tp_copy` on the f32
    side of its cast, so that the ranks' partial input gradients are summed
    in f32 and rounded to a's dtype once, where one process rounds its
    whole sum. Without a mesh, `mm_f32` itself."""
    return torch.nn.functional.linear(tp_copy(a.float(), mesh), w.to(a.dtype).float())


def local_bias(b: torch.Tensor, n: int, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This tp rank's n entries of a whole bias (b itself without a tp
    split); its gradient, nonzero on these entries alone, summed over the
    tp ranks, so that every rank holds the whole bias's."""
    tp, j = tp_split(mesh)
    return b if tp == 1 else tp_copy(b, mesh).narrow(0, j * n, n)


def film_residual(x, sa, film_scale, film_shift):
    """x + (fs+1) * sa + fb in f32, FiLM rows (b, d)."""
    return x.float() + (film_scale.float()[:, None, :] + 1.0) * sa + film_shift.float()[:, None, :]


def as_uint32_int32(seeds: torch.Tensor) -> torch.Tensor:
    """int64 seeds holding uint32 values -> int32 with the same 32 bits,
    which the CUDA kernels read as uint32."""
    s = seeds.to(torch.int64) & _M32
    return (s - (s >= 2**31).to(torch.int64) * 2**32).to(torch.int32).contiguous()


# csrc/train_common.cuh: the attention blocks' row kernels (K3, K4) cut
# each batch element's L rows into cdiv(L, RCH) chunks, one partial row of
# each parameter gradient a chunk; K5's own row kernels (csrc/ff_tail_train.cu)
# take chunks of FF_RCH rows, and its rows_bwd launch the same count
RCH, FF_RCH = 32, 16


# csrc/gemm_mma.cuh: the weight gradient's 128 x 128 tiles, its chunks a
# multiple of the 64-row K step, about one wave of 264 blocks (2 an SM of
# the H100's 132) in all
WGRAD_TILE, WGRAD_STEP, WGRAD_BLOCKS = 128, 64, 264


def weight_splits(rows: int, n: int, k: int, groups: int = 1) -> int:
    """Row chunks of a CUDA weight gradient (n, k) over `rows` rows, as
    `wgrad_group` in csrc/gemm_mma.cuh cuts them: about one wave of blocks
    over the tiles of the `groups` gradients of one launch, each chunk a
    multiple of the K step."""
    cdiv = lambda a, b: -(-a // b)
    tiles = groups * cdiv(n, WGRAD_TILE) * cdiv(k, WGRAD_TILE)
    target = max(1, min(WGRAD_BLOCKS // tiles, cdiv(rows, WGRAD_STEP)))
    return cdiv(rows, cdiv(cdiv(rows, target), WGRAD_STEP) * WGRAD_STEP)


def weight_scratch(*products) -> int:
    """f32 elements of split-row partials enough for each (rows, n, k) or
    (rows, n, k, groups) weight-gradient launch of a kernel in turn."""
    return max(g * weight_splits(r, n, k, g) * n * k for r, n, k, g in ((*p, 1)[:4] for p in products))


def save_tensors(ctx, ten: dict) -> None:
    """Keep a forward's tensors for its backward through save_for_backward,
    so that autograd frees them once the backward has run (a dict on ctx
    that held the output would be a reference cycle, freed only by the
    cycle collector). The output is left out: no backward kernel reads it."""
    ctx.names = tuple(k for k in ten if k != "out")
    ctx.save_for_backward(*(ten[k] for k in ctx.names))


def saved_tensors(ctx) -> dict:
    """The tensors `save_tensors` kept, by name."""
    return dict(zip(ctx.names, ctx.saved_tensors))


def count_kernel(fn):
    """Give a kernel wrapper its launch counters: forward and backward
    launches; the plain path counts neither."""
    fn.launches = 0
    fn.bwd_launches = 0
    return fn


# --------------------------------------------------- the row kernels alone
# The row kernels of csrc/train_common.cuh by themselves, for tests and
# measurement (csrc/train_rows.cu); K3, K4 and K5 launch them inside their
# sequences and no path calls these wrappers. Each runs its CUDA kernel for
# a CUDA tensor (the backward ones also add their chunk partials, in order)
# and its plain version for a CPU tensor. z, dr, dadd and an f32 resid are
# f32 (b, L, d); x, g and the outputs are in the compute dtype; the LayerNorm
# affine (d,) and the FiLM rows (b, d) are widened to f32; seeds int64 (b,).

def _chain_in(z, s, b, seeds, rate: float, eps: float):
    """drop_FC(z) and its LayerNorm's xhat and rstd, in f32."""
    z2 = drop(z.float(), seeds, SALT_FC, rate)
    mu = z2.mean(-1, keepdim=True)
    rs = torch.rsqrt((z2 * z2).mean(-1, keepdim=True) - mu * mu + eps)
    return z2, (z2 - mu) * rs, rs


def chain_top_fwd_plain(z, x, s, b, film_scale, film_shift, seeds, *, rate: float, eps: float = 1e-6):
    """out = x + (fs+1) * drop_OUT(LN(drop_FC(z); eps) * s + b) + fb, in x's dtype."""
    _, xh, _ = _chain_in(z, s, b, seeds, rate, eps)
    sa = drop(xh * s.float() + b.float(), seeds, SALT_OUT, rate)
    return film_residual(x, sa, film_scale, film_shift).to(x.dtype)


def chain_top_bwd_plain(g, z, s, b, film_scale, seeds, *, rate: float, eps: float = 1e-6):
    """The backward of chain_top_fwd_plain for its cotangent g: (dz in g's
    dtype, dfs and dfb (b, d), ds and db (d,), all f32)."""
    _, xh, rs = _chain_in(z, s, b, seeds, rate, eps)
    gf = g.float()
    sad = drop(xh * s.float() + b.float(), seeds, SALT_OUT, rate)
    gsa = drop(gf * (film_scale.float()[:, None, :] + 1.0), seeds, SALT_OUT, rate)
    gx = gsa * s.float()
    dz2 = rs * (gx - gx.mean(-1, keepdim=True) - xh * (gx * xh).mean(-1, keepdim=True))
    dz = drop(dz2, seeds, SALT_FC, rate).to(g.dtype)
    return dz, (gf * sad).sum(1), gf.sum(1), (gsa * xh).sum((0, 1)), gsa.sum((0, 1))


def rows_bwd_plain(dr, x=None, s=None, eps: float = 1e-5, *, angles=None, dadd=None, resid=None, dtype=None):
    """dy = rot^T(dr) + dadd (rot^T(g) = g*cos + swap(g*ssin), the tables of
    `angles` (L, d) in the output dtype), then with x the LayerNorm's
    backward of dy (x's statistics, scale s) and (ds, db), then + resid:
    (out in x's dtype or `dtype`, ds, db), the last two None without x."""
    dt = x.dtype if x is not None else dtype
    dy = dr.float()
    if angles is not None:
        cos, ssin = rotary_tables(angles, dt)
        dy = dy * cos.float() + swap_pairs(dy * ssin.float())
    if dadd is not None:
        dy = dy + dadd.float()
    ds = db = None
    if x is not None:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        rs = torch.rsqrt((xf * xf).mean(-1, keepdim=True) - mu * mu + eps)
        xh = (xf - mu) * rs
        gx = dy * s.float()
        ds, db = (dy * xh).sum((0, 1)), dy.sum((0, 1))
        dy = rs * (gx - gx.mean(-1, keepdim=True) - xh * (gx * xh).mean(-1, keepdim=True))
    if resid is not None:
        dy = dy + resid.float()
    return dy.to(dt), ds, db


_ROWS_KINDS = {"chain_top_fwd": 0, "chain_top_bwd": 1, "rows_bwd": 2}
_RowsArgs = args_struct(  # RowsArgs in csrc/train_rows.cu
    "RowsArgs",
    ("z", "x", "g", "dr", "cos", "ssin", "dadd", "resT", "res32", "s", "b", "fs", "fb", "seeds", "out", "part",
     "vec"),
    ("kind", "B", "L", "d", "nch", "drop_on"),
    ("eps", "dscale"),
    ("thresh",),
)


def _rows_cuda(kind: str, x_like, ten: dict, B: int, L: int, d: int, seeds=None, rate: float = 0.0,
               eps: float = 0.0):
    if d % 2 or d > 1024:
        raise ValueError(f"the row kernels take an even d <= 1024, got {d}")
    nch = -(-L // RCH)
    dev = x_like.device
    ten.update(part=torch.empty((4, B * nch, d), dtype=torch.float32, device=dev),
               vec=torch.empty(4 * B * d, dtype=torch.float32, device=dev))
    if seeds is not None:
        ten["seeds"] = as_uint32_int32(seeds)
    dims = dict(kind=_ROWS_KINDS[kind], B=B, L=L, d=d, nch=nch, drop_on=int(rate > 0), eps=eps,
                dscale=1.0 / (1.0 - rate), thresh=threshold(rate))
    launch("train_rows", "tcd_train_rows", _RowsArgs, {k: t for k, t in ten.items() if t is not None}, dims,
           x_like, kind)
    return ten["vec"]


def _rows_device(t, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {t.device}")
    return t.device.type


def _f32(t):
    return None if t is None else as_t(t, torch.float32)


def _check_rows(first, **tensors):
    check_cuda(first, **tensors)
    B, L, d = first.shape
    for name, t in tensors.items():
        if t is not None and t.dim() == 3 and tuple(t.shape) != (B, L, d):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(B, L, d)}")
        if t is not None and t.dim() == 2 and tuple(t.shape) not in ((B, d), (L, d)):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(B, d)} or {(L, d)}")
        if t is not None and t.dim() == 1 and tuple(t.shape) != (d,) and name != "seeds":
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(d,)}")
    return B, L, d


def chain_top_fwd(z, x, s, b, film_scale, film_shift, seeds, *, rate: float, eps: float = 1e-6):
    """The chain top's forward row kernel: see chain_top_fwd_plain."""
    if _rows_device(x, "chain_top_fwd") == "cpu":
        return chain_top_fwd_plain(z, x, s, b, film_scale, film_shift, seeds, rate=rate, eps=eps)
    B, L, d = _check_rows(x, z=z, s=s, b=b, film_scale=film_scale, film_shift=film_shift, seeds=seeds)
    out = torch.empty_like(x)
    _rows_cuda("chain_top_fwd", x, dict(z=_f32(z), x=x, s=_f32(s), b=_f32(b), fs=_f32(film_scale),
                                        fb=_f32(film_shift), out=out), B, L, d, seeds, rate, eps)
    chain_top_fwd.launches += 1
    return out


def chain_top_bwd(g, z, s, b, film_scale, seeds, *, rate: float, eps: float = 1e-6):
    """The chain top's backward row kernel: see chain_top_bwd_plain."""
    if _rows_device(g, "chain_top_bwd") == "cpu":
        return chain_top_bwd_plain(g, z, s, b, film_scale, seeds, rate=rate, eps=eps)
    B, L, d = _check_rows(g, z=z, s=s, b=b, film_scale=film_scale, seeds=seeds)
    dz = torch.empty_like(g)
    vec = _rows_cuda("chain_top_bwd", g, dict(g=g, z=_f32(z), s=_f32(s), b=_f32(b), fs=_f32(film_scale), out=dz),
                     B, L, d, seeds, rate, eps)
    chain_top_bwd.launches += 1
    vec = vec.view(4, B, d)
    return dz, vec[0], vec[1], vec[2, 0], vec[3, 0]


def rows_bwd(dr, x=None, s=None, eps: float = 1e-5, *, angles=None, dadd=None, resid=None, dtype=None):
    """The bottom of a block's backward, the row kernel: see rows_bwd_plain."""
    if _rows_device(dr, "rows_bwd") == "cpu":
        return rows_bwd_plain(dr, x, s, eps, angles=angles, dadd=dadd, resid=resid, dtype=dtype)
    dt = x.dtype if x is not None else dtype
    if dt not in DTYPE_CODE or (x is not None) != (s is not None):
        raise ValueError("rows_bwd takes x with its scale s, or neither and an output dtype")
    lead = x if x is not None else torch.empty((1, 1, 1), dtype=dt, device=dr.device)
    B, L, d = _check_rows(dr, ln_input=x, dadd=dadd, resid=resid, angles=angles)
    if x is not None and not x.is_contiguous():
        raise ValueError("x must be contiguous")
    cos, ssin = cached_rotary_tables(angles, dt) if angles is not None else (None, None)
    res32 = resid if resid is not None and resid.dtype == torch.float32 and dt != torch.float32 else None
    resT = resid if resid is not None and res32 is None else None
    out = torch.empty(dr.shape, dtype=dt, device=dr.device)
    vec = _rows_cuda("rows_bwd", lead, dict(dr=_f32(dr), cos=cos, ssin=ssin, dadd=_f32(dadd), x=x, s=_f32(s),
                                           resT=None if resT is None else resT.to(dt).contiguous(),
                                           res32=res32, out=out), B, L, d, eps=eps)
    rows_bwd.launches += 1
    return (out, vec[:d], vec[d:2 * d]) if x is not None else (out, None, None)


chain_top_fwd.launches = chain_top_bwd.launches = rows_bwd.launches = 0  # kernel launches; not the plain path
