"""What the three train-block ops share: the dropout hash, the dropout
sites' salts, and the bookkeeping of their autograd Functions.

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
"""

from __future__ import annotations

import torch

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


def keep_mask(seeds: torch.Tensor, salt, rows: int, cols: int, rate: float, row0: int = 0) -> torch.Tensor:
    """Boolean keep mask over (rows, cols) arrays, one per seed.

    seeds: int64 (b,) holding uint32 values; salt: an int, or an int64
    tensor (h,) for one mask per head. Returns (b, rows, cols), or
    (b, h, rows, cols) for a tensor salt."""
    dev = seeds.device
    idx = (torch.arange(rows, dtype=torch.int64, device=dev)[:, None] + row0) * cols
    idx = (idx + torch.arange(cols, dtype=torch.int64, device=dev)[None, :]) & _M32
    salt = torch.as_tensor(salt, dtype=torch.int64, device=dev)
    key = (seeds.to(torch.int64)[:, None] + _mul32(salt.reshape(1, -1), _GOLDEN)) & _M32  # (b, h)
    h = idx[None, None] ^ key[:, :, None, None]
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    h = h ^ (h >> 16)
    keep = h >= threshold(rate)
    return keep if salt.dim() else keep[:, 0]


def drop(x: torch.Tensor, seeds: torch.Tensor, salt, rate: float, row0: int = 0) -> torch.Tensor:
    """Dropout of f32 x (b, [h,] rows, cols) with the hash mask; identity at rate 0."""
    if rate == 0.0:
        return x
    keep = keep_mask(seeds, salt, x.shape[-2], x.shape[-1], rate, row0)
    return torch.where(keep, x * torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype), torch.zeros((), dtype=x.dtype))


def film_residual(x, sa, film_scale, film_shift):
    """x + (fs+1) * sa + fb in f32, FiLM rows (b, d)."""
    return x.float() + (film_scale.float()[:, None, :] + 1.0) * sa + film_shift.float()[:, None, :]


def as_uint32_int32(seeds: torch.Tensor) -> torch.Tensor:
    """int64 seeds holding uint32 values -> int32 with the same 32 bits,
    which the CUDA kernels read as uint32."""
    s = seeds.to(torch.int64) & _M32
    return (s - (s >= 2**31).to(torch.int64) * 2**32).to(torch.int32).contiguous()


RCH = 16  # rows per block of the CUDA row kernels (csrc/train_common.cuh)


# csrc/gemm_mma.cuh: the weight gradient's 128 x 128 tiles, its chunks a
# multiple of the 64-row K step, about one wave of 264 blocks (2 an SM of
# the H100's 132) in all
WGRAD_TILE, WGRAD_STEP, WGRAD_BLOCKS = 128, 64, 264


def weight_splits(rows: int, n: int, k: int) -> int:
    """Row chunks of a CUDA weight gradient (n, k) over `rows` rows, as
    `wgrad` in csrc/gemm_mma.cuh cuts them: about one wave of blocks over
    the gradient's tiles, each chunk a multiple of the K step."""
    cdiv = lambda a, b: -(-a // b)
    tiles = cdiv(n, WGRAD_TILE) * cdiv(k, WGRAD_TILE)
    target = max(1, min(WGRAD_BLOCKS // tiles, cdiv(rows, WGRAD_STEP)))
    return cdiv(rows, cdiv(cdiv(rows, target), WGRAD_STEP) * WGRAD_STEP)


def weight_scratch(*products) -> int:
    """f32 elements of split-row partials enough for each (rows, n, k)
    weight gradient of a kernel in turn."""
    return max(weight_splits(r, n, k) * n * k for r, n, k in products)


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
