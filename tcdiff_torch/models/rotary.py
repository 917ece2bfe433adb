"""Rotary position embedding on the FULL model vector, before projection.

PyTorch counterpart of `tcdiff_tpu/models/rotary.py`: frequencies span the
model dim, channels rotate in adjacent (even, odd) pairs, and the rotation
is applied to the 512-d layer input before the q/k projections. The angle
table is the same numpy table as the JAX package's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn



def inv_freq_buffer(dim: int) -> np.ndarray:
    """The reference RotaryEmbedding's `freqs` buffer: 1 / 10000^(2i/dim),
    computed in float32 throughout so that it matches the reference's
    buffer bit for bit."""
    exponent = np.arange(0, dim, 2, dtype=np.float32) / np.float32(dim)
    return (np.float32(1.0) / np.float32(10000.0) ** exponent).astype(np.float32)


def rotary_freqs(seq_len: int, dim: int, theta: float = 10000.0) -> np.ndarray:
    """Angle table (seq_len, dim): outer(position, inv_freq) with every
    frequency duplicated into adjacent channel pairs (float32)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    angles = np.outer(np.arange(seq_len), inv_freq)
    return np.repeat(angles, 2, axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=32)
def angle_table(seq_len: int, dim: int, device) -> torch.Tensor:
    """`rotary_freqs` as a tensor on `device`, copied there once per
    (seq_len, dim, device): a copy from host memory inside the sampling
    loop would stall the host on the device. Shared: never write to it."""
    return torch.from_numpy(rotary_freqs(seq_len, dim)).to(device)


def swap_pairs(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (x1, x0, x3, x2, ...)."""
    return x.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)


def signed_pairs(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x0, x1, -x2, x3, ...): the rotate-half
    signs, so that rotate_half(x) == swap_pairs(x) * signed_pairs(1)."""
    x2 = x.unflatten(-1, (-1, 2))
    return torch.stack([-x2[..., 0], x2[..., 1]], dim=-1).flatten(-2)


def apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (..., S, D); angles: (S, D). The table is cast to x's dtype
    BEFORE cos/sin, as the JAX package does (visible in bf16)."""
    a = angles.to(x.dtype)
    return x * torch.cos(a) + swap_pairs(x) * signed_pairs(torch.sin(a))


class RotaryEmbedding(nn.Module):
    """Holds the reference's `freqs` buffer so state dicts line up; the
    angle tables themselves come from `rotary_freqs`."""

    def __init__(self, dim: int):
        super().__init__()
        self.register_buffer("freqs", torch.from_numpy(inv_freq_buffer(dim)))
