"""Exponential moving average of the parameters: e = e * beta + (1 - beta) * p,
in place over all tensors at once (`tcdiff_tpu/optim/ema.py`)."""

from __future__ import annotations

from typing import Sequence

import torch


@torch.no_grad()
def ema_update(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor], beta: float = 0.9999) -> None:
    torch._foreach_mul_(ema, beta)
    torch._foreach_add_(ema, params, alpha=1.0 - beta)
