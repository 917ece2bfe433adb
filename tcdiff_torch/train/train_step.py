"""The train step: loss forward, backward, Adan, EMA.

PyTorch counterpart of `tcdiff_tpu/train/train_step.py`. The EMA is
updated every `ema_interval` steps from the parameters after the optimizer
step. Metrics are device scalars (no host sync): the four weighted loss
terms, their total and the global L2 norm of the gradients (a parameter
without a gradient counts as zeros, as in the JAX gradient tree).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from tcdiff_torch.diffusion.gaussian import GaussianDiffusion
from tcdiff_torch.optim.ema import ema_update
from tcdiff_torch.train.state import TrainState


def make_train_step(diffusion: GaussianDiffusion, optimizer: torch.optim.Optimizer,
                    ema_beta: float = 0.9999, ema_interval: int = 1, device="cuda") -> Callable:
    """Returns train_step(state, x, cond, generator, *, t=None, noise=None,
    keep_mask=None) -> (state, metrics), which updates `state` in place.

    x: (B, dn, seq, nfeats) normalised motion; cond: (B, 301, cond_dim);
    generator: the torch.Generator every draw of the step comes from (t,
    noise, keep_mask and dropout), on `device`. t, noise and keep_mask may
    be injected instead, as `GaussianDiffusion.p_losses` takes them.
    `device` (the GPU unless the caller asks for the CPU) must be the
    diffusion's."""
    device = torch.empty(0, device=device).device  # raises where the device does not exist
    if device != diffusion.device:
        raise ValueError(f"the train step runs on {device}, the diffusion on {diffusion.device}")
    model = diffusion.model
    names = [name for name, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]

    def train_step(state: TrainState, x, cond, generator: Optional[torch.Generator] = None, *,
                   t=None, noise=None, keep_mask=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer than this train step")
        optimizer.zero_grad(set_to_none=True)
        total, parts = diffusion.loss(x, cond, generator, t=t, noise=noise, keep_mask=keep_mask)
        total.backward()
        grads = [p.grad for p in params if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        optimizer.step()
        if state.step % ema_interval == 0:
            ema_update([state.ema_params[n] for n in names], params, ema_beta)
        state.step += 1
        metrics = {k: v.detach() for k, v in parts.items()}
        metrics.update(total=total.detach(), grad_norm=grad_norm)
        return state, metrics

    return train_step
