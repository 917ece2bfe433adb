"""The train step: loss forward, backward, Adan, EMA.

PyTorch counterpart of `tcdiff_tpu/train/train_step.py`. The EMA is
updated every `ema_interval` steps from the parameters after the optimizer
step. Metrics are device scalars (no host sync): the four weighted loss
terms, their total and the global L2 norm of the gradients (a parameter
without a gradient counts as zeros, as in the JAX gradient tree).

With a data-parallel mesh (`parallel.mesh`) each rank computes the loss
on its rows of the global batch, every draw made at the global batch from
a generator seeded alike on every rank (what the JAX package's replicated
key over a sharded batch gives); after the backward the gradients go
through one flat all-reduce (their mean over the ranks), so that the
optimizer sees the global batch's gradient and every rank's parameters,
Adan moments and EMA stay bit-identical. The gradient norm is taken after
the all-reduce and the metrics are their means over the ranks. An explicit
all-reduce, not `DistributedDataParallel`: the loss calls the model's
`forward_train`, and DDP prepares its reducer only in `forward`.

With tensor parallelism (a state split by `parallel.sharding_rules.
shard_train_state` over the mesh's tp ranks) the model computes each
split layer over this rank's shards (`models/dance_decoder.py`), the
gradients are the shards' own (the dp all-reduce runs over the ranks of
this rank's tp index), Adan and the EMA run on the shards, and the
gradient norm sums the squares of the split gradients over the tp ranks
and counts the whole ones once.

While a torch.profiler session records, a step is the span `train.step`
(`utils/profiling.span`) and its phases `train.loss`, `train.backward`,
`train.allreduce` (with a mesh), `train.grad_norm`, `train.adan` and
`train.ema`, in that order.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from tcdiff_torch.diffusion.gaussian import GaussianDiffusion
from tcdiff_torch.optim.ema import ema_update
from tcdiff_torch.parallel.comm import all_reduce_grads_, all_reduce_mean, tp_sum
from tcdiff_torch.parallel.mesh import Mesh
from tcdiff_torch.train.state import TrainState
from tcdiff_torch.utils.profiling import span, traced


def make_train_step(diffusion: GaussianDiffusion, optimizer: torch.optim.Optimizer,
                    ema_beta: float = 0.9999, ema_interval: int = 1, device="cuda",
                    mesh: Optional[Mesh] = None) -> Callable:
    """Returns train_step(state, x, cond, generator, *, t=None, noise=None,
    keep_mask=None) -> (state, metrics), which updates `state` in place.

    x: (B, dn, seq, nfeats) normalised motion; cond: (B, 301, cond_dim);
    generator: the torch.Generator every draw of the step comes from (t,
    noise, keep_mask and dropout), on `device`. t, noise and keep_mask may
    be injected instead, as `GaussianDiffusion.p_losses` takes them.
    `device` (the GPU unless the caller asks for the CPU) must be the
    diffusion's. With `mesh`, x and cond are this rank's rows of the global
    batch (its dp index's), and t, noise and keep_mask, drawn or injected,
    the global batch's; a model split over the mesh's tp ranks must be
    split before the first step."""
    device = torch.empty(0, device=device).device  # raises where the device does not exist
    if device != diffusion.device:
        raise ValueError(f"the train step runs on {device}, the diffusion on {diffusion.device}")
    model = diffusion.model
    names = [name for name, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]

    def norm(grads, split):
        """The global L2 norm: the split gradients' squares summed over the
        tp ranks, the whole ones' counted once."""
        sq = lambda gs: torch.stack(torch._foreach_norm(gs)).square().sum() if gs else grads[0].new_zeros(())
        whole = [g for g, s in zip(grads, split) if not s]
        parts = [g for g, s in zip(grads, split) if s]
        return (sq(whole) + tp_sum(sq(parts), model.tp_mesh)).sqrt()

    @traced("train.step")
    def train_step(state: TrainState, x, cond, generator: Optional[torch.Generator] = None, *,
                   t=None, noise=None, keep_mask=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer than this train step")
        optimizer.zero_grad(set_to_none=True)
        rows = None if mesh is None else mesh.rows(x.shape[0] * mesh.world)
        with span("train.loss"):
            total, parts = diffusion.loss(x, cond, generator, t=t, noise=noise, keep_mask=keep_mask, rows=rows)
        with span("train.backward", adopt=True):  # the autograd engine's thread opens the kernels' .bwd spans
            total.backward()
        held = [p for p in params if p.grad is not None]
        grads = [p.grad for p in held]
        if mesh is not None:
            with span("train.allreduce"):
                all_reduce_grads_(grads, mesh)
                parts = all_reduce_mean({**parts, "total": total}, mesh)
                total = parts.pop("total")
        with span("train.grad_norm"):
            if model.tp_mesh is None:
                grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            else:
                grad_norm = norm(grads, [hasattr(p, "tp_shard") for p in held])
        with span("train.adan"):
            optimizer.step()
        if state.step % ema_interval == 0:
            with span("train.ema"):
                ema_update([state.ema_params[n] for n in names], params, ema_beta)
        state.step += 1
        metrics = {k: v.detach() for k, v in parts.items()}
        metrics.update(total=total.detach(), grad_norm=grad_norm)
        return state, metrics

    return train_step
