"""Training state: the step count, the model, the EMA shadow of its
parameters and the optimizer (whose state holds Adan's moments).

PyTorch counterpart of `tcdiff_tpu/train/state.py`. Where the JAX state is
an immutable tree, this one holds the model and the optimizer themselves
and the train step updates them in place. Where the JAX state's arrays
carry their sharding, here the model carries the mesh it is split over
(`model.tp_mesh`) and each split parameter its `Shard`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from tcdiff_torch.models.dance_decoder import DanceDecoder


@dataclasses.dataclass
class TrainState:
    step: int
    model: DanceDecoder
    ema_params: Dict[str, torch.Tensor]  # by parameter name
    optimizer: torch.optim.Optimizer


def create_train_state(model: DanceDecoder, optimizer: torch.optim.Optimizer) -> TrainState:
    """Step 0, the EMA a copy of the parameters. The optimizer must hold
    exactly the model's parameters."""
    params = {id(p) for p in model.parameters()}
    held = {id(p) for group in optimizer.param_groups for p in group["params"]}
    if params != held:
        raise ValueError("the optimizer must hold exactly the model's parameters")
    ema = {name: p.detach().clone() for name, p in model.named_parameters()}
    return TrainState(step=0, model=model, ema_params=ema, optimizer=optimizer)
