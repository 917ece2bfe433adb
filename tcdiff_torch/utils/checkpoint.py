"""Checkpoints of the trainers: `torch.save` in the reference's layouts.

The port of `tcdiff_tpu/utils/checkpoint.py`, without orbax:

  * the denoiser: `{model_state_dict, ema_state_dict, optimizer_state_dict,
    normalizer, step}`, the reference's `TCDiff.py:266-274` keys plus the
    step. Unlike the reference, which saves the optimizer state but never
    loads it (`TCDiff.py:113-120`), `restore_train_state` brings back the
    parameters, the EMA, the optimizer's moments and the step, as the JAX
    package's restore does (`checkpoint.py:92`);
  * the DBN: `{net, optimizer, scheduler, step, normalizer}`, the
    reference's `TrajDecoder/train_traj.py:281-282` `{'net': state_dict}`
    with the trainer's state beside it, so that
    `interop/from_jax.load_reference_traj` reads it.

The normalizer is stored as plain float32 arrays (`scale`, `offset`), not
as the reference's pickled object. A file is written under a temporary
name and renamed, so a reader never sees half of one. Under data
parallelism only rank 0 writes (every rank holds the same state); every
rank reads. A state split over tensor-parallel ranks is gathered by every
rank (`parallel.sharding_rules.gather_train_state`, a collective) and
written whole by rank 0, so a file has one layout at every tp; it is
restored into a whole state, which `shard_train_state` then splits at any
tp. Checkpoints are
unpickled (`weights_only=False`: the arrays are numpy); load only files
this program wrote.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from tcdiff_torch.data.normalizer import Normalizer
from tcdiff_torch.parallel.mesh import is_host0
from tcdiff_torch.parallel.sharding_rules import gather_train_state


def _normalizer_arrays(normalizer: Optional[Normalizer]) -> Optional[dict]:
    return None if normalizer is None else {k: np.asarray(v, np.float32) for k, v in normalizer.to_numpy().items()}


def _save(payload: dict, path: Path) -> str:
    """Write `payload` to `path` on rank 0 (`parallel.mesh.is_host0`);
    return the path on every rank."""
    if not is_host0():
        return str(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return str(path)


def save_checkpoint(directory: str, step: int, state, normalizer: Optional[Normalizer] = None) -> str:
    """Write a denoiser `TrainState` to `{directory}/ckpt_{step}.pt`;
    returns the path. A state split over tp ranks is gathered first: every
    rank calls this then."""
    names = [name for name, _ in state.model.named_parameters()]
    model_sd, ema, opt_sd = state.model.state_dict(), state.ema_params, state.optimizer.state_dict()
    if state.model.tp_mesh is not None:
        whole = gather_train_state(state)
        model_sd, ema, opt_sd = {**model_sd, **whole["params"]}, whole["ema"], whole["optimizer"]
    payload = {
        "model_state_dict": model_sd,
        "ema_state_dict": {name: ema[name] for name in names},
        "optimizer_state_dict": opt_sd,
        "normalizer": _normalizer_arrays(normalizer),
        "step": int(state.step),
    }
    return _save(payload, Path(directory) / f"ckpt_{step}.pt")


def save_traj_checkpoint(directory: str, step: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                         scheduler, normalizer: Optional[Normalizer] = None) -> str:
    """Write the DBN trainer's state to `{directory}/ckpt_{step}.pt`;
    returns the path."""
    payload = {
        "net": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "scheduler": scheduler.state_dict(),
        "step": int(step),
        "normalizer": _normalizer_arrays(normalizer),
    }
    return _save(payload, Path(directory) / f"ckpt_{step}.pt")


def latest_checkpoint(directory: str) -> Optional[str]:
    """The `ckpt_{step}.pt` of `directory` with the largest step, or None."""
    d = Path(directory)
    if not d.is_dir():
        return None
    steps = []
    for p in d.glob("ckpt_*.pt"):
        try:
            steps.append((int(p.stem.split("_")[1]), p))
        except ValueError:
            continue
    return str(max(steps)[1]) if steps else None


def load_checkpoint(path: str, device="cuda") -> dict:
    """The payload of a checkpoint, its tensors on the CPU and its
    normalizer (where it has one) a `Normalizer` on `device`."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    norm = payload.get("normalizer")
    if norm is not None:
        payload["normalizer"] = Normalizer.from_torch_state(norm["scale"], norm["offset"], device=device)
    return payload


def restore_train_state(path: str, state):
    """Load a denoiser checkpoint into a whole `state` (shapes must match;
    split it after, `shard_train_state`): the parameters, the EMA, the
    optimizer's state and the step. Returns (state, normalizer or None),
    the normalizer on the model's device."""
    if state.model.tp_mesh is not None:
        raise ValueError("restore a checkpoint into the whole state, then split it (shard_train_state)")
    device = next(state.model.parameters()).device
    payload = load_checkpoint(path, device=device)
    state.model.load_state_dict(payload["model_state_dict"], strict=True)
    ema = payload["ema_state_dict"]
    if set(ema) != set(state.ema_params):
        raise ValueError(f"{path}: the EMA holds other parameters than the state")
    with torch.no_grad():
        for name, t in state.ema_params.items():
            t.copy_(ema[name])
    state.optimizer.load_state_dict(payload["optimizer_state_dict"])
    state.step = int(payload["step"])
    return state, payload["normalizer"]
