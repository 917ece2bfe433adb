"""Data parallelism over torch.distributed: the process group, the mesh,
and the rows of a global batch that each rank holds.

The counterpart of `tcdiff_tpu/parallel/mesh.py`. The reference's only
parallelism is DDP over NCCL; the JAX package lays the batch over a `dp`
mesh axis (`NamedSharding(P("dp"))`) with replicated parameters and a
replicated key. Here each rank is one process: it holds a copy of the
parameters, the rows [r B/N, (r+1) B/N) of each global batch of B, and a
generator seeded as every other rank's, so that every random draw is made
at the global batch and each rank keeps its rows (`draw`). The
collectives are `parallel.comm`'s.

`init_distributed` joins the group torchrun describes (RANK, WORLD_SIZE,
LOCAL_RANK); without that environment the program is one process with no
group. The backend follows the device asked for: NCCL for `cuda`, gloo
for `cpu`; a caller may name another one (two ranks on one card need gloo:
NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def init_distributed(device="cuda", backend: Optional[str] = None,
                     init_method: Optional[str] = None) -> torch.device:
    """Join the process group torchrun's environment describes and return
    this rank's device: `cuda` becomes `cuda:{LOCAL_RANK}`, an indexed
    device (`cuda:0`) or `cpu` stays as given. The backend is NCCL for a
    CUDA device and gloo for the CPU unless `backend` names one;
    `init_method` defaults to `env://` (MASTER_ADDR, MASTER_PORT). Without
    torchrun's environment nothing is joined (one process, no group).
    Joining twice is a no-op."""
    dev = torch.device(device)
    env = {k: os.environ.get(k) for k in _TORCHRUN_ENV}
    if any(v is None for v in env.values()):
        return dev
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(env["LOCAL_RANK"]))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method=init_method or "env://", rank=int(env["RANK"]),
                                world_size=int(env["WORLD_SIZE"]))
    return dev


def is_host0() -> bool:
    """True on rank 0, and in a program that joined no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


@dataclasses.dataclass(frozen=True)
class Rows:
    """This rank's rows [start, stop) of a global batch of `total`."""

    start: int
    stop: int
    total: int

    def take(self, a):
        """This rank's rows of a global array or tensor (axis 0)."""
        if a.shape[0] != self.total:
            raise ValueError(f"expected a global batch of {self.total} rows, got {a.shape[0]}")
        return a[self.start:self.stop]


def draw(fn: Callable, shape, rows: Optional[Rows] = None) -> torch.Tensor:
    """fn(shape); with `rows`, fn drawn at the global batch and this rank's
    rows kept, so that every rank's draws advance one generator alike and
    equal the rows one process draws."""
    if rows is None:
        return fn(tuple(shape))
    return fn((rows.total,) + tuple(shape[1:]))[rows.start:rows.stop]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data-parallel layout of one rank: its rank, the world size, its
    device and its process group (None: one process, no collectives)."""

    rank: int
    world: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    def rows(self, n: int) -> Rows:
        """This rank's rows of a global batch of n; n must divide."""
        if n % self.world:
            raise ValueError(f"a batch of {n} does not divide over {self.world} data-parallel ranks")
        per = n // self.world
        return Rows(self.rank * per, (self.rank + 1) * per, n)


def make_mesh(dp: int = -1, tp: int = 1, device="cuda") -> Mesh:
    """The mesh of this rank: dp=-1 means the world size, any other dp must
    equal it; tp > 1 (tensor parallelism) is not ported."""
    if tp != 1:
        raise NotImplementedError(f"tp={tp}: tensor parallelism is not ported yet (ROADMAP queue 1 item 9)")
    joined = dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    if dp not in (-1, world):
        raise ValueError(f"dp={dp} but the world has {world} rank(s): launch one process a data-parallel rank "
                         f"(torchrun --nproc_per_node {dp} ...)")
    return Mesh(dist.get_rank() if joined else 0, world, torch.device(device),
                dist.group.WORLD if joined else None)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of every array or tensor, and of every list of
    names (one a row), in a (nested) dict, list or tuple, as
    `NamedSharding(P("dp"))` lays a batch out; other leaves pass
    unchanged."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        return mesh.rows(batch.shape[0]).take(batch)
    if isinstance(batch, list) and batch and all(isinstance(v, str) for v in batch):  # names, one a row
        rows = mesh.rows(len(batch))
        return batch[rows.start:rows.stop]
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return batch
