"""Data and tensor parallelism over torch.distributed: the process group,
the (dp, tp) mesh, and the rows of a global batch that each rank holds.

The counterpart of `tcdiff_tpu/parallel/mesh.py`. The reference's only
parallelism is DDP over NCCL; the JAX package lays the devices out as a
(dp, tp) grid (`make_mesh`: a row-major reshape), the batch over `dp`
(`NamedSharding(P("dp"))`) and, with tp > 1, its parameters split
Megatron-style over `tp` (`sharding_rules`). Here each rank is one
process, and the grid is row-major as JAX's: global rank g has the
data-parallel index g // tp and the tensor-parallel index g % tp. A rank
holds the rows [i B/dp, (i+1) B/dp) of each global batch of B (i its dp
index; its tp peers hold the same rows) and a generator seeded as every
other rank's, so that every random draw is made at the global batch and
each rank keeps its rows (`draw`). The collectives are `parallel.comm`'s.

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
    """The layout of one rank. `rank`, `world` and `group` are the
    data-parallel axis: this rank's dp index, the dp size and the group of
    the ranks that share its tp index (None: one process, or dp = 1 beside
    tp > 1; a joined world of one keeps its world group, as every joined
    dp world does).
    `tp_rank`, `tp` and `tp_group` are the tensor-parallel axis: its tp
    index, the tp size and the group of the ranks that share its dp index
    (None: tp = 1)."""

    rank: int
    world: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    tp_rank: int = 0
    tp: int = 1
    tp_group: Optional[dist.ProcessGroup] = None

    @property
    def backend(self) -> Optional[str]:
        g = self.group if self.group is not None else self.tp_group
        return None if g is None else dist.get_backend(g)

    @property
    def host0(self) -> bool:
        """Whether this is global rank 0, the rank that writes the files."""
        return self.rank == 0 and self.tp_rank == 0

    def rows(self, n: int) -> Rows:
        """This rank's rows of a global batch of n; n must divide."""
        if n % self.world:
            raise ValueError(f"a batch of {n} does not divide over {self.world} data-parallel ranks")
        per = n // self.world
        return Rows(self.rank * per, (self.rank + 1) * per, n)


def _groups(lists, me: int, world: int):
    """Create a group for each rank list that is neither the whole world
    nor one rank (every rank creates every group, in one order, as
    `dist.new_group` requires) and return the one holding `me`: the
    world's own group where a list is the whole world (a joined world of
    one too, whose collectives run over its backend), None where it is
    `me` alone in a larger world."""
    mine = None
    for ranks in lists:
        if len(ranks) == world:
            group = dist.group.WORLD
        elif len(ranks) == 1:
            group = None
        else:
            group = dist.new_group(ranks)
        if me in ranks:
            mine = group
    return mine


def make_mesh(dp: int = -1, tp: int = 1, device="cuda") -> Mesh:
    """The (dp, tp) mesh of this rank: the world as a row-major dp x tp
    grid, as the JAX package's `make_mesh` reshapes its devices (global
    rank g: dp index g // tp, tp index g % tp). dp=-1 means the world size
    over tp; dp x tp must equal the world size (ValueError otherwise)."""
    joined = dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    if tp < 1:
        raise ValueError(f"tp={tp}: the tensor-parallel size must be at least 1")
    if dp == -1:
        if world % tp:
            raise ValueError(f"tp={tp} does not divide the world of {world} rank(s)")
        dp = world // tp
    if dp * tp != world:
        grid = f"dp={dp}" if tp == 1 else f"dp={dp} x tp={tp} = {dp * tp}"
        raise ValueError(f"{grid} but the world has {world} rank(s): launch one process a rank "
                         f"(torchrun --nproc_per_node {dp * tp} ...)")
    me = dist.get_rank() if joined else 0
    dp_group = tp_group = None
    if joined:
        dp_group = _groups([[i * tp + j for i in range(dp)] for j in range(tp)], me, world)
        if tp > 1:
            tp_group = _groups([[i * tp + j for j in range(tp)] for i in range(dp)], me, world)
    return Mesh(me // tp, dp, torch.device(device), dp_group, me % tp, tp, tp_group)


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
