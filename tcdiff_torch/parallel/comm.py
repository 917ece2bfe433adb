"""The port's collectives, over a `parallel.mesh.Mesh`.

Over the data-parallel axis (`mesh.group`):

  * `all_reduce_grads_`: the gradient all-reduce of a data-parallel step,
    every gradient in one flat buffer, summed and then divided by the dp
    size (gloo has no AVG), written back in place;
  * `all_reduce_mean`: the mean over the ranks of a few scalars (the loss
    terms a rank computed on its rows; a non-finite one makes every rank's
    mean non-finite, so every rank takes the same halt decision);
  * `all_gather_rows`: the rows of every rank, in rank order (the global
    batch from this rank's rows);
  * `from_previous`: the neighbour exchange of the sharded long sampler,
    each rank sending a tensor to the next one and receiving the previous
    one's (`dist.batch_isend_irecv`).

Over the tensor-parallel axis (`mesh.tp_group`), the four operators of a
Megatron split, as autograd Functions, each along the last dim:

  * `tp_copy`: the identity, whose backward sums the gradient over the tp
    ranks (where a whole input enters a split computation);
  * `tp_reduce`: the sum over the tp ranks, whose backward is the identity
    (where the partial sums of a split computation leave it);
  * `tp_gather`: the concatenation of every tp rank's slice, whose
    backward keeps this rank's slice of the gradient;
  * `tp_slice`: this rank's slice, whose backward gathers the gradient;

and, outside autograd, `tp_sum` and `tp_parts` (every tp rank's tensor).
Their sums and gathers run in float32 (a lower-precision tensor is widened
for the wire and rounded back once).

A mesh without the axis's group (one process, or a size of 1 on that
axis) makes each of them the identity. Each collective that runs adds one
to `COUNTS["{name} {backend}"]` (`collective_counts`), so that a run can
show which collectives it issued, and over which backend. gloo's collectives read host
memory, so with the gloo backend a tensor on the card goes through the
host: `_wire` makes that copy, for every collective, here and nowhere
else.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from tcdiff_torch.parallel.mesh import Mesh

COUNTS: collections.Counter = collections.Counter()


def _count(name: str, group) -> None:
    COUNTS[f"{name} {dist.get_backend(group)}"] += 1


def collective_counts() -> Dict[str, int]:
    """{"name backend": the collectives of that name this process issued}."""
    return dict(sorted(COUNTS.items()))


def _wire(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tensor the backend reads: a host copy of a card tensor under
    gloo, else t itself (contiguous)."""
    if mesh.backend == "gloo" and t.device.type != "cpu":
        return t.detach().to("cpu")
    return t.contiguous()


def all_reduce_grads_(grads: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Replace every gradient by its mean over the dp ranks: one flat
    buffer, summed, divided by the dp size, copied back. The gradients must
    share one dtype and device (the port's parameters are float32)."""
    if mesh.group is None or not grads:
        return
    if len({(g.dtype, g.device) for g in grads}) != 1:
        raise ValueError("the gradient all-reduce takes gradients of one dtype on one device")
    flat = _wire(torch.cat([g.reshape(-1) for g in grads]), mesh)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    _count("all_reduce_grads_", mesh.group)
    flat = (flat / mesh.world).to(grads[0].device)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def all_reduce_mean(values: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """{name: scalar} -> the same names, each the mean over the ranks, as
    float64 scalars on the scalars' device (one all-reduce for all of
    them)."""
    if mesh.group is None:
        return values
    names = list(values)
    dev = values[names[0]].device
    buf = _wire(torch.stack([values[k].detach().double().reshape(()) for k in names]), mesh)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    _count("all_reduce_mean", mesh.group)
    buf = (buf / mesh.world).to(dev)
    return {k: buf[i] for i, k in enumerate(names)}


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's rows of x (equal counts), concatenated in rank order
    along axis 0, on x's device."""
    if mesh.group is None:
        return x
    wire = _wire(x, mesh)
    parts = [torch.empty_like(wire) for _ in range(mesh.world)]
    dist.all_gather(parts, wire, group=mesh.group)
    _count("all_gather_rows", mesh.group)
    return torch.cat(parts).to(x.device)


def from_previous(send: torch.Tensor, mesh: Mesh) -> Optional[torch.Tensor]:
    """Send `send` to the next rank and return the previous rank's (None
    on rank 0; the last rank sends nothing). Every rank of the mesh must
    call it, with tensors of one shape and dtype."""
    if mesh.group is None or mesh.world == 1:
        return None
    wire = _wire(send, mesh)
    recv = torch.empty_like(wire) if mesh.rank > 0 else None
    ops = []
    if mesh.rank + 1 < mesh.world:
        ops.append(dist.P2POp(dist.isend, wire, mesh.rank + 1, mesh.group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv, mesh.rank - 1, mesh.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    _count("from_previous", mesh.group)
    return None if recv is None else recv.to(send.device)


# ------------------------------------------------------ tensor parallelism
def _tp_wire(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A float32 tensor for a tp collective that owns its memory (never
    t's own storage, which an in-place collective would overwrite)."""
    wire = _wire(t.detach().float(), mesh)
    return wire.clone() if wire.data_ptr() == t.data_ptr() else wire


def tp_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of t over the tp ranks, in t's dtype and on its device (t
    itself without a tp group)."""
    if mesh is None or mesh.tp_group is None:
        return t
    wire = _tp_wire(t, mesh)
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=mesh.tp_group)
    _count("tp_sum", mesh.tp_group)
    return wire.to(device=t.device, dtype=t.dtype)


def tp_parts(t: torch.Tensor, mesh: Optional[Mesh]) -> list:
    """Every tp rank's t (one shape and dtype on all), in tp order, in t's
    dtype and on its device ([t] without a tp group)."""
    if mesh is None or mesh.tp_group is None:
        return [t]
    wire = _tp_wire(t.contiguous(), mesh)
    parts = [torch.empty_like(wire) for _ in range(mesh.tp)]
    dist.all_gather(parts, wire, group=mesh.tp_group)
    _count("tp_parts", mesh.tp_group)
    return [p.to(device=t.device, dtype=t.dtype) for p in parts]


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return tp_sum(g, ctx.mesh), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return tp_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[-1]
        return torch.cat(tp_parts(x, mesh), dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.mesh.tp_rank * ctx.n, ctx.n).contiguous(), None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        n = x.shape[-1] // mesh.tp
        return x.narrow(-1, mesh.tp_rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(tp_parts(g, ctx.mesh), dim=-1), None


def _tp_on(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.tp > 1


def tp_copy(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """x; its gradient summed over the tp ranks."""
    return _Copy.apply(x, mesh) if _tp_on(mesh) else x


def tp_reduce(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of x over the tp ranks; its gradient passed as it is."""
    return _Reduce.apply(x, mesh) if _tp_on(mesh) else x


def tp_gather(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every tp rank's x concatenated along the last dim, in tp order; the
    gradient's slice of this rank passed back."""
    return _Gather.apply(x, mesh) if _tp_on(mesh) else x


def tp_slice(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This tp rank's slice of x along the last dim (which tp divides);
    the gradient gathered."""
    if not _tp_on(mesh):
        return x
    if x.shape[-1] % mesh.tp:
        raise ValueError(f"a last dim of {x.shape[-1]} does not divide over {mesh.tp} tensor-parallel ranks")
    return _Slice.apply(x, mesh)
