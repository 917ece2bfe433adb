"""The port's collectives, over a `parallel.mesh.Mesh`.

  * `all_reduce_grads_`: the gradient all-reduce of a data-parallel step,
    every gradient in one flat buffer, summed and then divided by the world
    size (gloo has no AVG), written back in place;
  * `all_reduce_mean`: the mean over the ranks of a few scalars (the loss
    terms a rank computed on its rows; a non-finite one makes every rank's
    mean non-finite, so every rank takes the same halt decision);
  * `all_gather_rows`: the rows of every rank, in rank order (the global
    batch from this rank's rows);
  * `from_previous`: the neighbour exchange of the sharded long sampler,
    each rank sending a tensor to the next one and receiving the previous
    one's (`dist.batch_isend_irecv`).

A mesh without a group (one process) makes each of them the identity.
gloo's point-to-point and gather read host memory, so with the gloo
backend a tensor on the card goes through the host: `_wire` makes that
copy, for every collective, here and nowhere else.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from tcdiff_torch.parallel.mesh import Mesh


def _wire(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tensor the backend reads: a host copy of a card tensor under
    gloo, else t itself (contiguous)."""
    if mesh.backend == "gloo" and t.device.type != "cpu":
        return t.detach().to("cpu")
    return t.contiguous()


def all_reduce_grads_(grads: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Replace every gradient by its mean over the ranks: one flat buffer,
    summed, divided by the world size, copied back. The gradients must
    share one dtype and device (the port's parameters are float32)."""
    if mesh.group is None or not grads:
        return
    if len({(g.dtype, g.device) for g in grads}) != 1:
        raise ValueError("the gradient all-reduce takes gradients of one dtype on one device")
    flat = _wire(torch.cat([g.reshape(-1) for g in grads]), mesh)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
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
    return None if recv is None else recv.to(send.device)
