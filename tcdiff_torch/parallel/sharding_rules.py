"""The Megatron split of the train state over the mesh's `tp` axis.

The port of `tcdiff_tpu/parallel/sharding_rules.py`. Its rule, copied as
it is (`_ROW_PARALLEL`, `_spec_for`, with both fallbacks), picks a split
for each parameter from its flax path: a 2-D kernel whose parent's name
holds a row-parallel fragment is split on its input dim, any other 2-D
leaf on its output dim, each where tp divides that dim (else the other
dim, else none); biases, LayerNorm scales and 3-D leaves stay whole.

The flax path of each of the port's parameters comes from the port's own
map (`interop.from_jax.params_to_state_dict`), run over a tree that
records the paths it is asked for; the spec is then read in the torch
layout. A flax kernel (in, out) is an nn.Linear weight (out, in), so
P("tp", None) on it is dim 1 and P(None, "tp") dim 0; the cond encoder's
packed `in_proj_weight` (3d, d) gathers three flax kernels along dim 0 and
the rule must hold for each of them alike (a dim-0 split cuts each chunk);
a table that is not transposed (`embeddings_table`, `null_cond_hidden`)
keeps JAX's dim.

`shard_train_state` keeps this rank's slice of every split parameter, of
its EMA entry and of each of its Adan moments, in place, so that the
optimizer and the EMA run on the shards (both are elementwise); each split
parameter carries its `Shard` (`tp_shard`), which the model reads to run
its split computation (`models/dance_decoder.py`), and the model the mesh
(`tp_mesh`), which the state's readers take from it. `gather_train_state`
gives back the whole tensors, for checkpoints and sampling: a collective,
which every rank of the tp group calls.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tcdiff_torch.parallel.comm import tp_parts
from tcdiff_torch.parallel.mesh import Mesh

# name fragments whose kernels shard on the INPUT (row-parallel / down-proj)
_ROW_PARALLEL = ("fc", "out_proj", "linear2", "final_layer", "mlp2", "proj", "decoder_3")


def _spec_for(path: str, shape, tp: int) -> Tuple[Optional[str], ...]:
    """The JAX package's spec of one leaf, as a tuple: () whole,
    ("tp", None) split on dim 0, (None, "tp") split on dim 1."""
    if len(shape) != 2 or tp <= 1:
        return ()
    leaf = path.split("/")[-2] if "/" in path else path
    row = any(frag in leaf for frag in _ROW_PARALLEL)
    if row and shape[0] % tp == 0:
        return ("tp", None)
    if not row and shape[1] % tp == 0:
        return (None, "tp")
    if shape[1] % tp == 0:
        return (None, "tp")
    if shape[0] % tp == 0:
        return ("tp", None)
    return ()


class _Paths:
    """A flax tree that records the paths `params_to_state_dict` reads:
    each node answers every key, and as an array it is its path (one
    element, so that transposes and concatenations keep the order)."""

    def __init__(self, path: str = ""):
        self.path = path

    def __getitem__(self, key: str) -> "_Paths":
        return _Paths(f"{self.path}/{key}" if self.path else key)

    def __contains__(self, key: str) -> bool:
        return True

    def __array__(self, dtype=None, copy=None):
        a = np.empty((1, 1), dtype=object)
        a[0, 0] = self.path
        return a


@dataclasses.dataclass(frozen=True)
class Shard:
    """How a parameter lies over the tp ranks: split along `dim` of its
    torch layout, each of its `chunks` blocks along dim 0 (3 for a packed
    q/k/v weight) cut alike; `mesh` holds this rank's tp index and group."""

    dim: int
    chunks: int
    mesh: Mesh


def _layout(model: torch.nn.Module, tp: int) -> Dict[str, Optional[Tuple[int, int]]]:
    """{parameter name: (torch dim, chunks along dim 0) or None (whole)}."""
    from tcdiff_torch.interop.from_jax import params_to_state_dict  # it imports the model

    paths = params_to_state_dict(_Paths(), model.cfg.num_layers, model.cfg.latent_dim)
    out = {}
    for name, p in model.named_parameters():
        chunk_paths = [str(v) for v in np.asarray(paths[name]).ravel()]
        chunks = len(chunk_paths)
        shape = (p.shape[0] // chunks,) + tuple(p.shape[1:])
        specs = set()
        for path in chunk_paths:
            kernel = path.endswith("/kernel")
            spec = _spec_for(path, shape[::-1] if kernel else shape, tp)
            if spec:
                flax_dim = spec.index("tp")
                specs.add(1 - flax_dim if kernel else flax_dim)
            else:
                specs.add(None)
        if len(specs) != 1:
            raise ValueError(f"{name}: its {chunks} flax leaves {chunk_paths} take different splits")
        dim = specs.pop()
        out[name] = None if dim is None else (dim, chunks)
    return out


def param_splits(model: torch.nn.Module, tp: int) -> Dict[str, Optional[int]]:
    """{parameter name: the torch dim it is split on over tp ranks, or
    None where it stays whole}: the JAX package's `params_pspecs` in the
    port's layout."""
    return {name: None if s is None else s[0] for name, s in _layout(model, tp).items()}


def shard_tensor(t: torch.Tensor, dim: int, chunks: int, index: int, tp: int) -> torch.Tensor:
    """Rank `index`'s slice of a whole tensor split along `dim` over tp
    ranks (each of `chunks` blocks along dim 0 cut alike), as a new
    tensor."""
    if chunks > 1 and dim == 0:
        return torch.cat([c.chunk(tp, 0)[index] for c in t.chunk(chunks, 0)]).clone()
    n = t.shape[dim] // tp
    return t.narrow(dim, index * n, n).clone()


def whole_tensor(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The whole tensor from every tp rank's slice `t` (a collective)."""
    parts = tp_parts(t, shard.mesh)
    if shard.chunks > 1 and shard.dim == 0:
        return torch.cat([torch.cat([p.chunk(shard.chunks, 0)[c] for p in parts]) for c in range(shard.chunks)])
    return torch.cat(parts, dim=shard.dim)


def _check_layers(model: torch.nn.Module, layout: dict, tp: int) -> None:
    """The decoder layers' split computation needs the Megatron pattern:
    whole heads a rank (q/k/v split on the output, fc on the input), the
    feed-forward's linear1 on the output, linear2 on the input, and the
    layer's tail linear3 on the output."""
    nhead = model.cfg.num_heads
    if nhead % tp:
        raise ValueError(f"tp={tp} does not divide the {nhead} attention heads")
    want = {"self_attn.w_qs": 0, "self_attn.w_ks": 0, "self_attn.w_vs": 0, "self_attn.fc": 1,
            "multihead_attn.w_qs": 0, "multihead_attn.w_ks": 0, "multihead_attn.w_vs": 0, "multihead_attn.fc": 1,
            "linear1": 0, "linear2": 1, "linear3": 0}
    for i in range(model.cfg.num_layers):
        for site, dim in want.items():
            name = f"seqTransDecoder.stack.{i}.{site}.weight"
            got = layout[name]
            if got is None or got[0] != dim:
                shape = tuple(dict(model.named_parameters())[name].shape)
                raise ValueError(f"tp={tp}: {name} {shape} is split on {got and got[0]}, but the layer's split "
                                 f"computation needs dim {dim} (tp must divide its widths)")


def shard_train_state(state, mesh: Mesh):
    """Keep this rank's slice of every split parameter, of its EMA entry
    and of each of its Adan moments (the optimizer's tensors of the
    parameter's shape), in place; the step and the whole parameters stay
    as they are. Marks each split parameter with its `Shard`, and the model
    with the mesh (`tp_mesh`). Returns the state. A mesh of tp = 1 leaves
    it whole."""
    model = state.model
    if mesh.tp == 1:
        return state
    if model.tp_mesh is not None:
        raise ValueError("the train state is split already")
    layout = _layout(model, mesh.tp)
    _check_layers(model, layout, mesh.tp)
    opt_state = state.optimizer.state
    with torch.no_grad():
        for name, p in model.named_parameters():
            if layout[name] is None:
                continue
            dim, chunks = layout[name]
            cut = lambda t: shard_tensor(t, dim, chunks, mesh.tp_rank, mesh.tp)  # noqa: E731
            moments = opt_state.get(p, {})
            for k, v in moments.items():
                if torch.is_tensor(v) and v.shape == p.shape:
                    moments[k] = cut(v)
            state.ema_params[name] = cut(state.ema_params[name])
            p.data = cut(p.data)
            p.grad = None
            p.tp_shard = Shard(dim, chunks, mesh)
    model.tp_mesh = mesh
    return state


def _whole(named, params: dict) -> dict:
    """{name: whole tensor} of tensors by parameter name, gathered where
    the parameter is split."""
    out = {}
    for name, t in named:
        shard = getattr(params[name], "tp_shard", None)
        out[name] = t if shard is None else whole_tensor(t, shard)
    return out


def gather_train_state(state, parts=("params", "ema", "optimizer")) -> dict:
    """The whole tensors of a split state, each part asked for:
    {"params": {name: tensor}, "ema": {name: tensor}, "optimizer": the
    optimizer's state_dict with whole moments}. Every rank of the tp group
    calls it (a collective), in one order; a whole state's own tensors are
    returned as they are."""
    params = dict(state.model.named_parameters())
    out = {}
    with torch.no_grad():
        if "params" in parts:
            out["params"] = _whole(((n, p.detach()) for n, p in params.items()), params)
        if "ema" in parts:
            out["ema"] = _whole(((n, state.ema_params[n]) for n in params), params)
        if "optimizer" in parts:
            sd = state.optimizer.state_dict()
            order = [p for group in state.optimizer.param_groups for p in group["params"]]
            whole_state = {}
            for idx, st in sd["state"].items():
                shard = getattr(order[idx], "tp_shard", None)
                whole_state[idx] = {k: whole_tensor(v, shard) if shard is not None and torch.is_tensor(v)
                                    and v.shape == order[idx].shape else v for k, v in st.items()}
            out["optimizer"] = {**sd, "state": whole_state}
    return out

