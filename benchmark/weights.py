"""Seeded weights and derived seeds.

`make_weights(seed, model_cfg, device)` draws every parameter of the
denoiser from one normal draw on the device (a `torch.Generator` there,
seeded from the run's seed) and scales it per parameter: a linear map's
weight with std 1/sqrt(fan_in), its bias 0.02; a LayerNorm's scale 1 +
0.05 N, its shift 0.05 N; the null embeddings and the trajectory table
N(0, 1). Names and shapes are the reference's (`benchmark/reference`),
which are the upstream state-dict layout; both sides load the same
float32 tensors, the measured program as its master weights.
"""

from __future__ import annotations

import hashlib

import torch
from torch import nn

from benchmark.reference.model import ReferenceDecoder, linear_weight_names


def sub_seed(seed: int, *tags) -> int:
    """A 60-bit seed for one use of the run's seed (weights, inputs, a
    request's noise, a step's draws), the same on every machine."""
    key = ":".join(str(t) for t in (seed, *tags)).encode()
    return int(hashlib.sha256(key).hexdigest()[:15], 16)


def generator(seed: int, device, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def _spec(model: nn.Module):
    """[(name, shape, mean, std)] of every parameter."""
    lin = linear_weight_names(model)
    norms = {f"{p}.{k}" for p, m in model.named_modules() if isinstance(m, nn.LayerNorm) for k in ("weight", "bias")}
    out = []
    for name, p in model.named_parameters():
        if name in lin:
            mean, std = 0.0, p.shape[1] ** -0.5
        elif name in norms:
            mean, std = (1.0 if name.endswith("weight") else 0.0), 0.05
        elif name.endswith("bias"):
            mean, std = 0.0, 0.02
        else:  # null_cond_embed, null_cond_hidden, embeddings_table
            mean, std = 0.0, 1.0
        out.append((name, tuple(p.shape), mean, std))
    return out


def make_weights(seed: int, model_cfg: dict, device) -> dict:
    """{name: float32 tensor on `device`} for the denoiser of `model_cfg`."""
    with torch.device("meta"):
        spec = _spec(ReferenceDecoder(model_cfg))
    sizes = [torch.Size(s).numel() for _, s, _, _ in spec]
    counts = torch.tensor(sizes, device=device)
    std = torch.repeat_interleave(torch.tensor([s for *_, s in spec], device=device), counts)
    mean = torch.repeat_interleave(torch.tensor([m for _, _, m, _ in spec], device=device), counts)
    flat = torch.randn(sum(sizes), generator=generator(seed, device, "weights"), device=device) * std + mean
    return {name: t.view(shape) for (name, shape, _, _), t in zip(spec, flat.split(sizes))}
