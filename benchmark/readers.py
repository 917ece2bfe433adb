"""What the per-layer metrics' readers (`benchmark/metrics/<name>.py`)
share. Each takes a `harness.Reading` and returns a number or None where
its source holds nothing to read (no kernel of its kind, a count that the
profiler cut short, a card the peak table does not hold)."""

from __future__ import annotations

from typing import Optional

from benchmark import flops
from benchmark.device import kernel_base


def idle_share(r) -> Optional[float]:
    if not r.trace.kernels or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def peak_gib(r) -> Optional[float]:
    return r.memory_peak_bytes / 2**30 if r.memory_peak_bytes else None


def _rows(r) -> int:
    """Rows a card: a sampling request's batch or a rank's train batch."""
    return r.traffic["batch"]


def mfu_sample(r) -> Optional[float]:
    if r.peaks is None:
        return None
    steps = r.cell.config["diffusion"]["sampling_timesteps"]
    work = flops.sample_request_flops(r.model_cfg, _rows(r), steps) * r.window_units
    return 100.0 * work / r.window_wall_s / r.peaks["bf16_flops"]


def mfu_train(r) -> Optional[float]:
    if r.peaks is None:
        return None
    work = flops.train_step_flops(r.model_cfg, _rows(r), r.cell.config["diffusion"]["cond_drop_prob"])
    return 100.0 * work * r.window_units / r.window_wall_s / r.peaks["bf16_flops"]


def is_attention(name: str) -> bool:
    return kernel_base(name).startswith("attn_")


def attention_roofline(r, train: bool) -> Optional[float]:
    """The attention's least time (operations or bytes, from the shapes)
    over the device time of the kernels named attn_*, in the profiled
    units; None unless the profile holds every forward call (one a layer
    and step of serving; two a layer, forward and backward, of training)."""
    if r.peaks is None:
        return None
    nl, steps = r.model_cfg["num_layers"], r.cell.config["diffusion"]["sampling_timesteps"]
    fwd = r.trace.count(lambda n: kernel_base(n) == "attn_mma_kernel")
    if train:
        bwd = r.trace.count(lambda n: kernel_base(n).startswith("attn_bwd_dq"))
        if fwd != 2 * nl * r.trace.units or bwd != 2 * nl * r.trace.units:
            return None
    elif fwd != nl * steps * r.trace.units:
        return None
    bound = flops.attention_bound_s(r.model_cfg, _rows(r), steps, r.peaks["bf16_flops"], r.peaks["hbm_bytes_per_s"],
                                    train) * r.trace.units
    spent = r.trace.device_time(is_attention)
    return 100.0 * bound / spent if spent > 0 else None


def allreduce_ms(r) -> Optional[float]:
    spent = r.trace.device_time(lambda n: "allreduce" in n.lower())
    return 1e3 * spent / r.trace.units if spent > 0 else None
