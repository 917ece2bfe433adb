"""The numbers that decide `correct`, each against its limit from
`benchmark/limits/<cell>.json`. How each limit was set (the program's
readings over seeds, the control's, the faults') is in PERF.md.

Sampling (the recorded paths of clips of the window's requests, drawn
from the seed; `benchmark/drivers/sample.py`), each |y - r| / |r| over a
clip (channels 4, 5 included: both impose the trajectory there):
  x0_rel_err     the widest over clips and steps: the program's guided x0
                 prediction against the reference's from the same state
  update_rel_err the widest over clips and steps: the program's next state
                 (the served clip, after the last) against the reference's
                 DDIM step from the program's state, clipped x0 and noise
  start_abs_err  the start x_T with the trajectory against the reference's
                 from the same noise, the largest difference (limit 0)
  clips_off      served clips, of all in the window, whose XY channels are
                 not the trajectory, that hold a non-finite value or leave
                 [-1, 1] in another channel (limit 0)
Training (the first three steps of the window's own train step):
  loss_velocity_gap  step 1's |l - l_ref| / |l_ref| of the loss's velocity
                 term: a mean over all the batch's rows, so a step that
                 leaves rows out moves it
  change_gap     the median over the moving leaves (below) of
                 | |d| - |d_ref| | over the larger of |d_ref| and the median
                 leaf's |d_ref|, d the parameters' change over the three
                 steps (p3 - p0)
  ema_gap        the same of the EMA's change
  change_shortfall  the largest over the moving leaves of |d_ref| / |d|: a
                 leaf that the program leaves unmoved reads far above 1
                 (moving leaves: those whose reference gradient is at least
                 a thousandth of the median leaf's; the others move by
                 round-off alone)
  window_nonfinite  window steps whose loss was not finite (limit 0)
  ranks_differ   data parallelism: ranks whose whole state (parameters,
                 EMA, Adan's moments) differs in a bit from rank 0's
                 (limit 0)
Printed, not compared: each step's total loss gap, the other terms' at
step 1, and grad_gap, the widest over the leaves of the same gap of the
first gradient (as Adan holds it after step 1). The fk and foot terms, and
through them every leaf's gradient, go through the SMPL FK's Gram-Schmidt
and the foot contact's threshold: a bf16 rounding of the output moves
them far on some seeds; the recon term's gap reads too close to half the
batch's (PERF.md). None of them separates sound runs from a fault.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch


def clip_errors(served: torch.Tensor, ref: torch.Tensor) -> List[float]:
    d = (served.float() - ref.float()).flatten(1).norm(dim=1)
    return (d / ref.float().flatten(1).norm(dim=1).clamp_min(1e-12)).tolist()


def clips_off(out: torch.Tensor, x_0: torch.Tensor) -> int:
    """Clips that hold a non-finite value, whose XY channels are not the
    trajectory, or whose other channels leave [-1, 1]."""
    finite = torch.isfinite(out).flatten(1).all(1)
    xy = (out[..., 4:6] == x_0[..., 0:2].to(out.dtype)).flatten(1).all(1)
    rest = torch.cat([out[..., :4], out[..., 6:]], dim=-1).abs().flatten(1).amax(1) <= 1.0
    return int((~(finite & xy & rest)).sum().item())


def _gaps(got: Dict[str, float], ref: Dict[str, float], names) -> Dict[str, float]:
    med = statistics.median(ref[k] for k in names)
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names}


def train_numbers(got: dict, ref: dict) -> Dict[str, float]:
    """got/ref: {"loss": [3], "terms": [{term: weighted mean}] (step 1's at
    least), "grad_norms": {leaf: |g1|}, "change": {leaf: |p3 - p0|},
    "ema_change": {leaf: |e3 - e0|}}."""
    losses = [abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"])]
    leaves = sorted(ref["grad_norms"])
    grad = max(_gaps(got["grad_norms"], ref["grad_norms"], leaves).values())
    gmed = statistics.median(ref["grad_norms"].values())
    moving = [k for k in leaves if ref["grad_norms"][k] >= 1e-3 * gmed]
    change = statistics.median(_gaps(got["change"], ref["change"], moving).values())
    ema = statistics.median(_gaps(got["ema_change"], ref["ema_change"], moving).values())
    worst = max(_gaps(got["change"], ref["change"], moving).items(), key=lambda kv: kv[1])
    terms = {k: abs(got["terms"][0][k] - v) / abs(v) for k, v in ref["terms"][0].items()}
    short = max(ref["change"][k] / max(got["change"][k], 1e-30) for k in moving)
    return {"loss_velocity_gap": terms["velocity"], "change_gap": change, "ema_gap": ema,
            "change_shortfall": short, "grad_gap": grad, "loss_rel": losses[0],
            **{f"_loss_gap.{k}": v for k, v in terms.items()},
            "_change_gap_worst_leaf": worst[1], "_change_gap_worst_name": worst[0], "_moving_leaves": len(moving),
            "_loss_steps": losses}
