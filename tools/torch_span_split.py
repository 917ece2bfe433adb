"""One traced run of a benchmark cell, and where its units' device time
goes by the port's spans (`tcdiff_torch.utils.profiling`).

    python3 tools/torch_span_split.py --workload <cell> --seed <n> [--seconds 10] [--out DIR]

Runs `benchmark/run.py --trace 1` for the cell in this process (its result
line on stdout, as ever), then reads the tracer's spans of the profiled
window's units and prints on stderr, and writes as JSON to
`DIR/<cell>.<seed>.json` (default `chiprun_out/span_split`):

  * sampling (`sample.request`): device ms a DDIM step of the step, the
    guided call, K1, K2, K7 (`k7.ca_block`), the plain cross-attention
    (`ca.plain`), the CFG combine, the rest of the decoder layers, the rest
    of the guided call and the sampler's own work, and the K7 and
    `ca.plain` spans a request; the cond encoding once a request; 50 x the
    mean step against the request and the profiled window;
  * training (`train.step`): device ms a step of each phase, K3-K5
    forward and their backward spans, the rest of the loss and of the
    backward; the phases' sum against the step;
  * both: the widest ratio of a span's children's summed ms to its own
    (nesting on the card's clock: at most 1), the device time and count of
    the window's index kernels by name (the sampling harness's recorder
    copies are `index_select`'s) and the breakdown's idle gaps; with
    `--ab N`, N pairs of profiled windows with the spans switched off and
    on in this process first (each window's seconds a unit); with `--ops
    SPAN` (a span's name, as `ca.plain`), one more profiled window after
    the run's own, and the device kernels that overlap that span's ranges
    on the card's timeline, by name: calls and ms a unit, beside the
    ranges' own ms.

On a tree whose port has no spans (a parent commit) it prints the same
numbers without the split.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import device as devmod  # noqa: E402
from benchmark import harness  # noqa: E402


def _tree(root):
    kids = collections.defaultdict(list)
    for s in root.spans:
        kids[s.parent].append(s)
    return kids


def _under(kids, parent, name: str) -> float:
    """Summed ms of the spans named `name` anywhere under `parent`, not
    counting those nested in another span of that name."""
    total, todo = 0.0, list(kids[parent.id])
    while todo:
        s = todo.pop()
        if s.name == name:
            total += s.ms
        else:
            todo.extend(kids[s.id])
    return total


def _nesting(root, kids) -> float:
    return max((sum(c.ms for c in kids[s.id]) / s.ms for s in root.spans if kids[s.id] and s.ms > 0), default=0.0)


def sample_split(root, window_s: float) -> dict:
    kids = _tree(root)
    steps = [s for s in kids[root.record.id] if s.name == "sample.step"]
    n = len(steps)
    mean = lambda f: sum(f(s) for s in steps) / n
    guided = {s.id: next(c for c in kids[s.id] if c.name == "sample.guided") for s in steps}
    g = lambda s: guided[s.id]
    out = {
        "steps": n, "request_ms": root.record.ms,
        "cond_ms": sum(c.ms for c in kids[root.record.id] if c.name == "sample.cond"),
        "step_ms": mean(lambda s: s.ms), "guided_ms": mean(lambda s: g(s).ms),
        "sampler_ms": mean(lambda s: s.ms - g(s).ms),
        "k1_ms": mean(lambda s: _under(kids, g(s), "k1.sa_block")),
        "k2_ms": mean(lambda s: _under(kids, g(s), "k2.ff_tail")),
        "k7_ms": mean(lambda s: _under(kids, g(s), "k7.ca_block")),
        "ca_plain_ms": mean(lambda s: _under(kids, g(s), "ca.plain")),
        "k7_spans": sum(s.name == "k7.ca_block" for s in root.spans),
        "ca_plain_spans": sum(s.name == "ca.plain" for s in root.spans),
        "cfg_ms": mean(lambda s: _under(kids, g(s), "sample.cfg")),
        "layers_ms": mean(lambda s: _under(kids, g(s), "decoder.layer")),
    }
    out["layer_rest_ms"] = out["layers_ms"] - out["k1_ms"] - out["k2_ms"] - out["k7_ms"] - out["ca_plain_ms"]
    out["guided_rest_ms"] = out["guided_ms"] - out["layers_ms"] - out["cfg_ms"]
    out["steps_x_mean_over_request"] = n * out["step_ms"] / out["request_ms"]
    out["steps_x_mean_over_window"] = n * out["step_ms"] / (1e3 * window_s)
    out["widest_children_over_parent"] = _nesting(root, kids)
    return out


def train_split(roots) -> dict:
    acc = collections.defaultdict(float)
    widest = 0.0
    for root in roots:
        kids = _tree(root)
        phases = {c.name: c for c in kids[root.record.id]}
        acc["step_ms"] += root.record.ms
        for name, c in phases.items():
            acc[name.split(".", 1)[1] + "_ms"] += c.ms
        loss, bwd = phases["train.loss"], phases["train.backward"]
        for k in ("k3.sa_block_train", "k4.ca_block_train", "k5.ff_tail_train"):
            acc[k.split(".")[0] + "_fwd_ms"] += _under(kids, loss, k)
            acc[k.split(".")[0] + "_bwd_ms"] += _under(kids, bwd, k + ".bwd")
        widest = max(widest, _nesting(root, kids))
    out = {k: v / len(roots) for k, v in acc.items()}
    out["loss_rest_ms"] = out["loss_ms"] - sum(out[f"k{i}_fwd_ms"] for i in (3, 4, 5))
    out["backward_rest_ms"] = out["backward_ms"] - sum(out[f"k{i}_bwd_ms"] for i in (3, 4, 5))
    phases = out["loss_ms"] + out["backward_ms"] + sum(out.get(k, 0.0) for k in ("grad_norm_ms", "adan_ms",
                                                                                  "ema_ms"))
    out["phases_over_step"] = phases / out["step_ms"]
    out["widest_children_over_parent"] = widest
    out["steps"] = len(roots)
    return out


def op_split(fn, units: int, name: str) -> dict:
    """fn() (`units` units) under torch.profiler once more: the device-side
    ranges of the span `name` (the profiler's user annotation of
    `tcd.<name>` on the card's timeline), their ms a unit, and {kernel base
    name: [calls, ms]} a unit of the device kernels that overlap one, each
    counted whole."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    ranges = sorted((e.time_range.start, e.time_range.end) for e in events
                    if getattr(e, "is_user_annotation", False) and e.name == "tcd." + name)
    out = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if getattr(e, "is_user_annotation", False) or "spin_kernel" in e.name:
            continue
        s, t = e.time_range.start, e.time_range.end
        if any(s < b and a < t for a, b in ranges):
            k = out[devmod.kernel_base(e.name)]
            k[0] += 1 / units
            k[1] += (t - s) / 1e3 / units
    return {"ranges_a_unit": len(ranges) / units, "ranges_ms_a_unit": sum(b - a for a, b in ranges) / 1e3 / units,
            "kernels": dict(sorted(out.items(), key=lambda kv: -kv[1][1]))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "span_split"))
    ap.add_argument("--ops", default=None, help="a span's name: its device kernels by name, from one more window")
    ap.add_argument("--ab", type=int, default=0,
                    help="before the run's own profiled window, this many pairs of windows with the spans off "
                         "and on (the on cost a unit, in one process)")
    args = ap.parse_args()
    traces, ab, ops = [], [], {}
    capture = devmod.capture

    def captured(fn, units):
        if args.ab and not ab:  # before the run's own window: windows with the spans off and on, alternately
            import tcdiff_torch.utils.profiling as prof

            on = prof._profiler_on
            for rep in range(args.ab):
                for spans_on in ((False, True) if rep % 2 == 0 else (True, False)):
                    prof._profiler_on = on if spans_on else (lambda: False)
                    try:
                        ab.append([spans_on, capture(fn, units).window_s / units])
                    finally:
                        prof._profiler_on = on
        traces.append(capture(fn, units))
        if args.ops and not ops:
            ops.update(op_split(fn, units, args.ops))
        return traces[-1]

    devmod.capture = captured
    rc = harness.main(["--workload", args.workload, "--seed", str(args.seed), "--seconds", str(args.seconds),
                       "--trace", "1"])
    if rc != 0 or not traces:
        return rc or 1
    trace = traces[-1]
    sampling = args.workload.startswith("sample.")
    try:
        from tcdiff_torch.utils.profiling import TRACER
    except ImportError:  # a port without spans
        split = {}
    else:
        roots = TRACER.roots("sample.request" if sampling else "train.step")[-trace.units:]
        split = sample_split(roots[-1], trace.window_s) if sampling else train_split(roots)
    index = collections.defaultdict(lambda: [0, 0.0])
    for n, s, e in trace.kernels:
        if "index" in devmod.kernel_base(n).lower():
            index[devmod.kernel_base(n)][0] += 1
            index[devmod.kernel_base(n)][1] += 1e3 * (e - s)
    split.update(window_s=trace.window_s, busy_s=trace.busy_s, units=trace.units, kernels=len(trace.kernels),
                 index_kernels=dict(index), idle_gaps=trace.idle_gaps(), windows_s=[t.window_s for t in traces],
                 ab_window_s_a_unit=ab, ops={args.ops: ops} if args.ops else {})
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.workload}.{args.seed}.json"), "w") as f:
        json.dump(split, f, indent=1)
    print("span split: " + json.dumps({k: (round(v, 4) if isinstance(v, float) else v) for k, v in split.items()}),
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
