"""One run of one cell: check the cards, hand the cell to its traffic
kind's driver, read the per-layer metrics, judge the comparison and print
the result line.

The drivers (`benchmark/drivers/<kind>.py`) take a `Run` and return a
`Outcome`; they make the weights and inputs from the seed, warm up, time
the window, trace a short steady window where asked, and compare what the
timed path produced with the plain reference. Everything here is the
same for every cell.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from benchmark import device as devmod
from benchmark import spec as specmod


@dataclass
class Run:
    cell: specmod.Cell
    seed: int
    seconds: float
    trace: bool
    t0: float  # time.perf_counter() at process start
    device: str = "cuda"
    model_overrides: dict = field(default_factory=dict)  # tests: a small model on the CPU
    traffic_overrides: dict = field(default_factory=dict)
    backend: str = "nccl"  # the collectives' backend across ranks (tests on the CPU: gloo)
    faults: tuple = ()  # `benchmark/faults.py`, planted in every rank (tests and the control's readings)
    precision: Optional[str] = None  # tests: the program in float32 on the CPU

    @property
    def model_cfg(self) -> dict:
        return {**self.cell.config["model"], **self.model_overrides}

    @property
    def config(self) -> dict:
        return dict(self.cell.config, precision=self.precision or self.cell.config["precision"])

    @property
    def traffic(self) -> dict:
        return {**self.cell.traffic, **self.traffic_overrides}

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0


@dataclass
class Reading:
    """What a per-layer metric's reader gets (`benchmark/metrics/`)."""

    cell: specmod.Cell
    model_cfg: dict
    traffic: dict
    trace: devmod.Trace
    window_units: int  # requests or steps in the timed window
    window_wall_s: float
    memory_peak_bytes: int
    peaks: Optional[dict]


@dataclass
class Outcome:
    setup_s: float
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, tuple]  # name: (value, limit)
    memory_peak_bytes: int
    count: int
    per_layer: Dict[str, float] = field(default_factory=dict)
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    readings: Dict[str, float] = field(default_factory=dict)  # numbers read but not compared (printed)
    forbidden: List[str] = field(default_factory=list)  # JAX's modules loaded in a rank process other than this


def read_per_layer(cell: specmod.Cell, reading: Reading) -> Dict[str, float]:
    """Each per-layer metric's reader over one rank's reading; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for name, read in specmod.readers(cell).items():
        value = read(reading)
        if value is not None:
            out[name] = float(value)
    return out


def log(run: Run, what: str) -> None:
    """A phase's end on stderr, with the seconds since the process started."""
    print(f"[{run.elapsed():8.2f} s] {what}", file=sys.stderr, flush=True)


def traced(cell: specmod.Cell, reading_fn, attempts: int = 3, agree=bool):
    """(the per-layer metrics, the Reading) of a profiled window, profiled
    again (at most `attempts` times) while a metric listed for the cell
    finds nothing to read, as where the profiler dropped events. `agree`
    turns this process's "read again" into every rank's (ranks that run
    collectives must profile alike)."""
    for attempt in range(attempts):
        reading = reading_fn()
        got = read_per_layer(cell, reading)
        missing = sorted({m["name"] for m in cell.per_layer} - set(got))
        if not agree(bool(missing)):
            break
        print(f"trace {attempt + 1} of {attempts}: nothing to read for {missing}", file=sys.stderr)
    return got, reading


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def execute(run: Run) -> Outcome:
    return specmod.driver(run.traffic["kind"]).run(run)


def result_line(run: Run, out: Outcome, kind: str) -> dict:
    units = {m["name"]: m["unit"] for m in run.cell.end_to_end + run.cell.per_layer}
    if run.trace:
        metrics = {k: {"value": v, "unit": units[k]} for k, v in out.per_layer.items()}
    else:
        values = dict(out.end_to_end, setup_s=out.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in run.cell.end_to_end}
    dev = {"platform": "gpu", "kind": kind, "count": out.count, "memory_peak_bytes": out.memory_peak_bytes}
    if run.trace:
        dev.update(busy_s=out.busy_s, window_s=out.window_s)
    correct = out.failed == 0 and all(_passes(v, lim) for v, lim in out.checks.values())
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed, "metrics": metrics, "device": dev}
    if run.trace and out.breakdown:
        line["breakdown"] = out.breakdown
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return line


def _passes(value: float, limit: float) -> bool:
    return value is not None and math.isfinite(value) and value <= limit


def forbidden_loaded(out: Outcome) -> List[str]:
    """JAX's or the JAX package's top-level modules loaded in this process
    or in a rank process of the run."""
    return sorted(set(devmod.forbidden_modules()) | set(out.forbidden))


def main(argv: Optional[List[str]] = None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = specmod.load(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {cell.name} needs {cell.chips} CUDA card(s); this machine has {have}", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    print(f"card: {kind} x {torch.cuda.device_count()}, power limit {devmod.power_limit()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", file=sys.stderr)
    run = Run(cell, args.seed, args.seconds, bool(args.trace), t0)
    out = execute(run)
    line = result_line(run, out, kind)
    faulthandler.cancel_dump_traceback_later()
    bad = forbidden_loaded(out)
    if bad:
        print(f"refused: the process loaded {bad} (JAX or the JAX package)", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    sys.stdout.flush()
    return 0
