"""The readings that the limits of `benchmark/limits/<cell>.json` are set
from, on the card at the cell's own size, in one process:

    python3 benchmark/tools/control.py --cell <cell> --program-seeds 1,2,... --control-seeds 7,8,9 \
        [--faults half_batch,no_exchange] [--seconds 1]

- the program: a run of the cell (a short window) per seed; its compared
  numbers are the lower readings;
- the controls: the float32 reference with every product's operands
  rounded to fp8 (e4m3, a scale per tensor), the precision below the
  configuration's bf16, put in the program's place (sampling: its x0 on
  the program's recorded states; training: its three steps); for the
  sampler's own float32 step, the reference's step rounded to bf16; and
  the program's own int8 serving path (`ServingKernels(int8=True)`), read
  beside them;
- the faults (`benchmark/faults.py`) planted in the program.

Prints one JSON line per reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import compare, harness, spec  # noqa: E402


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to float8 e4m3 (a scale per tensor),
    the sums in float32."""
    def q(t):
        s = t.abs().amax().clamp_min(1e-30) / 448.0
        return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s

    return torch.matmul(q(a), q(b))


def _numbers(out: harness.Outcome) -> dict:
    return {**{k: v for k, (v, _) in out.checks.items()}, **out.readings}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--faults-only", action="store_true", help="at the control seeds, the faults alone")
    args = ap.parse_args()
    seeds = lambda s: [int(v) for v in s.split(",") if v]
    cell = spec.load(args.cell)
    card = f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}"

    def emit(kind: str, seed: int, numbers: dict, t: float) -> None:
        rec = {"cell": args.cell, "kind": kind, "seed": seed, "numbers": numbers, "s": round(time.time() - t, 1),
               "card": card}
        print(json.dumps(rec), flush=True)

    def program_run(seed: int, **kw) -> dict:
        run = harness.Run(cell, seed, args.seconds, False, time.perf_counter(), **kw)
        return _numbers(harness.execute(run))

    for seed in seeds(args.program_seeds):
        t = time.time()
        emit("program", seed, program_run(seed), t)
    for seed in seeds(args.control_seeds):
        t = time.time()
        if args.faults_only:
            pass
        elif cell.traffic["kind"] == "sample":
            from benchmark.drivers import sample

            emit("control_int8", seed, program_run(seed, traffic_overrides={"kernels": {"int8": True}}), t)
            t = time.time()
            run = harness.Run(cell, seed, args.seconds, False, time.perf_counter())
            emit("control_bf16_step", seed, _numbers(sample._run(run, round_update=torch.bfloat16)), t)
            t = time.time()
            run = harness.Run(cell, seed, args.seconds, False, time.perf_counter())
            emit("control_fp8_reference", seed, _numbers(sample._run(run, control_mm=fp8_mm)), t)
        else:
            from benchmark.drivers import train

            run = harness.Run(cell, seed, args.seconds, False, time.perf_counter())
            dev = torch.device("cuda:0")
            ref = train.reference(run, dev)
            ctl = train.reference(run, dev, mm=fp8_mm)
            emit("control_fp8", seed, {k: v for k, v in compare.train_numbers(ctl, ref).items()
                                       if not k.startswith("_change")}, t)
        for fault in (f for f in args.faults.split(",") if f):
            t = time.time()
            emit(f"fault_{fault}", seed, program_run(seed, faults=(fault,)), t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
