"""The card: its name and power limit, the check that the run has the cards
the cell asks for, the peak table, and the reading of a profiler trace over
a short steady window.

The trace is read in memory and not written to disk. A profiler session
on the card drops its first device events now and then (more of them late
in a long process), so each session starts with a pause and a run of
short spin kernels that take that loss; they end before the window and
are not read. Every reader that depends on a count of kernels checks it.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
LEAD_SPINS = 32
FORBIDDEN = ("jax", "jaxlib", "flax", "tcdiff_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else None


def peaks(kind: str) -> Optional[dict]:
    """{"bf16_flops", "hbm_bytes_per_s", "source"} of this card, or None for
    a card the table does not hold."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f).get(kind)


def kernel_base(name: str) -> str:
    """A device kernel's function name: no `void`, namespace, template
    arguments or parameters ("void tcd::attn_mma_kernel<...>(...)" ->
    "attn_mma_kernel")."""
    n = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    n = re.sub(r"\(.*$", "", n)
    depth, out = 0, []
    for ch in n:
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">"
    return "".join(out).split("::")[-1].strip()


@dataclass
class Trace:
    """What one profiled window held: device kernels (name, start s, end s)
    clipped to the window, the host ops (name, start s, end s), the
    window's length and the units (requests or steps) it ran."""

    kernels: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    window_s: float
    units: int
    busy_s: float = field(init=False)

    def __post_init__(self):
        busy, end = 0.0, -1.0
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        self.busy_s = busy

    def device_time(self, pred: Callable[[str], bool]) -> float:
        return sum(e - s for n, s, e in self.kernels if pred(n))

    def count(self, pred: Callable[[str], bool]) -> int:
        return sum(1 for n, _, _ in self.kernels if pred(n))

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, s, e in self.kernels:
            key = kernel_base(name) or name
            by[key] = by.get(key, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest idle gaps between device kernels, each labelled by
        the innermost host op running at its midpoint."""
        gaps, end = [], None
        for s, e in sorted((s, e) for _, s, e in self.kernels):
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        out = []
        for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = 0.5 * (g0 + g1)
            covering = [(e - s, name) for name, s, e in self.host if s <= mid <= e]
            out.append([min(covering)[1] if covering else "host: none traced", g1 - g0])
        return out


def capture(fn: Callable[[], None], units: int) -> Trace:
    """Run fn() (`units` requests or steps, ending in a synchronize) once
    under torch.profiler and read the window."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(0.01)
        for _ in range(LEAD_SPINS):
            torch.cuda._sleep(10_000)
        torch.cuda.synchronize()
        with torch.profiler.record_function("benchmark_window"):
            fn()
            torch.cuda.synchronize()
    w0 = w1 = None
    kernels, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.events():
        s, e = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        if ev.name == "benchmark_window" and ev.device_type != cuda:
            w0, w1 = s, e
        elif ev.device_type == cuda:
            if "spin_kernel" in ev.name or getattr(ev, "is_user_annotation", False):
                continue
            kernels.append((ev.name, s, e))
        else:
            host.append((ev.name, s, e))
    if w0 is None:
        raise RuntimeError("the profiler recorded no window")
    kernels = [(n, max(s, w0), min(e, w1)) for n, s, e in kernels if e > w0 and s < w1]
    host = [(n, s, e) for n, s, e in host if e > w0 and s < w1 and not n.startswith("benchmark_window")]
    trace = Trace(kernels, host, w1 - w0, units)
    calls = {}
    for name, _, _ in kernels:
        calls[kernel_base(name)] = calls.get(kernel_base(name), 0) + 1
    print(f"trace: {units} unit(s) in {trace.window_s:.3f} s, busy {trace.busy_s:.3f} s, {len(kernels)} kernels; "
          f"calls by kernel: {sorted(calls.items(), key=lambda kv: -kv[1])[:16]}", file=sys.stderr)
    return trace
