"""The port's own spans (`tcdiff_torch.utils.profiling`: `TRACER`) of a
profiled window's units, for the per-layer metrics that read them
(`benchmark/metrics/{sampler_ms,glue_ms,launches_per_step}.sample.py`,
`{loss_ms,backward_ms,optim_ms}.train.py`). With `program.py` and the
drivers, the one place of the benchmark that imports `tcdiff_torch`.

A span's milliseconds are the card's, from the CUDA events it recorded at
its entry and exit, or the host's where it recorded none (a run on the
CPU). Every reader returns None where the window's host events hold fewer
than `trace.units` root spans (`tcd.sample.request`, `tcd.train.step`),
the tracer fewer finished roots of that name, or a count does not match;
else it reads the tracer's last `trace.units` roots (the harness may
profile a window again).
"""

from __future__ import annotations

import re
from typing import List, Optional

KERNEL = re.compile(r"k\d+b?\.")  # a kernel call site's span: k1.sa_block ... k11.attention


def units(r, root: str) -> Optional[list]:
    """The last r.trace.units finished roots named `root`, each as (root
    record, {parent id: [child records]}); None where there are fewer, in
    the profile or in the tracer."""
    n = r.trace.units
    if n < 1 or sum(1 for name, _, _ in r.trace.host if name == "tcd." + root) < n:
        return None
    try:
        from tcdiff_torch.utils.profiling import TRACER
    except ImportError:  # a port without spans
        return None
    roots = TRACER.roots(root)
    if len(roots) < n:
        return None
    out = []
    for rec, spans in roots[-n:]:
        kids = {}
        for s in spans:
            kids.setdefault(s.parent, []).append(s)
        out.append((rec, kids))
    return out


def _one(kids: dict, parent, name: str):
    """The one child of `parent` named `name`, else None."""
    got = [s for s in kids.get(parent.id, []) if s.name == name]
    return got[0] if len(got) == 1 else None


def _outermost_kernels(kids: dict, parent) -> list:
    """The kernel call-site spans under `parent` with no kernel span
    between them and it."""
    out, todo = [], list(kids.get(parent.id, []))
    while todo:
        s = todo.pop()
        if KERNEL.match(s.name):
            out.append(s)
        else:
            todo.extend(kids.get(s.id, []))
    return out


def _steps(r) -> Optional[List[tuple]]:
    """(step, its guided call, the kernel spans outermost in it) of every
    `sample.step` of the units; None unless each unit has the
    configuration's DDIM steps, each with one guided call."""
    got = units(r, "sample.request")
    if got is None:
        return None
    want = r.cell.config["diffusion"]["sampling_timesteps"]
    out = []
    for rec, kids in got:
        steps = [s for s in kids.get(rec.id, []) if s.name == "sample.step"]
        if len(steps) != want:
            return None
        for s in steps:
            g = _one(kids, s, "sample.guided")
            if g is None:
                return None
            out.append((s, g, _outermost_kernels(kids, g)))
    return out


def sampler_ms(r) -> Optional[float]:
    """Mean over the steps of sample.step's ms less its sample.guided's."""
    steps = _steps(r)
    return None if not steps else sum(s.ms - g.ms for s, g, _ in steps) / len(steps)


def glue_ms(r) -> Optional[float]:
    """Mean over the steps of sample.guided's ms less that of the kernel
    spans outermost in it."""
    steps = _steps(r)
    return None if not steps else sum(g.ms - sum(k.ms for k in ks) for _, g, ks in steps) / len(steps)


def launches_per_step(r) -> Optional[float]:
    """The window's device ops over its sample.step spans."""
    steps = _steps(r)
    return None if not steps or not r.trace.kernels else len(r.trace.kernels) / len(steps)


def _phases(r, names) -> Optional[float]:
    """Mean over the units of the summed ms of train.step's children named
    `names`; None unless each unit has one train.loss, one train.backward
    and one train.adan."""
    got = units(r, "train.step")
    if got is None:
        return None
    total = 0.0
    for rec, kids in got:
        if any(_one(kids, rec, n) is None for n in ("train.loss", "train.backward", "train.adan")):
            return None
        total += sum(s.ms for s in kids.get(rec.id, []) if s.name in names)
    return total / len(got)


def loss_ms(r) -> Optional[float]:
    return _phases(r, ("train.loss",))


def backward_ms(r) -> Optional[float]:
    return _phases(r, ("train.backward",))


def optim_ms(r) -> Optional[float]:
    return _phases(r, ("train.grad_norm", "train.adan", "train.ema"))
