"""Step timing, trace capture and the port's spans.

The port of `tcdiff_tpu/utils/profiling.py`: `trace` records a
torch.profiler trace (the host, and the card where there is one) and
writes it as a Chrome trace; `StepTimer` keeps an EMA of the step time and
derives steps/s and seconds of motion per second. A caller that times
device work ends it with `torch.cuda.synchronize()` before `tock`.

Spans. `span(name, **attrs)` names a range of the port's own work (a
sampling request and its DDIM steps, the guided call, a decoder layer, a
kernel's call site, a train step and its phases). It is on only while a
torch.profiler session records (`trace` here, or any other); otherwise it
returns one shared null context and costs a flag read. On, a span
  * opens `torch.profiler.record_function("tcd." + name)`, so that it
    lies in the profiler's timeline on the clock of the device kernels;
  * records a CUDA event on the current stream at entry and at exit
    (events from a reused pool) where CUDA is initialised;
  * keeps a `SpanRecord` in `TRACER`: name, attrs, id, the parent's and
    the root's id (every span of one request or step shares its root's),
    host start and end (ns) and the events. Device milliseconds are
    resolved from the events only when a record is read; nothing in a
    span synchronises.
`TRACER` keeps the spans of its last `KEEP_ROOTS` finished roots.
`traced(name)` wraps a function in a span; with `backward=True` the
backward of what the function computes gets its own span, `<name>.bwd`,
from the first to the last of its backward nodes. The autograd engine runs
a backward on a thread of its own: a span opened on a thread with no span
open takes as its parent the innermost open span opened with
`adopt=True` (the train step's `train.backward`), if any.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

KEEP_ROOTS = 64  # finished roots the tracer keeps
_profiler_on = torch._C._autograd._profiler_enabled


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the block into `log_dir/trace.json` (a no-op when log_dir
    is None)."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """EMA-smoothed step timing with derived throughput metrics."""

    def __init__(self, smoothing: float = 0.9):
        self._smoothing = smoothing
        self._avg = None
        self._last = None

    def tick(self) -> None:
        self._last = time.perf_counter()

    def tock(self, steps: int = 1) -> float:
        """The seconds a step since `tick` (the time over `steps` steps);
        the EMA tracks the time a step."""
        dt = (time.perf_counter() - self._last) / max(1, steps)
        self._avg = dt if self._avg is None else self._smoothing * self._avg + (1 - self._smoothing) * dt
        return dt

    @property
    def avg_step_s(self) -> Optional[float]:
        return self._avg

    def metrics(self, motion_seconds_per_step: float = 0.0) -> dict:
        if self._avg is None:
            return {}
        out = {"step_time_s": self._avg, "steps_per_sec": 1.0 / self._avg}
        if motion_seconds_per_step:
            out["motion_s_per_sec"] = motion_seconds_per_step / self._avg
        return out


class SpanRecord:
    """One span: `name` (without the "tcd." of its range), `attrs`, `id`,
    `parent` (None for a root) and `root` ids, host `start_ns` and `end_ns`
    (time.perf_counter_ns; end None while open) and, where it ran with CUDA
    initialised, its (start, end) CUDA events."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "start_ns", "end_ns", "events", "_device_ms", "_stack",
                 "_range")

    def __init__(self, name: str, attrs: dict, id: int, parent: Optional["SpanRecord"]):
        self.name, self.attrs, self.id = name, attrs, id
        self.parent = None if parent is None else parent.id
        self.root = id if parent is None else parent.root
        self.start_ns = self.end_ns = self.events = self._device_ms = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """The card's milliseconds from the entry event to the exit event
        (waits for the exit event); None without events, nan once the
        tracer has dropped the span's root unread."""
        if self._device_ms is None and self.events is not None:
            start, end = self.events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
        return self._device_ms

    @property
    def ms(self) -> float:
        """device_ms where the span recorded events, else host_ms (a run on
        the CPU)."""
        dev = self.device_ms
        return self.host_ms if dev is None else dev


class Root(NamedTuple):
    """A finished root span and every span of it (the root first, then in
    the order they opened)."""

    record: SpanRecord
    spans: List[SpanRecord]


class Tracer:
    """The spans of the last `keep` finished roots, in memory. Any thread
    may open spans; a span closes on the thread that opened it."""

    def __init__(self, keep: int = KEEP_ROOTS):
        self.keep = keep
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._adopters: List[SpanRecord] = []
        self._open: Dict[int, List[SpanRecord]] = {}
        self._done: collections.deque = collections.deque()
        self._pool: list = []

    def roots(self, name: Optional[str] = None) -> List[Root]:
        """The kept finished roots, oldest first (those named `name`)."""
        with self._lock:
            return [r for r in self._done if name is None or r.record.name == name]

    def clear(self) -> None:
        with self._lock:
            while self._done:
                self._recycle(self._done.popleft())

    def _recycle(self, root: Root) -> None:
        """Return a dropped root's events to the pool; its records' device
        ms read nan unless read before."""
        for rec in root.spans:
            if rec.events is not None:
                self._pool.extend(rec.events)
                rec.events = None
                if rec._device_ms is None:
                    rec._device_ms = float("nan")

    def _event(self):
        return self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)

    def open(self, name: str, attrs: dict, adopt: bool = False) -> SpanRecord:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        with self._lock:
            parent = stack[-1] if stack else (self._adopters[-1] if self._adopters else None)
            rec = SpanRecord(name, attrs, next(self._ids), parent)
            if parent is None:
                self._open[rec.id] = [rec]
            elif rec.root in self._open:
                self._open[rec.root].append(rec)
            if adopt:
                self._adopters.append(rec)
            if torch.cuda.is_initialized():
                rec.events = (self._event(), self._event())
        rec._stack = stack
        stack.append(rec)
        rec._range = torch.profiler.record_function("tcd." + name)
        rec._range.__enter__()
        if rec.events is not None:
            rec.events[0].record()
        rec.start_ns = time.perf_counter_ns()
        return rec

    def close(self, rec: SpanRecord) -> None:
        rec.end_ns = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record()
        rec._range.__exit__(None, None, None)
        rec._range = None
        stack, rec._stack = rec._stack, None
        if stack and stack[-1] is rec:
            stack.pop()
        elif rec in stack:
            stack.remove(rec)
        with self._lock:
            if rec in self._adopters:
                self._adopters.remove(rec)
            if rec.parent is None:
                self._done.append(Root(rec, self._open.pop(rec.id)))
                while len(self._done) > self.keep:
                    self._recycle(self._done.popleft())


TRACER = Tracer()


class _Null:
    """The span while no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "attrs", "adopt", "rec")

    def __init__(self, name: str, attrs: dict, adopt: bool):
        self.name, self.attrs, self.adopt = name, attrs, adopt

    def __enter__(self) -> SpanRecord:
        self.rec = TRACER.open(self.name, self.attrs, self.adopt)
        return self.rec

    def __exit__(self, *exc) -> bool:
        TRACER.close(self.rec)
        return False


def span(name: str, adopt: bool = False, **attrs):
    """A context manager: the span `name` while a profiler records (see the
    module docstring), else one shared null context. `adopt`: spans first
    opened meanwhile on another thread (the autograd engine's) nest under
    this one."""
    if not _profiler_on():
        return _NULL
    return _Span(name, attrs, adopt)


class _BackwardSpan:
    """The span of one call's backward: opened by its first backward node,
    closed by its last."""

    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name, self.rec = name, None

    def open(self) -> None:
        if self.rec is None and _profiler_on():
            self.rec = TRACER.open(self.name, {})

    def close(self) -> None:
        if self.rec is not None:
            TRACER.close(self.rec)
            self.rec = None  # a second backward of a retained graph opens another


class _BackwardStart(torch.autograd.Function):
    """The identity on a call's output; its backward, the first of the
    call's, opens the call's backward span."""

    @staticmethod
    def forward(ctx, box, t):
        ctx.box = box
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        ctx.box.open()
        return None, g


class _BackwardEnd(torch.autograd.Function):
    """The identity on a call's inputs; its backward, which runs once every
    input's gradient is complete, closes the call's backward span."""

    @staticmethod
    def forward(ctx, box, *ts):
        ctx.box = box
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        ctx.box.close()
        return (None, *gs)


def _with_backward_span(name: str, fn, args: tuple, kwargs: dict):
    """fn(*args, **kwargs) between _BackwardEnd on its inputs that require
    grad and _BackwardStart on its output."""
    slots = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor) and a.requires_grad]
    keys = [k for k, a in kwargs.items() if isinstance(a, torch.Tensor) and a.requires_grad]
    if not slots and not keys:
        return fn(*args, **kwargs)
    box = _BackwardSpan(name)
    ins = _BackwardEnd.apply(box, *(args[i] for i in slots), *(kwargs[k] for k in keys))
    ins = (ins,) if isinstance(ins, torch.Tensor) else ins
    args = list(args)
    for i, t in zip(slots, ins):
        args[i] = t
    kwargs = {**kwargs, **dict(zip(keys, ins[len(slots):]))}
    out = fn(*args, **kwargs)
    if isinstance(out, torch.Tensor) and out.requires_grad:
        out = _BackwardStart.apply(box, out)
    return out


def traced(name: str, backward: bool = False):
    """Decorator: each call of the function in the span `name`; with
    `backward`, where grad is enabled, the backward of its output in the
    span `name + ".bwd"`. Off (no profiler recording), the call costs a
    flag read more."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler_on():
                return fn(*args, **kwargs)
            with span(name):
                if backward and torch.is_grad_enabled():
                    return _with_backward_span(name + ".bwd", fn, args, kwargs)
                return fn(*args, **kwargs)

        return call

    return wrap
