"""Step timing and trace capture.

The port of `tcdiff_tpu/utils/profiling.py`: `trace` records a
torch.profiler trace (the host, and the card where there is one) and
writes it as a Chrome trace; `StepTimer` keeps an EMA of the step time and
derives steps/s and seconds of motion per second. A caller that times
device work ends it with `torch.cuda.synchronize()` before `tock`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


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
