"""Step timing (counterpart of `alphafold2_tpu/utils/profiling.py`).

- `percentile`: the one interpolating percentile the port reports through
  (`StepTimer`, `obs.registry.Histogram`);
- `StepTimer`: wall-clock step durations with mean/p50/p90/p99/min. The
  card runs asynchronously, so `stop()` synchronises the CUDA device
  before it reads the clock: a step's time includes its kernels.
- `trace`: a `torch.profiler` scope that writes a trace directory
  TensorBoard's profiler plugin loads (the CPU's activities, and the
  card's when one is in use);
- `annotate`: a named range that shows up in the profiler's timeline.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Sequence

import torch


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (numpy's default method) on a
    possibly-unsorted sequence; 0.0 for empty input."""
    import numpy as np

    return float(np.percentile(values, q)) if len(values) else 0.0


def synchronize():
    """Wait for the CUDA device, when one is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Accumulates wall-clock step durations (seconds). `histogram`: an
    optional `obs.registry.Histogram` every stop() also observes into."""

    def __init__(self, histogram=None):
        self.durations: List[float] = []
        self.histogram = histogram
        self._start: Optional[float] = None

    def start(self):
        synchronize()
        self._start = time.perf_counter()

    def stop(self):
        if self._start is None:
            raise RuntimeError("StepTimer.stop() without start()")
        synchronize()
        dur = time.perf_counter() - self._start
        self.durations.append(dur)
        self._start = None
        if self.histogram is not None:
            self.histogram.observe(dur)

    @contextlib.contextmanager
    def measure(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    @property
    def count(self) -> int:
        return len(self.durations)

    @property
    def mean(self) -> float:
        return sum(self.durations) / max(len(self.durations), 1)

    @property
    def p50(self) -> float:
        return percentile(self.durations, 50)

    @property
    def p90(self) -> float:
        return percentile(self.durations, 90)

    @property
    def p99(self) -> float:
        return percentile(self.durations, 99)

    @property
    def best(self) -> float:
        return min(self.durations) if self.durations else 0.0

    def summary(self) -> dict:
        return {"count": self.count, "mean_s": self.mean,
                "p50_s": self.p50, "p90_s": self.p90, "p99_s": self.p99,
                "best_s": self.best}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the scope into `log_dir`: one `*.pt.trace.json` that
    TensorBoard's profiler plugin (or chrome://tracing) loads. The card's
    kernels are traced when CUDA is available."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    try:
        yield prof
    finally:
        synchronize()
        prof.stop()


annotate = torch.profiler.record_function
