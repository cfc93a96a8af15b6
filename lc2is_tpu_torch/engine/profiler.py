"""Timing and tracing, counterpart of ``lc2is_tpu/engine/profiler.py``:

- ``timeit``: the reference's decorator (``metrics.py:14-23``), with a
  ``torch.cuda.synchronize()`` before the clock stops where a card is in use,
  so the time covers the device's work and not only its enqueue;
- ``trace``: ``torch.profiler`` over the CPU and, where there is one, the
  card, its Chrome trace written to ``logdir``;
- ``StepTimer``: wall-clock per step with the first ``warmup`` steps left out.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Optional

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(func):
    """Print the seconds ``func`` took, its device work included."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        start = time.perf_counter()
        result = func(*args, **kwargs)
        _sync()
        total = time.perf_counter() - start
        print(f"Function {func.__name__} took {total:.4f} seconds")
        return result

    return wrapper


@contextlib.contextmanager
def trace(logdir: str = "./lc2is_trace"):
    """``torch.profiler.profile`` around the block; yields the profiler, and
    writes ``{logdir}/trace.json`` (chrome://tracing, Perfetto) at the end."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """``with timer:`` around each step; ``mean`` and ``steps_per_sec`` over
    the steps after the first ``warmup``."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._n = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / self.mean if self.times else 0.0
