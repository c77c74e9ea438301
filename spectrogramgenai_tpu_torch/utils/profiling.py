"""Profiling hooks (``spectrogramgenai_tpu/utils/profiling.py``): a
``torch.profiler`` trace written as a Chrome trace, and a steps/s reporter."""

from __future__ import annotations

import contextlib
import os
import time

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Trace the CPU and, where there is a card, the CUDA kernels of what
    runs inside into ``<log_dir>/trace.json`` (open it in Perfetto or
    chrome://tracing). No ``log_dir``: nothing is traced."""
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class StepTimer:
    """Rolling steps/s reporter for train loops: ``tick()`` returns the rate
    every ``every`` steps, else None."""

    def __init__(self, every: int = 100):
        self.every = every
        self._t0 = time.perf_counter()
        self._count = 0

    def tick(self) -> float | None:
        self._count += 1
        if self._count % self.every == 0:
            now = time.perf_counter()
            rate = self.every / (now - self._t0)
            self._t0 = now
            return rate
        return None
