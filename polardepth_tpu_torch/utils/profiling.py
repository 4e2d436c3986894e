"""Profiling hooks (polardepth_tpu/utils/profiling.py): a torch.profiler
trace and per-step wall-clock statistics."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block on the host and, where there is a card, on the
    card; the trace is written to log_dir/trace.json (Chrome/Perfetto
    format).  Yields the profiler, whose key_averages() splits the time."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling per-step wall-clock statistics with examples/sec and ETA, the
    reference's log_time equivalent."""

    def __init__(self, batch_size: int, total_steps: int | None = None,
                 window: int = 50):
        self.batch_size = batch_size
        self.total_steps = total_steps
        self.window = window
        self._times: list[float] = []
        self._last = None
        self.step = 0

    def tick(self) -> dict:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            self._times = self._times[-self.window:]
        self._last = now
        self.step += 1
        if not self._times:
            return {}
        mean = sum(self._times) / len(self._times)
        out = {"step_time_s": mean,
               "examples_per_sec": self.batch_size / mean}
        if self.total_steps:
            out["eta_s"] = mean * max(self.total_steps - self.step, 0)
        return out
