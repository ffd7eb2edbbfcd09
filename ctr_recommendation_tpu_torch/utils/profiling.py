"""Profiling hooks: a ``torch.profiler`` trace of a block, and the step
timer that powers the examples/s logging."""

from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.distributed as dist


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block into
    ``log_dir/rank<R>.pt.trace.json`` (Chrome trace JSON, which Perfetto and
    TensorBoard's profiler plugin read; R is the process group's rank, 0
    without one): host activity, and the device's once this process uses
    CUDA. On exit the device is synchronized first, so the trace holds the
    block's kernels to their end."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    rank = dist.get_rank() if dist.is_initialized() else 0
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"rank{rank}.pt.trace.json"))


class StepTimer:
    """Wall-clock EMA of step time -> examples/s."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self._last: float | None = None
        self.ema: float | None = None

    def tick(self) -> float | None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.ema = dt if self.ema is None else (
                self.alpha * dt + (1 - self.alpha) * self.ema
            )
        self._last = now
        return self.ema

    def examples_per_sec(self, batch_size: int) -> float | None:
        return batch_size / self.ema if self.ema else None
