"""Timing and running-average helpers, as ``ndcn_tpu/utils/timing.py``,
and a ``torch.profiler`` trace context for the drivers' ``--profile_dir``
(the JAX package's ``jax.profiler`` trace)."""

from __future__ import annotations

import contextlib
import os
import time


class Timer:
    def __enter__(self):
        self.start = time.perf_counter()
        self.elapsed = 0.0
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False


class RunningAverageMeter:
    """Exponential moving average of a scalar."""

    def __init__(self, momentum: float = 0.99):
        self.momentum = momentum
        self.reset()

    def reset(self):
        self.val = None
        self.avg = 0.0

    def update(self, val: float):
        self.avg = val if self.val is None else (
            self.avg * self.momentum + val * (1.0 - self.momentum))
        self.val = val


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA's
    where a card is visible) and write a Chrome trace
    ``trace_<pid>_<ms>.json`` into ``logdir``; a no-op for None. Yields the
    trace's path (None when off)."""
    if logdir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_"
                                f"{int(time.time() * 1e3)}.json")
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
