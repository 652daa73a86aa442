"""The port's tracing: the ``torch.profiler`` trace of the drivers'
``--profile_dir`` (the JAX package's ``jax.profiler`` trace), and ``span``,
the named ranges the port opens at its layer boundaries, which land in that
trace (and in any other ``torch.profiler`` trace) beside the device's
events, on the same clock."""

from __future__ import annotations

import contextlib
import os
import time

from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler is
    recording, else a shared null context: off, a span costs one flag read
    and starts no torch operation, so a CUDA graph captured with the
    profiler off records nothing of it.

    The port's spans: ``train.step`` holding ``train.forward``,
    ``train.backward`` (the backward and the gradients' all-reduce) and
    ``train.optimizer`` (``train.optim``); ``model.encode`` and
    ``model.decode`` (``models.ndcn.ndcn_forward``; the decoding left after
    the solve); ``ode.solve`` holding one ``ode.attempt`` an attempt (which
    holds the host loop's ``ode.sync``, its one device→host read) and the
    host loop's ``ode.observe`` around each read of a step's observations
    (``ode.adaptive``); ``train.chunk.replay`` around each graph replay and
    ``train.chunk.read`` around the chunk's one read (``train.chunk``)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _profiler.record_function(name)


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
