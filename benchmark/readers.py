"""What the metric readers under ``benchmark/metrics/`` read from a run's
record, shared by the metrics that split one quantity by the end-to-end
metric it moves (``nfe_per_step.graphed`` and ``nfe_per_step.hostloop``
read the same thing in different cells). Each returns None where the run
holds nothing to read.

The record (``benchmark/run.py``): ``window`` (steps, failed, seconds,
cycle_s), ``setup_s``, ``peak_bytes``, ``capture_s``, ``max_steps``,
``work`` (the shapes ``benchmark.roofline`` counts), ``counts`` (one
cycle's (nfe, accepted, rejected, success) a step, ``--trace 1``),
``trace`` (``benchmark.trace.Trace`` of ``trace_steps`` steps, ``--trace
1``) and ``traffic``.
"""

from __future__ import annotations

from benchmark import roofline
from benchmark import trace as trace_lib


def steps_per_s(rec):
    """Completed steps over the whole window, by the host's clock."""
    w = rec["window"]
    return w.steps / w.seconds


def nfe_per_step(rec):
    """The solves' live RHS evaluations, the mean over one cycle."""
    counts = rec["counts"]
    if not counts:
        return None
    return sum(c[0] for c in counts) / len(counts)


def step_roofline_pct(rec):
    """The step's least time (``roofline.step``, one cycle's live NFE,
    attempts and accepted attempts) over the window's mean step time."""
    counts, win = rec["counts"], rec["window"]
    if not counts or not win.steps:
        return None
    k = len(counts)
    least = roofline.step(rec["work"], sum(c[0] for c in counts) / k,
                          sum(c[1] + c[2] for c in counts) / k,
                          sum(c[1] for c in counts) / k)
    return 100.0 * least / (win.seconds / win.steps)


def idle_pct(rec):
    """1 - the union of the device operations' intervals / the traced
    window."""
    tr = rec["trace"]
    if tr is None or not tr.device:
        return None
    return 100.0 * trace_lib.idle_share(tr)


def launches_per_step(rec):
    """Kernels in the traced window over its steps."""
    tr = rec["trace"]
    n = 0 if tr is None else trace_lib.launches(tr)
    return n / rec["traffic"]["trace_steps"] if n else None
