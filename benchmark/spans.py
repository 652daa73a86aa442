"""What the program's own spans (``ndcn_tpu_torch.utils.timing.span``:
``record_function`` ranges such as ``train.backward``, ``ode.solve``,
``train.chunk.replay``) show in a traced window (``benchmark.trace``): the
spans and the device events are one profiler trace, on one clock.

- the idle time under a span: the window's gaps (``trace.gaps``) where
  they overlap the span's intervals on the window's thread;
- the device time a span launched: the device operations whose launch (a
  ``cuda_runtime`` or ``cuda_driver`` event on the window's thread) starts
  inside the span, matched by the trace's ``correlation`` id;
- the device time launched from other threads: device operations whose
  launch is no event of the window's thread (in an eager train step, the
  autograd engine's device thread: the backward);
- a span's own host time.

Each returns None where the trace holds no such span (a program without
it), or no device operation. Times are per step of the traced window
(``traffic["trace_steps"]``) in milliseconds, or shares of the window in
percent.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Set, Tuple

from benchmark import trace as trace_lib

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _interval(e: dict) -> Tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def intervals(tr: trace_lib.Trace, name: str) -> List[Tuple[float, float]]:
    """The merged intervals of the spans ``name`` on the window's thread,
    cut to the window (microseconds)."""
    return [(max(s, tr.start), min(e, tr.end))
            for s, e in trace_lib.union(_interval(e) for e in tr.host
                                        if e.get("name") == name)
            if min(e, tr.end) > max(s, tr.start)]


def _overlap(a: List[Tuple[float, float]],
             b: List[Tuple[float, float]]) -> float:
    """The length shared by two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_pct(tr: Optional[trace_lib.Trace], name: str) -> Optional[float]:
    """The device's idle time under the spans ``name``, in percent of the
    traced window."""
    if tr is None or not tr.device:
        return None
    under = intervals(tr, name)
    if not under:
        return None
    return 100.0 * _overlap(trace_lib.gaps(tr), under) / (tr.end - tr.start)


def _correlation(e: dict):
    return e.get("args", {}).get("correlation")


def _launches(tr: trace_lib.Trace) -> List[dict]:
    return [e for e in tr.host if e.get("cat") in LAUNCH_CATS
            and _correlation(e) is not None]


def _device_ms(tr: trace_lib.Trace, keep) -> float:
    return sum(float(e["dur"]) for e in tr.device
               if _correlation(e) is not None and keep(_correlation(e))
               ) * 1e-3


def device_ms_per_step(rec, name: str) -> Optional[float]:
    """The device time of the operations launched inside the spans
    ``name`` on the window's thread, per traced step (ms)."""
    tr = rec["trace"]
    if tr is None or not tr.device:
        return None
    under = intervals(tr, name)
    if not under:
        return None
    starts = [s for s, _ in under]
    ids: Set[int] = set()
    for e in _launches(tr):
        ts = float(e["ts"])
        k = bisect.bisect_right(starts, ts) - 1
        if k >= 0 and ts < under[k][1]:
            ids.add(_correlation(e))
    return _device_ms(tr, ids.__contains__) / rec["traffic"]["trace_steps"]


def other_thread_device_ms_per_step(rec, marker: str) -> Optional[float]:
    """The device time of the operations in the window that no event of
    the window's thread launched, per traced step (ms); None unless a span
    ``marker`` is on the window's thread."""
    tr = rec["trace"]
    if tr is None or not tr.device or not intervals(tr, marker):
        return None
    own = {_correlation(e) for e in _launches(tr)}
    return _device_ms(tr, lambda c: c not in own) / \
        rec["traffic"]["trace_steps"]


def host_ms_per_step(rec, name: str) -> Optional[float]:
    """The summed host time of the spans ``name`` in the window, per
    traced step (ms)."""
    tr = rec["trace"]
    if tr is None:
        return None
    under = intervals(tr, name)
    if not under:
        return None
    return sum(e - s for s, e in under) * 1e-3 / \
        rec["traffic"]["trace_steps"]
