"""Arithmetic over a profiler trace in Chrome's trace format (the
``traceEvents`` of ``torch.profiler``'s ``export_chrome_trace``): what ran
on the device and when, against the traced window.

- the device's busy time: the union of the intervals of every device
  operation (kernels, copies, sets) inside the window; its idle share is
  1 - busy / window;
- the launches: the kernel events in the window;
- a kernel's time: the sum of the durations of its events (its name
  found by a regular expression);
- the breakdown: the device operations that took most time, by name, and
  the idle gaps (the window less the busy union) summed by the innermost
  host operation on the window's thread at each gap's middle.

Times in the trace are microseconds; every result here is in seconds.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
TOP = 10


class Trace(NamedTuple):
    device: List[dict]      # device operations inside the window
    host: List[dict]        # host operations on the window's thread
    start: float            # the window, microseconds
    end: float

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6


def load(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _complete(events: Iterable[dict]) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def window(events: List[dict], name: str = WINDOW) -> Trace:
    """The trace of the host span ``name``: its device operations (up to
    the last one that started inside it) and its thread's host operations."""
    done = _complete(events)
    spans = [e for e in done if e.get("name") == name
             and e.get("cat") in ("user_annotation", "cpu_op")]
    if not spans:
        raise ValueError(f"the trace holds no {name!r} span")
    span = max(spans, key=lambda e: e["dur"])
    start = float(span["ts"])
    end = start + float(span["dur"])
    device = [e for e in done if e.get("cat") in DEVICE_CATS
              and start <= float(e["ts"]) < end]
    if device:
        end = max(end, max(float(e["ts"]) + float(e["dur"]) for e in device))
    host = [e for e in done if e.get("cat") in HOST_CATS
            and e.get("tid") == span.get("tid") and e is not span
            and float(e["ts"]) < end
            and float(e["ts"]) + float(e["dur"]) > start]
    return Trace(device, host, start, end)


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals, merged and sorted."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(trace: Trace) -> float:
    merged = union((max(float(e["ts"]), trace.start),
                    min(float(e["ts"]) + float(e["dur"]), trace.end))
                   for e in trace.device)
    return sum(e - s for s, e in merged if e > s) * 1e-6


def idle_share(trace: Trace) -> float:
    return 1.0 - busy_s(trace) / trace.window_s


def launches(trace: Trace) -> int:
    return sum(1 for e in trace.device if e.get("cat") == "kernel")


def kernel_time(trace: Trace, pattern) -> Tuple[float, int]:
    """(seconds, events) of the kernels whose name ``pattern`` (a compiled
    regular expression) finds."""
    hits = [e for e in trace.device if e.get("cat") == "kernel"
            and pattern.search(e.get("name", ""))]
    return sum(float(e["dur"]) for e in hits) * 1e-6, len(hits)


def device_ops(trace: Trace, top: int = TOP) -> List[list]:
    by_name: Dict[str, float] = defaultdict(float)
    for e in trace.device:
        by_name[e.get("name", "?")] += float(e["dur"]) * 1e-6
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])
            [:top]]


def gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The window's idle intervals (microseconds)."""
    merged = union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in trace.device)
    out, at = [], trace.start
    for s, e in merged:
        if s > at:
            out.append((at, min(s, trace.end)))
        at = max(at, e)
    if at < trace.end:
        out.append((at, trace.end))
    return [(s, e) for s, e in out if e > s]


def _innermost(host: List[dict], points: List[float]) -> List[Optional[str]]:
    """The innermost host operation holding each sorted point: a sweep that
    keeps the operations open at the point on a stack (nested spans)."""
    order = sorted(host, key=lambda e: (float(e["ts"]), -float(e["dur"])))
    starts = [float(e["ts"]) for e in order]
    stack: List[dict] = []
    i, out = 0, []
    for p in points:
        j = bisect.bisect_right(starts, p)
        while i < j:
            e = order[i]
            while stack and float(stack[-1]["ts"]) + float(stack[-1]["dur"]) \
                    <= float(e["ts"]):
                stack.pop()
            stack.append(e)
            i += 1
        while stack and float(stack[-1]["ts"]) + float(stack[-1]["dur"]) <= p:
            stack.pop()
        out.append(stack[-1]["name"] if stack else None)
    return out


def idle_gaps(trace: Trace, top: int = TOP) -> List[list]:
    """The idle time summed by what the host was doing (module docstring)."""
    spans = gaps(trace)
    labels = _innermost(trace.host, [(s + e) / 2 for s, e in spans])
    by_label: Dict[str, float] = defaultdict(float)
    for (s, e), label in zip(spans, labels):
        by_label[label or "host, outside any operation"] += (e - s) * 1e-6
    return [[k, v] for k, v in sorted(by_label.items(), key=lambda kv: -kv[1])
            [:top]]


def breakdown(trace: Trace) -> dict:
    return {"device_ops": device_ops(trace), "idle_gaps": idle_gaps(trace)}
