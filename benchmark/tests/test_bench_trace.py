"""The trace arithmetic (``benchmark.trace``) on a small synthetic Chrome
trace whose busy time, gaps and labels are counted by hand."""

import json
import re

import pytest

from benchmark import trace as tr


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1}


def _events():
    # the window: [100, 200) us on thread 1
    return [
        _ev(tr.WINDOW, "user_annotation", 100, 100),
        _ev("bench.read", "user_annotation", 105, 60),
        _ev("aten::mm", "cpu_op", 110, 10),
        _ev("cudaLaunchKernel", "cuda_runtime", 112, 2),
        _ev("aten::add", "cpu_op", 150, 10),
        _ev("aten::other_thread", "cpu_op", 120, 50, tid=2),
        # device: two overlapping kernels, a copy, a kernel after the window
        _ev("void fused_rhs_kernel<64, 2>(float const*)", "kernel", 115, 20),
        _ev("void bsr_fused_rhs_kernel<64>(float const*)", "kernel", 125, 15),
        _ev("Memcpy DtoH", "gpu_memcpy", 170, 5),
        _ev("void fused_rhs_kernel<64, 2>(float const*)", "kernel", 190, 20),
        _ev("early", "kernel", 50, 10),        # before the window: left out
        {"ph": "i", "name": "instant", "ts": 120},
    ]


def test_window_takes_its_span_and_thread():
    t = tr.window(_events())
    assert t.start == 100
    # the last device operation that started inside ends at 210
    assert t.end == 210
    assert t.window_s == pytest.approx(110e-6)
    assert sorted(e["name"] for e in t.host) == [
        "aten::add", "aten::mm", "bench.read", "cudaLaunchKernel"]
    assert len(t.device) == 4


def test_busy_union_idle_and_launches():
    t = tr.window(_events())
    # union: [115, 140) + [170, 175) + [190, 210) = 25 + 5 + 20 = 50 us
    assert tr.busy_s(t) == pytest.approx(50e-6)
    assert tr.idle_share(t) == pytest.approx(1 - 50 / 110)
    assert tr.launches(t) == 3
    assert tr.union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]


def test_kernel_time_matches_whole_names():
    t = tr.window(_events())
    secs, calls = tr.kernel_time(t, re.compile(r"\bfused_rhs_kernel<"))
    assert calls == 2 and secs == pytest.approx(40e-6)
    secs, calls = tr.kernel_time(t, re.compile(r"\bbsr_fused_rhs_kernel<"))
    assert calls == 1 and secs == pytest.approx(15e-6)


def test_breakdown_labels_gaps_by_the_innermost_host_op():
    t = tr.window(_events())
    assert tr.gaps(t) == [(100, 115), (140, 170), (175, 190)]
    b = tr.breakdown(t)
    ops = dict((k, v) for k, v in b["device_ops"])
    assert ops["void fused_rhs_kernel<64, 2>(float const*)"] == \
        pytest.approx(40e-6)
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # [100, 115): middle 107.5 inside bench.read; [140, 170): 155 inside
    # aten::add (in bench.read); [175, 190): 182.5 outside any operation
    assert gaps == pytest.approx({"bench.read": 15e-6, "aten::add": 30e-6,
                                  "host, outside any operation": 15e-6})
    assert len(b["device_ops"]) <= tr.TOP and len(b["idle_gaps"]) <= tr.TOP


def test_load_reads_an_exported_file(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    assert len(tr.load(str(path))) == len(_events())


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        tr.window([_ev("x", "kernel", 0, 1)])
