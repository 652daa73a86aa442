"""The readers of the program's spans (``benchmark.spans`` and the five
metrics that use it) on a synthetic Chrome trace of two threads, counted
by hand: the window's thread holds the spans and its launches, a second
thread (the autograd engine's, in an eager step) only launches."""

import pytest

from benchmark import spans, spec
from benchmark import trace as tr

METRICS = ("idle_backward_pct.hostloop", "idle_solve_pct.hostloop",
           "solve_device_ms_per_step.hostloop",
           "backward_device_ms_per_step.hostloop",
           "replay_host_ms_per_step.graphed")
STEPS = 2


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events(with_spans=True):
    """The window [0, 1000) us on thread 1; busy [70, 120), [210, 260),
    [310, 340), [420, 500), [520, 560), [710, 730), [905, 915)."""
    ev = [
        _ev(tr.WINDOW, "user_annotation", 0, 1000),
        _ev("cudaLaunchKernel", "cuda_runtime", 60, 5, corr=1),
        _ev("cudaLaunchKernel", "cuda_runtime", 200, 5, corr=2),
        _ev("cuLaunchKernel", "cuda_driver", 300, 5, corr=4),
        _ev("cudaLaunchKernel", "cuda_runtime", 700, 5, corr=3),
        _ev("cudaMemcpyAsync", "cuda_runtime", 900, 20, corr=7),
        # the autograd thread's launches
        _ev("cudaLaunchKernel", "cuda_runtime", 410, 5, tid=2, corr=5),
        _ev("cudaLaunchKernel", "cuda_runtime", 450, 5, tid=2, corr=6),
        _ev("k_solve_a", "kernel", 70, 50, tid=7, corr=1),
        _ev("k_solve_b", "kernel", 210, 50, tid=7, corr=2),
        _ev("k_solve_c", "kernel", 310, 30, tid=7, corr=4),
        _ev("k_bwd_a", "kernel", 420, 80, tid=7, corr=5),
        _ev("k_bwd_b", "kernel", 520, 40, tid=7, corr=6),
        _ev("k_adam", "kernel", 710, 20, tid=7, corr=3),
        _ev("Memcpy DtoH", "gpu_memcpy", 905, 10, tid=7, corr=7),
    ]
    if with_spans:
        ev += [
            _ev("ode.solve", "user_annotation", 50, 300),
            _ev("ode.attempt", "user_annotation", 55, 150),
            _ev("train.backward", "user_annotation", 400, 200),
            _ev("train.chunk.replay", "user_annotation", 800, 10),
            _ev("train.chunk.replay", "user_annotation", 850, 20),
            # another thread's span: not the window's, left out
            _ev("ode.solve", "user_annotation", 600, 400, tid=2),
        ]
    return ev


def _read(name, events):
    entry = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}[name]
    rec = {"trace": None if events is None else tr.window(events),
           "traffic": {"trace_steps": STEPS}}
    return spec.metric_reader(name, entry).read(rec)


def test_the_readers_count_the_trace_by_hand():
    ev = _events()
    # gaps under train.backward [400, 600): [400, 420), [500, 520),
    # [560, 600) = 80 us of the 1000
    assert _read("idle_backward_pct.hostloop", ev) == pytest.approx(8.0)
    # under ode.solve [50, 350): [50, 70), [120, 210), [260, 310),
    # [340, 350) = 170 us
    assert _read("idle_solve_pct.hostloop", ev) == pytest.approx(17.0)
    # launched inside ode.solve: correlations 1, 2 and 4 (the CUDA driver
    # launch too), 130 us over 2 steps
    assert _read("solve_device_ms_per_step.hostloop", ev) == \
        pytest.approx(0.065)
    # launched by no event of the window's thread: 5 and 6, 120 us
    assert _read("backward_device_ms_per_step.hostloop", ev) == \
        pytest.approx(0.060)
    # two replays of 10 and 20 us over 2 steps
    assert _read("replay_host_ms_per_step.graphed", ev) == \
        pytest.approx(0.015)


def test_the_layers_and_the_rest_sum_to_the_busy_time():
    t = tr.window(_events())
    rec = {"trace": t, "traffic": {"trace_steps": STEPS}}
    everything = sum(float(e["dur"]) for e in t.device) * 1e-3 / STEPS
    solve = spans.device_ms_per_step(rec, "ode.solve")
    backward = spans.other_thread_device_ms_per_step(rec, "train.backward")
    # the optimizer's kernel and the read's copy: 30 us
    assert everything - solve - backward == pytest.approx(0.015)
    assert everything == pytest.approx(tr.busy_s(t) * 1e3 / STEPS)


@pytest.mark.parametrize("name", METRICS)
def test_a_trace_without_the_spans_reads_none(name):
    assert _read(name, _events(with_spans=False)) is None
    assert _read(name, None) is None


def test_no_device_operation_reads_none_but_the_replays_host_time():
    ev = [e for e in _events() if e["cat"] not in ("kernel", "gpu_memcpy")]
    for name in METRICS[:4]:
        assert _read(name, ev) is None
    assert _read("replay_host_ms_per_step.graphed", ev) == \
        pytest.approx(0.015)
