"""The work counts (``benchmark.roofline``) on shapes counted by hand, and
the bound PERF.md's kernel table gives for K1 at 200k and K1-fm at 1M."""

import pytest

from benchmark import roofline as rf


def test_k1_200k_and_k1fm_1m_bounds():
    # K1 at 200k nodes, 2.2M stored entries, d = 20: (row pointer, columns,
    # values, x, y) = 0.8 + 8.8 + 8.8 + 16 + 16 MB over 3.35 TB/s
    k1 = rf.spmv(200_000, 2_200_000, 20)
    assert k1.bytes == (200_001 + 2 * 2_200_000 + 2 * 200_000 * 20) * 4
    assert round(k1.least_s() * 1e3, 4) == 0.0150
    # K1-fm at 1M nodes, 11M entries, the (24, n) state
    k1fm = rf.k1fm(1_000_000, 11_000_000, 24)
    assert k1fm.bytes == 284_000_004
    assert round(k1fm.least_s() * 1e3, 4) == 0.0848
    assert k1fm.flops == 2 * 11_000_000 * 24


def test_k2_counts_a_h_w_b_and_the_output():
    w = rf.k2(400, 20)
    assert w.bytes == (160_000 + 8_000 + 400 + 20 + 8_000) * 4 == 705_680
    assert w.flops == 2 * 400 * 400 * 20 + 2 * 400 * 20 * 20 == 6_720_000
    # bound by bytes: 705,680 / 3.35e12 s
    assert w.least_s() == pytest.approx(705_680 / 3.35e12)


def test_a_function_bound_by_operations():
    w = rf.Work(bytes=1.0, flops=495e12)
    assert w.least_s() == pytest.approx(1.0)


def _shapes(**kw):
    base = dict(n=10, nnz=30, operator="csr", state_width=4, hidden=4,
                input_size=1, output_size=1, observations=3, params=50)
    base.update(kw)
    return base


def test_rhs_and_its_vjp():
    w = _shapes()
    # relu((A h) W + b): CSR (11 + 60) + h 40 + out 40 + W 16 + b 4 floats
    assert rf.rhs(w).bytes == (11 + 60 + 40 + 40 + 16 + 4) * 4
    assert rf.rhs(w).flops == 2 * 30 * 4 + 2 * 10 * 4 * 4
    # the VJP: CSR, cotangent, h, out, h's cotangent (4 states), W, dW, db
    assert rf.rhs_vjp(w).bytes == (11 + 60 + 4 * 40 + 2 * 16 + 4) * 4
    dense = _shapes(operator="dense")
    assert rf.rhs(dense).bytes == (100 + 40 + 40 + 16 + 4) * 4


def test_attempt_counts_the_tableaus_nonzero_terms():
    w = _shapes()
    s = 10 * 4 * 4                                 # a state, bytes
    pieces = rf.attempt(w)
    # six combinations over 1, 2, 3, 4, 5, 5 stages (+ y in, y_i out)
    assert [p.bytes for p in pieces[:6]] == [(t + 2) * s
                                            for t in (1, 2, 3, 4, 5, 5)]
    # the error: six stages, y0 and y1 in
    assert pieces[6].bytes == 8 * s
    mid, readout = rf.accepted(w)
    assert mid.bytes == 8 * s
    assert readout.bytes == 5 * (40 + 10) * 4


def test_step_sums_least_times_of_live_work_only():
    w = _shapes()
    one = rf.step(w, nfe=8, attempts=1, accepted_=1)
    two = rf.step(w, nfe=14, attempts=2, accepted_=1)
    extra = (6 * (rf.rhs(w).least_s() + rf.rhs_vjp(w).least_s())
             + 2 * rf.total_least_s(rf.attempt(w)))
    assert two - one == pytest.approx(extra)
    assert one > 0
