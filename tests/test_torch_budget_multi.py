"""The replica sweeps' budget helpers and memory guard against the JAX
package (``ndcn_tpu/train/budget.py``): ``probe_step_budget_multi``,
``probe_step_budget_each`` and ``bucket_budgets`` on the same attempt
counts give the same budgets and buckets (exact: integer arithmetic), and
the guard's refusal names the JAX driver's advice."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from ndcn_tpu.train import budget as j_budget
from ndcn_tpu_torch.train import budget

ATTEMPTS = [[3], [7, 12, 5, 9], [1, 1, 1], [40, 2, 17, 17, 33, 8, 64],
            [0, 6]]


class _Stats(NamedTuple):
    n_accepted: int
    n_rejected: int


def _solves(attempts):
    """Probe solves that report ``attempts`` (split into accepted and
    rejected)."""
    return [lambda a=a: _Stats(a - a // 3, a // 3) for a in attempts]


@pytest.mark.parametrize("attempts", ATTEMPTS)
@pytest.mark.parametrize("kw", [{}, dict(floor=8, headroom=2.5, slack=4,
                                         quantum=4)])
def test_multi_and_each_match_jax(attempts, kw):
    assert (budget.probe_step_budget_multi(_solves(attempts), **kw)
            == j_budget.probe_step_budget_multi(_solves(attempts), **kw))
    assert (budget.probe_step_budget_each(_solves(attempts), **kw)
            == j_budget.probe_step_budget_each(_solves(attempts), **kw))


@pytest.mark.parametrize("budgets", [
    [16], [16, 16, 24], [8, 16, 16, 24, 40, 40, 48, 96],
    list(np.random.RandomState(0).choice([16, 24, 32, 48, 64, 128], 25))])
@pytest.mark.parametrize("max_buckets", [1, 2, 3, 4, 8])
def test_bucket_budgets_match_jax(budgets, max_buckets):
    got = budget.bucket_budgets(budgets, max_buckets)
    want = j_budget.bucket_budgets(budgets, max_buckets)
    assert [b for b, _ in got] == [int(b) for b, _ in want]
    for (_, ix), (_, jx) in zip(got, want):
        np.testing.assert_array_equal(ix, jx)
    assert sorted(np.concatenate([ix for _, ix in got]).tolist()) == list(
        range(len(budgets)))


def test_memory_guard_refuses_with_the_jax_advice():
    """No guard on the CPU; a sweep over the limit is refused before it
    trains, naming how many replicas fit."""
    assert budget.sweep_memory_estimate(lambda: None, 25,
                                        torch.device("cpu")) is None
    budget.check_sweep_memory(None, 25)
    est = {"per_replica": 3 * 10 ** 9, "estimate": 75 * 10 ** 9,
           "limit": 68 * 10 ** 9}
    with pytest.raises(SystemExit, match="run batches of <= 22 replicas"):
        budget.check_sweep_memory(est, 25)
    budget.check_sweep_memory(dict(est, estimate=60 * 10 ** 9), 20)
    with pytest.raises(SystemExit, match="not even ONE replica"):
        budget.check_sweep_memory(dict(est, per_replica=70 * 10 ** 9), 25)
