"""Elastic step-budget recovery, as ``ndcn_tpu/train/elastic.py``.

A snug step budget keeps the differentiable solve short, but a training
trajectory may outgrow it: the loss then turns NaN (the solver flags
``success=False`` and the training loss propagates it). ``ElasticBudget``
makes the snug choice safe: the training loop snapshots ``(cursor, rng, state)`` at
every finite-loss boundary; on a NaN under an auto-sized budget it rolls
back to the snapshot, doubles the budget and replays the lost iterations
(same generator state, so the replay is deterministic). After
``max_retries`` consecutive doublings a NaN is divergence, not exhaustion,
and training stops with advice.

Snapshots are deep copies (tensors cloned on their own device): a kept
reference would see the optimizer's in-place updates.
"""

from __future__ import annotations

import copy
from typing import Any, Tuple

import numpy as np


class ElasticBudget:
    """Rollback-and-regrow controller for an auto-sized step budget.

    Usage (training loop)::

        elastic = ElasticBudget(max_steps, enabled=budget_is_auto)
        elastic.snapshot(cursor, rng_state, state)
        ...
        if elastic.exhausted(loss):         # NaN under an auto budget
            cursor, rng_state, state = elastic.rollback()
        else:
            elastic.snapshot(cursor, rng_state, state)
    """

    def __init__(self, max_steps: int, enabled: bool = True,
                 max_retries: int = 3):
        self.max_steps = max_steps
        self.enabled = enabled
        self.max_retries = max_retries
        self.retries = 0          # consecutive failed doublings (resets)
        self.total_rollbacks = 0  # cumulative, for reporting
        self._snap = None
        self._rollback_cursor = None

    def snapshot(self, cursor: Any, rng: Any, state: Any) -> None:
        """Record a finite-loss restore point (a copy of ``state``).

        A snapshot strictly past the last rollback point means that recovery
        succeeded: the retry counter resets, so ``max_retries`` bounds
        CONSECUTIVE failed doublings, not total recoveries over a long run."""
        if self.enabled:
            if (self._rollback_cursor is not None
                    and cursor > self._rollback_cursor):
                self.retries = 0
                self._rollback_cursor = None
            self._snap = (cursor, copy.deepcopy(rng), copy.deepcopy(state))

    def exhausted(self, loss) -> bool:
        """True when recovery should fire: any non-finite value in ``loss``
        (a scalar or a sequence of them; eval metrics share the budget)."""
        return self.enabled and not bool(np.all(np.isfinite(
            np.asarray(loss, dtype=np.float64))))

    def rollback(self) -> Tuple[Any, Any, Any]:
        """Double the budget; return a copy of the snapshot
        ``(cursor, rng, state)`` (the kept one survives a second rollback)."""
        if self.retries >= self.max_retries:
            raise SystemExit(
                f"training loss is NaN even at max_steps={self.max_steps} "
                f"({self.max_retries} budget doublings): this is divergence, "
                f"not step-budget exhaustion; lower --lr or loosen rtol/atol")
        self.retries += 1
        self.total_rollbacks += 1
        self.max_steps *= 2
        cursor, rng, state = self._snap
        self._rollback_cursor = cursor
        return cursor, copy.deepcopy(rng), copy.deepcopy(state)
