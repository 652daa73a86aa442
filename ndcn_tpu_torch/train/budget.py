"""Automatic step budgets for the differentiable solve, as
``ndcn_tpu/train/budget.py::probe_step_budget``.

The experiments probe the inference solve once at initialization and size the
step-attempt budget of the training solve from it, with headroom. Exhaustion
during training surfaces as a NaN loss (the solver flags success=False),
never as a silently short trajectory. The JAX package's byte estimators are
TPU layout models and are not ported; the scale experiment's ``--estimate``
carries the port's own census (``experiments/large_graph.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def accelerator_memory_limit(device: torch.device) -> Optional[int]:
    """The card's device memory in bytes (its total memory), or None for the
    CPU, which has no device arena to size against."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


def probe_step_budget(solve_nondiff: Callable[[], "object"],
                      floor: int = 16, headroom: float = 4.0,
                      slack: int = 8, quantum: int = 8) -> int:
    """Run ``solve_nondiff`` (returning SolveStats) and size the budget:
    clip(headroom · attempts + slack, floor, ∞), rounded up to ``quantum``.

    The defaults are conservative; a caller that recovers from exhaustion
    (``train.elastic.ElasticBudget``) passes snug values, as the dynamics
    experiments and the classification driver do (``floor=8,
    headroom=2.5, slack=4, quantum=4``, the JAX dgnn driver's).

    The budget is a count of step attempts, a property of the matrix and
    the tolerances, not of the operator's layout or the device. The JAX
    driver probes on the CPU, and with COO where the run asks for BSR (its
    interpret-mode Pallas BSR is slow there); the port's drivers probe on
    the run's own device with the run's own operator, BSR included, since
    both paths count the same attempts."""
    stats = solve_nondiff()
    attempts = int(stats.n_accepted) + int(stats.n_rejected)
    budget = max(floor, int(headroom * attempts) + slack)
    return -(-budget // quantum) * quantum
