"""Automatic step budgets for the differentiable solve, as
``ndcn_tpu/train/budget.py::probe_step_budget``.

The experiments probe the inference solve once at initialization and size the
step-attempt budget of the training solve from it, with headroom. Exhaustion
during training surfaces as a NaN loss (the solver flags success=False),
never as a silently short trajectory. Of the JAX package's byte estimators
``scan_train_bytes`` is ported, the footprint of one bounded differentiable
solve from its shapes, which the chunked train step's guard reads
(``check_step_memory``, ``train.chunk``); the others are TPU layout models
and are not: the scale experiment's ``--estimate`` carries the port's own
census (``experiments/large_graph.py``), and a replica sweep's guard
measures one replica's step (``sweep_memory_estimate``).

For replica sweeps (``--replicas``, ``--batch_iters``) the budget helpers
are the JAX package's, carried over as they are (arithmetic on attempt
counts): ``probe_step_budget_multi`` sizes one shared budget from the
hardest of several probed inits, ``probe_step_budget_each`` one budget per
init, and ``bucket_budgets`` groups replicas by budget.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


def accelerator_memory_limit(device: torch.device) -> Optional[int]:
    """The card's device memory in bytes (its total memory), or None for the
    CPU, which has no device arena to size against."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


def _tree_bytes(tree) -> int:
    from ndcn_tpu_torch.ode.tree_math import leaves

    return sum(leaf.numel() * leaf.element_size() for leaf in leaves(tree))


def scan_train_bytes(method: str, max_steps: int, y_state,
                     n_obs: int = 0, max_order: int = 12) -> int:
    """The device memory of ONE bounded differentiable solve inside a train
    step (``ode.adaptive.solve_scan``), from the solve's shapes: the JAX
    package's ``scan_train_bytes``, the same formula. Per attempt the
    forward emits the dense-output sources (whose cotangents the backward
    materializes again) and the backward keeps the carry (y, f). ``y_state``
    is the ODE state, a tensor or a tuple of them, on any device (``meta``
    included): (n, hidden) for NDCN.

    dopri5 / tsit5: max_steps · (2 · interp + 2 · y) bytes, interp the
    method's dense-output sources (5 states for dopri5, 8 for tsit5); adams:
    max_steps · (2 (max_order + 1) + 3) · y, the JAX package's VCABM carry;
    any other method: 2 · max(n_obs, 2) · y, a carry a grid point."""
    from ndcn_tpu_torch.ode import adaptive
    from ndcn_tpu_torch.ode.tree_math import tmap

    y_meta = tmap(lambda leaf: torch.empty_like(leaf, device="meta"), y_state)
    y_b = _tree_bytes(y_meta)
    if method in ("dopri5", "tsit5"):
        m = {"dopri5": adaptive.DOPRI5_METHOD,
             "tsit5": adaptive.TSIT5_METHOD}[method]
        interp_b = sum(_tree_bytes(c) for c in m.interp_init(y_meta))
        return max_steps * (2 * interp_b + 2 * y_b)
    if method == "adams":
        return max_steps * (2 * (max_order + 1) + 3) * y_b
    return 2 * max(n_obs, 2) * y_b


def check_step_memory(step_bytes: int, params, device: torch.device) -> None:
    """Refuse a train step whose estimate does not fit the card, before it
    runs: ``step_bytes`` (``scan_train_bytes``) plus the model's own bytes
    (its parameters, their gradients and Adam's two moments) against
    ``SWEEP_MEMORY_SHARE`` of the card's memory, as the sweep's guard sizes
    its limit. Nothing on the CPU."""
    limit = accelerator_memory_limit(device)
    if limit is None:
        return
    model_b = 4 * sum(p.numel() * p.element_size() for p in params)
    share = int(SWEEP_MEMORY_SHARE * limit)
    if step_bytes + model_b > share:
        raise SystemExit(
            f"the bounded train step needs ~{(step_bytes + model_b) / 1e9:.1f}"
            f" GB of device memory ({step_bytes / 1e9:.1f} GB for the solve's "
            f"attempts, {model_b / 1e6:.0f} MB for the model and Adam; budget "
            f"{share / 1e9:.1f} GB): lower --max_steps or --hidden, or drop "
            f"--scan_chunk")


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
    return _budget(_attempts(solve_nondiff()), floor, headroom, slack,
                   quantum)


def _budget(attempts: int, floor: int, headroom: float, slack: int,
            quantum: int) -> int:
    budget = max(floor, int(headroom * attempts) + slack)
    return -(-budget // quantum) * quantum


def _attempts(stats) -> int:
    return int(stats.n_accepted) + int(stats.n_rejected)


def probe_step_budget_multi(solves: Sequence[Callable[[], "object"]],
                            floor: int = 16, headroom: float = 4.0,
                            slack: int = 8, quantum: int = 8) -> int:
    """One shared budget from several probe solves: the most attempts any
    of them took, then ``probe_step_budget``'s formula. A batched solve
    cannot roll back one replica, and one init can need more attempts than
    another, so the sweep is sized for the hardest of the probed inits."""
    attempts = max(_attempts(solve()) for solve in solves)
    return _budget(attempts, floor, headroom, slack, quantum)


def probe_step_budget_each(solves: Sequence[Callable[[], "object"]],
                           floor: int = 16, headroom: float = 4.0,
                           slack: int = 8, quantum: int = 8) -> List[int]:
    """One budget per probe solve (``probe_step_budget``'s formula), for
    ``bucket_budgets``."""
    return [_budget(_attempts(solve()), floor, headroom, slack, quantum)
            for solve in solves]


def bucket_budgets(budgets, max_buckets: int) -> List[Tuple[int, np.ndarray]]:
    """Group replica indices by budget into at most ``max_buckets`` groups:
    [(budget, indices)] by budget ascending. While there are more distinct
    budgets than buckets, the adjacent pair whose merge adds the fewest
    wasted attempt slots (count[lo] · (hi - lo)) merges upward into the
    larger budget (a larger budget is always correct, merely slower)."""
    budgets = np.asarray(budgets)
    uniq = sorted(set(int(b) for b in budgets))
    while len(uniq) > max(1, max_buckets):
        counts = {u: int((budgets == u).sum()) for u in uniq}
        i = min(range(len(uniq) - 1),
                key=lambda j: counts[uniq[j]] * (uniq[j + 1] - uniq[j]))
        lo, hi = uniq[i], uniq[i + 1]
        budgets = np.where(budgets == lo, hi, budgets)
        uniq = sorted(set(int(b) for b in budgets))
    return [(u, np.flatnonzero(budgets == u)) for u in uniq]


# the share of the card's memory a sweep may plan to use (the JAX driver's)
SWEEP_MEMORY_SHARE = 0.85


def sweep_memory_estimate(probe_step: Callable[[], "object"], replicas: int,
                          device: torch.device,
                          probe_replicas: int = 1) -> Optional[dict]:
    """The device memory a sweep of ``replicas`` replicas needs, from the
    port's own census: ``probe_step`` (run once here), a training step of a
    sweep of ``probe_replicas`` replicas, takes its peak allocation above
    what was allocated before it; a replica takes that over
    ``probe_replicas``, and R replicas R times that. None on the CPU, which
    has no guard. Returns {"per_replica", "estimate", "limit"} in bytes;
    the limit is ``SWEEP_MEMORY_SHARE`` of the card's memory.

    The probe must be the step the sweep will take: with the continuous
    adjoint, the adjoint step (``make_ndcn_replica_train_step(adjoint=
    True)``), whose peak does not grow with the trajectory; backprop's
    does, which is the reason to run the adjoint.

    A batched solve records every replica's attempts until its slowest
    replica is done, so a probe of several replicas (the hardest of a few
    inits sets their attempts) sizes a replica closer than one alone."""
    limit = accelerator_memory_limit(device)
    if limit is None:
        return None
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    probe_step()
    torch.cuda.synchronize(device)
    used = max(1, torch.cuda.max_memory_allocated(device) - base)
    per_replica = -(-used // probe_replicas)
    return {"per_replica": per_replica, "estimate": replicas * per_replica,
            "limit": int(SWEEP_MEMORY_SHARE * limit)}


def check_sweep_memory(est: Optional[dict], replicas: int) -> None:
    """Refuse a sweep whose estimate exceeds the limit, before it trains,
    with the JAX driver's advice."""
    if est is None or est["estimate"] <= est["limit"]:
        return
    fit = est["limit"] // est["per_replica"]
    advice = (f"run batches of <= {fit} replicas instead (or reduce "
              f"--hidden/--max_steps)" if fit >= 1 else
              "not even ONE replica fits this budget — reduce "
              "--hidden/--max_steps")
    raise SystemExit(
        f"--batch_iters with {replicas} replicas needs ~"
        f"{est['estimate'] / 1e9:.1f} GB of device memory for its training "
        f"step (~{est['per_replica'] / 1e6:.0f} MB each, measured on a probe "
        f"step; budget {est['limit'] / 1e9:.1f} GB); {advice}")
