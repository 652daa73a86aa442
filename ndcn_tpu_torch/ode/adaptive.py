"""Adaptive Runge-Kutta integration (dopri5), the inference solve.

The port of ``ndcn_tpu/ode/adaptive.py::solve_while``. There a
``lax.while_loop`` runs ``lax.cond(ready, consume_obs, take_step)``; here the
loop is on the host and the step stays branch-free on the device
(``torch.where`` on accept, as ``_attempt_step_core``). The host needs three
numbers after each step attempt (the new t1, accept, and the dt-underflow
flag) and reads them in one device→host copy: one sync per step attempt and
none per observation. ``SolveStats.host_syncs`` counts them.

The solution buffer is a plain (T, *shape) tensor: the JAX package flattened
it against the TPU's lane padding, which a GPU does not have.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ndcn_tpu_torch.ode import interp as interp_lib
from ndcn_tpu_torch.ode.runge_kutta import (StageCoeffs, runge_kutta_step,
                                            stage_coeffs)
from ndcn_tpu_torch.ode.step_control import (Controller, accept_and_max_ratio,
                                             error_ratios, optimal_step_size,
                                             select_initial_step)
from ndcn_tpu_torch.ode.tableaux import DOPRI5, Tableau

# The reference passes order 4 to the initial-step heuristic for its
# 5th-order methods; kept for identical first steps.
_INIT_STEP_ORDER = 4


@dataclasses.dataclass(frozen=True)
class AdaptiveMethod:
    name: str
    tableau: Tableau
    interp_init: Callable
    interp_make: Callable
    interp_eval: Callable


DOPRI5_METHOD = AdaptiveMethod(
    name="dopri5",
    tableau=DOPRI5,
    interp_init=interp_lib._interp_init,
    interp_make=interp_lib._interp_state,
    interp_eval=interp_lib._interp_eval,
)


class SolveStats(NamedTuple):
    nfe: int           # number of RHS evaluations
    n_accepted: int
    n_rejected: int
    success: bool      # all observation times reached within max_steps
    host_syncs: int    # device→host reads the loop made (one per attempt)


class RKState(NamedTuple):
    y: torch.Tensor    # state at t1
    f: torch.Tensor    # RHS at (t1, y)
    t0: torch.Tensor   # last accepted interval, float32 0-dim tensors
    t1: torch.Tensor
    dt: torch.Tensor   # proposed next step
    interp: Optional[object] = None  # last accepted step's dense output


def _all_finite(*tensors: torch.Tensor) -> torch.Tensor:
    ok = torch.isfinite(tensors[0]).all()
    for t in tensors[1:]:
        ok = ok & torch.isfinite(t).all()
    return ok


def _attempt_step_core(method: AdaptiveMethod, func, rk: RKState,
                       ctrl: Controller, coeffs: StageCoeffs):
    """One accept-or-reject step, branch-free. Returns (updated state without
    interp, this attempt's interp state, its interval ends, accept, finite).

    An attempt with any non-finite stage, trial state or error estimate is
    rejected with dt·dfactor (maximal shrink), whatever its error ratio says.
    """
    y1, f1, y1_error, k = runge_kutta_step(func, rk.y, rk.f, rk.t1, rk.dt,
                                           coeffs)
    finite = _all_finite(y1, y1_error, k)
    ratio = error_ratios(y1_error, rk.y, y1, ctrl.rtol, ctrl.atol)
    accept, max_ratio = accept_and_max_ratio(ratio)
    accept = accept & finite
    dt_next = torch.where(finite, optimal_step_size(rk.dt, max_ratio, ctrl),
                          rk.dt * ctrl.dfactor)
    new_interp = method.interp_make(rk.y, y1, k, rk.dt, coeffs)
    att_t0, att_t1 = rk.t1, rk.t1 + rk.dt

    base = RKState(y=torch.where(accept, y1, rk.y),
                   f=torch.where(accept, f1, rk.f),
                   t0=torch.where(accept, att_t0, rk.t0),
                   t1=torch.where(accept, att_t1, rk.t1),
                   dt=dt_next)
    return base, new_interp, (att_t0, att_t1), accept, finite


def _attempt_step(method: AdaptiveMethod, func, rk: RKState, ctrl: Controller,
                  coeffs: StageCoeffs):
    """While-loop variant: keeps the last ACCEPTED interp state."""
    base, new_interp, _, accept, _ = _attempt_step_core(method, func, rk, ctrl,
                                                        coeffs)
    interp = type(new_interp)(*(torch.where(accept, a, b)
                                for a, b in zip(new_interp, rk.interp)))
    return base._replace(interp=interp), accept


def _init_rk_state(method: AdaptiveMethod, func, y0: torch.Tensor,
                   t0: torch.Tensor, ctrl: Controller,
                   first_step: Optional[float]):
    f0 = func(t0, y0)
    if first_step is None:
        dt0 = select_initial_step(func, t0, y0, _INIT_STEP_ORDER, ctrl.rtol,
                                  ctrl.atol, f0)
        nfe0 = 2
    else:
        dt0 = torch.tensor(first_step, dtype=t0.dtype, device=t0.device)
        nfe0 = 1
    rk = RKState(y=y0, f=f0, t0=t0, t1=t0, dt=dt0,
                 interp=method.interp_init(y0))
    return rk, nfe0


def solve_while(method: AdaptiveMethod, func, y0: torch.Tensor,
                t: torch.Tensor, ctrl: Controller, max_steps: int = 1 << 16,
                first_step: Optional[float] = None):
    """Minimal-FLOP solve, not differentiable. Returns (solution, SolveStats).

    ``t`` is a strictly increasing 1-D float32 tensor ON THE CPU (the loop
    compares against it on the host); it is copied to y0's device once.
    solution: (len(t), *y0.shape) with solution[0] == y0.
    """
    T = t.shape[0]
    t_host = t.tolist()              # python floats, exactly the f32 values
    t_dev = t.to(y0.device)
    coeffs = stage_coeffs(method.tableau, y0.dtype, y0.device)
    n_evals = len(method.tableau.alpha)  # f0 comes from the last step (FSAL)
    rk, nfe = _init_rk_state(method, func, y0, t_dev[0], ctrl, first_step)

    sol = torch.zeros((T,) + tuple(y0.shape), dtype=y0.dtype, device=y0.device)
    sol[0] = y0
    obs_i, nacc, nrej, syncs, ok = 1, 0, 0, 0, True
    t1_host = t_host[0]
    while obs_i < T and nacc + nrej < max_steps and ok:
        if t_host[obs_i] <= t1_host:
            # consume an observation: dense output of the last accepted step
            sol[obs_i] = method.interp_eval(rk.interp, rk.t0, rk.t1,
                                            t_dev[obs_i])
            obs_i += 1
            continue
        # dt-underflow guard (the reference asserts): flag and stop
        underflow = ~((rk.t1 + rk.dt) > rk.t1)
        rk, accept = _attempt_step(method, func, rk, ctrl, coeffs)
        nfe += n_evals
        t1_host, acc, under = torch.stack(
            [rk.t1, accept.to(rk.t1.dtype), underflow.to(rk.t1.dtype)]).tolist()
        syncs += 1
        if acc:
            nacc += 1
        else:
            nrej += 1
        ok = not under

    stats = SolveStats(nfe=nfe, n_accepted=nacc, n_rejected=nrej,
                       success=ok and obs_i >= T, host_syncs=syncs)
    return sol, stats
