"""Public odeint API, as ``ndcn_tpu/ode/api.py``.

    odeint(func, y0, t, rtol=1e-7, atol=1e-9, method=None, options=None)

``func(t, y) -> dy/dt`` on tensors; ``t`` is a 1-D strictly monotone grid
(tensor, array or list), the solution carries a leading time axis with
solution[0] == y0, and decreasing grids integrate s = -t forward. Time runs in
float32, as the JAX package's default.

The port has ``method="dopri5"``: ``differentiable=True`` (the default) is
the solve autograd records, with a budget of 256 step attempts;
``differentiable=False`` the inference solve under ``torch.no_grad()``, with a
budget of 2**16. Both run ``adaptive.solve``. ``emission_dtype`` and
``emission_readout`` (the JAX scan path's levers, see ``adaptive``) are
taken by the differentiable solve only. Every other method raises
``NotImplementedError`` naming the ROADMAP item that brings it; the
validation errors are the JAX package's.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Optional

import torch

from ndcn_tpu_torch.ode import adaptive
from ndcn_tpu_torch.ode.step_control import Controller

_ADAPTIVE = {"dopri5": adaptive.DOPRI5_METHOD}

SOLVERS = ("dopri5", "tsit5", "euler", "midpoint", "rk4",
           "explicit_adams", "fixed_adams", "adams")


_DEFAULT_MAX_STEPS_SCAN = 256
_DEFAULT_MAX_STEPS_WHILE = 1 << 16

# dopri5's option keys, as the JAX package recognizes them (a typo'd option
# silently ignored is a debugging trap, so unknown keys warn).
_DOPRI5_OPTIONS = {"differentiable", "max_steps", "safety", "ifactor",
                   "dfactor", "first_step", "time_dtype", "emission_dtype",
                   "emission_readout"}


def require_ported(method: str) -> None:
    """Raise as ``odeint`` would for a method the port does not have."""
    if method not in SOLVERS:
        raise ValueError(f"unknown method {method!r}; choose from {SOLVERS}")
    if method not in _ADAPTIVE:
        raise NotImplementedError(f"method={method!r} is not ported yet: "
                                  f"ROADMAP item 5 (the remaining solvers)")


def _check_options(method: str, options: Dict[str, Any]) -> None:
    unknown = set(options) - _DOPRI5_OPTIONS
    if unknown:
        warnings.warn(f"{method}: unexpected options {sorted(unknown)} "
                      f"(recognized: {sorted(_DOPRI5_OPTIONS)})")


def _canonical_time(t) -> torch.Tensor:
    """The grid as a float32 tensor on the CPU (the solver loop reads it on
    the host)."""
    return torch.as_tensor(t).detach().to("cpu", torch.float32)


def _maybe_reverse(func, t):
    """Validate the grid on the host; a decreasing grid integrates s = -t."""
    t = _canonical_time(t)
    if t.ndim != 1 or t.shape[0] < 2:
        raise ValueError("t must be a 1-D grid with at least 2 points")
    if bool(torch.all(t[1:] < t[:-1])):
        base = func
        return (lambda s, y: -base(-s, y)), -t
    if not bool(torch.all(t[1:] > t[:-1])):
        raise ValueError("t must be strictly increasing or decreasing")
    return func, t


def odeint_with_stats(func: Callable, y0: torch.Tensor, t,
                      rtol: float = 1e-7, atol: float = 1e-9,
                      method: Optional[str] = None,
                      options: Optional[Dict[str, Any]] = None):
    """Solve dy/dt = func(t, y); returns (solution, SolveStats)."""
    if options is None:
        options = {}
    elif method is None:
        raise ValueError("cannot supply `options` without specifying `method`")
    if method is None:
        method = "dopri5"
    require_ported(method)
    _check_options(method, options)

    func, t = _maybe_reverse(func, t)

    if options.get("time_dtype") is not None:
        raise NotImplementedError("time_dtype is not ported yet: ROADMAP "
                                  "item 5")
    differentiable = bool(options.get("differentiable", True))
    emission = {k: options.get(k) for k in ("emission_dtype",
                                             "emission_readout")}
    if not differentiable and any(v is not None for v in emission.values()):
        raise ValueError("emission_dtype / emission_readout apply to the "
                         "differentiable solve only (differentiable=True)")
    ctrl = Controller(rtol=float(rtol), atol=float(atol),
                      safety=float(options.get("safety", 0.9)),
                      ifactor=float(options.get("ifactor", 10.0)),
                      dfactor=float(options.get("dfactor", 0.2)),
                      order=5)
    max_steps = int(options.get("max_steps", _DEFAULT_MAX_STEPS_SCAN
                                if differentiable
                                else _DEFAULT_MAX_STEPS_WHILE))
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        return adaptive.solve(_ADAPTIVE[method], func, y0, t, ctrl,
                              max_steps=max_steps,
                              first_step=options.get("first_step"),
                              **emission)


def odeint(func: Callable, y0: torch.Tensor, t, rtol: float = 1e-7,
           atol: float = 1e-9, method: Optional[str] = None,
           options: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Solve dy/dt = func(t, y) over t; the solution has a leading time axis.

    A blown step budget is loud: the trajectory comes back as NaN. Use
    ``odeint_with_stats`` to branch on ``stats.success`` instead."""
    sol, stats = odeint_with_stats(func, y0, t, rtol=rtol, atol=atol,
                                   method=method, options=options)
    return sol if stats.success else torch.full_like(sol, float("nan"))
