"""Public odeint API, as ``ndcn_tpu/ode/api.py``.

    odeint(func, y0, t, rtol=1e-7, atol=1e-9, method=None, options=None)

``func(t, y) -> dy/dt`` on a tensor, or on a flat tuple of tensors; ``t`` is
a 1-D strictly monotone grid (tensor, array or list), the solution carries a
leading time axis with solution[0] == y0, and decreasing grids integrate
s = -t forward. Time runs in float32, as the JAX package's default;
``time_dtype="float64"`` (the adaptive methods) runs the grid and the
controller's scalars in float64 with the state's dtype unchanged.

Every method of the JAX package:

- ``dopri5`` and ``tsit5`` (``adaptive``; tsit5 takes ``reference_weights``)
  and ``adams`` (``vcabm``, adaptive step and order): ``differentiable=True``
  (the default) is the solve autograd records, with a budget of 256 step
  attempts; ``differentiable=False`` the inference solve under
  ``torch.no_grad()``, with a budget of 2**16. ``emission_dtype`` and
  ``emission_readout`` (the JAX scan path's levers, see ``adaptive``) are
  taken by dopri5's and tsit5's differentiable solve only.
- the fixed-grid methods ``euler``, ``midpoint`` and ``rk4``
  (``fixed_grid``, with ``step_size``) and ``explicit_adams`` and
  ``fixed_adams`` (``fixed_adams``, with ``max_order`` and ``max_iters``)
  accept and ignore the common options, as in the JAX package;
  ``differentiable=False`` runs them under ``torch.no_grad()`` too.

``scan=True`` sends dopri5's and tsit5's solve to ``adaptive.solve_scan``
and adams' to ``vcabm.solve_vcabm_scan``, the JAX package's bounded scan
paths: exactly ``max_steps`` attempts (256 unless given, also for
``differentiable=False``) and no read of the device from the host, so
that a train step can be recorded into one CUDA graph (``train.chunk``);
its stats are 0-dim device tensors. With ``differentiable=False`` it is
the bounded inference solve that the continuous adjoint runs under it
(``ode.adjoint``). It takes one replica (not ``batched``), with or without
a ``node_group``. The fixed-grid and fixed-order methods accept and ignore
it: their loop reads nothing. Without it the solve is the host loop
(``adaptive.solve``, ``vcabm.solve_vcabm``), whose numbers it keeps. While
a CUDA graph is being captured the grid is taken as a tensor of the time
dtype on the card, unchecked: the eager warm-up step that every capture
follows checked the same grid.
``params``, the list that ``func`` (and ``emission_readout``) reads every
tensor it uses that requires grad from, at each call, lets dopri5's and
tsit5's differentiable bounded solve take each attempt's gradients itself,
so that a captured step puts every attempt behind a conditional graph node
in its backward too (``adaptive.solve_scan``); every other solve accepts
and ignores it.

``batched=True`` solves R independent replicas of the problem at once
(``jax.vmap`` of the solve in the JAX package): every leaf of ``y0`` has a
leading replica axis, the grid is shared, the solution is (len(t), R, ...)
and the stats a ``BatchedSolveStats`` (one value per replica). dopri5 and
tsit5 run ``adaptive.solve_batched``, adams ``vcabm.solve_vcabm_batched``;
euler, midpoint, rk4, explicit_adams and fixed_adams run their grid with
the batched state as it is (every replica takes the same steps).

``node_group`` (a ``torch.distributed`` process group) solves a state
whose node rows split over that group's ranks (``parallel.coo_shard``; the
JAX package's GSPMD-sharded solve): the norms and means of its
node-sharded leaves, and each attempt's finite flag, are taken over every
rank, so that every rank takes the same steps. ``node_sharded``, one bool
a leaf of ``y0``, marks which leaves are node-sharded (the others are
replicated: their norms stay local); without it every leaf is. The
fixed-grid and fixed-order methods take no norm and accept both.

Under ``torch.export`` (the serving artifact, ``serve.export_ndcn``) the
inference solve of dopri5 and tsit5 is ``adaptive.solve_while`` and that of
adams ``vcabm.solve_vcabm_while``, the loop as one device-resident program,
as the JAX package takes its while-loop path for the inference solve;
euler, midpoint, rk4, explicit_adams and fixed_adams trace as they stand (a
Python loop over the static grid, unrolled).

The validation errors are the JAX package's.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, Callable, Dict, Optional

import torch

from ndcn_tpu_torch.ode import adaptive, fixed_adams, fixed_grid, vcabm
from ndcn_tpu_torch.ode.step_control import Controller
from ndcn_tpu_torch.ode.tree_math import leaf_groups, leaves, tmap

_ADAPTIVE = {"dopri5": adaptive.DOPRI5_METHOD,
             "tsit5": adaptive.TSIT5_METHOD}

SOLVERS = ("dopri5", "tsit5", "euler", "midpoint", "rk4",
           "explicit_adams", "fixed_adams", "adams")


_DEFAULT_MAX_STEPS_SCAN = 256
_DEFAULT_MAX_STEPS_WHILE = 1 << 16

# each method's option keys, as the JAX package recognizes them (a typo'd
# option silently ignored is a debugging trap, so unknown keys warn); the
# fixed-grid and fixed-order methods accept and ignore the common options,
# so that one options dict serves every method
_COMMON_OPTIONS = {"differentiable", "max_steps", "batched", "node_group",
                   "node_sharded", "scan", "params"}

_METHOD_OPTIONS = {
    "dopri5": _COMMON_OPTIONS | {"safety", "ifactor", "dfactor", "first_step",
                                 "time_dtype", "emission_dtype",
                                 "emission_readout"},
    "tsit5": _COMMON_OPTIONS | {"safety", "ifactor", "dfactor", "first_step",
                                "time_dtype", "reference_weights",
                                "emission_dtype", "emission_readout"},
    "euler": _COMMON_OPTIONS | {"step_size"},
    "midpoint": _COMMON_OPTIONS | {"step_size"},
    "rk4": _COMMON_OPTIONS | {"step_size"},
    "explicit_adams": _COMMON_OPTIONS | {"max_order", "max_iters"},
    "fixed_adams": _COMMON_OPTIONS | {"max_order", "max_iters"},
    "adams": _COMMON_OPTIONS | {"max_order", "time_dtype", "safety",
                                "ifactor", "dfactor"},
}

_TIME_DTYPES = {None: torch.float32, "float32": torch.float32,
                torch.float32: torch.float32, "float64": torch.float64,
                torch.float64: torch.float64}


def _check_options(method: str, options: Dict[str, Any]) -> None:
    unknown = set(options) - _METHOD_OPTIONS[method]
    if unknown:
        warnings.warn(f"{method}: unexpected options {sorted(unknown)} "
                      f"(recognized: {sorted(_METHOD_OPTIONS[method])})")


def _time_dtype(time_dtype) -> torch.dtype:
    if time_dtype not in _TIME_DTYPES:
        raise ValueError(f"time_dtype must be float32 or float64; got "
                         f"{time_dtype!r}")
    return _TIME_DTYPES[time_dtype]


def _canonical_time(t, time_dtype=None) -> torch.Tensor:
    """The grid as a tensor of the time dtype on the CPU (the solver loop
    reads it on the host): float32, or float64 with ``time_dtype``, where
    the grid keeps the precision it came in (as the JAX package's under
    x64)."""
    tdtype = _time_dtype(time_dtype)
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", tdtype)
    return torch.as_tensor(t, dtype=tdtype)


def _capturing(t) -> bool:
    """Whether ``t`` is a card tensor read while a CUDA graph is captured,
    when no copy to the host may be made."""
    return (isinstance(t, torch.Tensor) and t.is_cuda
            and torch.cuda.is_current_stream_capturing())


def _maybe_reverse(func, t, time_dtype=None):
    """Validate the grid on the host; a decreasing grid integrates s = -t.

    Under ``torch.export`` the grid is traced data the host cannot read:
    it is taken as it is, an increasing grid that the exporter checked
    before the trace (``serve.export_ndcn``), in the time dtype on its own
    device."""
    if torch.compiler.is_exporting() or _capturing(t):
        return func, t.to(_time_dtype(time_dtype))
    t = _canonical_time(t, time_dtype)
    if t.ndim != 1 or t.shape[0] < 2:
        raise ValueError("t must be a 1-D grid with at least 2 points")
    if bool(torch.all(t[1:] < t[:-1])):
        base = func
        return (lambda s, y: tmap(torch.neg, base(-s, y))), -t
    if not bool(torch.all(t[1:] > t[:-1])):
        raise ValueError("t must be strictly increasing or decreasing")
    return func, t


def grad_mode(enabled: bool):
    """``torch.set_grad_enabled(enabled)``; nothing under ``torch.export``,
    which traces the serving artifact under ``torch.no_grad()`` already,
    and whose pass over grad-mode regions loses the branches of a
    ``torch.cond`` inside a ``while_loop`` in such a region (seen with
    torch 2.13)."""
    if torch.compiler.is_exporting():
        return contextlib.nullcontext()
    return torch.set_grad_enabled(enabled)


def odeint_with_stats(func: Callable, y0, t, rtol: float = 1e-7,
                      atol: float = 1e-9, method: Optional[str] = None,
                      options: Optional[Dict[str, Any]] = None):
    """Solve dy/dt = func(t, y); returns (solution, SolveStats)."""
    if options is None:
        options = {}
    elif method is None:
        raise ValueError("cannot supply `options` without specifying `method`")
    if method is None:
        method = "dopri5"
    if method not in SOLVERS:
        raise ValueError(f"unknown method {method!r}; choose from {SOLVERS}")
    _check_options(method, options)

    # the fixed-grid methods take no time_dtype (it is not among their
    # options: it warns above and is ignored, as in the JAX package)
    time_dtype = (options.get("time_dtype")
                  if method in ("dopri5", "tsit5", "adams") else None)
    func, t = _maybe_reverse(func, t, time_dtype)
    differentiable = bool(options.get("differentiable", True))
    batched = bool(options.get("batched", False))
    exporting = torch.compiler.is_exporting()
    groups = leaf_groups(options.get("node_group"),
                         options.get("node_sharded"), len(leaves(y0)))

    def recording():
        # autograd records the solve only when it is differentiable
        return grad_mode(differentiable and torch.is_grad_enabled())

    if method in fixed_grid.STEP_FUNCS or method in ("explicit_adams",
                                                      "fixed_adams"):
        with recording():
            if method in fixed_grid.STEP_FUNCS:
                sol, stats = fixed_grid.solve_fixed_grid(
                    fixed_grid.STEP_FUNCS[method], func, y0, t,
                    step_size=options.get("step_size"))
            else:
                sol, stats = fixed_adams.solve_fixed_adams(
                    func, y0, t, implicit=method == "fixed_adams",
                    max_order=int(options.get("max_order", 12)),
                    max_iters=int(options.get("max_iters", 4)))
        if batched:
            # the grid is shared: every replica takes the same steps
            stats = adaptive.BatchedSolveStats.shared(
                stats, leaves(y0)[0].shape[0])
        return sol, stats

    scan = bool(options.get("scan", False))
    if scan and batched:
        raise ValueError("scan=True solves one replica (not batched)")
    max_steps = int(options.get("max_steps", _DEFAULT_MAX_STEPS_SCAN
                                if differentiable or scan
                                else _DEFAULT_MAX_STEPS_WHILE))
    ctrl_kw = dict(safety=float(options.get("safety", 0.9)),
                   ifactor=float(options.get("ifactor", 10.0)),
                   dfactor=float(options.get("dfactor", 0.2)))
    if method == "adams":
        if scan and not exporting:
            with recording():
                return vcabm.solve_vcabm_scan(
                    func, y0, t, rtol=float(rtol), atol=float(atol),
                    max_order=int(options.get("max_order", 12)),
                    max_steps=max_steps, groups=groups,
                    differentiable=differentiable, **ctrl_kw)
        if batched:
            solve = vcabm.solve_vcabm_batched
        elif exporting and not differentiable:
            # the host loop cannot be traced: the device-resident loop can
            solve = vcabm.solve_vcabm_while
        else:
            solve = vcabm.solve_vcabm
        with recording():
            return solve(func, y0, t, rtol=float(rtol), atol=float(atol),
                         max_order=int(options.get("max_order", 12)),
                         max_steps=max_steps, groups=groups, **ctrl_kw)

    emission = {k: options.get(k) for k in ("emission_dtype",
                                             "emission_readout")}
    if not differentiable and any(v is not None for v in emission.values()):
        raise ValueError("emission_dtype / emission_readout apply to the "
                         "differentiable solve only (differentiable=True)")
    ctrl = Controller(rtol=float(rtol), atol=float(atol), order=5, **ctrl_kw)
    m = _ADAPTIVE[method]
    if method == "tsit5" and options.get("reference_weights"):
        # bit-compatibility mode: the reference's (non-converging) tsit5
        # error weights (``tableaux.TSIT5_REFERENCE_WEIGHTS``)
        m = adaptive.TSIT5_REFERENCE_METHOD
    if exporting and not differentiable and not batched:
        # the host loop cannot be traced: the device-resident loop can
        with recording():
            return adaptive.solve_while(m, func, y0, t, ctrl, max_steps,
                                        first_step=options.get("first_step"))
    if scan:
        with recording():
            return adaptive.solve_scan(m, func, y0, t, ctrl, max_steps,
                                       first_step=options.get("first_step"),
                                       groups=groups,
                                       differentiable=differentiable,
                                       params=options.get("params"),
                                       **emission)
    solve = adaptive.solve_batched if batched else adaptive.solve
    with recording():
        return solve(m, func, y0, t, ctrl, max_steps=max_steps,
                     first_step=options.get("first_step"), groups=groups,
                     **emission)


def odeint(func: Callable, y0, t, rtol: float = 1e-7, atol: float = 1e-9,
           method: Optional[str] = None,
           options: Optional[Dict[str, Any]] = None):
    """Solve dy/dt = func(t, y) over t; the solution has a leading time axis.

    A blown step budget is loud: the trajectory comes back as NaN. Use
    ``odeint_with_stats`` to branch on ``stats.success`` instead."""
    sol, stats = odeint_with_stats(func, y0, t, rtol=rtol, atol=atol,
                                   method=method, options=options)
    return nan_on_failure(sol, stats, axis=1)


def nan_on_failure(sol, stats, axis: int = 0):
    """``sol`` with NaN where the solve failed: all of it, or with
    BatchedSolveStats the failed replicas along each leaf's ``axis``.
    The bounded solve's flag is a device tensor (``scan=True``): a
    ``torch.where``, with no host read."""
    if isinstance(stats, adaptive.BatchedSolveStats):
        return tmap(lambda b: nan_unless(stats.success, b, axis), sol)
    if isinstance(stats.success, torch.Tensor):
        return tmap(lambda b: torch.where(stats.success, b, torch.full_like(
            b, float("nan"))), sol)
    if stats.success:
        return sol
    return tmap(lambda b: torch.full_like(b, float("nan")), sol)


def nan_unless(success, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """``x`` with the replicas whose solve failed set to NaN: ``success``
    is one flag per replica, along ``x``'s axis ``axis``. A ``torch.where``,
    so a failed replica's entries get a zero cotangent, never 0·NaN."""
    ok = torch.tensor(success, device=x.device)
    ok = ok.view((-1,) + (1,) * (x.ndim - axis - 1))
    return torch.where(ok, x, torch.full_like(x, float("nan")))
