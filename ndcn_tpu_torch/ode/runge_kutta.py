"""Explicit Runge-Kutta stages with an embedded error estimate, and the
fixed-grid rk4 step.

As ``ndcn_tpu/ode/runge_kutta.py``: the stage derivatives are kept as a list
and stacked out of place before each combination, a tensordot with the
tableau's coefficients (as tensors, made once per dtype and device), leaf by
leaf of the state (``tree_math``). Nothing is written in place, so autograd
can record the step: the differentiable solve backpropagates through every
stage.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ndcn_tpu_torch.ode.tableaux import Tableau
from ndcn_tpu_torch.ode.tree_math import tmap, tscaled_dot_product, tstack


class StageCoeffs(NamedTuple):
    """A tableau's coefficients as tensors on the state's device."""
    alpha: Tuple[float, ...]
    beta: Tuple[torch.Tensor, ...]
    c_error: torch.Tensor
    c_mid: Optional[torch.Tensor]


def shared_constants(make: Callable) -> Callable:
    """``make(*key)``, a solver's constant tensors copied from the host,
    made once per key and shared, never written: a solve recorded into a
    CUDA graph (``train.chunk``) may copy nothing from the host, and the
    first (eager) solve of a run has made them. A program being traced
    (``torch.export``) and a solve under inference mode make their own, so
    that no traced or inference tensor is kept."""
    shared = functools.lru_cache(maxsize=None)(make)

    def get(*key):
        if torch.compiler.is_compiling() or torch.is_inference_mode_enabled():
            return make(*key)
        return shared(*key)

    return get


@shared_constants
def _coeffs(tab: Tableau, dtype: torch.dtype,
            device: torch.device) -> StageCoeffs:
    def vec(c):
        return torch.tensor(c, dtype=dtype, device=device)

    return StageCoeffs(alpha=tab.alpha, beta=tuple(vec(b) for b in tab.beta),
                       c_error=vec(tab.c_error),
                       c_mid=None if tab.c_mid is None else vec(tab.c_mid))


def stage_coeffs(tab: Tableau, dtype: torch.dtype,
                 device: torch.device) -> StageCoeffs:
    """The step below takes the last stage as the solution (FSAL), which
    holds for every tableau the port has. Made once per (tableau, dtype,
    device) (``shared_constants``)."""
    if not tab.fsal:
        raise ValueError("runge_kutta_step takes FSAL tableaux only")
    return _coeffs(tab, dtype, device)


def runge_kutta_step(func: Callable, y0, f0, t0: torch.Tensor,
                     dt: torch.Tensor, coeffs: StageCoeffs):
    """One explicit RK step. ``f0`` is the RHS at (t0, y0), reused from the
    previous step (FSAL). Returns (y1, f1, y1_error, k), k the stages stacked
    along a new leading axis (S, *leaf.shape), leaf by leaf."""
    ks = [f0]
    for alpha_i, beta_i in zip(coeffs.alpha, coeffs.beta):
        ti = t0 + alpha_i * dt
        yi = tmap(torch.add, y0,
                  tscaled_dot_product(dt, beta_i, tstack(ks)))
        ks.append(func(ti, yi))
    k = tstack(ks)

    # FSAL: the last stage was evaluated at the solution point, so yi is y1
    y1 = yi
    y1_error = tscaled_dot_product(dt, coeffs.c_error, k)
    return y1, ks[-1], y1_error, k


def rk4_alt_step_func(func: Callable, t: torch.Tensor, dt: torch.Tensor, y,
                      k1=None):
    """The increment of one RK4 step by the 3/8 rule, the reference's 'rk4'
    (``ndcn_tpu/ode/runge_kutta.py::rk4_alt_step_func``), leaf by leaf;
    ``k1`` is the RHS at (t, y) when the caller has it."""
    if k1 is None:
        k1 = func(t, y)
    third = dt / 3.0
    k2 = func(t + third, tmap(lambda y_, a: y_ + third * a, y, k1))
    k3 = func(t + third * 2.0,
              tmap(lambda y_, a, b: y_ + dt * (a / -3.0 + b), y, k1, k2))
    k4 = func(t + dt, tmap(lambda y_, a, b, c: y_ + dt * (a - b + c),
                           y, k1, k2, k3))
    return tmap(lambda a, b, c, d: (a + 3.0 * b + 3.0 * c + d) * (dt / 8.0),
                k1, k2, k3, k4)
