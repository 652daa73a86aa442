"""Explicit Runge-Kutta stages with an embedded error estimate, and the
fixed-grid rk4 step.

As ``ndcn_tpu/ode/runge_kutta.py``: the stage derivatives are kept as a list
and stacked out of place before each combination, a tensordot with the
tableau's coefficients (as float32 tensors, made once per solve). Nothing is
written in place, so autograd can record the step: the differentiable solve
backpropagates through every stage.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ndcn_tpu_torch.ode.tableaux import Tableau
from ndcn_tpu_torch.ode.tree_math import scaled_dot_product


class StageCoeffs(NamedTuple):
    """A tableau's coefficients as tensors on the state's device."""
    alpha: Tuple[float, ...]
    beta: Tuple[torch.Tensor, ...]
    c_error: torch.Tensor
    c_mid: Optional[torch.Tensor]


def stage_coeffs(tab: Tableau, dtype: torch.dtype,
                 device: torch.device) -> StageCoeffs:
    """The step below takes the last stage as the solution (FSAL), which
    holds for every tableau the port has."""
    if not tab.fsal:
        raise ValueError("runge_kutta_step takes FSAL tableaux only")

    def vec(c):
        return torch.tensor(c, dtype=dtype, device=device)

    return StageCoeffs(alpha=tab.alpha, beta=tuple(vec(b) for b in tab.beta),
                       c_error=vec(tab.c_error),
                       c_mid=None if tab.c_mid is None else vec(tab.c_mid))


def runge_kutta_step(func: Callable, y0: torch.Tensor, f0: torch.Tensor,
                     t0: torch.Tensor, dt: torch.Tensor, coeffs: StageCoeffs):
    """One explicit RK step. ``f0`` is the RHS at (t0, y0), reused from the
    previous step (FSAL). Returns (y1, f1, y1_error, k), k of shape
    (S, *y0.shape)."""
    ks = [f0]
    for alpha_i, beta_i in zip(coeffs.alpha, coeffs.beta):
        ti = t0 + alpha_i * dt
        yi = y0 + scaled_dot_product(dt, beta_i, torch.stack(ks))
        ks.append(func(ti, yi))
    k = torch.stack(ks)

    # FSAL: the last stage was evaluated at the solution point, so yi is y1
    y1 = yi
    y1_error = scaled_dot_product(dt, coeffs.c_error, k)
    return y1, ks[-1], y1_error, k


def rk4_alt_step_func(func: Callable, t: torch.Tensor, dt: torch.Tensor,
                      y: torch.Tensor) -> torch.Tensor:
    """The increment of one RK4 step by the 3/8 rule, the reference's 'rk4'
    (``ndcn_tpu/ode/runge_kutta.py::rk4_alt_step_func``)."""
    k1 = func(t, y)
    third = dt / 3.0
    k2 = func(t + third, y + third * k1)
    k3 = func(t + third * 2.0, y + dt * (k1 / -3.0 + k2))
    k4 = func(t + dt, y + dt * (k1 - k2 + k3))
    return (k1 + 3.0 * k2 + 3.0 * k3 + k4) * (dt / 8.0)
