"""Fixed-grid solvers euler, midpoint and rk4, as ``ndcn_tpu/ode/fixed_grid.py``.

The JAX package runs one ``lax.scan`` over the grid; here it is a plain
Python loop over the steps, which autograd records when it is on (the
gradient is backprop through every step). By default the integration grid
is the observation grid itself. With ``step_size`` the solver builds a finer
grid on the host and reads each observation by linear interpolation between
the two grid states that bracket it: the JAX package's deliberate fix of the
reference, which returns the right-endpoint value there (docs/PARITY.md).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ndcn_tpu_torch.ode.adaptive import SolveStats
from ndcn_tpu_torch.ode.runge_kutta import rk4_alt_step_func
from ndcn_tpu_torch.ode.tree_math import leaves, tmap, tstack


def euler_step(func, t, dt, y):
    return tmap(lambda f: dt * f, func(t, y)), 1


def midpoint_step(func, t, dt, y):
    y_mid = tmap(lambda y_, f: y_ + f * (dt / 2.0), y, func(t, y))
    return tmap(lambda f: dt * f, func(t + dt / 2.0, y_mid)), 2


def rk4_step(func, t, dt, y):
    return rk4_alt_step_func(func, t, dt, y), 4


STEP_FUNCS = {"euler": euler_step, "midpoint": midpoint_step, "rk4": rk4_step}


def _integrate(step_fn: Callable, func, y0, grid: torch.Tensor):
    """The states at every point of ``grid`` (a float32 tensor on y0's
    device), y0 first, and the RHS evaluations spent."""
    ys, nfe = [y0], 0
    for i in range(grid.shape[0] - 1):
        dy, n = step_fn(func, grid[i], grid[i + 1] - grid[i], ys[-1])
        ys.append(tmap(torch.add, ys[-1], dy))
        nfe += n
    return ys, nfe


def solve_fixed_grid(step_fn: Callable, func, y0, t: torch.Tensor,
                     step_size: Optional[float] = None):
    """Integrate over the grid ``t`` (a strictly increasing float32 tensor on
    the CPU); returns (solution (len(t), *y0.shape), SolveStats), leaf by
    leaf for a tuple state."""
    device = leaves(y0)[0].device
    t_dev = t.to(device)
    if step_size is None:
        ys, nfe = _integrate(step_fn, func, y0, t_dev)
        return tstack(ys), SolveStats(nfe=nfe, n_accepted=len(t) - 1,
                                      n_rejected=0, success=True,
                                      host_syncs=0)
    t_host = t.numpy().astype(np.float64)
    niters = int(np.ceil((t_host[-1] - t_host[0]) / step_size + 1))
    grid = np.arange(niters) * step_size + t_host[0]
    if grid[-1] > t_host[-1]:
        grid[-1] = t_host[-1]
    grid_t = torch.as_tensor(grid, dtype=t.dtype)
    ys, nfe = _integrate(step_fn, func, y0, grid_t.to(device))
    # each observation lies in the first grid interval whose right end is
    # at or past it (the reference's inner loop, solvers.py:99-102)
    seg = np.clip(np.searchsorted(grid[1:], t_host[1:], side="left"), 0,
                  len(grid) - 2)
    g0, g1 = grid_t[seg], grid_t[seg + 1]
    frac = ((t[1:] - g0) / torch.where(g1 == g0, 1.0, g1 - g0)).tolist()
    obs = [y0] + [tmap(lambda a, b: a + (b - a) * x, ys[s], ys[s + 1])
                  for s, x in zip(seg.tolist(), frac)]
    return tstack(obs), SolveStats(nfe=nfe, n_accepted=len(grid) - 1,
                                   n_rejected=0, success=True, host_syncs=0)
