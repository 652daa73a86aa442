"""Fixed-grid Adams-Bashforth(-Moulton), ``explicit_adams`` and
``fixed_adams``, as ``ndcn_tpu/ode/fixed_adams.py``.

Coefficient tables up to order 12, an RK4 bootstrap while the history is
short, and a fixed-point Adams-Moulton corrector. The JAX package's two
documented deviations from the reference are kept:

- the corrector always runs ``max_iters`` fixed-point iterations (the
  reference breaks early on a convergence test);
- the history is never popped on non-convergence.

The JAX package carries the history as a newest-first buffer through one
``lax.scan``; here it is a newest-first Python list of RHS values, rebuilt
out of place each step (autograd refuses a buffer written in place), and the
order, known on the host, selects a row of the tables.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ndcn_tpu_torch.ode.adaptive import SolveStats
from ndcn_tpu_torch.ode.runge_kutta import (rk4_alt_step_func,
                                            shared_constants)
from ndcn_tpu_torch.ode.tree_math import (cast, leaves, tmap,
                                          tscaled_dot_product, tstack)

_MIN_ORDER = 4
_MAX_ORDER = 12
_MAX_ITERS = 4


def _adams_bashforth_table(max_order: int) -> np.ndarray:
    """Rows o=1..max_order: AB weights for f_n, f_{n-1}, ... (newest first):
    w_j = ∫_0^1 Π_{i≠j} (s + i)/(i - j) ds, j = 0..o-1."""
    table = np.zeros((max_order + 1, max_order), dtype=np.float64)
    for order in range(1, max_order + 1):
        for j in range(order):
            poly = np.poly1d([1.0])
            denom = 1.0
            for i in range(order):
                if i == j:
                    continue
                poly = poly * np.poly1d([1.0, float(i)])
                denom *= (i - j)
            integ = np.polyint(poly)
            table[order, j] = (integ(1.0) - integ(0.0)) / denom
    return table


def _adams_moulton_table(max_order: int) -> np.ndarray:
    """Rows o=1..max_order: AM weights for f_{n+1}, f_n, f_{n-1}, ...
    (newest first): with u = (t - t_n)/dt, node m sits at u_m (1 for
    f_{n+1}, -j for f_{n-j}); the weight is the integral over [0, 1] of the
    Lagrange basis polynomial at that node."""
    table = np.zeros((max_order + 1, max_order + 1), dtype=np.float64)
    for order in range(1, max_order + 1):
        nodes = [1.0] + [-float(j) for j in range(order - 1)]
        for j, nj in enumerate(nodes):
            poly = np.poly1d([1.0])
            denom = 1.0
            for i, ni in enumerate(nodes):
                if i == j:
                    continue
                poly = poly * np.poly1d([1.0, -ni])
                denom *= (nj - ni)
            integ = np.polyint(poly)
            table[order, j] = (integ(1.0) - integ(0.0)) / denom
    return table


@functools.lru_cache(maxsize=1)
def _tables_np():
    return (_adams_bashforth_table(_MAX_ORDER - 1),   # (12, 11)
            _adams_moulton_table(_MAX_ORDER))          # (13, 13)


@shared_constants
def _tables(device: torch.device):
    """The AB and AM tables in float32 on ``device``, made once a device
    (``runge_kutta.shared_constants``)."""
    return tuple(torch.as_tensor(tab, dtype=torch.float32).to(device)
                 for tab in _tables_np())


def solve_fixed_adams(func, y0, t: torch.Tensor, implicit: bool = True,
                      max_order: int = _MAX_ORDER,
                      max_iters: int = _MAX_ITERS):
    """Integrate on the observation grid ``t`` (a strictly increasing float32
    tensor on the CPU, or on the state's device: the loop reads nothing);
    returns (solution (len(t), *y0.shape), SolveStats), leaf by leaf for a
    tuple state."""
    # clamped as the reference's int(min(max_order, 12))
    max_order = max(1, min(int(max_order), _MAX_ORDER))
    max_hist = max_order - 1
    device = leaves(y0)[0].device
    ab, am = _tables(device)
    t_dev = t.to(device)

    ys, hist, nfe = [y0], [], 0
    for i in range(t.shape[0] - 1):
        t0, t1 = t_dev[i], t_dev[i + 1]
        dt = t1 - t0
        y = ys[-1]
        f = func(t0, y)
        hist = ([f] + hist)[:max_hist]
        order = len(hist)  # the reference's min(len(prev_f), max_order - 1)
        if order < _MIN_ORDER - 1:
            # the reference bootstraps with RK4 while the history is short
            dy = rk4_alt_step_func(func, t0, dt, y, k1=f)
            nfe += 4
        else:
            stack = tstack(hist)
            dy = tscaled_dot_product(dt, ab[order, :order], stack)
            nfe += 1
            if implicit:
                am_row = am[order + 1]  # weight 0 is for f(t + dt)
                delta = tscaled_dot_product(dt, am_row[1:order + 1], stack)
                c0 = dt * am_row[0]
                for _ in range(max_iters):
                    dy = tmap(lambda f_, d_: cast(c0, f_.dtype) * f_ + d_,
                              func(t1, tmap(torch.add, y, dy)), delta)
                nfe += max_iters
        ys.append(tmap(torch.add, y, dy))
    return tstack(ys), SolveStats(nfe=nfe, n_accepted=len(t) - 1,
                                  n_rejected=0, success=True, host_syncs=0)
