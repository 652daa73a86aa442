"""Adaptive step-size control, as ``ndcn_tpu/ode/step_control.py``.

- error tolerance per element: atol + rtol * max(|y0|, |y1|)
- error metric: mean over elements of (err/tol)^2
- accept iff the metric <= 1
- next dt = dt / clamp(sqrt(ratio)^(1/order) / safety, 1/ifactor, 1/dfactor),
  with dfactor forced to 1 when the step was accepted
- Hairer's heuristic for the initial step

Every quantity stays a float32 tensor on the state's device (the JAX
package's time dtype): the host never branches here, and doing this
arithmetic in Python floats (float64) would move borderline accept / reject
decisions and with them the step count.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndcn_tpu_torch.ode.tree_math import rms_norm

# Guard against division by zero; a normal float32 (see the JAX package).
_TINY = 1e-30


class Controller(NamedTuple):
    rtol: float
    atol: float
    safety: float = 0.9
    ifactor: float = 10.0
    dfactor: float = 0.2
    order: int = 5


def error_ratios(y1_error: torch.Tensor, y0: torch.Tensor, y1: torch.Tensor,
                 rtol: float, atol: float) -> torch.Tensor:
    """Mean squared error ratio of one state tensor (0-dim)."""
    tol = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    r = y1_error / tol
    return torch.mean(r * r)


def accept_and_max_ratio(ratio: torch.Tensor):
    """(accept, max_ratio) for the port's single-tensor state."""
    return ratio <= 1.0, ratio


def optimal_step_size(last_step: torch.Tensor, max_ratio: torch.Tensor,
                      ctrl: Controller) -> torch.Tensor:
    """Next step size; a NaN ratio counts as infinitely bad (maximal shrink)."""
    max_ratio = torch.where(torch.isnan(max_ratio),
                            torch.full_like(max_ratio, float("inf")), max_ratio)
    dfactor = torch.where(max_ratio < 1.0, torch.ones_like(max_ratio),
                          torch.full_like(max_ratio, ctrl.dfactor))
    error_ratio = torch.sqrt(torch.clamp(max_ratio, min=_TINY))
    exponent = 1.0 / ctrl.order
    factor = torch.clamp(torch.minimum(error_ratio ** exponent / ctrl.safety,
                                       1.0 / dfactor),
                         min=1.0 / ctrl.ifactor)
    return last_step / factor


def select_initial_step(func, t0: torch.Tensor, y0: torch.Tensor, order: int,
                        rtol: float, atol: float,
                        f0: torch.Tensor) -> torch.Tensor:
    """Hairer's empirical initial step; the reference's host branches become
    ``torch.where`` with the same thresholds. Calls ``func`` once."""
    scale = atol + torch.abs(y0) * rtol
    d0 = rms_norm(y0 / scale)
    d1 = rms_norm(f0 / scale)
    ratio = torch.where(d1 < 1e-5, torch.zeros_like(d0),
                        d0 / torch.clamp(d1, min=_TINY))
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.full_like(d0, 1e-6),
                     0.01 * ratio)

    y1 = y0 + h0 * f0
    f1 = func(t0 + h0, y1)
    d2 = rms_norm((f1 - f0) / scale) / h0

    h1_small = torch.clamp(h0 * 1e-3, min=1e-6)
    h1_big = (0.01 / torch.clamp(torch.maximum(d1, d2), min=_TINY)) \
        ** (1.0 / (order + 1.0))
    h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15), h1_small, h1_big)
    return torch.minimum(100.0 * h0, h1)
