"""Adaptive step-size control, as ``ndcn_tpu/ode/step_control.py``.

- error tolerance per element: atol + rtol * max(|y0|, |y1|)
- error metric, per leaf of the state: mean over elements of (err/tol)^2
- accept iff every leaf's metric <= 1
- next dt = dt / clamp(sqrt(max_ratio)^(1/order) / safety, 1/ifactor,
  1/dfactor), with dfactor forced to 1 when the step was accepted
- Hairer's heuristic for the initial step, with per-leaf norms

With ``batched`` (R replicas in one solve, ``adaptive.solve_batched``)
every leaf has a leading replica axis and every quantity here is one value
per replica, shape (R,): each norm and mean is taken over one replica's
elements only, so the replicas' step sizes stay independent. While the
state is node-sharded (``groups``: one process group a leaf, None for a
replicated leaf, ``tree_math.leaf_groups``) a node-sharded leaf's mean is
over every rank's elements, so every rank takes the same steps.

Every quantity stays a tensor of the time dtype on the state's device
(float32 unless the caller asks for float64 time, as the JAX package's
``time_dtype``): the host never branches here, and doing this arithmetic in
Python floats (float64) would move borderline accept / reject decisions and
with them the step count.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from ndcn_tpu_torch.ode.tree_math import (bcast, cast, leaves, per_leaf,
                                          rms_norm, tmax, tmax_rows,
                                          whole_mean, whole_mean_rows)

# Guard against division by zero; a normal float32 (see the JAX package).
_TINY = 1e-30


class Controller(NamedTuple):
    rtol: float
    atol: float
    safety: float = 0.9
    ifactor: float = 10.0
    dfactor: float = 0.2
    order: int = 5


def error_ratios(y1_error, y0, y1, rtol: float, atol: float,
                 tdtype: torch.dtype = torch.float32,
                 batched: bool = False, groups=None) -> List[torch.Tensor]:
    """The mean squared error ratio of each leaf, as 0-dim tensors of the
    time dtype (the ratios of a float32 state are widened before the mean
    under float64 time, as in the JAX package); with ``batched``, (R,)
    tensors, each the mean over one replica's elements; with ``groups``,
    a node-sharded leaf's over every rank's elements."""
    out = []
    errs = leaves(y1_error)
    for err, a, b, g in zip(errs, leaves(y0), leaves(y1),
                            per_leaf(groups, len(errs))):
        tol = atol + rtol * torch.maximum(torch.abs(a), torch.abs(b))
        r = cast(err / tol, tdtype)
        if batched:
            out.append(whole_mean_rows(r * r, g))
        else:
            out.append(whole_mean(r * r, g))
    return out


def accept_and_max_ratio(ratios: List[torch.Tensor]):
    """(accept, max_ratio): accept iff every leaf's ratio is <= 1 (per
    replica, for (R,) ratios)."""
    if len(ratios) == 1:
        return ratios[0] <= 1.0, ratios[0]
    stacked = torch.stack(ratios)
    return torch.all(stacked <= 1.0, dim=0), torch.amax(stacked, dim=0)


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


def select_initial_step(func, t0: torch.Tensor, y0, order: int,
                        rtol: float, atol: float, f0,
                        batched: bool = False, groups=None) -> torch.Tensor:
    """Hairer's empirical initial step, in ``t0``'s dtype; the reference's
    host branches become ``torch.where`` with the same thresholds. Calls
    ``func`` once. With ``batched`` (``t0`` of shape (R,)), one step per
    replica from that replica's own norms.

    The norms are taken per leaf and the largest kept, as in the JAX
    package; a leaf whose derivative norm is under 1e-5 (the adjoint-time
    scalar of the augmented system) gives no step-size ratio, where its raw
    ratio would be inf or NaN. ``groups`` as in ``error_ratios``."""
    tdtype = t0.dtype
    vmax = tmax_rows if batched else tmax
    ys, fs = leaves(y0), leaves(f0)
    gs = per_leaf(groups, len(ys))
    scales = [atol + torch.abs(y) * rtol for y in ys]
    d0s = [rms_norm(y / s, batched, g) for y, s, g in zip(ys, scales, gs)]
    d1s = [rms_norm(f / s, batched, g) for f, s, g in zip(fs, scales, gs)]
    ratios = [torch.where(b < 1e-5, torch.zeros_like(a),
                          a / torch.clamp(b, min=_TINY))
              for a, b in zip(d0s, d1s)]
    d0, d1 = cast(vmax(d0s), tdtype), cast(vmax(d1s), tdtype)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.full_like(d0, 1e-6),
                     0.01 * cast(vmax(ratios), tdtype))

    if isinstance(y0, torch.Tensor):
        y1 = y0 + bcast(cast(h0, y0.dtype), y0) * f0
    else:
        y1 = tuple(y + bcast(cast(h0, y.dtype), y) * f
                   for y, f in zip(ys, fs))
    f1 = func(t0 + h0, y1)
    d2 = cast(vmax([rms_norm((a - b) / s, batched, g) / cast(h0, a.dtype)
                    for a, b, s, g in zip(leaves(f1), fs, scales, gs)]),
              tdtype)

    h1_small = torch.clamp(h0 * 1e-3, min=1e-6)
    h1_big = (0.01 / torch.clamp(torch.maximum(d1, d2), min=_TINY)) \
        ** (1.0 / (order + 1.0))
    h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15), h1_small, h1_big)
    return torch.minimum(100.0 * h0, h1)
