"""A plain Dormand-Prince 5(4) solve with torchdiffeq's step control, the
reference the benchmark holds the port's solve against.

Written from the method's definition (Dormand & Prince 1980; Shampine's
dense output, as torchdiffeq's ``dopri5``) and torchdiffeq's controller
(``_impl/misc.py``), with the differentiable-solve semantics the port
states for training (its ``ode/adaptive.py`` docstring): one host loop of
attempts; t0, t1 and dt are tensors on the autograd tape, so the gradient
flows through the step-size controller (rejected attempts included) and
the initial-step heuristic; each observation is the last accepted step's
dense output. It shares no code with the port.

The controller:

- tolerance per element: atol + rtol · max(|y0|, |y1|);
- error ratio: the mean of (err / tol)² over the state, in the time dtype;
- accept iff the ratio is at most 1 and the attempt is finite;
- next dt = dt / clamp(min(sqrt(ratio)^(1/5) / 0.9, 1 / dfactor), 1/10),
  dfactor 1 after a ratio under 1, else 0.2; a non-finite attempt is
  rejected with dt · 0.2;
- Hairer's initial step with order 4 (torchdiffeq passes 4 for its
  fifth-order methods).

``norm_count`` is the count the means divide by: the state's element count,
or more where the solve's state carries zero rows that the norms count (the
feature-major layout pads the hidden width to a multiple of 8; its zero
rows add nothing to a sum and count in the mean).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

ALPHA = (1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
BETA = (
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
C_ERROR = (35 / 384 - 1951 / 21600, 0.0, 500 / 1113 - 22642 / 50085,
           125 / 192 - 451 / 720, -2187 / 6784 - -12231 / 42400,
           11 / 84 - 649 / 6300, -1.0 / 60.0)
C_MID = (6025192743 / 30085553152 / 2, 0.0, 51252292925 / 65400821598 / 2,
         -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
         -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2)

SAFETY, IFACTOR, DFACTOR, ORDER, INIT_ORDER = 0.9, 10.0, 0.2, 5, 4
TINY = 1e-30


class Stats(NamedTuple):
    nfe: int
    n_accepted: int
    n_rejected: int
    success: bool


def _combine(dt: torch.Tensor, coeffs, ks: List[torch.Tensor]):
    """dt · Σ_j coeffs[j] · ks[j] (the zero coefficients skipped)."""
    acc = None
    for c, k in zip(coeffs, ks):
        if c != 0.0:
            acc = c * k if acc is None else acc + c * k
    return dt.to(ks[0].dtype) * acc


def _rms(x: torch.Tensor, count: int) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x) / count)


def initial_step(func: Callable, t0: torch.Tensor, y0: torch.Tensor,
                 f0: torch.Tensor, rtol: float, atol: float,
                 count: int) -> torch.Tensor:
    """Hairer's initial step (one more RHS evaluation), in t0's dtype."""
    tdt = t0.dtype
    scale = atol + torch.abs(y0) * rtol
    d0 = _rms(y0 / scale, count).to(tdt)
    d1 = _rms(f0 / scale, count).to(tdt)
    if bool(d0 < 1e-5) or bool(d1 < 1e-5):
        h0 = torch.full_like(d0, 1e-6)
    else:
        h0 = 0.01 * d0 / d1
    y1 = y0 + h0.to(y0.dtype) * f0
    f1 = func(t0 + h0, y1)
    d2 = (_rms((f1 - f0) / scale, count) / h0.to(y0.dtype)).to(tdt)
    if bool(d1 <= 1e-15) and bool(d2 <= 1e-15):
        h1 = torch.clamp(h0 * 1e-3, min=1e-6)
    else:
        h1 = (0.01 / torch.clamp(torch.maximum(d1, d2), min=TINY)) \
            ** (1.0 / (INIT_ORDER + 1.0))
    return torch.minimum(100.0 * h0, h1)


def next_step(dt: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """torchdiffeq's optimal step size from the error ratio."""
    if bool(torch.isnan(ratio)):
        ratio = torch.full_like(ratio, float("inf"))
    dfactor = 1.0 if bool(ratio < 1.0) else DFACTOR
    err = torch.sqrt(torch.clamp(ratio, min=TINY))
    factor = torch.clamp(torch.clamp(err ** (1.0 / ORDER) / SAFETY,
                                     max=1.0 / dfactor), min=1.0 / IFACTOR)
    return dt / factor


def _dense(y0, y1, y_mid, f0, f1, t0, t1, t):
    """Shampine's quartic dense output of the step [t0, t1] at t."""
    dt = t1 - t0
    x = (t - t0) / (dt if bool(dt != 0) else torch.ones_like(dt))
    x2 = x * x
    x3 = x2 * x
    x4 = x3 * x
    w = (-8.0 * x4 + 18.0 * x3 - 11.0 * x2 + 1.0,
         -8.0 * x4 + 14.0 * x3 - 5.0 * x2,
         16.0 * x4 - 32.0 * x3 + 16.0 * x2,
         dt * (-2.0 * x4 + 5.0 * x3 - 4.0 * x2 + x),
         dt * (2.0 * x4 - 3.0 * x3 + x2))
    out = None
    for wi, s in zip(w, (y0, y1, y_mid, f0, f1)):
        term = wi.to(s.dtype) * s
        out = term if out is None else out + term
    return out


def odeint(func: Callable, y0: torch.Tensor, t: torch.Tensor, rtol: float,
           atol: float, max_steps: int = 1 << 14,
           norm_count: Optional[int] = None):
    """Solve y' = func(t, y) from y0 over the increasing grid ``t`` (a 1-D
    tensor of the time dtype on y0's device); returns ([y(t_i)], Stats).
    Differentiable when autograd records it."""
    count = y0.numel() if norm_count is None else norm_count
    t_host = t.tolist()
    f0 = func(t[0], y0)
    dt = initial_step(func, t[0], y0, f0, rtol, atol, count)
    nfe = 2
    y, f = y0, f0
    t0 = t1 = t[0]
    dense = None
    sol = [y0]
    nacc = nrej = 0
    ok = True
    t1_host = t_host[0]
    while len(sol) < len(t_host) and nacc + nrej < max_steps and ok:
        if t_host[len(sol)] <= t1_host:
            sol.append(_dense(*dense, t0, t1, t[len(sol)]))
            continue
        underflow = not bool(t1 + dt > t1)
        ks = [f]
        yi = y
        for alpha, beta in zip(ALPHA, BETA):
            yi = y + _combine(dt, beta, ks)
            ks.append(func(t1 + alpha * dt, yi))
        nfe += len(ALPHA)
        y_new, err = yi, _combine(dt, C_ERROR, ks)
        finite = bool(torch.isfinite(y_new).all()) and bool(
            torch.isfinite(err).all()) and all(
            bool(torch.isfinite(k).all()) for k in ks)
        if finite:
            tol = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y_new))
            r = (err / tol).to(t.dtype)
            ratio = torch.sum(r * r) / count
            accept = bool(ratio <= 1.0)
            dt_next = next_step(dt, ratio)
        else:
            accept = False
            dt_next = dt * DFACTOR
        if accept:
            y_mid = y + _combine(dt, C_MID, ks)
            dense = (y, y_new, y_mid, ks[0], ks[-1])
            y, f = y_new, ks[-1]
            t0, t1 = t1, t1 + dt
            t1_host = float(t1.detach())
            nacc += 1
        else:
            nrej += 1
        dt = dt_next
        ok = not underflow
    success = ok and len(sol) == len(t_host)
    return sol, Stats(nfe, nacc, nrej, success)
