"""dopri5 dense output: the quartic fit from (y0, y1, y_mid, f0, f1), as
``ndcn_tpu/ode/interp.py``."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ndcn_tpu_torch.ode.runge_kutta import StageCoeffs
from ndcn_tpu_torch.ode.tree_math import scaled_dot_product


class Dopri5Interp(NamedTuple):
    y0: torch.Tensor
    y1: torch.Tensor
    y_mid: torch.Tensor
    f0: torch.Tensor
    f1: torch.Tensor


def _interp_state(y0: torch.Tensor, y1: torch.Tensor, k: torch.Tensor,
                  dt: torch.Tensor, coeffs: StageCoeffs) -> Dopri5Interp:
    """The interp sources of one dopri5 step."""
    y_mid = y0 + scaled_dot_product(dt, coeffs.c_mid, k)
    return Dopri5Interp(y0, y1, y_mid, k[0], k[-1])


def _interp_init(y0: torch.Tensor) -> Dopri5Interp:
    """Placeholder before the first accepted step (never evaluated)."""
    z = torch.zeros_like(y0)
    return Dopri5Interp(y0, y0, y0, z, z)


def dopri5_interp_weights(x: torch.Tensor, dt: torch.Tensor):
    """The five scalar weights w with y(t) = Σ_c w_c · source_c."""
    x2 = x * x
    x3 = x2 * x
    x4 = x3 * x
    w_y0 = -8.0 * x4 + 18.0 * x3 - 11.0 * x2 + 1.0
    w_y1 = -8.0 * x4 + 14.0 * x3 - 5.0 * x2
    w_ym = 16.0 * x4 - 32.0 * x3 + 16.0 * x2
    w_f0 = dt * (-2.0 * x4 + 5.0 * x3 - 4.0 * x2 + x)
    w_f1 = dt * (2.0 * x4 - 3.0 * x3 + x2)
    return w_y0, w_y1, w_ym, w_f0, w_f1


def _interp_eval(state: Dopri5Interp, t0: torch.Tensor, t1: torch.Tensor,
                 t: torch.Tensor, dtype: Optional[torch.dtype] = None
                 ) -> torch.Tensor:
    """Evaluate the quartic fit at time t in [t0, t1].

    With ``dtype`` (the JAX package's ``emission_dtype``) the five sources
    and their weights are rounded to it, as the JAX scan path stores its
    emitted coefficients and casts the evaluation weights to the buffer's
    type; the products and their sum are taken in float32, and the result
    is float32."""
    dt = t1 - t0
    x = (t - t0) / torch.where(dt == 0, torch.ones_like(dt), dt)
    w = dopri5_interp_weights(x, dt)
    if dtype is None:
        return (w[0] * state.y0 + w[1] * state.y1 + w[2] * state.y_mid
                + w[3] * state.f0 + w[4] * state.f1)
    out = None
    for wi, src in zip(w, state):
        term = (wi.to(dtype).to(torch.float32)
                * src.to(dtype).to(torch.float32))
        out = term if out is None else out + term
    return out
