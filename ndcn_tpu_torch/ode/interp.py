"""Dense output between accepted steps, as ``ndcn_tpu/ode/interp.py``.

- dopri5: the quartic fit from (y0, y1, y_mid, f0, f1);
- tsit5: Tsitouras' own rational dense-output polynomials over y0 and the
  seven stages.

Both are linear in their sources with scalar weights that depend only on
(x, dt), so each evaluation is Σ_c w_c · source_c, leaf by leaf of the
state. The sources are the fields of a NamedTuple, one state each, so that
the solver's ``emission_readout`` maps each of them alike.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ndcn_tpu_torch.ode.runge_kutta import StageCoeffs
from ndcn_tpu_torch.ode.tree_math import (bcast, cast, tindex, tmap,
                                          tscaled_dot_product)


class Dopri5Interp(NamedTuple):
    y0: torch.Tensor
    y1: torch.Tensor
    y_mid: torch.Tensor
    f0: torch.Tensor
    f1: torch.Tensor


def _interp_state(y0, y1, k, dt: torch.Tensor,
                  coeffs: StageCoeffs) -> Dopri5Interp:
    """The interp sources of one dopri5 step."""
    y_mid = tmap(torch.add, y0, tscaled_dot_product(dt, coeffs.c_mid, k))
    return Dopri5Interp(y0, y1, y_mid, tindex(k, 0), tindex(k, -1))


def _interp_init(y0) -> Dopri5Interp:
    """Placeholder before the first accepted step (never evaluated)."""
    z = tmap(torch.zeros_like, y0)
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


def _unit_x(t0: torch.Tensor, t1: torch.Tensor, t: torch.Tensor):
    dt = t1 - t0
    return (t - t0) / torch.where(dt == 0, torch.ones_like(dt), dt), dt


def _weighted_sum(w, state, dtype: Optional[torch.dtype]):
    """Σ_c w_c · state_c leaf by leaf. With ``dtype`` (the JAX package's
    ``emission_dtype``) the sources and their weights are rounded to it, as
    the JAX scan path stores its emitted coefficients and casts the
    evaluation weights to the buffer's type; the products and their sum are
    taken in float32, and the result is float32. Weights with leading axes
    (a batched solve's (R, m)) are laid over each leaf's leading axes
    (``bcast``), whatever the leaf's rank."""
    if dtype is None:
        def leaf(*src):
            out = None
            for wi, s in zip(w, src):
                term = bcast(cast(wi, s.dtype), s) * s
                out = term if out is None else out + term
            return out
    else:
        def leaf(*src):
            out = None
            for wi, s in zip(w, src):
                term = (bcast(wi.to(dtype).to(torch.float32), s)
                        * s.to(dtype).to(torch.float32))
                out = term if out is None else out + term
            return out
    return tmap(leaf, *state)


def _interp_eval(state: Dopri5Interp, t0: torch.Tensor, t1: torch.Tensor,
                 t: torch.Tensor, dtype: Optional[torch.dtype] = None):
    """Evaluate the quartic fit at time t in [t0, t1]."""
    x, dt = _unit_x(t0, t1, t)
    return _weighted_sum(dopri5_interp_weights(x, dt), state, dtype)


# ---------------------------------------------------------------- tsit5


class Tsit5Interp(NamedTuple):
    """y0 and the seven stages of one tsit5 step."""
    y0: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    k3: torch.Tensor
    k4: torch.Tensor
    k5: torch.Tensor
    k6: torch.Tensor
    k7: torch.Tensor


def tsit5_interp_state(y0, y1, k, dt: torch.Tensor,
                       coeffs: StageCoeffs) -> Tsit5Interp:
    del y1, dt, coeffs
    return Tsit5Interp(y0, *(tindex(k, i) for i in range(7)))


def tsit5_interp_init(y0) -> Tsit5Interp:
    z = tmap(torch.zeros_like, y0)
    return Tsit5Interp(y0, *([z] * 7))


def tsit5_b_coeffs(x: torch.Tensor):
    """The seven dense-output polynomials b_i(x) (the JAX package's
    ``_tsit5_b_coeffs``)."""
    t = x
    b1 = -1.0530884977290216 * t * (t - 1.3299890189751412) * (t * t - 1.4364028541716351 * t + 0.7139816917074209)  # noqa: E501
    b2 = 0.1017 * t * t * (t * t - 2.1966568338249754 * t + 1.2949852507374631)  # noqa: E501
    b3 = 2.490627285651252793 * t * t * (t * t - 2.38535645472061657 * t + 1.57803468208092486)  # noqa: E501
    b4 = -16.54810288924490272 * (t - 1.21712927295533244) * (t - 0.61620406037800089) * t * t  # noqa: E501
    b5 = 47.37952196281928122 * (t - 1.203071208372362603) * (t - 0.658047292653547382) * t * t  # noqa: E501
    b6 = -34.87065786149660974 * (t - 1.2) * (t - 0.666666666666666667) * t * t  # noqa: E501
    b7 = 2.5 * (t - 1.0) * (t - 0.6) * t * t
    return b1, b2, b3, b4, b5, b6, b7


def tsit5_interp_weights(x: torch.Tensor, dt: torch.Tensor):
    """The eight scalar weights [1, dt·b_1(x), …, dt·b_7(x)] of the sources
    (y0, k1, …, k7), the JAX package's ``tsit5_interp_weights``."""
    return (torch.ones_like(x), *(dt * b for b in tsit5_b_coeffs(x)))


def tsit5_interp_eval(state: Tsit5Interp, t0: torch.Tensor,
                      t1: torch.Tensor, t: torch.Tensor,
                      dtype: Optional[torch.dtype] = None):
    """Evaluate tsit5's dense output at time t in [t0, t1]."""
    x, dt = _unit_x(t0, t1, t)
    w = tsit5_interp_weights(x, dt)
    if dtype is not None:
        return _weighted_sum(w, state, dtype)
    # y0 enters with weight 1: added as it is
    return tmap(torch.add, state.y0,
                _weighted_sum(w[1:], state[1:], None))
