"""Variable-coefficient Adams-Bashforth-Moulton, ``method="adams"``:
adaptive step and order 1-12, as ``ndcn_tpu/ode/vcabm.py``.

The JAX package runs the attempts in a ``lax.while_loop`` (inference) or a
bounded rematerialized ``lax.scan`` (training), with the g / phi
divided-difference recurrences computed to a static maximum order and masked
to the live one. Here both solves are one host loop, as ``adaptive.solve``:
each attempt ends in one device→host read of (accept, observation reached,
dt underflow, finite, and the order controller's two comparisons), and the
host indexes the recurrences by the order it keeps from them. The entries past the live order that the JAX package
computes and masks are never read there, so the steps, the accepted times
and the answers are the JAX package's; the differentiable solve records the
same loop under autograd, the gradient flowing through the step-size and
order controller as it does through the JAX scan.

The reference's control flow is kept, including its predictor-advance
quirk: on an accepted step the state carried on, and the value reported at
an observation time, is the *predictor*; the corrector refines only the
error estimate and the divided differences. Every attempt evaluates the RHS
twice (predictor and corrector), as the JAX package's branch-free attempt
does. The history (times, divided differences) is rebuilt out of place each
attempt; nothing is written in place, so autograd can record it.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from ndcn_tpu_torch.ode.adaptive import SolveStats, stack_solution
from ndcn_tpu_torch.ode.grad_guard import all_finite
from ndcn_tpu_torch.ode.step_control import (Controller, accept_and_max_ratio,
                                             error_ratios, optimal_step_size,
                                             select_initial_step)
from ndcn_tpu_torch.ode.tree_math import (cast, leaves, tmap, tmax, tmin,
                                          tscaled_dot_product, tstack)

_MIN_ORDER = 1
_MAX_ORDER = 12

# gamma* coefficients of the order-(k+1) error estimate
_GAMMA_STAR = (
    1, -1 / 2, -1 / 12, -1 / 24, -19 / 720, -3 / 160, -863 / 60480,
    -275 / 24192, -33953 / 3628800, -0.00789255, -0.00678585, -0.00592406,
    -0.00523669, -0.0046775, -0.00421495, -0.0038269,
)


class _State(NamedTuple):
    y: object                 # the state (the last accepted predictor)
    prev_t: torch.Tensor      # (H,) accepted times, newest first
    phi: List[object]         # divided differences, newest first
    next_t: torch.Tensor      # the proposed end of the next step


def _g_and_explicit_phi(prev_t: torch.Tensor, next_t: torch.Tensor,
                        phi: List, order: int):
    """g[0..order] and the explicit divided differences phi[0..order-1].

    beta_0 = 1, beta_j = beta_{j-1} (next_t - prev_t[j-1]) / (curr_t -
    prev_t[j]); the g coefficients by the reference's c recurrence."""
    curr_t = prev_t[0]
    dt = next_t - curr_t
    num = next_t - prev_t[: order - 1]
    den = curr_t - prev_t[1:order]
    ratios = torch.cat([torch.ones(1, dtype=prev_t.dtype,
                                   device=prev_t.device),
                        num / torch.where(den == 0, torch.ones_like(den),
                                          den)])
    beta = torch.cumprod(ratios, dim=0)
    explicit = [tmap(lambda p, b=beta[j]: p * cast(b, p.dtype), phi[j])
                for j in range(order)]

    c = 1.0 / torch.arange(1, order + 3, dtype=prev_t.dtype,
                           device=prev_t.device)
    g = [torch.ones((), dtype=prev_t.dtype, device=prev_t.device)]
    for j in range(1, order + 1):
        if j == 1:
            c = c[:-1] - c[1:]
        else:
            c = c[:-1] - c[1:] * (dt / (next_t - prev_t[j - 1]))
        g.append(c[0])
    return g, explicit


def _implicit_phi(explicit: List, f, n: int) -> List:
    """phi[0] = f, phi[j] = phi[j-1] - explicit[j-1], for j < n."""
    out = [f]
    for j in range(1, n):
        out.append(tmap(torch.sub, out[-1], explicit[j - 1]))
    return out


def _scaled(factors, x):
    """(f_0 · f_1 · …) · x leaf by leaf, each scalar factor rounded to the
    leaf's dtype first, as the JAX package casts them."""
    def leaf(v):
        s = cast(factors[0], v.dtype)
        for f in factors[1:]:
            s = s * cast(f, v.dtype)
        return s * v

    return tmap(leaf, x)


def solve_vcabm(func, y0, t: torch.Tensor, rtol: float, atol: float,
                max_order: int = _MAX_ORDER, max_steps: int = 1 << 16,
                safety: float = 0.9, ifactor: float = 10.0,
                dfactor: float = 0.2):
    """Solve over the grid ``t`` (strictly increasing, 1-D, float32 or
    float64 on the CPU; its dtype is the time dtype); returns (solution,
    SolveStats). Differentiable when autograd records it."""
    max_order = int(max(_MIN_ORDER, min(max_order, _MAX_ORDER)))
    H = max_order + 1
    T = t.shape[0]
    lead = leaves(y0)[0]
    t_dev = t.to(lead.device)
    tdtype = t.dtype
    ctrl = Controller(rtol=rtol, atol=atol, safety=safety, ifactor=ifactor,
                      dfactor=dfactor, order=0)

    f0 = func(t_dev[0], y0)
    first_step = select_initial_step(func, t_dev[0], y0, 2, rtol, atol, f0)
    st = _State(y=y0, prev_t=t_dev[0].expand(H), phi=[f0],
                next_t=t_dev[0] + first_step)
    order, n_hist, nfe = 1, 1, 2
    sol = [y0]
    nacc, nrej, syncs, ok = 0, 0, 0, True
    gamma_star = torch.tensor(_GAMMA_STAR, dtype=tdtype, device=lead.device)

    while len(sol) < T and nacc + nrej < max_steps and ok:
        t_obs = t_dev[len(sol)]
        # the pending observation bounds the step, so that an accepted
        # attempt lands on it exactly
        next_t = torch.minimum(st.next_t, t_obs)
        curr_t = st.prev_t[0]
        dt = next_t - curr_t
        g, phi = _g_and_explicit_phi(st.prev_t, next_t, st.phi, order)

        n_pred = max(1, order - 1)
        p_next = tmap(torch.add, st.y, tscaled_dot_product(
            dt, torch.stack(g[:n_pred]), tstack(phi[:n_pred])))
        f_pred = func(next_t, p_next)
        iphi_p = _implicit_phi(phi, f_pred, order + 1)

        y_next = tmap(torch.add, p_next,
                      _scaled((dt, g[order - 1]), iphi_p[order - 1]))
        local_error = _scaled((dt, g[order] - g[order - 1]), iphi_p[order])
        ratios = error_ratios(local_error, st.y, y_next, rtol, atol, tdtype)
        accept, max_ratio = accept_and_max_ratio(ratios)

        f_corr = func(next_t, y_next)
        nfe += 2
        finite = all_finite(*leaves(p_next), *leaves(f_pred),
                            *leaves(y_next), *leaves(f_corr),
                            *leaves(local_error))
        accept = accept & finite

        underflow = ~(next_t > curr_t)
        reached = accept & (next_t >= t_obs)
        flags = [accept, reached, underflow, finite]
        ramp = n_hist <= 4 or order < 3
        if not ramp:
            # order adaptation from the errors at orders k-1, k-2 and k+1
            def err_min(k: int):
                gd = g[max(k, 1)] - g[max(k - 1, 0)]
                return tmin(error_ratios(_scaled((dt, gd), iphi_p[max(k, 0)]),
                                         st.y, y_next, rtol, atol, tdtype))

            gamma = gamma_star[min(order, len(_GAMMA_STAR) - 1)]
            ekp1_max = tmax(error_ratios(_scaled((dt, gamma), iphi_p[order]),
                                         st.y, y_next, rtol, atol, tdtype))
            dec = torch.minimum(err_min(order - 1), err_min(order - 2)) \
                < max_ratio
            flags += [dec, ekp1_max < max_ratio]
        acc, hit, under, fin, *adapt = torch.stack(
            [f.to(tdtype) for f in flags]).tolist()
        syncs += 1
        ok = not under

        if not fin:
            # a forced rejection built from the state before the attempt,
            # with no RHS evaluation on the tape (``grad_guard``)
            st = st._replace(next_t=curr_t + dt * ctrl.dfactor)
            nrej += 1
            continue
        if not acc:
            dt_rej = optimal_step_size(dt, max_ratio,
                                       ctrl._replace(order=order))
            st = st._replace(next_t=curr_t + dt_rej)
            nrej += 1
            continue

        if ramp:
            k_next = min(order + 1, 3, max_order)
        elif adapt[0]:
            k_next = order - 1
        else:
            k_next = order + 1 if adapt[1] and order < max_order else order
        dt_acc = (dt if k_next > order
                  else optimal_step_size(dt, max_ratio,
                                         ctrl._replace(order=order + 1)))
        st = _State(y=p_next,
                    prev_t=torch.cat([next_t.reshape(1), st.prev_t[:-1]]),
                    phi=_implicit_phi(phi, f_corr, order + 1),
                    next_t=next_t + dt_acc)
        n_hist = min(n_hist + 1, H)
        order = k_next
        nacc += 1
        if hit:
            sol.append(p_next)

    stats = SolveStats(nfe=nfe, n_accepted=nacc, n_rejected=nrej,
                       success=ok and len(sol) >= T, host_syncs=syncs)
    return stack_solution(sol, T), stats
