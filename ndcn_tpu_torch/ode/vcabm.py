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

The JAX package's own design, the machine computed to the static maximum
order and masked to the live one, is here too (``_masked_attempt``), with
the order, the history count, the newest-first times and the divided
differences carried as tensors: phi is one (R, H, ...) tensor a leaf, H =
max_order + 1, and every replica r has its own order, step and history. Two
solves run it:

- ``solve_vcabm_batched``: R replicas in one host loop, ``jax.vmap`` of the
  JAX solve, as ``adaptive.solve_batched`` is for dopri5 (one (R, 4) read an
  attempt; a finished replica is frozen). Differentiable when autograd
  records it.
- ``solve_vcabm_while``: the inference solve of one model as one
  ``while_loop`` with no branch, for the serving artifact, as
  ``adaptive.solve_while`` is for dopri5. An accepted attempt lands on its
  observation exactly, so an observation is a masked write of the
  predictor.
- ``solve_vcabm_scan``: the JAX package's ``solve_vcabm_scan``, exactly
  ``max_steps`` attempts of one model with no read of the device from the
  host, as ``adaptive.solve_scan`` is for dopri5: the train step a CUDA
  graph records (``train.chunk``), and the bounded inference solve of the
  continuous adjoint under it.

The masked sums run over zeros past the live order: the history past it is
kept at zero, so that no weight of zero meets a non-finite entry. They may
round differently from the host-indexed sums in the last bit.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from torch._higher_order_ops import while_loop

from ndcn_tpu_torch.ode.adaptive import (BatchedSolveStats, SolveStats,
                                         _replica_finite, stack_solution)
from ndcn_tpu_torch.ode.grad_guard import all_finite
from ndcn_tpu_torch.ode.runge_kutta import shared_constants
from ndcn_tpu_torch.ode.step_control import (Controller, accept_and_max_ratio,
                                             error_ratios, optimal_step_size,
                                             select_initial_step)
from ndcn_tpu_torch.ode.collectives import all_true
from ndcn_tpu_torch.ode.tree_math import (bcast, cast, leaves, state_group,
                                          tmap, tmax, tmax_rows, tmin,
                                          tscaled_dot_product, tstack)

_MIN_ORDER = 1
_MAX_ORDER = 12

# gamma* coefficients of the order-(k+1) error estimate
_GAMMA_STAR = (
    1, -1 / 2, -1 / 12, -1 / 24, -19 / 720, -3 / 160, -863 / 60480,
    -275 / 24192, -33953 / 3628800, -0.00789255, -0.00678585, -0.00592406,
    -0.00523669, -0.0046775, -0.00421495, -0.0038269,
)


@shared_constants
def gamma_star(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``_GAMMA_STAR`` in the time dtype on ``device``, made once
    (``runge_kutta.shared_constants``)."""
    return torch.tensor(_GAMMA_STAR, dtype=dtype, device=device)


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
                dfactor: float = 0.2, groups=None):
    """Solve over the grid ``t`` (strictly increasing, 1-D, float32 or
    float64 on the CPU; its dtype is the time dtype); returns (solution,
    SolveStats). Differentiable when autograd records it. ``groups``: the
    process group of each node-sharded leaf (``adaptive.solve``)."""
    max_order = int(max(_MIN_ORDER, min(max_order, _MAX_ORDER)))
    H = max_order + 1
    T = t.shape[0]
    lead = leaves(y0)[0]
    t_dev = t.to(lead.device)
    tdtype = t.dtype
    ctrl = Controller(rtol=rtol, atol=atol, safety=safety, ifactor=ifactor,
                      dfactor=dfactor, order=0)

    f0 = func(t_dev[0], y0)
    first_step = select_initial_step(func, t_dev[0], y0, 2, rtol, atol, f0,
                                     groups=groups)
    st = _State(y=y0, prev_t=t_dev[0].expand(H), phi=[f0],
                next_t=t_dev[0] + first_step)
    order, n_hist, nfe = 1, 1, 2
    sol = [y0]
    nacc, nrej, syncs, ok = 0, 0, 0, True
    g_star = gamma_star(tdtype, lead.device)

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
        ratios = error_ratios(local_error, st.y, y_next, rtol, atol, tdtype,
                              groups=groups)
        accept, max_ratio = accept_and_max_ratio(ratios)

        f_corr = func(next_t, y_next)
        nfe += 2
        finite = all_finite(*leaves(p_next), *leaves(f_pred),
                            *leaves(y_next), *leaves(f_corr),
                            *leaves(local_error), group=state_group(groups))
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
                                         st.y, y_next, rtol, atol, tdtype,
                                         groups=groups))

            gamma = g_star[min(order, len(_GAMMA_STAR) - 1)]
            ekp1_max = tmax(error_ratios(_scaled((dt, gamma), iphi_p[order]),
                                         st.y, y_next, rtol, atol, tdtype,
                                         groups=groups))
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


# ------------------------------------------------------- the masked machine


class _Machine(NamedTuple):
    """The VCABM state of R replicas as tensors, each replica with its own
    order, history and step: leaves of ``y`` (R, ...), of ``phi`` (R, H,
    ...), ``prev_t`` (R, H), the rest (R,)."""
    y: object                 # the last accepted predictor
    prev_t: torch.Tensor      # accepted times, newest first
    phi: object               # divided differences, newest first
    next_t: torch.Tensor      # the proposed end of the next step
    order: torch.Tensor       # int64
    n_hist: torch.Tensor      # int64, accepted points in the history


def _init_machine(y0, f0, t0: torch.Tensor, first_step: torch.Tensor,
                  H: int) -> _Machine:
    """Order 1, one point of history (t0, f0), the rest of phi zero."""
    R = t0.shape[0]

    def hist(f):
        return torch.cat([f.unsqueeze(1), f.new_zeros(
            (R, H - 1, *f.shape[1:]))], dim=1)

    one = torch.ones(R, dtype=torch.int64, device=t0.device)
    return _Machine(y=y0, prev_t=t0.unsqueeze(1).expand(R, H).clone(),
                    phi=tmap(hist, f0), next_t=t0 + first_step, order=one,
                    n_hist=one.clone())


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == 0, torch.ones_like(x), x)


def _masked_g_and_beta(prev_t: torch.Tensor, next_t: torch.Tensor, H: int,
                       capturable: bool = False):
    """g[:, 0..H-1] and beta[:, 0..H-1] of every replica, by the recurrences
    of ``_g_and_explicit_phi`` taken to the static order. A zero gap (a
    replica frozen at dt = 0, a history not yet filled) divides by one, so
    that every entry stays finite; a live attempt never meets one in the
    entries its order reads. ``capturable``: a CUDA graph may record the
    backward (``solve_vcabm_scan``)."""
    curr_t = prev_t[:, 0]
    dt = next_t - curr_t
    num = next_t.unsqueeze(1) - prev_t
    den = curr_t.unsqueeze(1) - prev_t
    ratios = num[:, :-1] / _nonzero(den[:, 1:])
    if capturable and ratios.requires_grad:
        # the running product as H - 1 multiplications where a graph may
        # record the backward: ``torch.cumprod``'s reads the device on the
        # host (a zero test), which a capture refuses
        beta = [torch.ones_like(num[:, 0])]
        for j in range(H - 1):
            beta.append(beta[-1] * ratios[:, j])
        beta = torch.stack(beta, dim=1)
    else:
        beta = torch.cumprod(torch.cat([torch.ones_like(num[:, :1]), ratios],
                                       dim=1), dim=1)
    c = (1.0 / torch.arange(1, H + 2, dtype=prev_t.dtype,
                            device=prev_t.device)).expand(prev_t.shape[0],
                                                          H + 1)
    g = [torch.ones_like(dt)]
    for j in range(1, H):
        if j == 1:
            c = c[:, :-1] - c[:, 1:]
        else:
            factor = dt / _nonzero(next_t - prev_t[:, j - 1])
            c = c[:, :-1] - c[:, 1:] * factor.unsqueeze(1)
        g.append(c[:, 0])
    return torch.stack(g, dim=1), beta


def _masked_implicit(explicit, f, H: int):
    """phi[:, 0] = f, phi[:, j] = phi[:, j-1] - explicit[:, j-1], to H."""
    def leaf(ep, fn):
        out = [fn]
        for j in range(1, H):
            out.append(out[-1] - ep[:, j - 1])
        return torch.stack(out, dim=1)

    return tmap(leaf, explicit, f)


def _row(leaf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """leaf[r, idx[r]] for every replica r: leaf (R, H, ...), idx (R,)."""
    index = idx.view(-1, 1, *([1] * (leaf.ndim - 2))).expand(
        leaf.shape[0], 1, *leaf.shape[2:])
    return torch.gather(leaf, 1, index).squeeze(1)


def _rows(tree, idx: torch.Tensor):
    return tmap(lambda leaf: _row(leaf, idx), tree)


def _scaled_rows(factors, x):
    """(f_0 · f_1 · …) · x replica by replica, each (R,) factor rounded to
    the leaf's dtype first (``_scaled`` with a replica axis)."""
    def leaf(v):
        s = cast(factors[0], v.dtype)
        for f in factors[1:]:
            s = s * cast(f, v.dtype)
        return bcast(s, v) * v

    return tmap(leaf, x)


def _weighted_rows(w: torch.Tensor, phi):
    """Σ_j w[r, j] · phi[r, j] for every replica r: w (R, H)."""
    def leaf(p):
        R, H = p.shape[:2]
        out = torch.bmm(cast(w, p.dtype).unsqueeze(1), p.reshape(R, H, -1))
        return out.reshape(R, *p.shape[2:])

    return tmap(leaf, phi)


def _step_for_order(dt: torch.Tensor, max_ratio: torch.Tensor,
                    order: torch.Tensor, ctrl: Controller) -> torch.Tensor:
    """``optimal_step_size`` with a per-replica order (R,): the exponent
    1/order is applied as ``tensor ** float`` applies it (orders 1 and 2 as
    the identity and a square root)."""
    max_ratio = torch.where(torch.isnan(max_ratio),
                            torch.full_like(max_ratio, float("inf")),
                            max_ratio)
    dfactor = torch.where(max_ratio < 1.0, torch.ones_like(max_ratio),
                          torch.full_like(max_ratio, ctrl.dfactor))
    error_ratio = torch.sqrt(torch.clamp(max_ratio, min=1e-30))
    k = order.to(error_ratio.dtype)
    powered = torch.where(order == 1, error_ratio, torch.where(
        order == 2, torch.sqrt(error_ratio), error_ratio ** (1.0 / k)))
    factor = torch.clamp(torch.minimum(powered / ctrl.safety, 1.0 / dfactor),
                         min=1.0 / ctrl.ifactor)
    return dt / factor


def _tmin_rows(values):
    return values[0] if len(values) == 1 else torch.stack(values).amin(0)


def _masked_attempt(func, st: _Machine, obs_i: torch.Tensor,
                    live: torch.Tensor, t: torch.Tensor, ctrl: Controller,
                    max_order: int, g_star: torch.Tensor,
                    bad: Optional[torch.Tensor] = None, groups=None,
                    capturable: bool = False):
    """One branch-free attempt of every replica, ``_make_vcabm_machine``'s
    ``attempt`` of the JAX package with a replica axis. ``obs_i`` (R,) is
    each replica's pending observation, ``g_star`` is ``_GAMMA_STAR`` in
    the time dtype (``gamma_star``, made by the caller outside any loop),
    ``live`` (R,) marks the replicas
    still solving; the others keep their state and attempt at dt = 0, as
    does a replica marked ``bad``, which is rejected with dt·dfactor (the
    forced rejection of a non-finite attempt, ``grad_guard``). ``groups``:
    the process group of each node-sharded leaf (``adaptive.solve``).
    ``capturable``: the attempt's backward reads nothing on the host
    (``_masked_g_and_beta``).

    Returns (state, accept, reached, underflow, ok, p_next): accept,
    reached (an accepted attempt that landed on its observation), underflow
    and ok (the attempt's finite flag) are (R,) bool, p_next the predictor
    that an observation reads."""
    H = max_order + 1
    tdtype = t.dtype
    go = live if bad is None else live & ~bad
    curr_t = st.prev_t[:, 0]
    t_obs = t.index_select(0, torch.clamp(obs_i, max=t.shape[0] - 1))
    # the pending observation bounds the step, so that an accepted attempt
    # lands on it exactly
    next_prop = torch.minimum(st.next_t, t_obs)
    dt_prop = next_prop - curr_t
    next_t = torch.where(go, next_prop, curr_t)
    dt = next_t - curr_t
    g, beta = _masked_g_and_beta(st.prev_t, next_t, H, capturable)
    phi = tmap(lambda p: p * bcast(cast(beta, p.dtype), p), st.phi)

    order = st.order
    j = torch.arange(H, device=order.device)
    pred_w = torch.where(j < torch.clamp(order - 1, min=1).unsqueeze(1), g,
                         torch.zeros_like(g))
    p_next = tmap(torch.add, st.y,
                  _scaled_rows((dt,), _weighted_rows(pred_w, phi)))
    f_pred = func(next_t, p_next)
    iphi_p = _masked_implicit(phi, f_pred, H)

    om1 = torch.clamp(order - 1, min=0)
    g_om1 = _row(g, om1)
    y_next = tmap(torch.add, p_next,
                  _scaled_rows((dt, g_om1), _rows(iphi_p, om1)))
    local_error = _scaled_rows((dt, _row(g, order) - g_om1),
                               _rows(iphi_p, order))
    ratios = error_ratios(local_error, st.y, y_next, ctrl.rtol, ctrl.atol,
                          tdtype, batched=True, groups=groups)
    accept, max_ratio = accept_and_max_ratio(ratios)
    f_corr = func(next_t, y_next)
    finite = all_true(_replica_finite(
        *leaves(p_next), *leaves(f_pred), *leaves(y_next), *leaves(f_corr),
        *leaves(local_error)), state_group(groups))
    ok = finite if bad is None else finite & ~bad
    accept = accept & ok & live

    # order adaptation from the errors at orders k-1, k-2 and k+1
    def err_min(k):
        gd = _row(g, torch.clamp(k, min=1)) - _row(g, torch.clamp(k - 1,
                                                                 min=0))
        e = _scaled_rows((dt, gd), _rows(iphi_p, torch.clamp(k, min=0)))
        return _tmin_rows(error_ratios(e, st.y, y_next, ctrl.rtol, ctrl.atol,
                                       tdtype, batched=True, groups=groups))

    gamma = g_star.index_select(
        0, torch.clamp(order, max=len(_GAMMA_STAR) - 1))
    ekp1_max = tmax_rows(error_ratios(
        _scaled_rows((dt, gamma), _rows(iphi_p, order)), st.y, y_next,
        ctrl.rtol, ctrl.atol, tdtype, batched=True, groups=groups))
    ramp = (st.n_hist <= 4) | (order < 3)
    dec = torch.minimum(err_min(order - 1), err_min(order - 2)) < max_ratio
    inc = ~dec & (order < max_order) & (ekp1_max < max_ratio)
    k_next = torch.where(ramp, torch.clamp(order + 1, max=min(3, max_order)),
                         torch.where(dec, order - 1,
                                     torch.where(inc, order + 1, order)))
    dt_acc = torch.where(k_next > order, dt,
                         _step_for_order(dt, max_ratio, order + 1, ctrl))
    dt_rej = torch.where(ok, _step_for_order(dt, max_ratio, order, ctrl),
                         dt_prop * ctrl.dfactor)

    # the history an accepted attempt leaves: the entries past its order
    # are never read, and are kept at zero
    keep = j <= order.unsqueeze(1)
    phi_acc = tmap(lambda p: torch.where(bcast(keep, p), p,
                                         torch.zeros_like(p)),
                   _masked_implicit(phi, f_corr, H))

    def pick(a, b):
        return torch.where(bcast(accept, a), a, b)

    new = _Machine(
        y=tmap(pick, p_next, st.y),
        prev_t=pick(torch.cat([next_t.unsqueeze(1), st.prev_t[:, :-1]],
                              dim=1), st.prev_t),
        phi=tmap(pick, phi_acc, st.phi),
        next_t=torch.where(accept, next_t + dt_acc, torch.where(
            live, curr_t + dt_rej, st.next_t)),
        order=torch.where(accept, k_next, order),
        n_hist=torch.where(accept, torch.clamp(st.n_hist + 1, max=H),
                           st.n_hist))
    reached = accept & (next_t >= t_obs)
    underflow = live & ~(next_prop > curr_t)
    return new, accept, reached, underflow, ok, p_next


def _clamped_order(max_order: int) -> int:
    return int(max(_MIN_ORDER, min(max_order, _MAX_ORDER)))


def solve_vcabm_batched(func, y0, t: torch.Tensor, rtol: float, atol: float,
                        max_order: int = _MAX_ORDER, max_steps: int = 1 << 16,
                        safety: float = 0.9, ifactor: float = 10.0,
                        dfactor: float = 0.2, groups=None):
    """``solve_vcabm`` for R replicas at once, ``jax.vmap`` of the JAX
    solve: every leaf of ``y0`` is (R, ...), ``func(t, y)`` takes t of
    shape (R,) and the batched state, the grid ``t`` (on the CPU) is
    shared. Returns (solution (len(t), R, ...), BatchedSolveStats).

    Each replica keeps its own order, step, history, accept flag,
    observation pointer, attempt count and NFE (two an attempt); one that
    has read every observation, spent ``max_steps`` attempts or underflowed
    is frozen, and the loop ends when every replica is. Each attempt ends
    in one (R, 4) read of (accept, reached, underflow, finite). An
    observation a replica did not reach holds its y0, a finite
    placeholder, with ``stats.success[r]`` False, as in
    ``adaptive.solve_batched``. Differentiable when autograd records it:
    the gradient crosses the step-size and order controller, and an
    attempt that is non-finite for a live replica is recorded again with
    that replica at dt = 0 and rejected, so that its gradient is zero."""
    max_order = _clamped_order(max_order)
    H = max_order + 1
    T = t.shape[0]
    lead = leaves(y0)[0]
    R, device = lead.shape[0], lead.device
    t_dev = t.to(device)
    ctrl = Controller(rtol=rtol, atol=atol, safety=safety, ifactor=ifactor,
                      dfactor=dfactor, order=0)
    t0 = t_dev[0].expand(R).clone()
    f0 = func(t0, y0)
    first = select_initial_step(func, t0, y0, 2, rtol, atol, f0,
                                batched=True, groups=groups)
    st = _init_machine(y0, f0, t0, first, H)
    obs_i = torch.ones(R, dtype=torch.int64, device=device)
    g_star = gamma_star(t.dtype, device)

    # slot 0 of every replica is y0; every attempt that reaches some
    # replica's observation adds a slot, slot_of[r][i] is where replica r's
    # observation i went
    rounds = [tmap(lambda leaf: leaf.unsqueeze(1), y0)]
    slot_of = [[0] * T for _ in range(R)]
    ptr, nfe = [1] * R, [2] * R
    nacc, nrej, ok = [0] * R, [0] * R, [True] * R
    syncs = 0
    while True:
        live = [ptr[r] < T and nacc[r] + nrej[r] < max_steps and ok[r]
                for r in range(R)]
        if not any(live):
            break
        live_t = torch.tensor(live, device=device)
        out = _masked_attempt(func, st, obs_i, live_t, t_dev, ctrl,
                              max_order, g_star, groups=groups)
        acc, hit, under, fin = torch.stack(
            [f.to(torch.int32) for f in out[1:5]]).tolist()
        syncs += 1
        bad = [lv and not f for lv, f in zip(live, fin)]
        if any(bad) and torch.is_grad_enabled():
            out = _masked_attempt(func, st, obs_i, live_t, t_dev, ctrl,
                                  max_order, g_star,
                                  bad=torch.tensor(bad, device=device),
                                  groups=groups)
        st, _, reached, _, _, p_next = out
        obs_i = obs_i + reached.long()
        if any(hit):
            rounds.append(tmap(lambda leaf: leaf.unsqueeze(1), p_next))
        for r in range(R):
            if not live[r]:
                continue
            nfe[r] += 2
            if acc[r]:
                nacc[r] += 1
            else:
                nrej[r] += 1
            ok[r] = not under[r]
            if hit[r]:
                slot_of[r][ptr[r]] = len(rounds) - 1
                ptr[r] += 1

    stats = BatchedSolveStats(
        nfe=tuple(nfe), n_accepted=tuple(nacc), n_rejected=tuple(nrej),
        success=tuple(ok[r] and ptr[r] >= T for r in range(R)),
        host_syncs=syncs)
    slots = tmap(lambda *ls: torch.cat(ls, dim=1), *rounds)
    idx = torch.tensor(slot_of, device=device).t()             # (T, R)
    reps = torch.arange(R, device=device).expand(T, R)
    # row-major, as every solve returns it (the kernels take no other)
    return tmap(lambda leaf: leaf[reps, idx].contiguous(), slots), stats


def solve_vcabm_while(func, y0, t: torch.Tensor, rtol: float, atol: float,
                      max_order: int = _MAX_ORDER, max_steps: int = 1 << 16,
                      safety: float = 0.9, ifactor: float = 10.0,
                      dfactor: float = 0.2, groups=None):
    """The inference solve of one model as one device-resident program, the
    JAX package's ``solve_vcabm`` (a ``lax.while_loop``): a ``while_loop``
    whose body is ``_masked_attempt`` on a replica axis of one, with no
    branch. It is what ``torch.export`` traces (``serve.export_ndcn``);
    run eagerly it gives what ``solve_vcabm`` gives, to the rounding of the
    masked sums.

    ``t`` is the grid in the time dtype, on any device (moved to the
    state's). The carry is flat tensors: the machine, (obs_i, nfe, nacc,
    nrej, ok) and one solution buffer a leaf, (len(t) + 1, 1, ...): an
    attempt that reaches its observation writes the predictor at obs_i,
    every other attempt writes into the last row, which is dropped. The
    rows not reached stay NaN. Returns (solution, SolveStats) with 0-dim
    tensors for the counts and ``success``, and ``host_syncs`` None."""
    max_order = _clamped_order(max_order)
    H = max_order + 1
    T = t.shape[0]
    lead = leaves(y0)[0]
    device = lead.device
    t = t.to(device)
    bare = isinstance(y0, torch.Tensor)
    m = len(leaves(y0))
    ctrl = Controller(rtol=rtol, atol=atol, safety=safety, ifactor=ifactor,
                      dfactor=dfactor, order=0)

    def one(tree):
        return tmap(lambda leaf: leaf.unsqueeze(0), tree)

    def func_r(tt, y):
        # the model's RHS on the replica axis of one
        return one(func(tt.reshape(()), tmap(lambda leaf: leaf[0], y)))

    y0_r = one(y0)
    t0 = t[:1].clone()
    f0 = func_r(t0, y0_r)
    first = select_initial_step(func_r, t0, y0_r, 2, rtol, atol, f0,
                                batched=True, groups=groups)
    st0 = _init_machine(y0_r, f0, t0, first, H)

    def count(v):
        return torch.full((1,), v, dtype=torch.int64, device=device)

    sol0 = tmap(lambda y: torch.cat([y.unsqueeze(0), torch.full(
        (T, *y.shape), float("nan"), dtype=y.dtype, device=device)]), y0_r)

    def tree(flat):
        return flat[0] if bare else tuple(flat)

    def pack(st: _Machine, counts, sol):
        return (*leaves(st.y), st.prev_t, *leaves(st.phi), st.next_t,
                st.order, st.n_hist, *counts, *leaves(sol))

    def unpack(flat):
        st = _Machine(y=tree(flat[:m]), prev_t=flat[m],
                      phi=tree(flat[m + 1:2 * m + 1]), next_t=flat[2 * m + 1],
                      order=flat[2 * m + 2], n_hist=flat[2 * m + 3])
        return st, flat[2 * m + 4:2 * m + 9], tree(flat[2 * m + 9:])

    carry0 = tuple(c.clone() for c in pack(st0, (
        count(1), count(2), count(0), count(0),
        torch.ones(1, dtype=torch.bool, device=device)), sol0))
    rep = torch.zeros(1, dtype=torch.int64, device=device)
    g_star = gamma_star(t.dtype, device)

    def live_of(counts):
        obs_i, _, nacc, nrej, ok = counts
        return (obs_i < T) & (nacc + nrej < max_steps) & ok

    def cond_fn(*c):
        return live_of(unpack(c)[1]).any()

    def body(*c):
        st, counts, sol = unpack(c)
        obs_i, nfe, nacc, nrej, ok = counts
        live = live_of(counts)
        new, accept, reached, underflow, _, p_next = _masked_attempt(
            func_r, st, obs_i, live, t, ctrl, max_order, g_star,
            groups=groups)
        idx = torch.where(reached, obs_i, torch.full_like(obs_i, T))
        sol = tmap(lambda buf, v: buf.index_put((idx, rep), v), sol, p_next)
        return pack(new, (obs_i + reached.long(), nfe + 2 * live.long(),
                          nacc + accept.long(),
                          nrej + (live & ~accept).long(), ok & ~underflow),
                    sol)

    final = while_loop(cond_fn, body, carry0)
    _, (obs_i, nfe, nacc, nrej, ok), sol = unpack(final)
    stats = SolveStats(nfe=nfe[0], n_accepted=nacc[0], n_rejected=nrej[0],
                       success=ok[0] & (obs_i[0] >= T), host_syncs=None)
    return tmap(lambda buf: buf[:T, 0], sol), stats


def solve_vcabm_scan(func, y0, t: torch.Tensor, rtol: float, atol: float,
                     max_order: int = _MAX_ORDER, max_steps: int = 256,
                     safety: float = 0.9, ifactor: float = 10.0,
                     dfactor: float = 0.2, groups=None,
                     differentiable: bool = True):
    """The bounded solve of one model that never reads the device from the
    host: the port of the JAX package's ``solve_vcabm_scan``. Returns
    (solution, SolveStats) with 0-dim device tensors for the counts and
    ``success``, and ``host_syncs`` 0.

    It runs exactly ``max_steps`` attempts of ``_masked_attempt`` on a
    replica axis of one, as ``solve_vcabm_while`` runs it. An attempt is
    live until every observation is reached or the step underflows; a
    frozen one runs at dt = 0 and is masked out with ``torch.where``: it
    adds nothing to the machine, to NFE (two an attempt) or the counts, and
    a zero cotangent to the gradients. (The JAX package skips frozen
    attempts with ``lax.cond``; here they cost an attempt each, ROADMAP §1
    entry 6b.) Each attempt emits its reached flag, its observation index
    and its predictor; after the loop one ``index_put`` writes the reached
    predictors into the solution, the rest into a row that is dropped. An
    observation not reached (a blown budget) holds zero, as in the JAX
    package, with ``success`` False (the callers turn it to NaN with
    ``torch.where``).

    ``differentiable``: each attempt runs under a non-reentrant
    ``torch.utils.checkpoint``, as in ``adaptive.solve_scan``, and its
    recomputation is the gradient guard: an attempt whose forward went
    non-finite is recomputed as the forced rejection (``bad``, at dt = 0),
    whose RHS parameters get zero. Otherwise (the continuous adjoint's
    solves, under ``torch.no_grad()``) the attempts run as they are.
    ``groups``: the process group of each node-sharded leaf
    (``adaptive.solve``): every rank runs the same attempts, frozen ones
    included, and so issues the same collectives. ``t`` is the grid in the
    time dtype on any device (moved to the state's)."""
    from torch.utils.checkpoint import checkpoint

    max_order = _clamped_order(max_order)
    H = max_order + 1
    T = t.shape[0]
    lead = leaves(y0)[0]
    device = lead.device
    t = t.to(device)
    bare = isinstance(y0, torch.Tensor)
    m = len(leaves(y0))
    ctrl = Controller(rtol=rtol, atol=atol, safety=safety, ifactor=ifactor,
                      dfactor=dfactor, order=0)

    def tree(flat):
        return flat[0] if bare else tuple(flat)

    def one(x):
        return tmap(lambda leaf: leaf.unsqueeze(0), x)

    def func_r(tt, y):
        # the model's RHS on the replica axis of one
        return one(func(tt.reshape(()), tmap(lambda leaf: leaf[0], y)))

    def pack(st: _Machine) -> tuple:
        return (*leaves(st.y), st.prev_t, *leaves(st.phi), st.next_t,
                st.order, st.n_hist)

    def unpack(flat) -> _Machine:
        return _Machine(y=tree(flat[:m]), prev_t=flat[m],
                        phi=tree(flat[m + 1:2 * m + 1]),
                        next_t=flat[2 * m + 1], order=flat[2 * m + 2],
                        n_hist=flat[2 * m + 3])

    y0_r = one(y0)
    t0 = t[:1]
    f0 = func_r(t0, y0_r)
    first = select_initial_step(func_r, t0, y0_r, 2, rtol, atol, f0,
                                batched=True, groups=groups)
    g_star = gamma_star(t.dtype, device)

    def attempt(veto, live, obs_i, *flat):
        """One masked attempt; ``veto`` is the one-element list the guard
        writes after the forward (see ``adaptive.solve_scan``)."""
        new, accept, reached, underflow, ok, p_next = _masked_attempt(
            func_r, unpack(flat), obs_i, live, t, ctrl, max_order, g_star,
            bad=veto[0], groups=groups, capturable=True)
        return (*pack(new), accept, reached, underflow, ok, *leaves(p_next))

    def count(v):
        return torch.full((1,), v, dtype=torch.int64, device=device)

    flat = pack(_init_machine(y0_r, f0, t0, first, H))
    n = len(flat)
    obs_i, nfe, nacc, nrej = count(1), count(2), count(0), count(0)
    ok = torch.ones(1, dtype=torch.bool, device=device)
    slots, emitted = [], []
    for _ in range(max_steps):
        live = (obs_i < T) & ok
        veto = [torch.zeros(1, dtype=torch.bool, device=device)]
        if differentiable:
            out = checkpoint(attempt, veto, live, obs_i, *flat,
                             use_reentrant=False, preserve_rng_state=False)
        else:
            out = attempt(veto, live, obs_i, *flat)
        flat = out[:n]
        accept, reached, underflow, fin = out[n:n + 4]
        veto[0] = ~fin
        # an attempt that reached no observation writes the dropped row T
        slots.append(torch.where(reached, obs_i, torch.full_like(obs_i, T)))
        emitted.append(out[n + 4:])
        obs_i = obs_i + reached.long()
        nfe = nfe + 2 * live.long()
        nacc = nacc + accept.long()
        nrej = nrej + (live & ~accept).long()
        ok = ok & ~underflow

    idx = torch.cat(slots)                                     # (S,)

    def write(j: int, y: torch.Tensor) -> torch.Tensor:
        preds = torch.cat([e[j] for e in emitted])             # (S, ...)
        buf = y.new_zeros((T + 1, *y.shape)).index_put((idx,), preds)
        return torch.cat([y.unsqueeze(0), buf[1:T]])

    sol = tree([write(j, y) for j, y in enumerate(leaves(y0))])
    stats = SolveStats(nfe=nfe[0], n_accepted=nacc[0], n_rejected=nrej[0],
                       success=ok[0] & (obs_i[0] >= T), host_syncs=0)
    return sol, stats
