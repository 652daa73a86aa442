"""Adaptive Runge-Kutta integration (dopri5, tsit5): one host loop for the
inference and the differentiable solve, and the bounded differentiable
solve that never reads the device (``solve_scan``).

The port of ``ndcn_tpu/ode/adaptive.py``. There ``solve_while`` runs a
``lax.while_loop`` of ``lax.cond(ready, consume_obs, take_step)`` and
``solve_scan`` a bounded ``lax.scan`` of step attempts followed by a
searchsorted over the emitted dense outputs. Here both are one loop on the
host around a branch-free step (``torch.where`` on accept, as the JAX
package's ``_attempt_step_core``). The host needs four numbers after each
step attempt (the new t1, accept, the dt-underflow flag and the attempt's
finite flag) and reads them in one device→host copy: one sync per attempt
and none per observation. ``SolveStats.host_syncs`` counts them.
``solve_while`` is the inference solve as one device-resident program
(``while_loop`` and ``torch.cond`` around the same step), which
``torch.export`` traces for the serving artifact. ``solve_scan`` is the
JAX package's ``solve_scan``: ``max_steps`` masked attempts and the
observations read from their emissions after the loop, with no host read,
so that a CUDA graph can record a whole train step (``train.chunk``); it
takes the same attempts as the host loop (see its docstring). While a
graph is being captured, each attempt of a state that is not node-sharded
also sits behind a conditional graph node on its live flag, in the forward
and in the backward (``graph_gate``, the JAX package's ``lax.cond``): a
replay skips a frozen attempt's kernels, with the masked answers bit for
bit. Eager and CPU solves, a capture's warm-up steps and a node-sharded
state (whose attempts issue collectives) run every attempt, masked.

Under autograd the loop records the differentiable solve with the JAX scan
path's gradient semantics:

- t0, t1 and dt stay time-dtype tensors on the tape, so the gradient flows
  through the step-size controller (rejected attempts included) and through
  the initial-step heuristic; the host reads values only to steer the loop.
- Each observation is read from the last accepted step's dense output when
  the loop passes it, as ``solve_while`` does. The scan path's searchsorted
  and one-hot matmul select the same interval and compute the same function.
  The host loop reads every observation a step passed at once: the step's
  sources read out once, the weights of all its times as vectors and one
  (m, ...) block of the same elementwise sums, so the values are those of
  one read an observation, bit for bit.
- An attempt with non-finite internals is replaced on the tape by its forced
  rejection (``grad_guard``).
- ``max_steps`` counts attempts; running out gives ``success=False`` and NaN
  for the observations not reached.

Per-step recomputation is not needed: autograd keeps each attempt's
intermediates, and the backward replays nothing. The JAX scan path's two
emission levers act where the observations are read:

- ``emission_readout``, a linear map from the state to a (much smaller)
  observable, is applied to the five dense-output sources before they are
  interpolated. Linearity makes that exact, and the kept trajectory is
  readout-sized: (T, n, 1) instead of (T, n, 20) for the decoder's weight.
- ``emission_dtype`` rounds those (read-out) sources and the interpolation
  weights to it, the same tensors the JAX package stores in its emission
  buffers; the sum is float32. Solver steps are unaffected.

``solve_batched`` runs R independent replicas of one problem (a leading
replica axis on every leaf of the state, the grid shared) in one loop and
one launch stream: every attempt is one batched attempt for all replicas,
and the host reads the (R, 4) block of (t1, accept, underflow, finite) in
one copy. Each replica keeps its own step size, accept flag, observation
pointer, attempt count, success flag and NFE; a replica that has read every
observation, run out of attempts or underflowed is frozen (its attempts
run at dt = 0 and ``torch.where`` keeps its state), and the loop ends when
every replica is frozen. Each replica computes what its own ``solve``
computes (see ``solve_batched``).

The state is a tensor or a flat tuple of tensors (``tree_math``); the
controller takes one error ratio per leaf. Time (t0, t1, dt and the
controller's scalars) runs in the grid's dtype: float32, or float64 when the
caller asks for it, with the state's dtype unchanged.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch._higher_order_ops import while_loop

from ndcn_tpu_torch.ode import graph_gate
from ndcn_tpu_torch.ode import interp as interp_lib
from ndcn_tpu_torch.ode.grad_guard import all_finite, forced_reject
from ndcn_tpu_torch.ode.runge_kutta import (StageCoeffs, runge_kutta_step,
                                            stage_coeffs)
from ndcn_tpu_torch.ode.step_control import (Controller, accept_and_max_ratio,
                                             error_ratios, optimal_step_size,
                                             select_initial_step)
from ndcn_tpu_torch.ode.tableaux import (DOPRI5, TSIT5,
                                         TSIT5_REFERENCE_WEIGHTS, Tableau)
from ndcn_tpu_torch.ode.collectives import all_true
from ndcn_tpu_torch.ode.tree_math import bcast, leaves, state_group, tmap
from ndcn_tpu_torch.utils.timing import span

# The reference passes order 4 to the initial-step heuristic for its
# 5th-order methods; kept for identical first steps.
_INIT_STEP_ORDER = 4


@dataclasses.dataclass(frozen=True)
class AdaptiveMethod:
    name: str
    tableau: Tableau
    interp_init: Callable
    interp_make: Callable
    interp_eval: Callable
    interp_weights: Callable  # (x, dt) of shape (O,) -> C weights of (O,)


DOPRI5_METHOD = AdaptiveMethod(
    name="dopri5",
    tableau=DOPRI5,
    interp_init=interp_lib._interp_init,
    interp_make=interp_lib._interp_state,
    interp_eval=interp_lib._interp_eval,
    interp_weights=interp_lib.dopri5_interp_weights,
)

TSIT5_METHOD = AdaptiveMethod(
    name="tsit5",
    tableau=TSIT5,
    interp_init=interp_lib.tsit5_interp_init,
    interp_make=interp_lib.tsit5_interp_state,
    interp_eval=interp_lib.tsit5_interp_eval,
    interp_weights=interp_lib.tsit5_interp_weights,
)

# options={"reference_weights": True}: the same solver with the reference's
# (non-converging) tsit5 error weights, for bit-compatibility experiments
# (``tableaux.TSIT5_REFERENCE_WEIGHTS``)
TSIT5_REFERENCE_METHOD = dataclasses.replace(TSIT5_METHOD,
                                             tableau=TSIT5_REFERENCE_WEIGHTS)


class SolveStats(NamedTuple):
    nfe: int           # number of RHS evaluations
    n_accepted: int
    n_rejected: int
    success: bool      # all observation times reached within max_steps
    host_syncs: int    # device→host reads the loop made (one per attempt)


class RKState(NamedTuple):
    y: object          # state at t1 (a tensor or a tuple of them)
    f: object          # RHS at (t1, y)
    t0: torch.Tensor   # last accepted interval, 0-dim time-dtype tensors
    t1: torch.Tensor
    dt: torch.Tensor   # proposed next step
    interp: Optional[object] = None  # last accepted step's dense output


def _trial(func, rk: RKState, ctrl: Controller, coeffs: StageCoeffs,
           dt: torch.Tensor, veto: Optional[torch.Tensor] = None,
           groups=None):
    """The RK step of one attempt from ``rk`` at step size ``dt`` (rk.dt,
    or ``solve_scan``'s masked step) and its verdict: (y1, f1, k, accept,
    finite, dt_next). An attempt with any non-finite stage, trial state or
    error estimate, or one that ``veto`` (a 0-dim bool) marks, is rejected
    with rk.dt·dfactor (maximal shrink), whatever its error ratio says."""
    y1, f1, y1_error, k = runge_kutta_step(func, rk.y, rk.f, rk.t1, dt,
                                           coeffs)
    finite = all_finite(*leaves(y1), *leaves(y1_error), *leaves(k),
                        group=state_group(groups))
    ok = finite if veto is None else finite & ~veto
    ratios = error_ratios(y1_error, rk.y, y1, ctrl.rtol, ctrl.atol,
                          rk.t1.dtype, groups=groups)
    accept, max_ratio = accept_and_max_ratio(ratios)
    accept = accept & ok
    dt_next = torch.where(ok, optimal_step_size(rk.dt, max_ratio, ctrl),
                          rk.dt * ctrl.dfactor)
    return y1, f1, k, accept, finite, dt_next


def _attempt_step(method: AdaptiveMethod, func, rk: RKState, ctrl: Controller,
                  coeffs: StageCoeffs, groups=None):
    """One accept-or-reject step, branch-free; the state keeps the last
    ACCEPTED step's dense output. Returns (state, accept, finite).

    An attempt with any non-finite stage, trial state or error estimate is
    rejected with dt·dfactor (maximal shrink), whatever its error ratio says.
    ``groups``: the process group of each node-sharded leaf (``solve``).
    """
    y1, f1, k, accept, finite, dt_next = _trial(func, rk, ctrl, coeffs,
                                                rk.dt, groups=groups)
    new_interp = method.interp_make(rk.y, y1, k, rk.dt, coeffs)

    def pick(a, b):
        return torch.where(accept, a, b)

    state = RKState(y=tmap(pick, y1, rk.y),
                    f=tmap(pick, f1, rk.f),
                    t0=pick(rk.t1, rk.t0),
                    t1=pick(rk.t1 + rk.dt, rk.t1),
                    dt=dt_next,
                    interp=type(new_interp)(*(
                        tmap(pick, a, b)
                        for a, b in zip(new_interp, rk.interp))))
    return state, accept, finite


def _init_rk_state(method: AdaptiveMethod, func, y0: torch.Tensor,
                   t0: torch.Tensor, ctrl: Controller,
                   first_step: Optional[float], batched: bool = False,
                   groups=None):
    f0 = func(t0, y0)
    if first_step is None:
        dt0 = select_initial_step(func, t0, y0, _INIT_STEP_ORDER, ctrl.rtol,
                                  ctrl.atol, f0, batched, groups)
        nfe0 = 2
    else:
        dt0 = torch.full(t0.shape, first_step, dtype=t0.dtype,
                         device=t0.device)
        nfe0 = 1
    rk = RKState(y=y0, f=f0, t0=t0, t1=t0, dt=dt0,
                 interp=method.interp_init(y0))
    return rk, nfe0


def solve(method: AdaptiveMethod, func, y0, t: torch.Tensor,
          ctrl: Controller, max_steps: int, first_step: Optional[float] = None,
          emission_dtype: Optional[torch.dtype] = None,
          emission_readout: Optional[Callable] = None, groups=None):
    """Solve over the grid ``t``; returns (solution, SolveStats).

    ``t`` is a strictly increasing 1-D float32 (or float64) tensor ON THE
    CPU (the loop compares against it on the host); it is copied to y0's
    device once. solution: (len(t), *y0.shape) with solution[0] == y0 (leaf
    by leaf for a tuple state), or the readout's trajectory
    (len(t), *readout(y0).shape) with ``emission_readout``.
    Differentiable when autograd records it (see the module docstring).

    ``groups`` (``tree_math.leaf_groups``) names the process group of each
    node-sharded leaf of a state whose node rows split over ranks: its
    norms and means, and the attempt's finite flag, are then over every
    rank, so that every rank takes the same steps. None: no collective.

    Each accepted step that passes observations is read once, after the
    attempt's read gives the host its end: its dense-output sources are
    read out once and every observation it passes is evaluated in one
    block (``interp_eval`` over a vector of times); a step that passes
    none is not read.

    Spans (``utils.timing.span``): ``ode.solve`` around the solve, one
    ``ode.attempt`` an attempt, and in it ``ode.sync`` around the read;
    ``ode.observe`` around y0's readout and around each step's block of
    observations.
    """
    with span("ode.solve"):
        T = t.shape[0]
        t_host = t.tolist()          # python floats, exactly the grid's values
        lead = leaves(y0)[0]
        t_dev = t.to(lead.device)
        coeffs = stage_coeffs(method.tableau, lead.dtype, lead.device)
        n_evals = len(method.tableau.alpha)  # f0 from the last step (FSAL)
        rk, nfe = _init_rk_state(method, func, y0, t_dev[0], ctrl, first_step,
                                 groups=groups)

        def read_out(state):
            return (state if emission_readout is None
                    else emission_readout(state))

        def rows(state, m: int = 1):
            # a leading axis for the block's observations, a view: broadcast
            # in the sums, or with ``emission_dtype`` m rows, so that each
            # observation's sources, and its cotangent, are rounded on
            # their own, as a read of one observation rounds them
            n = m if emission_dtype is not None else 1
            return tmap(lambda leaf: leaf.unsqueeze(0).expand(
                n, *leaf.shape), state)

        def observe(rk: RKState, lo: int, hi: int):
            """Observations lo..hi-1, all inside the last accepted step:
            its sources read out once, the weights of the hi - lo times as
            vectors, one (hi - lo, ...) block a leaf."""
            src = type(rk.interp)(*(rows(read_out(c), hi - lo)
                                    for c in rk.interp))
            return method.interp_eval(src, rk.t0, rk.t1, t_dev[lo:hi],
                                      emission_dtype)

        with span("ode.observe"):
            blocks = [rows(read_out(y0))]
        n_obs, nacc, nrej, syncs, ok = 1, 0, 0, 0, True
        t1_host = t_host[0]
        while n_obs < T and nacc + nrej < max_steps and ok:
            ready = bisect.bisect_right(t_host, t1_host, n_obs)
            if ready > n_obs:
                # consume every observation the last accepted step passed
                with span("ode.observe"):
                    blocks.append(observe(rk, n_obs, ready))
                n_obs = ready
                continue
            with span("ode.attempt"):
                # dt-underflow guard (the reference asserts): flag and stop
                underflow = ~((rk.t1 + rk.dt) > rk.t1)
                new, accept, finite = _attempt_step(method, func, rk, ctrl,
                                                    coeffs, groups)
                nfe += n_evals
                with span("ode.sync"):
                    t1_host, acc, under, fin = torch.stack(
                        [new.t1, accept.to(new.t1.dtype),
                         underflow.to(new.t1.dtype),
                         finite.to(new.t1.dtype)]).tolist()
                syncs += 1
                rk = new if fin else forced_reject(rk, ctrl.dfactor)
            if acc:
                nacc += 1
            else:
                nrej += 1
            ok = not under

        stats = SolveStats(nfe=nfe, n_accepted=nacc, n_rejected=nrej,
                           success=ok and n_obs >= T, host_syncs=syncs)
        return cat_solution(blocks, T), stats


def _masked_attempt(method: AdaptiveMethod, func, ctrl: Controller,
                    coeffs: StageCoeffs, bare: bool, m: int, groups=None,
                    emission_dtype: Optional[torch.dtype] = None,
                    emission_readout: Optional[Callable] = None):
    """``solve_scan``'s attempt, ``attempt(veto, live, t1, dt, *carry)`` of a
    state of ``m`` leaves (a bare tensor when ``bare``), carried as (*y,
    *f): the carry, t1, dt, accept, finite and the emissions (one (C, ...)
    stack of the read-out dense-output sources a leaf, zero unless
    accepted). ``veto`` is the one-element list the guard writes after the
    forward (see ``solve_scan``)."""

    def tree(flat):
        return flat[0] if bare else tuple(flat)

    def read_out(state):
        return state if emission_readout is None else emission_readout(state)

    def emit(interp, accept):
        srcs = [leaves(read_out(c)) for c in interp]
        out = []
        for j in range(len(srcs[0])):
            stack = torch.stack([src[j] for src in srcs])
            if emission_dtype is not None:
                stack = stack.to(emission_dtype)
            out.append(torch.where(accept, stack, torch.zeros_like(stack)))
        return out

    def attempt(veto, live, t1, dt, *carry):
        rk = RKState(y=tree(carry[:m]), f=tree(carry[m:]), t0=t1, t1=t1,
                     dt=dt)
        vetoed = veto[0]
        dt_eff = torch.where(live & ~vetoed, dt, torch.zeros_like(dt))
        y1, f1, k, accept, finite, dt_next = _trial(func, rk, ctrl, coeffs,
                                                    dt_eff, vetoed, groups)
        accept = accept & live

        def pick(a, b):
            return torch.where(accept, a, b)

        interp = method.interp_make(rk.y, y1, k, dt_eff, coeffs)
        return (*leaves(tmap(pick, y1, rk.y)), *leaves(tmap(pick, f1, rk.f)),
                pick(t1 + dt, t1), torch.where(live, dt_next, dt),
                accept, finite, *emit(interp, accept))

    return attempt


def _frozen_attempt(read_y0, n_sources: int,
                    emission_dtype: Optional[torch.dtype] = None):
    """``frozen(t1, dt, carry)``: the outputs of a frozen attempt, made
    outside its gate: the carry, t1 and dt copied, accept False, finite
    True, and zero emissions shaped as ``n_sources`` of ``read_y0`` (the
    state read out) leaf by leaf."""
    like = [((n_sources, *x.shape), emission_dtype or x.dtype, x.device)
            for x in leaves(read_y0)]

    def frozen(t1, dt, carry):
        flag = dict(dtype=torch.bool, device=t1.device)
        return (*(c.clone() for c in carry), t1.clone(), dt.clone(),
                torch.zeros((), **flag), torch.ones((), **flag),
                *(torch.zeros(shape, dtype=dtype, device=device)
                  for shape, dtype, device in like))

    return frozen


def _attempt_gate(lead: torch.Tensor, groups):
    """The gate of ``solve_scan``'s attempts, chosen from what the solve
    observes: a conditional graph node (``graph_gate.if_node``) while the
    state's stream captures a CUDA graph and the state is not node-sharded;
    None otherwise (eager, the CPU, and ``groups``, whose attempts issue
    collectives, which no conditional body takes): every attempt runs,
    masked."""
    if (groups is None and lead.is_cuda
            and torch.cuda.is_current_stream_capturing()):
        return graph_gate.if_node
    return None


def _gated(gate, live: torch.Tensor, frozen: Callable, compute: Callable):
    """``compute()``'s tensors; with a gate, the buffers ``frozen()`` makes
    (a frozen attempt's result, made outside the gate), into which
    ``compute()``'s tensors are copied behind ``gate(live, ...)``."""
    if gate is None:
        return compute()
    out = frozen()

    def body():
        for buf, value in zip(out, compute()):
            buf.copy_(value)

    gate(live, body)
    return out


class _GatedAttempt(torch.autograd.Function):
    """One attempt of the differentiable bounded solve, recomputed in its
    backward as the non-reentrant checkpoint does, behind ``gate`` in both
    directions (``_gated``; None: no gate). ``apply(attempt, frozen, gate,
    veto, bound, live, t1, dt, *carry, *bound)``: ``attempt`` is
    ``solve_scan``'s masked attempt, ``frozen`` makes a frozen attempt's
    outputs, ``veto`` is the guard's cell and ``bound`` the list the RHS
    and the emission readout read their parameters from, whose gradients
    the backward returns (autograd accumulates them outside any gate). The
    recomputation reads fresh leaves from it (``graph_gate.fresh_leaves``).
    A frozen attempt's VJP is the cotangents of the carry, t1 and dt passed
    through and zeros for the parameters: what its masked backward gives,
    since ``torch.where`` passes them and every other term is an exact
    zero."""

    @staticmethod
    def forward(ctx, attempt, frozen, gate, veto, bound, live, t1, dt,
                *rest):
        carry = rest[:len(rest) - len(bound)]
        ctx.attempt, ctx.gate, ctx.veto, ctx.bound = (attempt, gate, veto,
                                                      bound)
        ctx.save_for_backward(live, t1, dt, *carry)
        out = _gated(gate, live, lambda: frozen(t1, dt, carry),
                     lambda: attempt(veto, live, t1, dt, *carry))
        n = len(carry)
        ctx.mark_non_differentiable(out[n + 2], out[n + 3])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        live, t1, dt, *carry = ctx.saved_tensors
        n = len(carry)
        cots = (*grads[:n + 2], *grads[n + 4:])   # accept, finite: none

        def frozen():
            return (grads[n].clone(), grads[n + 1].clone(),
                    *(g.clone() for g in grads[:n]),
                    *(torch.zeros_like(p) for p in ctx.bound))

        def compute():
            with torch.enable_grad(), graph_gate.fresh_leaves(
                    ctx.bound) as params:
                xs = [x.detach().requires_grad_() for x in (t1, dt, *carry)]
                out = ctx.attempt(ctx.veto, live, *xs)
                wrt = (*xs, *params)
                got = torch.autograd.grad((*out[:n + 2], *out[n + 4:]), wrt,
                                          cots, allow_unused=True)
            return tuple(torch.zeros_like(x) if g is None else g
                         for g, x in zip(got, wrt))

        return (None,) * 6 + tuple(_gated(ctx.gate, live, frozen, compute))


def solve_scan(method: AdaptiveMethod, func, y0, t: torch.Tensor,
               ctrl: Controller, max_steps: int,
               first_step: Optional[float] = None,
               emission_dtype: Optional[torch.dtype] = None,
               emission_readout: Optional[Callable] = None, groups=None,
               differentiable: bool = True, params=None):
    """The differentiable solve as a bounded program that never reads the
    device from the host: the port of the JAX package's ``solve_scan``.
    Returns (solution, SolveStats) with 0-dim device tensors for the counts
    and ``success``, and ``host_syncs`` 0.

    It runs exactly ``max_steps`` step attempts. An attempt is live until
    the carry reaches t[-1] or its dt underflows; a live attempt is
    ``solve``'s attempt, the same arithmetic, and one that is not (frozen)
    runs at dt = 0 and is masked out with ``torch.where``: it adds nothing
    to the carry, to NFE or the accept / reject counts, and a zero
    cotangent to the gradients. While a CUDA graph is being captured and
    the state is not node-sharded, each attempt also sits behind a
    conditional graph node on its live flag (``graph_gate``, the JAX
    package's ``lax.cond``), in the forward and in the backward: a replay
    launches no kernel of a frozen attempt, and its outputs (the carry, t1
    and dt unchanged, accept False, finite True, zero emissions) and its
    VJP (the cotangents passed through, zeros for ``params``) are written
    outside the node, as its masked run gives them, bit for bit. Eager
    solves, the CPU, a capture's warm-up steps and a node-sharded state
    (``groups``: its attempts issue collectives, which no conditional body
    takes) run every attempt, masked (``_attempt_gate``). Each attempt
    emits its dense-output sources, read out by ``emission_readout`` and
    rounded to ``emission_dtype`` where given, masked to zero unless
    accepted, with its interval's ends and accept flag. The observations
    are then read from the emissions as JAX reads them: a running max of
    the accepted ends, ``searchsorted`` of t[1:] on it, and one (O, S·C) ×
    (S·C, numel) matmul a leaf whose one-hot rows carry each observation's
    C interpolation weights (float32 sums, also for bf16 emissions). Its
    answers agree with ``solve``'s to float32 rounding (the matmul sums the
    same terms in another order) with equal NFE and counts.

    Each attempt is recomputed in the backward, the counterpart of JAX's
    per-iteration rematerialization: the tape keeps the carry between
    attempts and the emissions, and the backward runs every attempt again,
    the operator products included (the graph product's output is not
    kept, unlike JAX's ``ndcn_spmv`` policy: a kept product of an
    overflowed attempt would reach the guard below unmasked). With
    ``params``, the list that ``func`` and ``emission_readout`` read every
    tensor they use that requires grad from, at each call, an attempt is
    one ``_GatedAttempt``, which takes them as inputs and returns their
    gradients, so that a gate holds its whole backward (its recomputation
    reads fresh leaves from the list: ``graph_gate``); without it, a
    non-reentrant ``torch.utils.checkpoint``, which reaches whatever the
    attempt closes over, and no gate. The recomputation is the gradient
    guard (``grad_guard``): an attempt whose forward went non-finite is
    recomputed at dt = 0 and rejected, which is exactly ``forced_reject``'s
    primal, so its RHS parameters get zero and dt keeps its dfactor
    sensitivity, where the backward through the overflowed stages would
    give NaN. The flag that selects this is set after the attempt's
    forward, from its own finite flag, and read only by the recomputation:
    the forward never waits for it.

    ``differentiable=False`` runs the attempts as they are, with no
    recomputation and no guard (behind the gate while a graph is being
    captured, then under ``torch.no_grad()``): the bounded inference solve,
    which the continuous adjoint runs under ``torch.no_grad()`` for its
    forward and each interval of its backward (``ode.adjoint``). Each
    observation is then evaluated as the host loop evaluates it, from the
    sources of the accepted attempt that covers it (gathered, not summed by
    the matmul): with the same budget it gives the host loop's attempts and
    answers bit for bit, as the JAX package's ``solve_while`` gives its
    own, so the adjoint's backward starts every interval from the host
    loop's state.

    ``groups`` (``tree_math.leaf_groups``): the process group of each
    node-sharded leaf, as in ``solve``. The norms and the finite flag are
    over every rank, so the live mask is too: every rank runs the same
    attempts, frozen ones included, and issues the same collectives in the
    same order, also in the recomputation.

    ``t`` is the grid in the time dtype, on any device (it is moved to the
    state's); a blown budget gives ``success`` False and finite values
    where the observations were not reached (the callers turn them to NaN
    with ``torch.where``).

    Spans: ``ode.solve`` and one ``ode.attempt`` an attempt, as ``solve``'s
    (no ``ode.sync``: nothing is read); a graph capture runs them once, and
    a replay runs no Python."""
    from torch.utils.checkpoint import checkpoint

    T = t.shape[0]
    lead = leaves(y0)[0]
    device = lead.device
    t = t.to(device)
    t_final = t[-1]
    coeffs = stage_coeffs(method.tableau, lead.dtype, device)
    n_evals = len(method.tableau.alpha)  # f0 comes from the last step (FSAL)
    bare = isinstance(y0, torch.Tensor)
    m = len(leaves(y0))
    if params is not None and not isinstance(params, list):
        raise TypeError(f"params must be the list func reads its parameters "
                        f"from; got {type(params).__name__}")
    gate = _attempt_gate(lead, groups)
    if differentiable and params is None:
        gate = None

    attempt = _masked_attempt(method, func, ctrl, coeffs, bare, m, groups,
                              emission_dtype, emission_readout)

    def tree(flat):
        return flat[0] if bare else tuple(flat)

    def read_out(state):
        return state if emission_readout is None else emission_readout(state)

    def count(v):
        return torch.full((), v, dtype=torch.int64, device=device)

    with span("ode.solve"):
        rk0, nfe0 = _init_rk_state(method, func, y0, t[0], ctrl, first_step,
                                   groups=groups)
        frozen = None
        if gate is not None:
            with torch.no_grad():
                frozen = _frozen_attempt(read_out(y0), len(rk0.interp),
                                         emission_dtype)
        carry = (*leaves(rk0.y), *leaves(rk0.f))
        t1, dt = rk0.t1, rk0.dt
        nfe, nacc, nrej = count(nfe0), count(0), count(0)
        ok = torch.ones((), dtype=torch.bool, device=device)
        accepts, ends0, ends1, emitted = [], [], [], []
        for _ in range(max_steps):
            with span("ode.attempt"):
                live = (t1 < t_final) & ok
                # dt-underflow guard (the reference asserts): flag and freeze
                underflow = ~((t1 + dt) > t1)
                veto = [torch.zeros((), dtype=torch.bool, device=device)]
                if not differentiable:
                    # a gated attempt records no tape
                    with torch.set_grad_enabled(torch.is_grad_enabled()
                                                and gate is None):
                        out = _gated(
                            gate, live, lambda: frozen(t1, dt, carry),
                            lambda: attempt(veto, live, t1, dt, *carry))
                elif params is None:
                    out = checkpoint(attempt, veto, live, t1, dt, *carry,
                                     use_reentrant=False,
                                     preserve_rng_state=False)
                else:
                    out = _GatedAttempt.apply(attempt, frozen, gate, veto,
                                              params, live, t1, dt, *carry,
                                              *params)
                accept, finite = out[2 * m + 2], out[2 * m + 3]
                veto[0] = ~finite
                accepts.append(accept)
                ends0.append(t1)
                ends1.append(torch.where(live, t1 + dt, t1))
                emitted.append(out[2 * m + 4:])
                carry, t1, dt = out[:2 * m], out[2 * m], out[2 * m + 1]
                nfe = nfe + live.long() * n_evals
                nacc = nacc + accept.long()
                nrej = nrej + (live & ~accept).long()
                ok = ok & ~(live & underflow)

        # the dense output of every observation after t[0], from the
        # accepted attempt whose interval covers it: rejected and frozen
        # slots hold the running max of the accepted ends, so searchsorted
        # lands on the first (accepting) slot of each value
        acc = torch.stack(accepts)
        t0s, t1s = torch.stack(ends0), torch.stack(ends1)
        t1_acc = torch.cummax(torch.where(acc, t1s.detach(), torch.full_like(
            t1s.detach(), float("-inf"))), dim=0).values
        t_obs = t[1:].contiguous()
        idx = torch.searchsorted(t1_acc, t_obs, side="left").clamp(
            0, max_steps - 1)
        t0g = t0s[idx]
        if not differentiable:
            # each observation from its step's gathered sources by the host
            # loop's own evaluation: the answers are the host loop's, bit
            # for bit (the inference solve takes no emission lever)
            srcs = [torch.stack([e[j] for e in emitted])[idx]
                    for j in range(m)]
            interp = type(rk0.interp)(*(
                tree([src[:, c] for src in srcs])
                for c in range(len(rk0.interp))))
            obs = method.interp_eval(interp, t0g, t1s[idx], t_obs)
            sol = tmap(lambda y, o: torch.cat([y.unsqueeze(0), o]), y0, obs)
            stats = SolveStats(nfe=nfe, n_accepted=nacc, n_rejected=nrej,
                               success=ok & (t1 >= t_final), host_syncs=0)
            return sol, stats
        dtg = t1s[idx] - t0g
        x = (t_obs - t0g) / torch.where(dtg == 0, torch.ones_like(dtg), dtg)
        w = torch.stack(method.interp_weights(x, dtg), dim=1)      # (O, C)
        sel = idx[:, None] == torch.arange(max_steps, device=device)[None, :]
        w_full = (sel.to(w.dtype)[:, :, None] * w[:, None, :]).reshape(
            T - 1, -1)                                              # (O, S·C)

        def eval_leaf(j: int, y: torch.Tensor) -> torch.Tensor:
            buf = torch.stack([e[j] for e in emitted])         # (S, C, ...)
            flat = buf.reshape(buf.shape[0] * buf.shape[1], -1)
            if emission_dtype is None:
                out = w_full.to(flat.dtype) @ flat
            else:
                # the weights ride in the emission dtype, the sums in
                # float32
                out = w_full.to(emission_dtype).float() @ flat.float()
            return torch.cat([y.unsqueeze(0), out.reshape(
                (T - 1, *y.shape)).to(y.dtype)])

        y0_out = read_out(y0)
        sol = (eval_leaf(0, y0_out) if isinstance(y0_out, torch.Tensor)
               else tuple(eval_leaf(j, y) for j, y in enumerate(y0_out)))
        stats = SolveStats(nfe=nfe, n_accepted=nacc, n_rejected=nrej,
                           success=ok & (t1 >= t_final), host_syncs=0)
        return sol, stats


class _Carry(NamedTuple):
    """How ``solve_while`` lays its loop state out as one flat tuple of
    tensors (``while_loop`` and ``torch.cond`` carry tensors only): the RK
    state, then the solution buffers, then (obs_i, nfe, nacc, nrej, ok).
    The state has ``n_leaves`` leaves (a bare tensor when ``bare``); the
    dense output's fields are of ``interp_type``."""
    bare: bool
    n_leaves: int
    interp_type: type

    @property
    def rk_size(self) -> int:
        """Entries of the RK state: y, f, t0, t1, dt and the dense output."""
        return (2 + len(self.interp_type._fields)) * self.n_leaves + 3

    def tree(self, flat):
        return flat[0] if self.bare else tuple(flat)

    def pack(self, rk: RKState, sol, counts) -> tuple:
        return (*leaves(rk.y), *leaves(rk.f), rk.t0, rk.t1, rk.dt,
                *(leaf for c in rk.interp for leaf in leaves(c)),
                *leaves(sol), *counts)

    def unpack(self, flat):
        """(RKState, the solution buffers, (obs_i, nfe, nacc, nrej, ok))."""
        m = self.n_leaves

        def tree_at(i):
            return self.tree(flat[i:i + m])

        fields = len(self.interp_type._fields)
        rk = RKState(y=tree_at(0), f=tree_at(m), t0=flat[2 * m],
                     t1=flat[2 * m + 1], dt=flat[2 * m + 2],
                     interp=self.interp_type(*(
                         tree_at(2 * m + 3 + j * m) for j in range(fields))))
        return rk, tree_at(self.rk_size), tuple(flat[self.rk_size + m:])


def _clone(flat) -> tuple:
    return tuple(c.clone() for c in flat)


def solve_while(method: AdaptiveMethod, func, y0, t: torch.Tensor,
                ctrl: Controller, max_steps: int,
                first_step: Optional[float] = None):
    """The inference solve as one device-resident program, the counterpart
    of the JAX package's ``solve_while``: a ``while_loop`` whose body is
    ``torch.cond(ready, consume_obs, take_step)``. It is what
    ``torch.export`` traces (``serve.export_ndcn``); run eagerly it gives
    what ``solve`` gives.

    ``t`` is the grid as a tensor of the time dtype, on any device (it is
    moved to the state's); the loop never reads the device from the host:
    every decision is a tensor (observations are picked with
    ``index_select``), and ``while_loop`` and ``torch.cond`` read their
    predicates themselves. The carry is flat tensors: the RK state with its
    dense output, one solution buffer (len(t), *leaf.shape) a leaf, and
    obs_i, nfe, nacc, nrej and ok.

    The arithmetic is ``solve``'s: ``take_step`` is ``_attempt_step`` as it
    stands, and on a non-finite attempt the state it returns IS
    ``forced_reject``'s (accept is false there, so every field is the old
    one, and dt is dt·dfactor), which ``solve`` picks with ``if fin``. The
    dt-underflow flag and the ``max_steps`` budget end the loop as there,
    and the rows not reached stay NaN. Returns (solution, SolveStats) with
    0-dim tensors for the counts and ``success``, and ``host_syncs`` None:
    the reads are the loop's own, not counted here.

    A branch of ``torch.cond`` may not return one of its inputs, so each
    branch clones what it passes through: ``take_step`` the solution
    buffers, ``consume_obs`` the RK state (one copy a leaf an iteration)."""
    T = t.shape[0]
    lead = leaves(y0)[0]
    device = lead.device
    t = t.to(device)
    coeffs = stage_coeffs(method.tableau, lead.dtype, device)
    n_evals = len(method.tableau.alpha)  # f0 comes from the last step (FSAL)
    rk0, nfe0 = _init_rk_state(method, func, y0, t[0], ctrl, first_step)
    layout = _Carry(isinstance(y0, torch.Tensor), len(leaves(y0)),
                    type(rk0.interp))

    def count(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    sol0 = tmap(lambda y: torch.cat([y.unsqueeze(0), torch.full(
        (T - 1, *y.shape), float("nan"), dtype=y.dtype, device=device)]), y0)
    counts0 = (count(1), count(nfe0), count(0), count(0),
               torch.tensor(True, device=device))
    # the carries may not alias one another (t0 is t1, y0 is in interp)
    carry0 = _clone(layout.pack(rk0, sol0, counts0))

    def cond_fn(*c):
        _, _, (obs_i, _, nacc, nrej, ok) = layout.unpack(c)
        return (obs_i < T) & (nacc + nrej < max_steps) & ok

    def t_obs(obs_i):
        return t.index_select(0, obs_i.reshape(1)).reshape(())

    def consume_obs(*c):
        rk, sol, (obs_i, nfe, nacc, nrej, ok) = layout.unpack(c)
        # the dense output of the last accepted step
        y_obs = method.interp_eval(rk.interp, rk.t0, rk.t1, t_obs(obs_i))
        sol = tmap(lambda buf, v: buf.index_copy(0, obs_i.reshape(1),
                                                 v.unsqueeze(0)), sol, y_obs)
        rk_flat = layout.pack(rk, (), ())           # the RK state alone
        return (_clone(rk_flat) + tuple(leaves(sol))
                + (obs_i + 1, *_clone((nfe, nacc, nrej, ok))))

    def take_step(*c):
        rk, sol, (obs_i, nfe, nacc, nrej, ok) = layout.unpack(c)
        # dt-underflow guard (the reference asserts): flag and stop
        underflow = ~((rk.t1 + rk.dt) > rk.t1)
        new, accept, _ = _attempt_step(method, func, rk, ctrl, coeffs)
        return layout.pack(new, tmap(torch.clone, sol), (
            obs_i.clone(), nfe + n_evals, nacc + accept.long(),
            nrej + (~accept).long(), ok & ~underflow))

    def body(*c):
        rk, _, (obs_i, *_) = layout.unpack(c)
        return tuple(torch.cond(t_obs(obs_i) <= rk.t1, consume_obs,
                                take_step, c))

    final = while_loop(cond_fn, body, carry0)
    _, sol, (obs_i, nfe, nacc, nrej, ok) = layout.unpack(final)
    stats = SolveStats(nfe=nfe, n_accepted=nacc, n_rejected=nrej,
                       success=ok & (obs_i >= T), host_syncs=None)
    return sol, stats


def stack_solution(sol: list, T: int):
    """The observations stacked along a new leading time axis, leaf by
    leaf; the ones not reached (a blown budget) are NaN."""
    return cat_solution([tmap(lambda leaf: leaf.unsqueeze(0), y)
                         for y in sol], T)


def cat_solution(blocks: list, T: int):
    """Blocks of observations, each (m, ...) a leaf, joined in order along
    the leading time axis, leaf by leaf; the rows not reached (a blown
    budget) are NaN."""
    got = sum(leaves(b)[0].shape[0] for b in blocks)
    if got < T:
        blocks = blocks + [tmap(lambda leaf: torch.full(
            (T - got, *leaf.shape[1:]), float("nan"), dtype=leaf.dtype,
            device=leaf.device), blocks[0])]
    return tmap(lambda *ls: torch.cat(ls), *blocks)


# ------------------------------------------------------------ replicas


class BatchedSolveStats(NamedTuple):
    """The stats of ``solve_batched``: a tuple of one value per replica for
    each of ``SolveStats``' fields, and the host reads of the one loop."""
    nfe: tuple
    n_accepted: tuple
    n_rejected: tuple
    success: tuple
    host_syncs: int

    def replica(self, i: int) -> SolveStats:
        """Replica ``i``'s stats, in the form its own solve returns."""
        return SolveStats(nfe=self.nfe[i], n_accepted=self.n_accepted[i],
                          n_rejected=self.n_rejected[i],
                          success=self.success[i], host_syncs=self.host_syncs)

    @classmethod
    def shared(cls, stats: SolveStats, replicas: int) -> "BatchedSolveStats":
        """Every replica with the same stats (the fixed-grid methods)."""
        return cls(*((v,) * replicas for v in stats[:4]),
                   host_syncs=stats.host_syncs)


def _replica_finite(*tensors: torch.Tensor, stage_axis: bool = False):
    """(R,) bool: every element of replica r of every tensor is finite; the
    replica axis leads, or follows a leading stage axis."""
    ok = None
    for t in tensors:
        f = torch.isfinite(t)
        if stage_axis:
            f = f.all(dim=0)
        f = f.reshape(f.shape[0], -1).all(dim=1)
        ok = f if ok is None else ok & f
    return ok


def _attempt_batched(method: AdaptiveMethod, func, rk: RKState,
                     ctrl: Controller, coeffs: StageCoeffs,
                     live: torch.Tensor, bad: Optional[torch.Tensor] = None,
                     groups=None):
    """One branch-free attempt of every replica; ``live`` (R,) marks the
    replicas still solving, the others keep their state. Returns (state,
    accept, ok), accept and ok (R,) bool; ok is the attempt's finite flag.

    The attempt of a replica that is not live, or is marked ``bad``, runs
    at dt = 0: its stages are the RHS at its own state, finite, so that
    nothing non-finite enters the tape where ``torch.where`` drops it (a
    zero cotangent times an overflowed stage would be NaN). A bad replica
    is rejected with dt·dfactor, what its non-finite attempt gives, and is
    ``forced_reject``'s counterpart for one replica."""
    go = live if bad is None else live & ~bad
    dt = torch.where(go, rk.dt, torch.zeros_like(rk.dt))
    y1, f1, y1_error, k = runge_kutta_step(func, rk.y, rk.f, rk.t1, dt,
                                           coeffs)
    finite = all_true(_replica_finite(*leaves(y1), *leaves(y1_error))
                      & _replica_finite(*leaves(k), stage_axis=True),
                      state_group(groups))
    ratios = error_ratios(y1_error, rk.y, y1, ctrl.rtol, ctrl.atol,
                          rk.t1.dtype, batched=True, groups=groups)
    accept, max_ratio = accept_and_max_ratio(ratios)
    ok = finite if bad is None else finite & ~bad
    accept = accept & ok & live
    dt_next = torch.where(ok, optimal_step_size(rk.dt, max_ratio, ctrl),
                          rk.dt * ctrl.dfactor)
    dt_next = torch.where(live, dt_next, rk.dt)
    new_interp = method.interp_make(rk.y, y1, k, dt, coeffs)

    def pick(a, b):
        return torch.where(bcast(accept, a), a, b)

    state = RKState(y=tmap(pick, y1, rk.y),
                    f=tmap(pick, f1, rk.f),
                    t0=pick(rk.t1, rk.t0),
                    t1=pick(rk.t1 + rk.dt, rk.t1),
                    dt=dt_next,
                    interp=type(new_interp)(*(
                        tmap(pick, a, b)
                        for a, b in zip(new_interp, rk.interp))))
    return state, accept, ok


def solve_batched(method: AdaptiveMethod, func, y0, t: torch.Tensor,
                  ctrl: Controller, max_steps: int,
                  first_step: Optional[float] = None,
                  emission_dtype: Optional[torch.dtype] = None,
                  emission_readout: Optional[Callable] = None, groups=None):
    """``solve`` for R replicas at once: every leaf of ``y0`` is (R, ...),
    ``func(t, y)`` takes t of shape (R,) and the batched state, and the grid
    ``t`` is shared. Returns (solution (len(t), R, ...), BatchedSolveStats).

    Replica r takes the steps its own ``solve`` takes: its error ratios,
    initial step and controller read only its own elements, it consumes its
    observations when its own accepted interval passes them (a consumption
    round evaluates the ready observations of every replica at once), and
    it is frozen when it has read every observation, spent ``max_steps``
    attempts or underflowed, as its own loop would stop there. Its
    observations come from the same arithmetic as its own solve's; the
    batched products and reductions may round differently in the last bit.

    An observation a replica did not reach (its budget ran out) holds its
    y0 (read out), a finite placeholder, and ``stats.success[r]`` is False:
    the JAX package's batched scan also leaves finite values there and
    flags the replica, and the caller turns them to NaN (``odeint``, the
    drivers' losses) with ``torch.where``, which keeps a zero cotangent
    there and no 0·NaN on the tape.

    Under autograd an attempt whose internals are non-finite for some live
    replica is recorded again with that replica at dt = 0 and rejected
    (``_attempt_batched``), so that its gradient is exactly zero, as
    ``forced_reject`` makes it for one solve."""
    T = t.shape[0]
    t_host = t.tolist()
    lead = leaves(y0)[0]
    R, device = lead.shape[0], lead.device
    t_dev = t.to(device)
    coeffs = stage_coeffs(method.tableau, lead.dtype, device)
    n_evals = len(method.tableau.alpha)
    rk, nfe0 = _init_rk_state(method, func, y0, t_dev[0].expand(R).clone(),
                              ctrl, first_step, batched=True, groups=groups)

    def read_out(state):
        return state if emission_readout is None else emission_readout(state)

    def observe(rk: RKState, times) -> object:
        """Each replica's dense output at its own row of ``times`` (R, m):
        leaves (R, m, ...); the (R, m) weights are laid over each leaf,
        whatever its rank (the adjoint's adj_t is (R,))."""
        interp = type(rk.interp)(*(read_out(c) for c in rk.interp))
        src = type(interp)(*(tmap(lambda leaf: leaf.unsqueeze(1), c)
                             for c in interp))
        t_obs = torch.tensor(times, dtype=t.dtype).to(device)
        return method.interp_eval(src, rk.t0.view(R, 1), rk.t1.view(R, 1),
                                  t_obs, emission_dtype)

    # slot 0 of every replica is y0 (read out); each consumption round adds
    # m slots, and slot_of[r][i] is where replica r's observation i went
    rounds = [tmap(lambda leaf: leaf.unsqueeze(1), read_out(y0))]
    n_slots = 1
    slot_of = [[0] * T for _ in range(R)]
    ptr = [1] * R
    nfe = [nfe0] * R
    nacc, nrej, ok, t1_host = [0] * R, [0] * R, [True] * R, [t_host[0]] * R
    syncs = 0

    def live_now():
        return [ptr[r] < T and nacc[r] + nrej[r] < max_steps and ok[r]
                for r in range(R)]

    while True:
        live = live_now()
        ready = []
        for r in range(R):
            i, got = ptr[r], []
            while live[r] and i < T and t_host[i] <= t1_host[r]:
                got.append(i)
                i += 1
            ready.append(got)
        m = max(len(got) for got in ready)
        if m:
            # consume: the dense output of each replica's last accepted
            # step at its ready observations (padded with its t1)
            rounds.append(observe(rk, [
                [t_host[i] for i in got] + [t1_host[r]] * (m - len(got))
                for r, got in enumerate(ready)]))
            for r, got in enumerate(ready):
                for j, i in enumerate(got):
                    slot_of[r][i] = n_slots + j
                ptr[r] += len(got)
            n_slots += m
            live = live_now()
        if not any(live):
            break
        live_t = torch.tensor(live, device=device)
        # dt-underflow guard (the reference asserts): flag and freeze
        underflow = ~((rk.t1 + rk.dt) > rk.t1)
        new, accept, fin = _attempt_batched(method, func, rk, ctrl, coeffs,
                                            live_t, groups=groups)
        t1_new, acc, under, fin = torch.stack(
            [new.t1, accept.to(new.t1.dtype), underflow.to(new.t1.dtype),
             fin.to(new.t1.dtype)]).tolist()
        syncs += 1
        bad = [lv and not f for lv, f in zip(live, fin)]
        if any(bad) and torch.is_grad_enabled():
            new, _, _ = _attempt_batched(method, func, rk, ctrl, coeffs,
                                         live_t,
                                         torch.tensor(bad, device=device),
                                         groups)
        rk = new
        for r in range(R):
            if not live[r]:
                continue
            nfe[r] += n_evals
            if acc[r]:
                nacc[r] += 1
            else:
                nrej[r] += 1
            ok[r] = not under[r]
            t1_host[r] = t1_new[r]

    stats = BatchedSolveStats(
        nfe=tuple(nfe), n_accepted=tuple(nacc), n_rejected=tuple(nrej),
        success=tuple(ok[r] and ptr[r] >= T for r in range(R)),
        host_syncs=syncs)
    # one gather for all replicas: observation i of replica r is slot
    # slot_of[r][i] of its row of the concatenated rounds
    slots = tmap(lambda *ls: torch.cat(ls, dim=1), *rounds)
    idx = torch.tensor(slot_of, device=device).t()             # (T, R)
    reps = torch.arange(R, device=device).expand(T, R)
    # row-major, as every solve returns it (the kernels take no other)
    return tmap(lambda leaf: leaf[reps, idx].contiguous(), slots), stats
