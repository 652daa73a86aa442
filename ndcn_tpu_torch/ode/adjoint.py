"""Continuous-adjoint gradients (memory that does not grow with the
trajectory), as ``ndcn_tpu/ode/adjoint.py``.

    sol = odeint_adjoint(func, y0, t, params, rtol, atol, method, options)

``func(t, y)`` closes over ``params``, a tuple of tensors (e.g. the model's
ODE-function parameters), or reads them at each call from ``params``, a
list; the gradients reach y0 and ``params``.

- Forward: the non-differentiable solve (``differentiable=False``), NaN when
  the step budget runs out. Nothing of it is kept but the observations.
- Backward: the observation intervals in reverse. For each interval the
  augmented system (y, adj_y, adj_t, *adj_params) is integrated at s = -t
  with the same method, tolerances and budget, and each observation's
  cotangent is added at its time. Each interval's solve is an inference
  solve: no tape outlives one evaluation of the augmented RHS.

The augmented RHS takes the VJP of ``func`` with ``torch.autograd.grad``
under ``torch.enable_grad()``, with a fresh leaf for y and ``params`` as the
inputs (``allow_unused=True``: a parameter the RHS does not touch gets
zeros); a list ``params`` gives fresh leaves too, swapped in for the
evaluation (``graph_gate.fresh_leaves``), which an interval solve whose
attempts a captured graph gates needs: no gradient may leave the gate's
body (``ode.graph_gate``). Its time derivative is taken as zero, since
NDCN's RHS is autonomous; adj_t still rides in the state, as in the JAX
package, and enters the step control only through the initial-step norms.
The kernels' ``autograd.Function`` backwards run inside that VJP (K1 over
the transpose CSR, K2's backward products, K3 over Aᵀ): the operator's
values are no input, so the NaN they give an operator cotangent is never
computed.

The cotangent -adj_y of the JAX package is passed as adj_y and the VJPs'
sign folded in: negation is exact and the VJP is linear, so the values are
the same and two negations a step are saved.

With ``options={"batched": True}`` R replicas run at once, ``jax.vmap`` of
the JAX adjoint: y0 and every leaf of the state are (R, ...), ``params``
are stacked (R, ...) (``parallel.sweep.stack_models``), and the forward is
the batched inference solve (``adaptive.solve_batched``, or
``vcabm.solve_vcabm_batched`` for adams), NaN for a replica whose budget
ran out. The backward's augmented state is batched too: y and adj_y (R, n,
d), adj_t (R,), each parameter cotangent (R, ...). The batched solve takes
its norms per replica over that replica's leaves, every reduction here is
per replica (``tree_dot_rows``), a replica that runs out of budget on an
interval reads NaN alone, and replica r's parameter cotangent is its own,
since replica r of the stacked RHS reads only its own slice of the
parameters. The kernels' batched forms run inside the VJP.

With ``options={"scan": True}`` (a train step that a CUDA graph records,
``train.chunk``) nothing reads the device from the host: the forward and
every interval solve of the backward are the bounded inference solve
(``adaptive.solve_scan`` or ``vcabm.solve_vcabm_scan`` with
``differentiable=False``), exactly ``max_steps`` attempts each, with no
checkpoint; the grid stays a tensor on its device, the stats are device
tensors and a failed solve reads NaN through ``torch.where``. Each
interval keeps its own initial step and its own budget, as the JAX
package's ``lax.while_loop`` per interval does, so NFE, success and the
NaN of a starved interval are the host loop's.

With ``options={"node_group": group}`` the state's node rows split over
the ranks of ``group`` (``parallel.coo_shard``; the JAX adjoint under
GSPMD): y0, the trajectory, y and adj_y are this rank's rows. The
forward and every interval solve take their norms over the group
(``ode.api``): y and adj_y are node-sharded leaves of the augmented state,
adj_t and the parameter cotangents replicated ones, whose norms stay
local. Each augmented evaluation's parameter VJPs are this rank's share
and are summed over the group in one flat all-reduce, so that adj_p is
whole and equal on every rank; adj_t's dot is summed likewise. The y-VJP
needs no collective of its own: the row-block product's backward gathers
the cotangent. The parameters' gradients come back whole on the group's
first rank and zero on the others (x + 0 is exact): the replicated
parameters' gradients are the ranks' shares, which the caller sums over
the group (``train.optim.make_sgd_step(group=)``), and that sum counts
them once.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ndcn_tpu_torch.ode import graph_gate
from ndcn_tpu_torch.ode.adaptive import BatchedSolveStats, SolveStats
from ndcn_tpu_torch.ode.api import (_canonical_time, _time_dtype,
                                    nan_on_failure, odeint_with_stats)
from ndcn_tpu_torch.ode.collectives import sum_flat
from ndcn_tpu_torch.ode.tree_math import tmap, tree_dot, tree_dot_rows


class AdjointStats(NamedTuple):
    """The forward solve's SolveStats fields, and ``backward``: the
    SolveStats of each interval solve of the backward pass, last interval
    first, filled when the backward runs (empty before). Batched: the
    fields are BatchedSolveStats' (a tuple a replica), ``backward`` holds
    BatchedSolveStats, and ``replica(i)`` is replica i's."""
    nfe: int
    n_accepted: int
    n_rejected: int
    success: bool
    host_syncs: int
    backward: List[SolveStats]

    def replica(self, i: int) -> "AdjointStats":
        """Replica i's stats of a batched adjoint, as its own adjoint
        returns them."""
        return AdjointStats(*BatchedSolveStats(*self[:5]).replica(i),
                            backward=[b.replica(i) for b in self.backward])


def _nondiff(options: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    return dict(options or {}, differentiable=False)


class _OdeintAdjoint(torch.autograd.Function):

    @staticmethod
    def forward(ctx, func, t, rtol, atol, method, options, record, bound,
                y0, *params):
        sol, stats = odeint_with_stats(func, y0, t, rtol=rtol, atol=atol,
                                       method=method,
                                       options=_nondiff(options))
        record.append(stats)
        sol = nan_on_failure(sol, stats, axis=1)
        ctx.func, ctx.t, ctx.solve = func, t, (rtol, atol, method, options)
        ctx.backward = []
        record.append(ctx.backward)
        ctx.params = params   # inputs: the VJPs are taken with respect to them
        ctx.bound = bound     # where func reads them, when a list
        ctx.save_for_backward(sol)
        return sol

    @staticmethod
    def backward(ctx, grad_sol):
        sol, = ctx.saved_tensors
        func, t, params = ctx.func, ctx.t, ctx.params
        rtol, atol, method, options = ctx.solve
        n_p = len(params)
        batched = bool((options or {}).get("batched", False))
        group = (options or {}).get("node_group")
        # time for the RHS: one per replica in a batched solve
        lead = () if not batched else (sol.shape[1],)
        aug_options = _nondiff(options)
        if group is not None:
            # y and adj_y are node-sharded; adj_t and adj_p replicated
            aug_options["node_sharded"] = (True, True) + (False,) * (1 + n_p)

        def leaves():
            if isinstance(ctx.bound, list):
                return graph_gate.fresh_leaves(ctx.bound)
            if graph_gate.in_body():
                raise TypeError("an adjoint whose interval solves a CUDA "
                                "graph gates takes params as the list func "
                                "reads them from")
            return contextlib.nullcontext(params)

        def augmented(s, aug):
            y, adj_y = aug[0], aug[1]
            with torch.enable_grad(), leaves() as ps:
                y_ = y.detach().requires_grad_()
                f = func(-s, y_)
                vjps = torch.autograd.grad(f, (y_, *ps), adj_y,
                                           allow_unused=True)
            vjps = [torch.zeros_like(x) if v is None else v
                    for v, x in zip(vjps, (y_, *params))]
            # this rank's share of the parameter VJPs: the group's sum
            vjp_p = sum_flat(vjps[1:], group)
            # reverse time: d/ds = -d/dt
            return (-f.detach(), vjps[0], torch.zeros_like(aug[2]),
                    *vjp_p)

        ctx.backward.clear()
        T = t.shape[0]
        t_dev = t.to(sol.device)
        adj_y = grad_sol[-1]
        adj_t = torch.zeros(lead, dtype=t.dtype, device=sol.device)
        adj_p = tuple(torch.zeros_like(p) for p in params)
        dot = tree_dot_rows if batched else tree_dot
        for i in range(T - 1, 0, -1):
            f_i = func(t_dev[i].expand(lead), sol[i])
            dot_i, = sum_flat([dot(f_i, grad_sol[i])], group)
            adj_t = adj_t - dot_i.to(adj_t.dtype)
            aug0 = (sol[i], adj_y, adj_t, *adj_p)
            aug_sol, stats = odeint_with_stats(
                augmented, aug0, torch.stack([-t[i], -t[i - 1]]), rtol=rtol,
                atol=atol, method=method, options=aug_options)
            ctx.backward.append(stats)
            aug_sol = nan_on_failure(tmap(lambda a: a[1], aug_sol), stats)
            adj_y = aug_sol[1] + grad_sol[i - 1]
            adj_t = aug_sol[2]
            adj_p = tuple(aug_sol[3:3 + n_p])
        if group is not None and dist.get_rank(group) != 0:
            # whole on the group's first rank: the caller's sum over the
            # group counts it once
            adj_p = tuple(torch.zeros_like(a) for a in adj_p)
        return (None,) * 8 + (adj_y, *adj_p)


def odeint_adjoint_with_stats(func: Callable, y0: torch.Tensor, t,
                              params: Sequence[torch.Tensor],
                              rtol: float = 1e-6, atol: float = 1e-12,
                              method: Optional[str] = None,
                              options: Optional[Dict[str, Any]] = None):
    """``odeint_adjoint`` and its AdjointStats."""
    time_dtype = (options or {}).get("time_dtype")
    if (options or {}).get("scan") and isinstance(t, torch.Tensor):
        # the bounded solves read the grid where it is: a CUDA graph may
        # copy nothing to the host
        t = t.detach().to(_time_dtype(time_dtype))
    else:
        t = _canonical_time(t, time_dtype)
    record: List[Any] = []
    sol = _OdeintAdjoint.apply(func, t, rtol, atol, method, options, record,
                               params, y0, *params)
    forward, backward = record
    return sol, AdjointStats(*forward, backward=backward)


def odeint_adjoint(func: Callable, y0: torch.Tensor, t,
                   params: Sequence[torch.Tensor], rtol: float = 1e-6,
                   atol: float = 1e-12, method: Optional[str] = None,
                   options: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Solve dy/dt = func(t, y) with continuous-adjoint gradients for y0 and
    ``params``; the trajectory is NaN if the step budget ran out."""
    return odeint_adjoint_with_stats(func, y0, t, params, rtol, atol, method,
                                     options)[0]
