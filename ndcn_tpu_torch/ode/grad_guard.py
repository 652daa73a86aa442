"""Gradient guard for step attempts whose internals overflowed (the
counterpart of ``ndcn_tpu/ode/grad_guard.py``).

Reverse mode cannot cross an attempt whose stages hold inf or NaN: each op's
backward multiplies its cotangent by primal values, so even a zero cotangent
into a poisoned stage gives 0·inf = NaN, which then adds into the gradient of
every parameter. The forward is healthy (the attempt is rejected); only the
tape is poisoned.

The JAX package wraps each attempt in a ``custom_vjp`` whose backward
switches on the attempt's finite flag. The port's loop runs on the host and
reads each attempt's outcome anyway, finite flag included, so the switch
happens in the forward: when the flag is false the solver drops the attempt's
tape and records ``forced_reject`` instead, the exact primal of a forced
rejection (the state passes through, dt becomes dt·dfactor) with no RHS call
in it. Its backward is clean by construction: the attempt's parameters get
exactly zero from it, and dt keeps its true dfactor sensitivity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndcn_tpu_torch.ode.collectives import all_true


def all_finite(*tensors: torch.Tensor, group=None) -> torch.Tensor:
    """0-dim bool tensor: every element of every tensor is finite (on every
    rank of ``group``, the process group a node-sharded state splits
    over)."""
    ok = torch.isfinite(tensors[0]).all()
    for t in tensors[1:]:
        ok = ok & torch.isfinite(t).all()
    return all_true(ok, group)


def forced_reject(rk: NamedTuple, dfactor: float) -> NamedTuple:
    """The solver state after a rejected attempt, built from the state before
    it: y, f, the last accepted interval and its dense output unchanged, dt
    shrunk by ``dfactor``."""
    return rk._replace(dt=rk.dt * dfactor)
