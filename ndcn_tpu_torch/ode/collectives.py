"""The collectives a node-sharded solve issues, over the process group its
state's node rows split over (``parallel.coo_shard``): the solvers take the
group as an argument (the solve's ``node_group`` option) and never import
``parallel``; ``parallel.mesh`` re-exports these for the models and the
drivers.

- ``all_reduce_sum``: a sum over the ranks that autograd differentiates
  (its gradient is the sum of the ranks' gradients): the step controller's
  norms are on the tape of the differentiable solve;
- ``sharded_sum_and_count``: the ranks' partial sums and element counts in
  one such all-reduce, float64 (a node-sharded leaf's mean);
- ``all_true``: a flag that holds on every rank (an attempt's finite flag);
- ``sum_flat``: tensors summed over the ranks in one flat all-reduce, off
  the tape (the continuous adjoint's parameter VJPs).

A group of None (a world of one, or a replicated state) runs none of them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        # every rank's copy of the sum feeds that rank's own computation:
        # the gradient of each term is the sum of the ranks' gradients
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor,
                   group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, differentiable (x
    itself for a group of one)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def sharded_sum_and_count(s: torch.Tensor, count: int,
                          group: Optional[dist.ProcessGroup]):
    """(the sum of the ranks' partial sums ``s``, a scalar or one per
    replica, and the sum of their element counts), float64: one
    differentiable all-reduce. The count is filled on the device: a copy
    from the host would wait for the device's queue at every norm."""
    both = torch.cat([s.reshape(-1).to(torch.float64),
                      s.new_full((1,), float(count), dtype=torch.float64)])
    both = all_reduce_sum(both, group)
    return both[:-1].reshape(s.shape), both[-1]


def all_true(flag: torch.Tensor,
             group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """A bool tensor of ``flag``'s shape, true where ``flag`` is true on
    every rank."""
    if group is None:
        return flag
    t = flag.to(torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return t.bool()


def sum_flat(tensors: Sequence[torch.Tensor],
             group: Optional[dist.ProcessGroup]) -> Tuple[torch.Tensor, ...]:
    """Each tensor summed over the ranks of ``group``, in one all-reduce of
    their concatenation (not differentiable); the tensors themselves for a
    group of one."""
    tensors = tuple(tensors)
    if group is None or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return tuple(out)
