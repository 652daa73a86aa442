"""The state algebra the solvers need.

The JAX package works on pytrees (``ndcn_tpu/ode/tree_math.py``). The port's
state is one tensor, or a flat tuple of tensors: the continuous adjoint
integrates (y, adj_y, adj_t, *adj_params). Every helper maps a bare tensor to
the same single call it would make on that tensor alone, so the one-tensor
solve launches exactly the kernels it did before states could be tuples.

A batched solve (R replicas in one loop, ``adaptive.solve_batched``) gives
every leaf a leading replica axis and every time scalar the shape (R,);
``bcast`` lays such a per-replica vector over a leaf, and leaves a 0-dim
scalar as it is.

A node-sharded solve (the state's node rows split over the ranks of a
process group, ``parallel.coo_shard``) takes each norm and mean of a
node-sharded leaf over the whole leaf: a sum and a count, all-reduced over
the group (differentiably: the step controller is on the tape). Every rank
then reads the same step sizes and flags and takes the same steps. The
JAX package gets this from GSPMD. The group is an argument, one a leaf
(``leaf_groups``: the solve's ``node_group`` option and its per-leaf
``node_sharded`` marks): a replicated leaf (the adjoint's adj_t and
parameter cotangents, equal on every rank) takes its mean locally, with no
collective, as GSPMD computes a replicated array's mean.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from ndcn_tpu_torch.ode.collectives import sharded_sum_and_count

State = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


def leaf_groups(group, marks: Optional[Sequence[bool]],
                n_leaves: int) -> Optional[tuple]:
    """The group each leaf's norms and means are taken over: ``group`` for
    a node-sharded leaf (``marks[i]`` true; no marks: every leaf), None
    for a replicated one. None, when ``group`` is None: no leaf is
    sharded."""
    if group is None:
        return None
    if marks is None:
        return (group,) * n_leaves
    if len(marks) != n_leaves:
        raise ValueError(f"node_sharded marks {len(marks)} leaves; the "
                         f"state has {n_leaves}")
    return tuple(group if m else None for m in marks)


def per_leaf(groups: Optional[Sequence], n_leaves: int) -> Sequence:
    """``groups`` as one entry a leaf (None everywhere for None)."""
    return (None,) * n_leaves if groups is None else groups


def state_group(groups: Optional[Sequence]):
    """The group of the state's node-sharded leaves (None if none is):
    what a flag over the whole state (an attempt's finite flag) is
    all-reduced over."""
    return next((g for g in groups or () if g is not None), None)


def whole_mean(terms: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``terms`` over the whole leaf: over every rank's
    elements of a node-sharded leaf (``group``), else ``torch.mean``."""
    if group is None:
        return torch.mean(terms)
    total, count = sharded_sum_and_count(torch.sum(terms), terms.numel(),
                                         group)
    return (total / count).to(terms.dtype)


def whole_mean_rows(terms: torch.Tensor, group=None) -> torch.Tensor:
    """``whole_mean`` per replica: the mean of each index of the leading
    axis, (R,)."""
    rows = terms.reshape(terms.shape[0], -1)
    if group is None:
        return torch.mean(rows, dim=1)
    total, count = sharded_sum_and_count(torch.sum(rows, dim=1),
                                         rows.shape[1], group)
    return (total / count).to(terms.dtype)


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``, with no dispatch when it is already: the solver
    loop is the host's, and a no-op ``.to`` a stage adds up."""
    return x if x.dtype == dtype else x.to(dtype)


def bcast(s: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A per-replica vector ``s`` (R,) shaped to broadcast over ``leaf``
    (R, ...) along its leading axis; a 0-dim ``s`` unchanged."""
    if s.ndim == 0:
        return s
    return s.reshape(s.shape + (1,) * (leaf.ndim - s.ndim))


def tmap(fn: Callable, *trees):
    """``fn`` leaf by leaf over states of one structure; a bare tensor is
    its own only leaf."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    return tuple(fn(*leaves) for leaves in zip(*trees))


def leaves(tree) -> List[torch.Tensor]:
    return [tree] if isinstance(tree, torch.Tensor) else list(tree)


def tstack(trees: Sequence) -> State:
    """A list of states stacked along a new leading axis, leaf by leaf."""
    return tmap(lambda *ls: torch.stack(ls), *trees)


def tindex(tree, i):
    return tmap(lambda leaf: leaf[i], tree)


def tmax(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """The largest of a list of 0-dim tensors (itself when there is one)."""
    return values[0] if len(values) == 1 else torch.max(torch.stack(values))


def tmin(values: Sequence[torch.Tensor]) -> torch.Tensor:
    return values[0] if len(values) == 1 else torch.min(torch.stack(values))


def rms_norm(x: torch.Tensor, batched: bool = False,
             group=None) -> torch.Tensor:
    """||x||_2 / sqrt(numel) of one leaf, as the reference ``_norm``; with
    ``batched`` one norm per replica (the leading axis), shape (R,); with
    ``group``, over every rank's elements of a node-sharded leaf."""
    if batched and group is not None:
        return torch.sqrt(whole_mean_rows(torch.square(x), group))
    if batched:
        rows = x.reshape(x.shape[0], -1)
        return torch.sqrt(torch.sum(torch.square(rows), dim=1)
                          / rows.shape[1])
    if group is not None:
        return torch.sqrt(whole_mean(torch.square(x), group))
    return torch.sqrt(torch.sum(torch.square(x)) / x.numel())


def tmax_rows(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """The elementwise largest of a list of (R,) tensors (``tmax`` per
    replica)."""
    return values[0] if len(values) == 1 else torch.stack(values).amax(0)


def tree_dot(a, b) -> torch.Tensor:
    """Σ a·b over every leaf, in the leaves' dtype."""
    out = None
    for x, y in zip(leaves(a), leaves(b)):
        s = torch.sum(x * y)
        out = s if out is None else out + s
    return out


def tree_dot_rows(a, b) -> torch.Tensor:
    """``tree_dot`` per replica: Σ a·b over each index of every leaf's
    leading axis, (R,)."""
    out = None
    for x, y in zip(leaves(a), leaves(b)):
        s = torch.sum((x * y).reshape(x.shape[0], -1), dim=1)
        out = s if out is None else out + s
    return out


def scaled_dot_product(scale: torch.Tensor, coeffs: torch.Tensor,
                       stacked: torch.Tensor) -> torch.Tensor:
    """scale * sum_i coeffs[i] * stacked[i] along the leading stage axis of
    one leaf; ``coeffs`` is a 1-D tensor of len <= stacked.shape[0]. A
    float64 ``scale`` (float64 time) is rounded to the leaf's dtype first,
    as the JAX package casts it; a per-replica ``scale`` (R,) scales each
    replica of a batched leaf."""
    combined = torch.tensordot(coeffs, stacked[: coeffs.shape[0]], dims=1)
    return bcast(cast(scale, stacked.dtype), combined) * combined


def tscaled_dot_product(scale: torch.Tensor, coeffs: torch.Tensor, stacked):
    return tmap(lambda k: scaled_dot_product(scale, cast(coeffs, k.dtype), k),
                stacked)
