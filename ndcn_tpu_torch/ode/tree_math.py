"""The state algebra the solvers need.

The JAX package works on pytrees (``ndcn_tpu/ode/tree_math.py``). The port's
state is one tensor, or a flat tuple of tensors: the continuous adjoint
integrates (y, adj_y, adj_t, *adj_params). Every helper maps a bare tensor to
the same single call it would make on that tensor alone, so the one-tensor
solve launches exactly the kernels it did before states could be tuples.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, Union

import torch

State = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``, with no dispatch when it is already: the solver
    loop is the host's, and a no-op ``.to`` a stage adds up."""
    return x if x.dtype == dtype else x.to(dtype)


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


def rms_norm(x: torch.Tensor) -> torch.Tensor:
    """||x||_2 / sqrt(numel) of one leaf, as the reference ``_norm``."""
    return torch.sqrt(torch.sum(torch.square(x)) / x.numel())


def tree_dot(a, b) -> torch.Tensor:
    """Σ a·b over every leaf, in the leaves' dtype."""
    out = None
    for x, y in zip(leaves(a), leaves(b)):
        s = torch.sum(x * y)
        out = s if out is None else out + s
    return out


def scaled_dot_product(scale: torch.Tensor, coeffs: torch.Tensor,
                       stacked: torch.Tensor) -> torch.Tensor:
    """scale * sum_i coeffs[i] * stacked[i] along the leading stage axis of
    one leaf; ``coeffs`` is a 1-D tensor of len <= stacked.shape[0]. A
    float64 ``scale`` (float64 time) is rounded to the leaf's dtype first,
    as the JAX package casts it."""
    return (cast(scale, stacked.dtype)
            * torch.tensordot(coeffs, stacked[: coeffs.shape[0]], dims=1))


def tscaled_dot_product(scale: torch.Tensor, coeffs: torch.Tensor, stacked):
    return tmap(lambda k: scaled_dot_product(scale, cast(coeffs, k.dtype), k),
                stacked)
