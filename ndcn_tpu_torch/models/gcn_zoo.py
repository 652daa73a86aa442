"""The discrete GCN zoo for semi-supervised node classification, as
``ndcn_tpu/models/gcn_zoo.py`` (the reference's ``models.py`` and
``ode_gcn.py``):

- ``GCN``      2-layer Kipf GCN with optional middle layers;
- ``DeepGCN``  residual Euler-step middle layers with one learned scalar
               ``time_step``;
- ``DeepGCN2`` the fixed-filter 2-linear variant (A applied to the raw
               features);
- ``DeepGCN3`` a learned dense (n, n) adjacency weight ``AW``, the Laplacian
               rebuilt each forward from the operator's dense matrix;
- ``DeepGCN4`` per-layer learned steps; its ``DiagLinear`` middle weights are
               kept though unused, as in the reference forward;
- ``resGCN``   Linear → ReLU → ResBlock^L → Linear (``euler``: U(0, 1)
               learned steps; ``normalize``: row-normalised blocks;
               ``time_varying``: a linear in each block);
- ``row_normalize``.

Each is an ``nn.Module`` whose ``forward(op, x, generator=None,
deterministic=True)`` propagates through ``graph.sparse.matvec``:
``torch.matmul`` on a dense operator, K1 on COO, K3 on BSR, the gather and
``einsum`` on ELL. Dropout draws one mask per site from ``generator``, in the
JAX function's order of sites (its keys); no generator, or
``deterministic``, drops nothing. Weights come from a ``torch.Generator``
on the CPU, with the JAX package's distributions; ``jax_tree`` names every
parameter by its key in the JAX package's parameter dict
(``convert.zoo_params_from_jax`` carries weights across).

On a row-sharded operator (``parallel.coo_shard``; the JAX package's
GSPMD sharding) x is this rank's node rows and so are the logits: every
product with the operator is the rank's row block (``rs_matvec``: K1's,
its wide form at cora's 1433 raw features, on COO), every linear layer
acts on the rank's rows, and each dropout mask is drawn at the whole
graph's shape and cut to the rank's rows (``models.nn.dropout``), so the
ranks together compute the unsharded forward. DeepGCN3 takes its rank's
row block of AW ∘ A as an (n_local, n) tensor, whose row sums are local,
and multiplies it by the all-gathered x (``parallel.mesh.gather_rows``,
differentiable).

GCN, DeepGCN, DeepGCN2 and DeepGCN4 (the JAX driver's ``--batch_iters``
models) also run R replicas at once when their parameters are stacked
along a leading axis (``parallel.sweep.stack_models``): the shared features
go in as they are, every hidden state is (R, n, h) and its products with
the operator are the kernels' batched forms (DeepGCN2's A·X on the raw
features is shared and taken once), ``generator`` is a list of R
generators, and the logits are (R, n, c).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

import torch.nn.functional as F

from ndcn_tpu_torch.graph.sparse import (DenseGraph, GraphOperator, matvec,
                                         to_dense_matrix)
from ndcn_tpu_torch.models.nn import dropout, linear_apply, linear_init
from ndcn_tpu_torch.parallel.coo_shard import (dense_rows, is_sharded,
                                               node_rows)
from ndcn_tpu_torch.parallel.mesh import gather_rows

ZOO = ("GCN", "DeepGCN", "DeepGCN2", "DeepGCN3", "DeepGCN4", "resGCN")


def row_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / ||row||_1 with zero rows kept at zero."""
    norm = torch.sum(torch.abs(x), dim=1, keepdim=True)
    return x / torch.where(norm == 0, torch.ones_like(norm), norm)


def _drop(generator, x, rate, deterministic, op):
    """``models.nn.dropout`` of x, a tensor of ``op``'s node rows (a rank's,
    on a row-sharded operator)."""
    if generator is None:
        return x
    return dropout(generator, x, rate, deterministic, rows=node_rows(op))


def _scale(x: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """x times a learned step: one model's (x (n, h)), or R replicas' (x (R,
    n, h), the step's leading axis the replica's)."""
    if x.ndim == 3:
        step = step.reshape(step.shape[0], 1, 1)
    return x * step


def _step(value: float, generator: Optional[torch.Generator] = None,
          size: int = 1) -> nn.Parameter:
    """A learned step of ``size`` entries: ``value`` each, or U(0, 1) from
    ``generator``."""
    if generator is not None:
        return nn.Parameter(torch.rand(size, generator=generator))
    return nn.Parameter(torch.full((size,), value, dtype=torch.float32))


class GCN(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, num_classes: int,
                 num_middle_layers: int = 0, *, generator: torch.Generator,
                 dropout: float = 0.0):
        super().__init__()
        g = generator
        self.dropout = dropout
        self.gc1 = linear_init(input_size, hidden_size, generator=g)
        self.middle = nn.ModuleList(
            linear_init(hidden_size, hidden_size, generator=g)
            for _ in range(num_middle_layers))
        self.gc2 = linear_init(hidden_size, num_classes, generator=g)

    def jax_tree(self) -> dict:
        return {"gc1": self.gc1, "middle": list(self.middle), "gc2": self.gc2}

    def forward(self, op: GraphOperator, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True) -> torch.Tensor:
        drop = (lambda h: _drop(generator, h, self.dropout, deterministic,
                                op))
        x = drop(x)
        x = torch.relu(matvec(op, linear_apply(self.gc1, x)))
        for layer in self.middle:
            x = drop(x)
            x = torch.relu(matvec(op, linear_apply(layer, x)))
        x = drop(x)
        return matvec(op, linear_apply(self.gc2, x))


class DeepGCN(GCN):
    """Residual Euler steps: x ← x + relu(conv(x)) · time_step."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.time_step = _step(0.1)

    def jax_tree(self) -> dict:
        return dict(super().jax_tree(), time_step=self.time_step)

    def forward(self, op, x, generator=None, deterministic=True):
        drop = (lambda h: _drop(generator, h, self.dropout, deterministic,
                                op))
        x = drop(x)
        x = torch.relu(matvec(op, linear_apply(self.gc1, x)))
        for layer in self.middle:
            f = drop(x)
            f = torch.relu(matvec(op, linear_apply(layer, f)))
            x = x + _scale(f, self.time_step)
        x = drop(x)
        return matvec(op, linear_apply(self.gc2, x))


class DeepGCN2(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, num_classes: int,
                 *, generator: torch.Generator, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.linear1 = linear_init(input_size, hidden_size, generator=generator)
        self.linear2 = linear_init(hidden_size, num_classes,
                                   generator=generator)
        self.time_step = _step(0.1)

    def jax_tree(self) -> dict:
        return {"linear1": self.linear1, "linear2": self.linear2,
                "time_step": self.time_step}

    def forward(self, op, x, generator=None, deterministic=True):
        x = matvec(op, x)
        x = _drop(generator, x, self.dropout, deterministic, op)
        x = torch.relu(linear_apply(self.linear1, x))
        x = matvec(op, x)
        x = _drop(generator, x, self.dropout, deterministic, op)
        return linear_apply(self.linear2, x)


def dense_operator(op: GraphOperator) -> torch.Tensor:
    """The operator as an (n, n) tensor on its device: a dense operator's
    own matrix, any other materialised through ``to_dense_matrix``; a
    row-sharded operator's rows of it, (n_local, n)
    (``coo_shard.dense_rows``)."""
    if isinstance(op, DenseGraph):
        return op.mat
    if is_sharded(op):
        return dense_rows(op)
    return torch.as_tensor(to_dense_matrix(op), device=op.device)


class DeepGCN3(nn.Module):
    """Learns an elementwise adjacency reweighting AW; L = A∘AW - D is
    recomputed every forward. Takes no dropout, as in the reference."""

    def __init__(self, input_size: int, hidden_size: int, num_classes: int,
                 num_nodes: int, num_middle_layers: int = 0, *,
                 generator: torch.Generator, dropout: float = 0.0):
        super().__init__()
        del dropout
        self.num_middle_layers = num_middle_layers
        self.linear1 = linear_init(input_size, hidden_size, generator=generator)
        self.linear2 = linear_init(hidden_size, num_classes,
                                   generator=generator)
        self.AW = nn.Parameter(torch.rand(num_nodes, num_nodes,
                                          generator=generator))
        self.time_step = _step(0.1)

    def jax_tree(self) -> dict:
        return {"linear1": self.linear1, "linear2": self.linear2,
                "AW": self.AW, "time_step": self.time_step}

    def forward(self, op, x, generator=None, deterministic=True):
        x = linear_apply(self.linear1, x)
        # this rank's rows [start, stop) of L (all of them unsharded): its
        # rows of AW ∘ A less their sums on the diagonal
        n, start, stop = node_rows(op) or (x.shape[0], 0, x.shape[0])
        a = self.AW[start:stop] * dense_operator(op)
        lap = a - F.pad(torch.diag(a.sum(1)), (start, n - stop))
        for _ in range(self.num_middle_layers):
            x_all = (gather_rows(x, op.rows_per, op.group)[:n]
                     if is_sharded(op) else x)
            x = x + torch.relu(lap @ x_all) * self.time_step
        return linear_apply(self.linear2, x)


class DiagLinear(nn.Module):
    """x · weight (+ bias), elementwise; U(±1/sqrt(n_features))."""

    def __init__(self, n_features: int, bias: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        stdv = 1.0 / math.sqrt(n_features)
        self.weight = nn.Parameter(
            torch.empty(n_features).uniform_(-stdv, stdv, generator=generator))
        self.bias = (nn.Parameter(torch.empty(n_features).uniform_(
            -stdv, stdv, generator=generator)) if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x * self.weight
        return out + self.bias if self.bias is not None else out


class DeepGCN4(nn.Module):
    """Per-layer learned Euler steps. As in the reference forward, the
    DiagLinear middle weights are present but unused."""

    def __init__(self, input_size: int, hidden_size: int, num_classes: int,
                 num_middle_layers: int = 0, *, generator: torch.Generator,
                 dropout: float = 0.0):
        super().__init__()
        g = generator
        self.dropout = dropout
        self.linear1 = linear_init(input_size, hidden_size, generator=g)
        self.diag = nn.ModuleList(DiagLinear(hidden_size, bias=False,
                                             generator=g)
                                  for _ in range(num_middle_layers))
        self.linear2 = linear_init(hidden_size, num_classes, generator=g)
        self.time_step_list = _step(0.1, size=max(num_middle_layers, 1))

    def jax_tree(self) -> dict:
        return {"linear1": self.linear1, "diag": list(self.diag),
                "linear2": self.linear2,
                "time_step_list": self.time_step_list}

    def forward(self, op, x, generator=None, deterministic=True):
        x = torch.relu(linear_apply(self.linear1, x))
        for i in range(len(self.diag)):
            f = matvec(op, x)
            f = _drop(generator, f, self.dropout, deterministic, op)
            x = x + _scale(torch.relu(f), self.time_step_list[..., i])
        return linear_apply(self.linear2, x)


class ResBlock(nn.Module):
    """One block of resGCN: an optional linear (time-varying) and an
    optional learned step (``euler``)."""

    def __init__(self, hidden_size: int, euler: bool, time_varying: bool, *,
                 generator: torch.Generator):
        super().__init__()
        self.linear = (linear_init(hidden_size, hidden_size,
                                   generator=generator)
                       if time_varying else None)
        # the reference initialises the learned step U(0, 1)
        self.time_step = _step(0.0, generator) if euler else None

    def jax_tree(self) -> dict:
        tree = {}
        if self.linear is not None:
            tree["linear"] = self.linear
        if self.time_step is not None:
            tree["time_step"] = self.time_step
        return tree


class ResGCN(nn.Module):
    """ResBlock stack: x ← x + relu(dropout(A x)) · step."""

    def __init__(self, input_size: int, hidden_size: int, num_classes: int,
                 n_blocks: int = 0, euler: bool = False,
                 time_varying: bool = False, normalize: bool = False, *,
                 generator: torch.Generator, dropout: float = 0.0):
        super().__init__()
        g = generator
        self.dropout = dropout
        self.normalize = normalize
        self.lin_in = linear_init(input_size, hidden_size, generator=g)
        self.blocks = nn.ModuleList(
            ResBlock(hidden_size, euler, time_varying, generator=g)
            for _ in range(n_blocks))
        self.out = linear_init(hidden_size, num_classes, generator=g)

    def jax_tree(self) -> dict:
        return {"in": self.lin_in,
                "blocks": [blk.jax_tree() for blk in self.blocks],
                "out": self.out}

    def forward(self, op, x, generator=None, deterministic=True):
        x = torch.relu(linear_apply(self.lin_in, x))
        for blk in self.blocks:
            h = row_normalize(x) if self.normalize else x
            f = matvec(op, h)
            if blk.linear is not None:
                f = linear_apply(blk.linear, f)
            f = _drop(generator, f, self.dropout, deterministic, op)
            if self.normalize:
                f = row_normalize(f)
            f = torch.relu(f)
            x = x + f * (blk.time_step if blk.time_step is not None else 1.0)
        return linear_apply(self.out, x)


def build_zoo_model(name: str, input_size: int, hidden_size: int,
                    num_classes: int, num_nodes: int, num_middle_layers: int,
                    *, generator: torch.Generator, dropout: float = 0.0,
                    euler: bool = False, normalize: bool = False) -> nn.Module:
    """The zoo model ``name`` as the classification driver builds it
    (``-nhl`` middle layers or blocks)."""
    kw = dict(generator=generator, dropout=dropout)
    if name == "GCN":
        return GCN(input_size, hidden_size, num_classes, num_middle_layers,
                   **kw)
    if name == "DeepGCN":
        return DeepGCN(input_size, hidden_size, num_classes,
                       num_middle_layers, **kw)
    if name == "DeepGCN2":
        return DeepGCN2(input_size, hidden_size, num_classes, **kw)
    if name == "DeepGCN3":
        return DeepGCN3(input_size, hidden_size, num_classes, num_nodes,
                        num_middle_layers, **kw)
    if name == "DeepGCN4":
        return DeepGCN4(input_size, hidden_size, num_classes,
                        num_middle_layers, **kw)
    if name == "resGCN":
        return ResGCN(input_size, hidden_size, num_classes, num_middle_layers,
                      euler=euler, normalize=normalize, **kw)
    raise ValueError(f"unknown zoo model {name!r}; choose from {ZOO}")
