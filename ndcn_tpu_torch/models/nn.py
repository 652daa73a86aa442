"""Linear layers, dropout and the recurrent cells with the JAX package's
semantics (``ndcn_tpu/models/nn.py``).

Every weight and bias of a linear layer is U(-1/sqrt(fan_in),
1/sqrt(fan_in)), the ``torch.nn.Linear`` default bound, and of a recurrent
cell U(±1/sqrt(hidden)), the torch cells' bound; each is drawn from an
explicit ``torch.Generator`` (never from the global generator).

A replica sweep stacks R models' parameters along a new leading axis
(``parallel.sweep.stack_models``): ``linear_apply`` then multiplies each
replica's input by its own weight (one batched product), and ``dropout`` /
``dropout_mask`` take a list of R generators, each drawing its replica's
mask as its own model would.

On a node-sharded model (``parallel.coo_shard``: each rank holds node rows
[start, stop) of n) ``dropout`` and ``dropout_mask`` take ``rows`` = (n,
start, stop) (``coo_shard.node_rows``): the mask is drawn at the whole
graph's shape, as the unsharded run draws it, and cut to the rank's rows,
so that the ranks together drop exactly the unsharded run's elements.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def linear_init(in_features: int, out_features: int, *,
                generator: torch.Generator) -> nn.Linear:
    """A float32 CPU ``nn.Linear`` drawn from ``generator`` (move it
    afterwards: the same seed then gives the same weights on every device)."""
    layer = nn.utils.skip_init(nn.Linear, in_features, out_features)
    bound = 1.0 / math.sqrt(in_features)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


def linear_apply(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ W + b with W (in, out), as the JAX package's ``linear_apply``
    (``nn.Linear`` stores W transposed). A stacked layer (weight (R, out,
    in), bias (R, out)) maps x (..., R, m, in), or a shared x (m, in), to
    (..., R, m, out)."""
    out = x @ layer.weight.transpose(-1, -2)
    if layer.bias is not None:
        out = out + layer.bias.unsqueeze(-2)
    return out


def _replica_uniform(generators, shape) -> torch.Tensor:
    """U(0, 1) of ``shape`` from one generator (on its own device), or of
    (R, *shape) from a list of R, each replica's draw its own generator's."""
    if isinstance(generators, (list, tuple)):
        return torch.stack([torch.rand(tuple(shape), generator=g,
                                       device=g.device)
                            for g in generators])
    return torch.rand(tuple(shape), generator=generators,
                      device=generators.device)


def _uniform_rows(generators, shape, rows) -> torch.Tensor:
    """``_replica_uniform`` of one replica's ``shape`` whose leading axis
    holds node rows [start, stop) of n (``rows`` = (n, start, stop)):
    drawn at (n, *shape[1:]) and cut to the rows (None: as it is)."""
    if rows is None:
        return _replica_uniform(generators, shape)
    n, start, stop = rows
    u = _replica_uniform(generators, (n, *tuple(shape)[1:]))
    axis = 1 if isinstance(generators, (list, tuple)) else 0
    return u.narrow(axis, start, stop - start)


def dropout(generator: torch.Generator, x: torch.Tensor, rate: float,
            deterministic: bool, rows=None) -> torch.Tensor:
    """Inverted dropout, as the JAX package's ``dropout``: rate 0 or
    ``deterministic`` is the identity (no draw). The mask is drawn from
    ``generator`` on its own device (the CPU for the drivers' generators)
    and moved to x's, so a card run and a CPU run at one seed drop the same
    elements.

    A list of R generators drops R replicas: x is (R, n, f), or a shared
    (n, f) that each replica drops on its own (the result is (R, n, f)).
    ``rows``: x holds a rank's node rows (the module docstring)."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    if isinstance(generator, (list, tuple)):
        shape = x.shape[1:] if x.ndim == 3 else x.shape
    else:
        shape = x.shape
    u = _uniform_rows(generator, shape, rows)
    return torch.where((u < keep).to(x.device), x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout_mask(generator: torch.Generator, shape, rate: float,
                 dtype=torch.float32, device=None, rows=None) -> torch.Tensor:
    """A fixed inverted-dropout mask, drawn once per forward from
    ``generator`` (on the generator's device, then moved to ``device``).

    As the JAX package's ``dropout_mask``: the reference resamples dropout at
    every RHS evaluation inside the solver, which makes the ODE stochastic per
    evaluation and the adaptive controller ill-posed; one mask per forward
    keeps the ODE well defined. With a list of R generators, ``shape`` is
    one replica's and the masks are stacked (R, *shape). ``rows``: its
    leading axis holds a rank's node rows (the module docstring)."""
    keep = 1.0 - rate
    u = _uniform_rows(generator, shape, rows)
    return ((u < keep).to(dtype) / keep).to(device)


# ----------------------------------------------------------------- RNN cells

RNN_GATES = {"rnn": 1, "gru": 3, "lstm": 4}


class RecurrentCell(nn.Module):
    """The parameters of an RNN (1 gate block), GRU (3) or LSTM (4) cell in
    the torch cells' layout: ``w_ih`` (gates·H, I), ``w_hh`` (gates·H, H),
    ``b_ih`` and ``b_hh`` (gates·H,), all U(±1/sqrt(H)) from ``generator``
    (float32, on the CPU: move the module afterwards). ``forward(x, state,
    gi=None)`` is the cell's apply function (``gi``: the input projection
    W_ih x + b_ih, precomputed)."""

    gates = 1

    def __init__(self, input_size: int, hidden_size: int, *,
                 generator: torch.Generator):
        super().__init__()
        g = self.gates * hidden_size
        bound = 1.0 / math.sqrt(hidden_size)

        def uniform(*shape):
            return nn.Parameter(torch.empty(shape).uniform_(
                -bound, bound, generator=generator))

        self.w_ih = uniform(g, input_size)
        self.w_hh = uniform(g, hidden_size)
        self.b_ih = uniform(g)
        self.b_hh = uniform(g)


def _gates(cell: RecurrentCell, x: torch.Tensor, h: torch.Tensor, gi=None):
    """(W_ih x + b_ih, W_hh h + b_hh); ``gi`` is the first, when the caller
    has computed it (a row-sharded input's projection, summed over the
    ranks: ``models.temporal_gcn``), and x is then not read."""
    if gi is None:
        gi = torch.matmul(x, cell.w_ih.t()) + cell.b_ih
    return gi, torch.matmul(h, cell.w_hh.t()) + cell.b_hh


def rnn_cell_apply(cell: RecurrentCell, x: torch.Tensor,
                   h: torch.Tensor, gi=None) -> torch.Tensor:
    """Elman cell: h' = tanh(W_ih x + b_ih + W_hh h + b_hh)."""
    gi, gh = _gates(cell, x, h, gi)
    return torch.tanh(gi + gh)


def gru_cell_apply(cell: RecurrentCell, x: torch.Tensor,
                   h: torch.Tensor, gi=None) -> torch.Tensor:
    """GRU with torch's gate order (reset, update, new)."""
    gi, gh = _gates(cell, x, h, gi)
    i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def lstm_cell_apply(cell: RecurrentCell, x: torch.Tensor, hc, gi=None):
    """LSTM with torch's gate order (input, forget, cell, output); hc is
    (h, c), and so is the result."""
    h, c = hc
    gi, gh = _gates(cell, x, h, gi)
    i, f, g, o = torch.chunk(gi + gh, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    return o * torch.tanh(c_new), c_new


class RNNCell(RecurrentCell):
    gates = RNN_GATES["rnn"]

    def forward(self, x, h, gi=None):
        return rnn_cell_apply(self, x, h, gi)


class GRUCell(RecurrentCell):
    gates = RNN_GATES["gru"]

    def forward(self, x, h, gi=None):
        return gru_cell_apply(self, x, h, gi)


class LSTMCell(RecurrentCell):
    gates = RNN_GATES["lstm"]

    def forward(self, x, hc, gi=None):
        return lstm_cell_apply(self, x, hc, gi)


CELLS = {"rnn": RNNCell, "gru": GRUCell, "lstm": LSTMCell}


def rnn_cell_init(input_size: int, hidden_size: int, rnn_type: str = "rnn",
                  *, generator: torch.Generator) -> RecurrentCell:
    """The ``rnn_type`` cell ('rnn', 'gru' or 'lstm') drawn from
    ``generator``, as the JAX package's ``rnn_cell_init`` with
    ``gates=RNN_GATES[rnn_type]``."""
    if rnn_type not in CELLS:
        raise ValueError(f"unknown rnn_type {rnn_type!r}; choose from "
                         f"{sorted(CELLS)}")
    return CELLS[rnn_type](input_size, hidden_size, generator=generator)
