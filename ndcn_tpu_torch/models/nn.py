"""Linear layers, dropout and the recurrent cells with the JAX package's
semantics (``ndcn_tpu/models/nn.py``).

Every weight and bias of a linear layer is U(-1/sqrt(fan_in),
1/sqrt(fan_in)), the ``torch.nn.Linear`` default bound, and of a recurrent
cell U(±1/sqrt(hidden)), the torch cells' bound; each is drawn from an
explicit ``torch.Generator`` (never from the global generator).
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
    (``nn.Linear`` stores W transposed)."""
    out = x @ layer.weight.t()
    if layer.bias is not None:
        out = out + layer.bias
    return out


def dropout(generator: torch.Generator, x: torch.Tensor, rate: float,
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout, as the JAX package's ``dropout``: rate 0 or
    ``deterministic`` is the identity (no draw). The mask is drawn from
    ``generator`` on its own device (the CPU for the drivers' generators)
    and moved to x's, so a card run and a CPU run at one seed drop the same
    elements."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(tuple(x.shape), generator=generator,
                   device=generator.device)
    return torch.where((u < keep).to(x.device), x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout_mask(generator: torch.Generator, shape, rate: float,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """A fixed inverted-dropout mask, drawn once per forward from
    ``generator`` (on the generator's device, then moved to ``device``).

    As the JAX package's ``dropout_mask``: the reference resamples dropout at
    every RHS evaluation inside the solver, which makes the ODE stochastic per
    evaluation and the adaptive controller ill-posed; one mask per forward
    keeps the ODE well defined."""
    keep = 1.0 - rate
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return ((u < keep).to(dtype) / keep).to(device)


# ----------------------------------------------------------------- RNN cells

RNN_GATES = {"rnn": 1, "gru": 3, "lstm": 4}


class RecurrentCell(nn.Module):
    """The parameters of an RNN (1 gate block), GRU (3) or LSTM (4) cell in
    the torch cells' layout: ``w_ih`` (gates·H, I), ``w_hh`` (gates·H, H),
    ``b_ih`` and ``b_hh`` (gates·H,), all U(±1/sqrt(H)) from ``generator``
    (float32, on the CPU: move the module afterwards). ``forward(x, state)``
    is the cell's apply function."""

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


def _gates(cell: RecurrentCell, x: torch.Tensor, h: torch.Tensor):
    return (torch.matmul(x, cell.w_ih.t()) + cell.b_ih,
            torch.matmul(h, cell.w_hh.t()) + cell.b_hh)


def rnn_cell_apply(cell: RecurrentCell, x: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
    """Elman cell: h' = tanh(W_ih x + b_ih + W_hh h + b_hh)."""
    gi, gh = _gates(cell, x, h)
    return torch.tanh(gi + gh)


def gru_cell_apply(cell: RecurrentCell, x: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
    """GRU with torch's gate order (reset, update, new)."""
    gi, gh = _gates(cell, x, h)
    i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def lstm_cell_apply(cell: RecurrentCell, x: torch.Tensor, hc):
    """LSTM with torch's gate order (input, forget, cell, output); hc is
    (h, c), and so is the result."""
    h, c = hc
    gi, gh = _gates(cell, x, h)
    i, f, g, o = torch.chunk(gi + gh, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    return o * torch.tanh(c_new), c_new


class RNNCell(RecurrentCell):
    gates = RNN_GATES["rnn"]

    def forward(self, x, h):
        return rnn_cell_apply(self, x, h)


class GRUCell(RecurrentCell):
    gates = RNN_GATES["gru"]

    def forward(self, x, h):
        return gru_cell_apply(self, x, h)


class LSTMCell(RecurrentCell):
    gates = RNN_GATES["lstm"]

    def forward(self, x, hc):
        return lstm_cell_apply(self, x, hc)


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
