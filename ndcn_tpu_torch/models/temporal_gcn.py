"""The discrete recurrent baselines, as ``ndcn_tpu/models/temporal_gcn.py``:
a GCN feature extractor and an {LSTM, GRU, RNN} cell (the reference's
``TemporalGCN``, neural_dynamics.py:179-238).

At each time step the (n, 1) node state goes through Linear → (n, h), the
graph product ``graph.sparse.matvec`` (``torch.matmul`` on a dense
operator, K1 on COO, K3 on BSR, the gather and ``einsum`` on ELL), a
row-major flatten to one (1, n·h) vector and relu, then the cell, and a
Linear decodes the cell's output back to (n,). The observed steps are
teacher-forced; then ``future`` steps run free, each fed the previous
output. The JAX package's two ``lax.scan``s are two Python loops here, so
each step launches its own product (and its own transposed product in the
backward).

On a row-sharded operator (``parallel.coo_shard``; the JAX package's
GSPMD sharding) x_seq is this rank's node rows and so is the output: the
graph product is the rank's row block (K1's, on COO), the flattened
features are the rank's slice [start · h, stop · h) of the n · h vector,
which meets the same column block of the cell's W_ih, and that partial
input projection is summed over the model group (``all_reduce_sum``,
differentiable) before the gates. The rest of the cell runs replicated;
the decoder computes the rank's rows of its output, and each step's
dropout mask is drawn at the whole (n, 1) and cut to the rank's rows.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ndcn_tpu_torch.graph.sparse import GraphOperator, matvec
from ndcn_tpu_torch.models.nn import (dropout as nn_dropout, linear_apply,
                                      linear_init, rnn_cell_init)
from ndcn_tpu_torch.parallel.coo_shard import (flat_columns, node_group,
                                               node_rows)
from ndcn_tpu_torch.parallel.mesh import all_reduce_sum


class TemporalGCN(nn.Module):
    """``gc`` Linear(input, h_gnn), the ``rnn_type`` cell over n·h_gnn
    inputs with h_rnn hidden units, and ``out`` Linear(h_rnn, n); its
    forward is ``temporal_gcn_forward``."""

    def __init__(self, input_size: int, hidden_size_gnn: int, n_nodes: int,
                 hidden_size_rnn: int, rnn_type: str = "lstm", *,
                 generator: torch.Generator):
        super().__init__()
        self.rnn_type = rnn_type
        self.gc = linear_init(input_size, hidden_size_gnn, generator=generator)
        self.cell = rnn_cell_init(n_nodes * hidden_size_gnn, hidden_size_rnn,
                                  rnn_type, generator=generator)
        self.out = linear_init(hidden_size_rnn, n_nodes, generator=generator)

    def jax_tree(self) -> dict:
        """The parameters by their keys in the JAX package's tree
        (``init_temporal_gcn``)."""
        c = self.cell
        return {"gc": self.gc, "out": self.out,
                "cell": {"w_ih": c.w_ih, "w_hh": c.w_hh, "b_ih": c.b_ih,
                         "b_hh": c.b_hh}}


def init_temporal_gcn(generator: torch.Generator, input_size: int,
                      hidden_size_gnn: int, n_nodes: int,
                      hidden_size_rnn: int, rnn_type: str = "lstm",
                      device: Optional[torch.device] = None) -> TemporalGCN:
    """A ``TemporalGCN`` drawn from ``generator`` on the CPU, then moved to
    ``device``: one seed gives the same weights on every device."""
    model = TemporalGCN(input_size, hidden_size_gnn, n_nodes,
                        hidden_size_rnn, rnn_type, generator=generator)
    return model.to(device) if device is not None else model


def _cell_step(model: TemporalGCN, rnn_type: str, features, state,
               gi=None):
    if rnn_type == "lstm":
        h, c = model.cell(features, state, gi)
        return (h, c), h
    h = model.cell(features, state[0], gi)
    return (h, state[1]), h


def temporal_gcn_forward(model: TemporalGCN, op: GraphOperator,
                         x_seq: torch.Tensor, rnn_type: str = "lstm",
                         future: int = 0, dropout: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         deterministic: bool = True) -> torch.Tensor:
    """x_seq: (n, T) observed node states. Returns (n, T + future)
    predictions. With ``dropout`` > 0, not ``deterministic`` and a
    ``generator``, each step drops its (n, 1) input with a mask drawn from
    ``generator`` (``models.nn.dropout``), the teacher steps' masks first.
    A row-sharded ``op`` takes and gives this rank's rows (the module
    docstring)."""
    hidden_rnn = model.out.weight.shape[1]
    zeros = x_seq.new_zeros((1, hidden_rnn))
    state = (zeros, zeros)
    use_drop = (not deterministic) and dropout > 0.0 and generator is not None
    group, rows = node_group(op), node_rows(op)
    cols = flat_columns(op, model.gc.weight.shape[0])
    out_w, out_b = model.out.weight, model.out.bias
    if group is not None:
        # the decoder's rows of this rank's nodes
        out_w, out_b = out_w[rows[1]:rows[2]], out_b[rows[1]:rows[2]]

    def step(state, xt):
        """(n,) → the next state and the (n,) output."""
        xt = xt[:, None]
        if use_drop:
            xt = nn_dropout(generator, xt, dropout, deterministic=False,
                            rows=rows)
        support = linear_apply(model.gc, xt)                  # (n, h)
        feats = torch.relu(matvec(op, support).reshape(1, -1))  # (1, n·h)
        gi = None
        if group is not None:
            # this rank's columns of W_ih x, summed over the ranks
            w_ih = model.cell.w_ih[:, cols[0]:cols[1]]
            gi = all_reduce_sum(torch.matmul(feats, w_ih.t()), group) \
                + model.cell.b_ih
        state, h = _cell_step(model, rnn_type, feats, state, gi)
        return state, (torch.matmul(h, out_w.t()) + out_b)[0]  # (n,)

    outs = []
    for xt in x_seq.t():
        state, y = step(state, xt)
        outs.append(y)
    for _ in range(future):
        state, y = step(state, outs[-1])
        outs.append(y)
    return torch.stack(outs, dim=1)                           # (n, T + future)
