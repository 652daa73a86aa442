"""Serving: the NDCN inference forward frozen around a model, an operator and
an observation grid, answering x0 → (trajectory, success).

The counterpart of ``ndcn_tpu/serve.py::export_ndcn`` + ``load_ndcn`` with the
same keyword surface: ``forward_kwargs`` pass through to ``ndcn_forward``, the
solve is forced onto the inference (while-loop) path, and ``nondiff`` /
``adjoint`` from a training config are dropped. ``success`` is the solver's
budget / underflow flag: serve a failed answer loudly, never silently.

The server runs in-process; a portable artifact (``torch.export`` of the
data-dependent solver loop) waits for ROADMAP §1 entry 11b.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ndcn_tpu_torch.graph.sparse import GraphOperator
from ndcn_tpu_torch.models.ndcn import NDCN, ndcn_forward
from ndcn_tpu_torch.ode import SolveStats


class Server:
    """A frozen NDCN; call it with x0. ``last_stats`` keeps the last solve's
    SolveStats (NFE, accepted / rejected steps, host syncs)."""

    def __init__(self, model: NDCN, op: GraphOperator, vt, **forward_kwargs):
        forward_kwargs.pop("nondiff", None)
        forward_kwargs.pop("adjoint", None)
        self.model = model
        self.op = op
        self.vt = torch.as_tensor(vt).detach().to("cpu", torch.float32)
        self.forward_kwargs = forward_kwargs
        self.last_stats: Optional[SolveStats] = None

    def __call__(self, x0) -> Tuple[torch.Tensor, bool]:
        x = torch.as_tensor(x0, dtype=torch.float32, device=self.op.device)
        out, stats = ndcn_forward(self.model, self.op, self.vt, x,
                                  nondiff=True, **self.forward_kwargs)
        self.last_stats = stats
        return out, stats.success


def make_server(model: NDCN, op: GraphOperator, vt, **forward_kwargs) -> Server:
    """Freeze ``model``, ``op`` and the grid ``vt`` into x0 → (out, success)."""
    return Server(model, op, vt, **forward_kwargs)
