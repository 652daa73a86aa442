"""Ground-truth physics right-hand sides (``ndcn_tpu/dynamics/rhs.py``).

This slice ports heat diffusion, dX/dt = -k L X; the mutualistic and gene
dynamics, and ``make_rhs`` that picks among them, come with the training
drivers (ROADMAP item 3).
"""

from __future__ import annotations

import torch

from ndcn_tpu_torch.graph.sparse import GraphOperator, matvec


def heat_diffusion(op: GraphOperator, t, x: torch.Tensor,
                   k: float = 1.0) -> torch.Tensor:
    """dX/dt = -k L X. ``op`` holds the Laplacian L; the sign lives here."""
    return -k * matvec(op, x)
