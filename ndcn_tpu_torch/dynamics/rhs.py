"""Ground-truth physics right-hand sides, as ``ndcn_tpu/dynamics/rhs.py``.

- heat diffusion     dX/dt = -k L X
- mutualistic        dx_i/dt = b + x_i(1-x_i/k)(x_i/c-1)
                              + sum_j A_ij x_i x_j / (d + e x_i + h x_j)
- gene regulation    dx_i/dt = -b x_i^f + sum_j A_ij x_j^h/(1+x_j^h)

The mutualistic interaction is one (n, n, d) contraction on a dense
operator, an (n, k, d) gather on an ELL one, and K1-w
(``kernels.coo_mutual``) on a COO one; BSR blocks do not expose the edges'
endpoints, so it refuses them. The gene coupling is one ``matvec`` (K1 on
COO, where a width-1 state is never rounded to bf16).
"""

from __future__ import annotations

from functools import partial

import torch

from ndcn_tpu_torch.graph.sparse import (CooGraph, DenseGraph, EllGraph,
                                         GraphOperator, matvec)
from ndcn_tpu_torch.kernels.coo_mutual import coo_mutual_inter


def heat_diffusion(op: GraphOperator, t, x: torch.Tensor,
                   k: float = 1.0) -> torch.Tensor:
    """dX/dt = -k L X. ``op`` holds the Laplacian L; the sign lives here."""
    return -k * matvec(op, x)


def gene_dynamics(op: GraphOperator, t, x: torch.Tensor, b: float = 1.0,
                  f: float = 1.0, h: float = 2.0) -> torch.Tensor:
    """Michaelis-Menten regulatory dynamics; the coupling is one matvec."""
    activation = x ** h / (x ** h + 1.0)
    return -b * (x ** f) + matvec(op, activation)


def mutualistic_dynamics(op: GraphOperator, t, x: torch.Tensor,
                         b: float = 0.1, k: float = 5.0, c: float = 1.0,
                         d: float = 5.0, e: float = 0.9, h: float = 0.1,
                         convention: str = "reference") -> torch.Tensor:
    """Logistic growth with a saturating pairwise mutualistic interaction,
    sum_j A_ij x_im x_jm / (d + e x_im + h x_jm) for node i, feature m.

    ``convention``: 'reference' (the default) evaluates d + e x_j + h x_i,
    as the reference's d=1 matrix form that its experiments run; 'paper'
    the written equation. The swap of e and h happens here, so every path
    below, the backward included, sees the swapped pair."""
    if convention == "reference":
        e, h = h, e
    elif convention != "paper":
        raise ValueError("convention must be 'reference' or 'paper'")
    growth = b + x * (1.0 - x / k) * (x / c - 1.0)
    if isinstance(op, DenseGraph):
        xi = x[:, None, :]                        # (n, 1, dim)
        xj = x[None, :, :]                        # (1, n, dim)
        pair = (xi * xj) / (d + e * xi + h * xj)  # (n, n, dim)
        inter = torch.einsum("ij,ijm->im", op.mat.to(x.dtype), pair)
    elif isinstance(op, CooGraph):
        inter = coo_mutual_inter(op, x, d, e, h)
    elif isinstance(op, EllGraph):
        xj = x[op.cols]                           # (n, K, dim)
        xi = x[:, None, :]                        # (n, 1, dim)
        pair = (xi * xj) / (d + e * xi + h * xj)  # (n, K, dim)
        inter = torch.einsum("nk,nkm->nm", op.vals.to(x.dtype), pair)
    else:
        raise ValueError("mutualistic couples through neighbour STATES; use "
                         "a dense, ELL or COO operator (BSR blocks do not "
                         "expose per-edge endpoints)")
    return growth + inter


_RHS = {
    "heat": heat_diffusion,
    "mutualistic": mutualistic_dynamics,
    "gene": gene_dynamics,
}

DYNAMICS = tuple(_RHS)


def make_rhs(kind: str, op: GraphOperator, **params):
    """Bind a dynamics kind and operator into an ``f(t, x)`` for odeint."""
    if kind not in _RHS:
        raise ValueError(f"unknown dynamics {kind!r}; choose from {DYNAMICS}")
    return partial(_RHS[kind], op, **params)
