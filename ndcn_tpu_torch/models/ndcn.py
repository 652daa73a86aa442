"""NDCN: encoder → graph-ODE block → decoder, as ``ndcn_tpu/models/ndcn.py``.

This slice ports the inference forward (``nondiff=True``, ``layout="nd"``)
with its ``fused`` dispatch. Options that belong to later slices raise
``NotImplementedError`` naming their ROADMAP item; none is ignored.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ndcn_tpu_torch.graph.sparse import DenseGraph, GraphOperator, matvec
from ndcn_tpu_torch.kernels.fused_rhs import fused_rhs
from ndcn_tpu_torch.models.nn import linear_apply, linear_init
from ndcn_tpu_torch.ode import odeint_with_stats


def fused_profitable(kind: str, width: int) -> bool:
    """The JAX package's fused-vs-unfused table, measured on a TPU (v5e);
    kept so that dispatch matches it. The H100's crossover is an open
    question in PERF.md."""
    if kind == "dense":
        return True
    return width >= 512


class NDCN(nn.Module):
    """enc1 → tanh → enc2 (the encoder), wt (the ODE's control layer), dec.

    ``no_embed`` runs the ODE in input space (no encoder); ``no_control``
    drops wt; ``encoder_layers`` is 2 for the dynamics tasks, 1 for the
    dgnn stack. Weights come from ``generator`` on the CPU."""

    def __init__(self, input_size: int, hidden_size: int, num_classes: int, *,
                 generator: torch.Generator, no_embed: bool = False,
                 no_control: bool = False, encoder_layers: int = 2):
        super().__init__()
        width = input_size if no_embed else hidden_size
        g = generator
        self.enc1 = (None if no_embed
                     else linear_init(input_size, hidden_size, generator=g))
        self.enc2 = (linear_init(hidden_size, hidden_size, generator=g)
                     if not no_embed and encoder_layers == 2 else None)
        self.wt = None if no_control else linear_init(width, width, generator=g)
        self.dec = linear_init(width, num_classes, generator=g)


def init_ndcn(generator: torch.Generator, input_size: int, hidden_size: int,
              num_classes: int, no_embed: bool = False, no_control: bool = False,
              encoder_layers: int = 2,
              device: Optional[torch.device] = None) -> NDCN:
    """The JAX package's ``init_ndcn`` with a ``torch.Generator`` for its key."""
    model = NDCN(input_size, hidden_size, num_classes, generator=generator,
                 no_embed=no_embed, no_control=no_control,
                 encoder_layers=encoder_layers)
    return model.to(device) if device is not None else model


def ode_func(model: NDCN, op: GraphOperator, t, h: torch.Tensor,
             no_graph: bool = False, no_control: bool = False,
             fused=False) -> torch.Tensor:
    """The learned RHS h' = relu(W·(A h) + b) (dropout waits for ROADMAP
    item 2, the SpMV residual dtype for item 4).

    ``fused`` routes relu((A h) W + b) through the K2 kernel:
    - False: never fuse.
    - True: force K2; the configuration must be fusable (a dense operator,
      graph and control on), else ValueError.
    - "auto": fuse when fusable and ``fused_profitable``; otherwise the
      standard path, silently."""
    if fused:
        if fused is not True and fused != "auto":
            raise ValueError(f"fused must be False, True or 'auto'; got {fused!r}")
        dense_ok = (not no_graph and not no_control
                    and isinstance(op, DenseGraph))
        if fused is True and not dense_ok:
            raise ValueError(
                "fused=True requires a dense operator with graph and control "
                f"on (got {type(op).__name__}, no_graph={no_graph}, "
                f"no_control={no_control}); use fused='auto' (or drop the "
                "flag) for the standard path")
        if dense_ok and (fused is True
                         or fused_profitable("dense", h.shape[-1])):
            return fused_rhs(op.mat, h, model.wt.weight.t(), model.wt.bias)
    if not no_graph:
        h = matvec(op, h)
    if not no_control:
        h = linear_apply(model.wt, h)
    return torch.relu(h)


def ode_block(func, h0: torch.Tensor, vt, rtol: float, atol: float,
              method: str, terminal: bool = False, adjoint: bool = False,
              max_steps: int = 256, nondiff: bool = False):
    """odeint wrapper mirroring ODEBlock semantics; returns (out, stats)."""
    if adjoint:
        raise NotImplementedError("the adjoint solve is not ported yet: "
                                  "ROADMAP item 5")
    sol, stats = odeint_with_stats(func, h0, vt, rtol=rtol, atol=atol,
                                   method=method,
                                   options={"max_steps": max_steps,
                                            "differentiable": not nondiff})
    return (sol[-1] if terminal else sol), stats


def ndcn_forward(model: NDCN, op: GraphOperator, vt, x: torch.Tensor, *,
                 rtol: float = 0.01, atol: float = 0.001,
                 method: str = "dopri5", terminal: bool = False,
                 no_embed: bool = False, no_graph: bool = False,
                 no_control: bool = False, dropout: float = 0.0,
                 rng: Optional[torch.Generator] = None, adjoint: bool = False,
                 max_steps: int = 256, nondiff: bool = False, fused=False,
                 layout: str = "auto", emission_dtype=None,
                 residual_dtype=None):
    """Full NDCN forward. Returns (output, stats).

    output: (T, n, num_classes) trajectory, or (n, num_classes) if terminal.
    ``layout`` 'auto' and 'nd' solve with the (n, d) state; the JAX
    package's feature-major layout is a TPU memory lever that waits for the
    scale path. The forward runs under ``torch.no_grad()``: it is the
    inference solve."""
    if layout not in ("auto", "nd", "feature_major"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "feature_major":
        raise NotImplementedError("layout='feature_major' is not ported yet: "
                                  "ROADMAP item 4")
    if emission_dtype is not None or residual_dtype is not None:
        raise NotImplementedError("emission_dtype / residual_dtype are not "
                                  "ported yet: ROADMAP item 4")
    if not nondiff:
        raise NotImplementedError("the differentiable forward (nondiff=False) "
                                  "is not ported yet: ROADMAP item 2. Pass "
                                  "nondiff=True for the inference solve")
    if dropout > 0.0:
        raise NotImplementedError("dropout > 0 is not ported yet: ROADMAP "
                                  "item 2")
    del rng  # only dropout draws from it

    with torch.no_grad():
        h = x
        if not no_embed:
            h = torch.tanh(linear_apply(model.enc1, h))
            if model.enc2 is not None:
                h = linear_apply(model.enc2, h)

        def func(t, hh):
            return ode_func(model, op, t, hh, no_graph=no_graph,
                            no_control=no_control, fused=fused)

        hvx, stats = ode_block(func, h, vt, rtol, atol, method,
                               terminal=terminal, adjoint=adjoint,
                               max_steps=max_steps, nondiff=True)
        out = linear_apply(model.dec, hvx)
    return out, stats
