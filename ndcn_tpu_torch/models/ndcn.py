"""NDCN: encoder → graph-ODE block → decoder, as ``ndcn_tpu/models/ndcn.py``.

The port has the differentiable forward (the training path, backprop through
the solver) and the inference forward (``nondiff=True``), in ``layout="nd"``,
with dropout and the ``fused`` dispatch over dense (K2) and BSR (K4)
operators. Options that belong to later slices raise ``NotImplementedError``
naming their ROADMAP item; none is ignored.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ndcn_tpu_torch.graph.sparse import (BsrGraph, DenseGraph, GraphOperator,
                                         matvec)
from ndcn_tpu_torch.kernels.bsr_spmm import bsr_fused_rhs
from ndcn_tpu_torch.kernels.fused_rhs import fused_rhs
from ndcn_tpu_torch.models.nn import dropout_mask, linear_apply, linear_init
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
             drop_mask: Optional[torch.Tensor] = None,
             fused=False) -> torch.Tensor:
    """The learned RHS h' = relu(dropout(W·(A h) + b)), ``drop_mask`` a fixed
    inverted-dropout mask (the SpMV residual dtype waits for ROADMAP item 4).

    ``fused`` routes relu((A h) W + b) through K2 (dense operator) or K4
    (BSR operator):
    - False: never fuse.
    - True: force the fused kernel; the configuration must be fusable (a
      dense or BSR operator, graph and control on, no dropout), else
      ValueError.
    - "auto": fuse when fusable and ``fused_profitable``; otherwise the
      standard path, silently."""
    if fused:
        if fused is not True and fused != "auto":
            raise ValueError(f"fused must be False, True or 'auto'; got {fused!r}")
        fusable = not no_graph and not no_control and drop_mask is None
        dense_ok = fusable and isinstance(op, DenseGraph)
        bsr_ok = fusable and isinstance(op, BsrGraph)
        if fused is True and not (dense_ok or bsr_ok):
            raise ValueError(
                "fused=True requires a dense or BSR operator with control on "
                f"and dropout 0 (got {type(op).__name__}, no_graph={no_graph},"
                f" no_control={no_control}, dropout="
                f"{'on' if drop_mask is not None else 'off'}); use "
                "fused='auto' (or drop the flag) for the standard path")
        width = h.shape[-1]
        if dense_ok and (fused is True or fused_profitable("dense", width)):
            return fused_rhs(op.mat, h, model.wt.weight.t(), model.wt.bias)
        if bsr_ok and (fused is True or fused_profitable("bsr", width)):
            return bsr_fused_rhs(op.fwd, op.bwd, h, model.wt.weight.t(),
                                 model.wt.bias)
    if not no_graph:
        h = matvec(op, h)
    if not no_control:
        h = linear_apply(model.wt, h)
    if drop_mask is not None:
        h = h * drop_mask
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
    scale path. ``nondiff=True`` runs the inference solve under
    ``torch.no_grad()``; otherwise autograd records the differentiable solve.
    ``dropout`` > 0 with a ``rng`` (a ``torch.Generator``) draws one mask per
    forward; without ``rng`` the forward is deterministic, as in JAX.

    The JAX package folds the decoder's weight into the solver's emissions
    (``emission_readout``); decoding the interpolated states afterwards, as
    here, computes the same linear function."""
    if layout not in ("auto", "nd", "feature_major"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "feature_major":
        raise NotImplementedError("layout='feature_major' is not ported yet: "
                                  "ROADMAP item 4")
    if emission_dtype is not None or residual_dtype is not None:
        raise NotImplementedError("emission_dtype / residual_dtype are not "
                                  "ported yet: ROADMAP item 4")
    with torch.set_grad_enabled(torch.is_grad_enabled() and not nondiff):
        h = x
        if not no_embed:
            h = torch.tanh(linear_apply(model.enc1, h))
            if model.enc2 is not None:
                h = linear_apply(model.enc2, h)

        drop_mask = None
        if dropout > 0.0 and rng is not None:
            drop_mask = dropout_mask(rng, h.shape, dropout, h.dtype, h.device)

        def func(t, hh):
            return ode_func(model, op, t, hh, no_graph=no_graph,
                            no_control=no_control, drop_mask=drop_mask,
                            fused=fused)

        hvx, stats = ode_block(func, h, vt, rtol, atol, method,
                               terminal=terminal, adjoint=adjoint,
                               max_steps=max_steps, nondiff=nondiff)
        out = linear_apply(model.dec, hvx)
    return out, stats
