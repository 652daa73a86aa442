"""NDCN: encoder → graph-ODE block → decoder, as ``ndcn_tpu/models/ndcn.py``.

The port has the differentiable forward (the training path, backprop through
the solver) and the inference forward (``nondiff=True``), in the (n, d)
layout and the feature-major (d_sub, n) layout of the scale path, with
dropout, the ``fused`` dispatch over dense (K2) and BSR (K4) operators, and
the scale path's memory levers ``emission_dtype`` and ``residual_dtype``.
No option is ignored.

A model whose parameters are stacked along a leading replica axis
(``parallel.sweep.stack_models``: R models in one) runs R replicas at once,
``jax.vmap`` of the forward in the JAX package: the encoder maps the shared
input to an (R, n, d) state, one batched solve integrates all replicas
(``ode.adaptive.solve_batched``, ``ode.vcabm.solve_vcabm_batched`` for
adams, the fixed grids as they are; with ``adjoint=True`` the batched
continuous adjoint; the operator products are the kernels' batched forms),
and the output carries the replica axis after the time axis: (T, R, n, c),
or (R, n, c) if terminal.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ndcn_tpu_torch.graph import sparse as graph_sparse
from ndcn_tpu_torch.graph.sparse import (BsrGraph, CooGraph, DenseGraph,
                                         GraphOperator, matvec)
from ndcn_tpu_torch.kernels.bsr_spmm import bsr_fused_rhs
from ndcn_tpu_torch.kernels.coo_spmv import spmv_T, sublane_pad
from ndcn_tpu_torch.kernels.fused_rhs import fused_rhs
from ndcn_tpu_torch.models.nn import dropout_mask, linear_apply, linear_init
from ndcn_tpu_torch.ode import odeint_with_stats
from ndcn_tpu_torch.ode.api import grad_mode
from ndcn_tpu_torch.ode.adjoint import odeint_adjoint_with_stats
from ndcn_tpu_torch.parallel.coo_shard import (RowShardedCoo, is_sharded,
                                               node_group, node_rows,
                                               rs_spmv_T)
from ndcn_tpu_torch.utils.timing import span


def fused_profitable(kind: str, width: int, n: int) -> bool:
    """Whether 'auto' takes the fused kernel (K2 for a dense operator, K4 for
    a BSR one) at ``n`` nodes and hidden width ``width``, from a sweep on the
    NVIDIA H100 80GB HBM3, 700.00 W (``chip_smoke.py`` [4] and [7b]: dense
    n in {400, 1000, 4000, 10000} x width in {20, 64, 128}; BSR on the
    400-node grid and a 2000-node 5 % matrix at width in {20, 64, 128, 256,
    512}; the fused call against ``matvec`` + ``linear_apply`` + relu).

    Dense: K2 is one launch where the other route is three, and wins on the
    card while the operator is small (0.011 ms against 0.022 at 400 x 20,
    0.018 against 0.026 at 1000 x 20); from n · width of about 50,000 (400 x
    128, 1000 x 64, 4000 x 20) the two tie, and beyond that ``torch.matmul``
    is faster and takes over. BSR: K3, the other route's product, runs on
    the same tile product as K4's first phase, so K4 saves the
    launches of the linear layer and relu and pays for its second product,
    which stages all of W in every CTA: it wins at small widths (0.011 ms
    against 0.022 on the grid at 20, 0.032 against 0.045 on the 2000-node
    matrix; 0.015 against 0.023 on the grid at 64), ties at 64 on the
    2000-node matrix (0.046 against 0.045) and loses from 128 on (0.023
    against 0.021 on the grid, 0.073 against 0.061 on the 2000-node matrix;
    0.27 against 0.18 there at 512)."""
    if kind == "dense":
        return n * width <= 30_000
    return width <= 64


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


class Control(NamedTuple):
    """The control layer's weight and bias as an RHS reads them (in place
    of ``model.wt``'s, which they hold unless a solve swapped them for
    fresh leaves: ``ndcn_forward``)."""
    weight: torch.Tensor
    bias: torch.Tensor


def ode_func(model: NDCN, op: GraphOperator, t, h: torch.Tensor,
             no_graph: bool = False, no_control: bool = False,
             drop_mask: Optional[torch.Tensor] = None,
             fused=False, residual_dtype=None,
             control: Optional[Control] = None) -> torch.Tensor:
    """The learned RHS h' = relu(dropout(W·(A h) + b)), ``drop_mask`` a fixed
    inverted-dropout mask. ``residual_dtype`` rounds the SpMV output through
    that dtype before the control layer consumes it (the JAX package's saved
    residual; the forward and backward see the same rounded values).
    ``control``: W and b in place of ``model.wt``'s.

    ``fused`` routes relu((A h) W + b) through K2 (dense operator) or K4
    (BSR operator):
    - False: never fuse.
    - True: force the fused kernel; the configuration must be fusable (a
      dense or BSR operator, graph and control on, no dropout), else
      ValueError.
    - "auto": fuse when fusable and ``fused_profitable``; otherwise the
      standard path, silently."""
    wt = model.wt if control is None else control
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
        n, width = h.shape[-2:]
        w_t = wt.weight.transpose(-1, -2)
        if dense_ok and (fused is True or fused_profitable("dense", width, n)):
            return fused_rhs(op.mat, h, w_t, wt.bias)
        if bsr_ok and (fused is True or fused_profitable("bsr", width, n)):
            return bsr_fused_rhs(op.fwd, op.bwd, h, w_t, wt.bias)
    if not no_graph:
        h = matvec(op, h)
    if residual_dtype is not None and not no_graph and not no_control:
        h = rounded_control(wt.weight, wt.bias, h, residual_dtype, False)
    else:
        if residual_dtype is not None and not no_graph:
            h = h.to(residual_dtype).to(torch.float32)
        if not no_control:
            h = linear_apply(wt, h)
    if drop_mask is not None:
        h = h * drop_mask
    return torch.relu(h)


def ode_block(func, h0: torch.Tensor, vt, rtol: float, atol: float,
              method: str, terminal: bool = False, adjoint: bool = False,
              params=None, max_steps: int = 256, nondiff: bool = False,
              emission_dtype=None, emission_readout=None,
              batched: bool = False, node_group=None, scan: bool = False):
    """odeint wrapper mirroring ODEBlock semantics; returns (out, stats).
    ``scan``: the adaptive methods' solve is the bounded one (the solve's
    ``scan`` option: ``ode.adaptive.solve_scan`` for dopri5 and tsit5,
    ``ode.vcabm.solve_vcabm_scan`` for adams), and with ``adjoint`` the
    forward and the backward's interval solves are its inference form; the
    fixed-grid and fixed-order methods solve as they are (their loop reads
    nothing).
    ``batched``: h0 carries a leading replica axis (one batched solve).
    ``node_group``: the process group h0's node rows split over (the
    solve's option of that name: its norms are over every rank's rows).

    With ``adjoint=True`` the gradients come from the continuous adjoint
    (``ode.adjoint``), taken for h0 and ``params``, the tensors the RHS
    closes over (stacked, when ``batched``): a list the RHS reads them from
    at each call, which the adjoint's VJPs swap for fresh leaves, or a
    tuple; the stats are the forward solve's. With ``scan`` and without
    it, ``params`` (such a list, then also what ``emission_readout`` reads)
    reaches the bounded solve, whose attempts return those gradients
    themselves (the solve's ``params`` option: a captured step gates each
    attempt's backward too). The emission options
    reach the solver on the differentiable adaptive path only, as the JAX
    package's ``ode_block`` passes them (not under the adjoint)."""
    if adjoint:
        if params is None:
            raise ValueError("adjoint=True requires the params the RHS "
                             "closes over")
        options = {"max_steps": max_steps}
        if batched:
            options["batched"] = True
        if node_group is not None:
            options["node_group"] = node_group
        if scan:
            options["scan"] = True
        sol, stats = odeint_adjoint_with_stats(
            func, h0, vt, params, rtol=rtol, atol=atol, method=method,
            options=options)
        return (sol[-1] if terminal else sol), stats
    options = {"max_steps": max_steps, "differentiable": not nondiff}
    if batched:
        options["batched"] = True
    if node_group is not None:
        options["node_group"] = node_group
    if scan:
        options["scan"] = True
        if params is not None:
            options["params"] = params
    if method in ("dopri5", "tsit5") and not nondiff:
        options.update(emission_dtype=emission_dtype,
                       emission_readout=emission_readout)
    sol, stats = odeint_with_stats(func, h0, vt, rtol=rtol, atol=atol,
                                   method=method, options=options)
    return (sol[-1] if terminal else sol), stats


def replica_count(model) -> Optional[int]:
    """R for a model stacked from R replicas (``parallel.sweep``), None for
    one model."""
    return getattr(model, "replicas", None)


# Above this node count 'auto' picks the feature-major layout, as the JAX
# package does (there for TPU memory: the (n, d) layout's saved residuals pad
# to 128 lanes). On the card neither layout pads; the threshold is kept so
# that the two packages solve the same problem the same way.
_FEATURE_MAJOR_AUTO_NODES = 500_000


def _feature_major_ok(op, h, no_graph, no_control, dropout, fused) -> bool:
    """The JAX package's eligibility predicate for the feature-major solve:
    a COO operator that serves the SpMV kernels (``use_tiled_kernel``), the
    full RHS (graph and control on, dropout 0, unfused), and a hidden width
    above 1 that is not a multiple of 128."""
    return (isinstance(op, (CooGraph, RowShardedCoo))
            and not (no_graph or no_control or dropout > 0.0 or fused)
            and h.ndim == 2 and h.shape[1] > 1 and h.shape[1] % 128 != 0
            and graph_sparse.use_tiled_kernel(op))


def resolve_layout(layout: str, op, h: torch.Tensor, no_graph: bool = False,
                   no_control: bool = False, dropout: float = 0.0,
                   fused=False) -> str:
    """'nd' or 'feature_major' for the encoded state ``h`` (n, d), as
    ``ndcn_forward`` resolves ``layout``; an explicit 'feature_major' that is
    not eligible raises."""
    if layout not in ("auto", "nd", "feature_major"):
        raise ValueError(f"unknown layout {layout!r}")
    ok = _feature_major_ok(op, h, no_graph, no_control, dropout, fused)
    if layout == "feature_major" and not ok:
        raise ValueError("layout='feature_major' requires a COO operator on "
                         "the card with the full RHS (graph + control on, "
                         "dropout 0, unfused) and a hidden width above 1 "
                         "that is not a multiple of 128")
    if layout == "auto":
        nodes = op.n if is_sharded(op) else h.shape[0]
        return ("feature_major"
                if nodes >= _FEATURE_MAJOR_AUTO_NODES and ok else "nd")
    return layout


class _RoundedControl(torch.autograd.Function):
    """The control layer W·r + b (without relu) where r is the SpMV output
    rounded to ``dtype``: the forward consumes the rounded values and the
    tape keeps the ``dtype`` copy, not a float32 one (the JAX package saves
    the rounded residual). The rounding's gradient passes through unchanged.
    ``weight`` is ``nn.Linear``'s (out, in); ``feature_major`` says whether
    ah is (d, n) (out = weight·r + b) or (n, d) (out = r·weightᵀ + b)."""

    @staticmethod
    def forward(ctx, weight, bias, ah, dtype, feature_major):
        r = ah.to(dtype)
        ctx.save_for_backward(weight, r)
        ctx.feature_major = feature_major
        rf = r.to(ah.dtype)
        if feature_major:
            return torch.addmm(bias[:, None], weight, rf)
        if ah.ndim == 3:        # R replicas, each with its own layer
            return torch.baddbmm(bias.unsqueeze(-2), rf,
                                 weight.transpose(-1, -2))
        return torch.addmm(bias, rf, weight.t())

    @staticmethod
    def backward(ctx, g):
        weight, r = ctx.saved_tensors
        rf = r.to(g.dtype)
        if ctx.feature_major:
            dw, db, dah = g @ rf.t(), g.sum(dim=1), weight.t() @ g
        else:
            dw, db, dah = (g.transpose(-1, -2) @ rf, g.sum(dim=-2),
                           g @ weight)
        need = ctx.needs_input_grad
        return (dw if need[0] else None, db if need[1] else None,
                dah if need[2] else None, None, None)


def rounded_control(weight, bias, ah, dtype,
                    feature_major: bool) -> torch.Tensor:
    return _RoundedControl.apply(weight, bias, ah, dtype, feature_major)


def ode_func_T(model: NDCN, op: CooGraph, t, hT: torch.Tensor,
               residual_dtype=None,
               control: Optional[Control] = None) -> torch.Tensor:
    """The learned RHS in feature-major form: hT (d_sub, n), rows >= d zero.

    relu((A h) W + b) transposes to relu(Wᵀ (A h)ᵀ + b[:, None]); the SpMV
    is ``spmv_T`` (K1-fm, or K5 under ``GATHER_WIDE``) and every
    intermediate keeps the node dimension minor. Wᵀ_pad and b_pad carry zero
    pad rows, so relu keeps the pad rows zero. The (d_sub × d_sub) product
    is a plain ``torch.matmul``, as the JAX package leaves it to XLA.
    ``control``: W and b in place of ``model.wt``'s."""
    wt = model.wt if control is None else control
    d_sub = hT.shape[0]
    d = wt.weight.shape[0]
    # nn.Linear stores W transposed: its weight is already Wᵀ
    w_p = F.pad(wt.weight, (0, d_sub - d, 0, d_sub - d))
    b_p = F.pad(wt.bias, (0, d_sub - d))
    ahT = (rs_spmv_T if isinstance(op, RowShardedCoo) else spmv_T)(op, hT)
    if residual_dtype is not None:
        return torch.relu(rounded_control(w_p, b_p, ahT, residual_dtype,
                                          True))
    return torch.relu(torch.addmm(b_p[:, None], w_p, ahT))


def ndcn_forward(model: NDCN, op: GraphOperator, vt, x: torch.Tensor, *,
                 rtol: float = 0.01, atol: float = 0.001,
                 method: str = "dopri5", terminal: bool = False,
                 no_embed: bool = False, no_graph: bool = False,
                 no_control: bool = False, dropout: float = 0.0,
                 rng: Optional[torch.Generator] = None, adjoint: bool = False,
                 max_steps: int = 256, nondiff: bool = False, fused=False,
                 layout: str = "auto", emission_dtype=None,
                 residual_dtype=None, scan: bool = False):
    """Full NDCN forward. Returns (output, stats).

    output: (T, n, num_classes) trajectory, or (n, num_classes) if terminal.

    ``layout``: 'nd' solves with the (n, d) state; 'feature_major' with the
    (d_sub, n) state (``resolve_layout`` says when it applies; 'auto' picks
    it from ``_FEATURE_MAJOR_AUTO_NODES`` nodes up). The feature-major error
    norm counts the zero pad rows, as the JAX package's does, which scales
    rtol by about (d_sub/d)^(1/2).

    ``emission_dtype`` (differentiable adaptive path only) rounds the dense
    output that the observations are read from; ``residual_dtype`` rounds
    the SpMV output that the control layer consumes (both layouts). See
    ``ode.adaptive`` and ``ode_func``.

    ``nondiff=True`` runs the inference solve under ``torch.no_grad()``;
    otherwise autograd records the differentiable solve: the host loop, or
    with ``scan`` the bounded solve that never reads the device
    (``ode_block``; the train step a CUDA graph records, ``train.chunk``).
    Under ``torch.export`` (``serve.export_ndcn``) the ``nondiff=True`` forward
    traces in either layout: every host decision on it is made from
    shapes and Python values. ``dropout`` > 0
    with a ``rng`` (a ``torch.Generator``) draws one mask per forward;
    without ``rng`` the forward is deterministic, as in JAX.

    On the differentiable adaptive path the decoder's weight rides through
    the solver as its ``emission_readout`` in the feature-major layout
    (always) and in the (n, d) layout when ``emission_dtype`` is set (so the
    rounded tensor is the one the JAX package rounds); otherwise the
    interpolated states are decoded afterwards, the same linear function.

    A stacked model (``replica_count(model)`` = R) runs R replicas on the
    shared ``x``: ``rng`` is then a list of R generators (or None), the
    solve is batched and the stats are a ``BatchedSolveStats`` (with
    ``adjoint=True``, an ``AdjointStats`` of per-replica tuples).

    A row-sharded operator (``parallel.coo_shard``) takes this rank's rows
    of ``x`` and gives this rank's rows of the output; the solve's norms
    are then over every rank's rows (its ``node_group`` option), and the
    dropout mask is drawn whole and cut to this rank's rows, so the ranks
    together compute the unsharded forward. With ``adjoint=True`` the
    backward solve's parameter VJPs are summed over the group
    (``ode.adjoint``)."""
    replicas = replica_count(model)
    group = node_group(op)
    with grad_mode(torch.is_grad_enabled() and not nondiff):
        h = x
        if not no_embed:
            with span("model.encode"):
                h = torch.tanh(linear_apply(model.enc1, h))
                if model.enc2 is not None:
                    h = linear_apply(model.enc2, h)
        if replicas is not None and h.ndim == x.ndim:
            h = h.expand(replicas, *h.shape).contiguous()   # no encoder
        feature_major = resolve_layout(layout, op, h, no_graph, no_control,
                                       dropout, fused) == "feature_major"

        drop_mask = None
        if dropout > 0.0 and rng is not None:
            shape = h.shape if replicas is None else h.shape[1:]
            drop_mask = dropout_mask(rng, shape, dropout, h.dtype, h.device,
                                     rows=node_rows(op))

        use_readout = (not terminal and not nondiff and not adjoint
                       and method in ("dopri5", "tsit5"))
        w_dec, b_dec = model.dec.weight, model.dec.bias   # (c, d), (c,)
        # the adjoint's VJPs are taken for the control layer, the only
        # parameters the RHS closes over (the JAX package's ode_params);
        # the RHS (and the emission readout, whose weight joins them) reads
        # them from this list at each call, so that a solve may swap them
        # for fresh leaves (ode.graph_gate.fresh_leaves)
        bound = ([] if model.wt is None or no_control
                 else [model.wt.weight, model.wt.bias])
        n_ctrl = len(bound)

        def control():
            return Control(*bound[:2]) if n_ctrl else None

        solve_kw = dict(adjoint=adjoint, params=bound,
                        max_steps=max_steps, nondiff=nondiff,
                        emission_dtype=emission_dtype,
                        batched=replicas is not None, node_group=group,
                        scan=scan)
        if feature_major:
            d = h.shape[1]
            hT = F.pad(h, (0, sublane_pad(d) - d)).t().contiguous()

            def func_T(t, hh):
                return ode_func_T(model, op, t, hh,
                                  residual_dtype=residual_dtype,
                                  control=control())

            # decode in feature-major form: the readout keeps (T, c, n)
            # where the full trajectory would be (T, d_sub, n)
            readout = None
            if use_readout:
                bound.append(w_dec)
                readout = lambda s: bound[-1] @ s[:d]  # noqa: E731
            sol_T, stats = ode_block(func_T, hT, vt, rtol, atol, method,
                                     terminal=terminal,
                                     emission_readout=readout, **solve_kw)
            with span("model.decode"):
                if terminal:
                    return linear_apply(model.dec, sol_T[:d].t()), stats
                out_T = (sol_T if use_readout else
                         torch.einsum("cd,tdn->tcn", w_dec, sol_T[:, :d]))
                out_T = out_T + b_dec[:, None]
                return out_T.permute(0, 2, 1), stats        # (T, n, c)

        def func(t, hh):
            return ode_func(model, op, t, hh, no_graph=no_graph,
                            no_control=no_control, drop_mask=drop_mask,
                            fused=fused, residual_dtype=residual_dtype,
                            control=control())

        if use_readout and emission_dtype is not None:
            bound.append(w_dec)
            sol, stats = ode_block(
                func, h, vt, rtol, atol, method,
                emission_readout=lambda s: s @ bound[-1].transpose(-1, -2),
                **solve_kw)
            with span("model.decode"):
                return sol + b_dec.unsqueeze(-2), stats
        hvx, stats = ode_block(func, h, vt, rtol, atol, method,
                               terminal=terminal, **solve_kw)
        with span("model.decode"):
            out = linear_apply(model.dec, hvx)
    return out, stats
