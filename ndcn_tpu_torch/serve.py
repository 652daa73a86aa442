"""Serving: the NDCN inference forward frozen around a model, an operator and
an observation grid, answering x0 → (trajectory, success).

The counterpart of ``ndcn_tpu/serve.py``, with the same keyword surface:
``forward_kwargs`` pass through to ``ndcn_forward``, the solve is forced
onto the inference path, and ``nondiff`` / ``adjoint`` from a training
config are dropped. ``success`` is the solver's budget / underflow flag:
serve a failed answer loudly, never silently. Two ways to serve:

- In-process, ``make_server`` / ``Server``: the eager forward, with the
  solver's host loop (``ode.adaptive.solve``, one host read an attempt).
- The portable artifact, ``export_ndcn`` / ``load_ndcn``: ``torch.export``
  of the whole inference forward (encoder, the solve over the frozen grid,
  the operator's products, decoder) into bytes, which ``save_artifact``
  writes. The adaptive solves are one device-resident ``while_loop`` each
  (dopri5 / tsit5: ``ode.adaptive.solve_while``; adams: the masked VCABM
  machine, ``ode.vcabm.solve_vcabm_while``); the fixed grids (euler,
  midpoint, rk4, explicit_adams, fixed_adams) are unrolled over the frozen
  grid. Either layout exports: the (n, d) state, and the feature-major
  (d_sub, n) state that ``layout="auto"`` picks from 500k nodes on a COO
  operator. Parameters, the operator's arrays and the grid are baked in as
  the program's buffers (dense, contiguous copies); the runtime input is
  x0 alone. The kernels are in the program as the operators of
  ``kernels.ops``: an artifact exported on CUDA tensors launches K1, K1-fm
  (pack and gather) or K5, K2, K3 and K4 on the card, one exported on the
  CPU runs their plain versions. The artifact records the device it was
  exported on (as the JAX one records its platform) and is served there.

The artifact loads without the model code. A process that serves it
imports torch and ``ndcn_tpu_torch.kernels`` (which registers the kernels'
operators; their library builds from the repository's sources at the first
launch), and nothing of the port's models, solvers, graphs or this module:
the port's counterpart of the JAX artifact loading with jax alone::

    import torch
    import ndcn_tpu_torch.kernels  # noqa: F401  (the operators)
    program = torch.export.load(path).module()
    out, success = program(x0)     # x0 on the artifact's device

``load_ndcn`` does that and moves x0 to the recorded device.
"""

from __future__ import annotations

import copy
import io
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ndcn_tpu_torch.graph.sparse import GraphOperator
from ndcn_tpu_torch.models.ndcn import NDCN, ndcn_forward
from ndcn_tpu_torch.ode import SolveStats
from ndcn_tpu_torch.utils.io import atomic_write

# the name under which an artifact records its device
_DEVICE_FILE = "ndcn_device"


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


def _hold(module: nn.Module, prefix: str, tree):
    """``tree`` (a tensor, a NamedTuple of them, or a plain value) with
    every tensor registered on ``module`` as a buffer, a dense contiguous
    copy; returns the tree of buffer names and plain values that
    ``_tree`` rebuilds it from."""
    if isinstance(tree, torch.Tensor):
        module.register_buffer(prefix, tree.detach().clone().contiguous())
        return _Buffer(prefix)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_hold(module, f"{prefix}_{name}", v)
                            for name, v in zip(tree._fields, tree)))
    return tree


class _Buffer(str):
    """A buffer's name in a tree that ``_hold`` made."""


def _tree(module: nn.Module, held):
    if isinstance(held, _Buffer):
        return getattr(module, held)
    if isinstance(held, tuple) and hasattr(held, "_fields"):
        return type(held)(*(_tree(module, v) for v in held))
    return held


class _Program(nn.Module):
    """What ``export_ndcn`` traces: x0 → (output, success) for a frozen
    model, operator and grid."""

    def __init__(self, model: NDCN, op: GraphOperator, vt: torch.Tensor,
                 forward_kwargs: dict):
        super().__init__()
        # a frozen copy: the program's weights take no gradient
        self.model = copy.deepcopy(model).requires_grad_(False)
        self.op = _hold(self, "op", op)
        self.register_buffer("vt", vt.to(op.device).contiguous())
        self.forward_kwargs = forward_kwargs

    def forward(self, x):
        out, stats = ndcn_forward(self.model, _tree(self, self.op), self.vt,
                                  x, nondiff=True, **self.forward_kwargs)
        success = stats.success
        if not isinstance(success, torch.Tensor):
            # the fixed-grid methods always arrive
            success = torch.tensor(success, device=x.device)
        return out, success


def export_ndcn(model: NDCN, op: GraphOperator, vt, x_shape: Sequence[int],
                *, x_dtype: torch.dtype = torch.float32,
                **forward_kwargs) -> bytes:
    """Serialize the NDCN inference forward to a portable artifact on
    ``op``'s device; hand the bytes to ``save_artifact`` / ``load_ndcn``.

    ``forward_kwargs`` pass through to ``models.ndcn_forward`` (rtol / atol
    / method / terminal / max_steps / fused / layout / the ablations); the
    solve is forced onto the inference path. Every method exports, in
    either layout (see the module docstring). ``vt`` must be a
    strictly increasing 1-D grid: it is checked here, on the host, since
    the traced solve cannot read it."""
    # the artifact always serves the inference path: drop the training
    # switches a caller mirrors from their training config
    forward_kwargs.pop("nondiff", None)
    forward_kwargs.pop("adjoint", None)
    grid = np.asarray(torch.as_tensor(vt).detach().cpu(), np.float64)
    if grid.ndim != 1 or grid.shape[0] < 2 or not np.all(np.diff(grid) > 0):
        raise ValueError("export_ndcn takes a strictly increasing 1-D grid "
                         "of at least 2 points")
    vt = torch.as_tensor(vt).detach().to("cpu", torch.float32)
    program = _Program(model, op, vt, forward_kwargs).eval()
    x = torch.zeros(tuple(x_shape), dtype=x_dtype, device=op.device)
    with torch.no_grad():
        exported = torch.export.export(program, (x,))
    exported.example_inputs = None      # not x's zeros in every artifact
    buf = io.BytesIO()
    torch.export.save(exported, buf,
                      extra_files={_DEVICE_FILE: str(torch.device(op.device))})
    return buf.getvalue()


def load_ndcn(blob: bytes) -> Callable[[torch.Tensor],
                                       Tuple[torch.Tensor, torch.Tensor]]:
    """Deserialize an ``export_ndcn`` artifact into ``x0 -> (out,
    success)``, served on the device it was exported on (x0 is moved
    there, as float32)."""
    extra = {_DEVICE_FILE: ""}
    program = torch.export.load(io.BytesIO(bytes(blob)),
                                extra_files=extra).module()
    device = torch.device(extra[_DEVICE_FILE])

    def serve(x0):
        with torch.no_grad():
            return program(torch.as_tensor(x0, dtype=torch.float32,
                                           device=device))

    return serve


def save_artifact(path: str, blob: bytes) -> None:
    """Atomic write (shared helper; the checkpointing policy)."""
    atomic_write(path, blob)


def load_artifact(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()
