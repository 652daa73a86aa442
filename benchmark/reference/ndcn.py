"""The plain reference of an NDCN train step (Zang & Wang, KDD 2020):
encoder, graph neural ODE, decoder, L1 loss, backpropagation through the
solver and Adam, in plain PyTorch.

- the normalized Laplacian I - D^-1/2 A D^-1/2 (a node of degree 0 keeps
  its identity row), worked out here from the adjacency;
- the encoder h0 = tanh(x0 W1ᵀ + b1) W2ᵀ + b2, the ODE h' = relu((A h) Wᵀ +
  b) solved by ``dopri5.odeint`` at the observation times, the decoder
  y = h Wdᵀ + bd at each observation;
- the loss: the mean absolute error over every observation and node;
- Adam as ``torch.optim.Adam`` defines it: the weight decay joins the
  gradient before the moments, eps after the square root of the
  bias-corrected second moment.

The parameters are a dict of the leaves by name (``LEAVES``), each a
``nn.Linear``-shaped weight (out, in) or bias (out,).
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from benchmark.reference import dopri5
from benchmark.reference.products import Products

LEAVES = ("enc1.weight", "enc1.bias", "enc2.weight", "enc2.bias",
          "wt.weight", "wt.bias", "dec.weight", "dec.bias")


def normalized_laplacian(adj, device: torch.device, dense: bool):
    """I - D^-1/2 A D^-1/2 of a symmetric adjacency (a numpy array or scipy
    sparse) in float64 on ``device``: a dense tensor, or a sparse CSR one.
    The degrees are row sums of A."""
    if not sp.issparse(adj):
        a = torch.as_tensor(np.asarray(adj), dtype=torch.float64,
                            device=device)
        deg = a.sum(1)
        inv = torch.where(deg > 0, deg.clamp(min=1e-300) ** -0.5,
                          torch.zeros_like(deg))
        lap = torch.eye(a.shape[0], dtype=torch.float64, device=device) \
            - inv[:, None] * a * inv[None, :]
        return lap if dense else lap.to_sparse_csr()
    csr = sp.csr_matrix(adj)
    n = csr.shape[0]
    indptr = torch.as_tensor(csr.indptr, dtype=torch.int64, device=device)
    cols = torch.as_tensor(csr.indices, dtype=torch.int64, device=device)
    vals = torch.as_tensor(csr.data, dtype=torch.float64, device=device)
    rows = torch.repeat_interleave(torch.arange(n, device=device),
                                   indptr.diff())
    deg = torch.zeros(n, dtype=torch.float64, device=device).index_add_(
        0, rows, vals)
    inv = torch.where(deg > 0, deg.clamp(min=1e-300) ** -0.5,
                      torch.zeros_like(deg))
    diag = torch.arange(n, device=device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "beta", invariants
        lap = torch.sparse_coo_tensor(
            torch.stack([torch.cat([rows, diag]), torch.cat([cols, diag])]),
            torch.cat([-inv[rows] * vals * inv[cols],
                       torch.ones(n, dtype=torch.float64, device=device)]),
            (n, n)).coalesce()
        return lap.to_dense() if dense else lap.to_sparse_csr()


class StepRecord(NamedTuple):
    """What the reference's first steps give: each step's loss and solve
    stats, the first gradient as Adam takes it (with the weight decay), the
    first raw gradient, and the parameters after the steps."""
    losses: List[float]
    stats: List[dopri5.Stats]
    first_grad: Dict[str, torch.Tensor]
    first_raw_grad: Dict[str, torch.Tensor]
    params: Dict[str, torch.Tensor]


def _linear(prod: Products, x, w, b):
    return prod.mm(x, w.t()) + b


def forward(prod: Products, params, op: Callable, x0, t, rtol, atol,
            norm_count: Optional[int] = None):
    """The trajectory (T, n, c) and the solve's stats."""
    h = torch.tanh(_linear(prod, x0, params["enc1.weight"],
                           params["enc1.bias"]))
    h = _linear(prod, h, params["enc2.weight"], params["enc2.bias"])
    w, b = params["wt.weight"], params["wt.bias"]

    def func(_t, y):
        return torch.relu(_linear(prod, op(y), w, b))

    sol, stats = dopri5.odeint(func, h, t, rtol, atol, norm_count=norm_count)
    out = torch.stack([_linear(prod, s, params["dec.weight"],
                               params["dec.bias"]) for s in sol])
    return out, stats


def train_steps(prod: Products, params0: Dict[str, torch.Tensor],
                op: Callable, x0: torch.Tensor, target: torch.Tensor,
                t: torch.Tensor, *, rtol: float, atol: float, lr: float,
                weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8,
                steps: int = 3, norm_count: Optional[int] = None,
                loss_rows: Optional[int] = None) -> StepRecord:
    """``steps`` full-batch train steps from ``params0`` (copied to the
    mode's dtype); ``target`` (T, n, c). ``loss_rows`` takes the loss over
    the first rows only (the half-batch fault)."""
    dt = prod.dtype
    params = {k: params0[k].detach().to(dt).clone().requires_grad_(True)
              for k in LEAVES}
    x0, target = x0.to(dt), target.to(dt)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2 = betas
    losses, stats, first, first_raw = [], [], {}, {}
    for step in range(1, steps + 1):
        out, st = forward(prod, params, op, x0, t, rtol, atol, norm_count)
        if loss_rows is None:
            loss = torch.mean(torch.abs(out - target))
        else:
            loss = torch.mean(torch.abs(out[:, :loss_rows]
                                        - target[:, :loss_rows]))
        grads = torch.autograd.grad(loss, [params[k] for k in LEAVES])
        losses.append(float(loss.detach()))
        stats.append(st)
        with torch.no_grad():
            for k, g in zip(LEAVES, grads):
                p = params[k]
                g_eff = g + weight_decay * p
                if step == 1:
                    first[k], first_raw[k] = g_eff.clone(), g.clone()
                m[k].mul_(b1).add_(g_eff, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g_eff, g_eff, value=1 - b2)
                bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
                denom = (v[k].sqrt() / bc2 ** 0.5).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / bc1)
    return StepRecord(losses, stats, first, first_raw,
                      {k: p.detach() for k, p in params.items()})
