"""The optimizer of every reference experiment, as ``ndcn_tpu/train/optim.py``.

The reference trains with ``torch.optim.Adam(params, lr, weight_decay)``:
coupled L2 (the decay joins the gradient before the moments) and eps added
after the square root of the bias-corrected second moment. The JAX package
rebuilds that update as an optax chain; the port uses it as it is.

Over a replica sweep's stacked parameters (``parallel.sweep``) the same
Adam updates every replica at once: its moments, bias correction (one step
count for all replicas, which all step together) and weight decay are
elementwise, so replica r's update is its own model's.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch

from ndcn_tpu_torch.parallel.mesh import all_reduce_grads


def torch_adam(params: Iterable[torch.Tensor], lr: float,
               weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)


def make_sgd_step(opt: torch.optim.Optimizer,
                  loss_fn: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
                  group=None):
    """One optimizer step: ``step(*args) -> (loss, aux)``, both detached.

    ``loss_fn(*args) -> (loss, aux)``; the step backpropagates the loss and
    applies the update, the counterpart of the JAX package's
    ``(params, opt_state, rng) -> (params, opt_state, loss, aux)``. With a
    node-sharded model's ``group`` the replicated parameters' gradients
    (each rank's share) are summed over it before the update, so every
    rank applies the same one."""

    def step(*args):
        opt.zero_grad(set_to_none=True)
        loss, aux = loss_fn(*args)
        loss.backward()
        all_reduce_grads([p for g in opt.param_groups for p in g["params"]],
                         group)
        opt.step()
        return loss.detach(), aux.detach()

    return step


def make_replica_sgd_step(opt: torch.optim.Optimizer,
                          loss_fn: Callable[[], Tuple[torch.Tensor,
                                                      torch.Tensor]],
                          group=None):
    """``make_sgd_step`` for a replica sweep: ``loss_fn()`` returns (losses,
    aux), one loss per replica (R,), and the step backpropagates their SUM,
    so that each replica's gradient is its own loss's (a mean would scale
    it by 1/R). A NaN loss of one replica (``ode.nan_unless``) carries a
    zero gradient; the others' are unchanged. ``group`` as
    ``make_sgd_step``'s: the model axis the replicas' nodes split over."""

    def step():
        opt.zero_grad(set_to_none=True)
        losses, aux = loss_fn()
        losses.sum().backward()
        all_reduce_grads([p for g in opt.param_groups for p in g["params"]],
                         group)
        opt.step()
        return losses.detach(), aux.detach()

    return step
