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
from ndcn_tpu_torch.utils.timing import span


def torch_adam(params: Iterable[torch.Tensor], lr: float,
               weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8,
               capturable: bool = False) -> torch.optim.Adam:
    """The reference's Adam; ``capturable`` gives ``CapturableAdam``, whose
    update a CUDA graph can record (the chunked train step, ``train.chunk``),
    on the CPU too."""
    cls = CapturableAdam if capturable else torch.optim.Adam
    return cls(params, lr=lr, betas=(b1, b2), eps=eps,
               weight_decay=weight_decay)


class CapturableAdam(torch.optim.Adam):
    """``torch.optim.Adam`` whose step count is a 0-dim float32 tensor on
    each parameter's device and whose update is ``torch.optim.Adam(
    capturable=True)``'s arithmetic (the bias corrections and the step size
    as device tensors; coupled L2, eps after the square root), on any
    device: PyTorch's own capturable update refuses the CPU, and the
    chunked step runs one optimizer on the card (graphed) and on the CPU
    (eager). The update reads nothing on the host, so a CUDA graph can
    record it. It rounds the step size otherwise than the default Adam,
    whose bias corrections are host floats: the two part in the last bits.
    At lr 0 it leaves the parameters alone (the capturable form would
    divide by the zero step size), and still updates the moments.

    Its hyper-parameters and ``state_dict`` are ``torch.optim.Adam``'s
    (``capturable`` False in the groups), so that either loads the other's
    checkpoints; a loaded step count moves to its parameter's device."""

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for p, state in self.state.items():
            if "step" in state:
                state["step"] = torch.as_tensor(
                    state["step"], dtype=torch.float32).to(p.device)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("CapturableAdam.step takes no closure")
        for group in self.param_groups:
            beta1, beta2 = group["betas"]
            lr, eps = group["lr"], group["eps"]
            weight_decay = group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32,
                                                device=p.device)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                step_t = state["step"]
                exp_avg, exp_avg_sq = state["exp_avg"], state["exp_avg_sq"]
                step_t += 1
                grad = p.grad
                if weight_decay != 0:
                    grad = grad.add(p, alpha=weight_decay)
                exp_avg.lerp_(grad, 1 - beta1)
                exp_avg_sq.mul_(beta2).addcmul_(grad, grad, value=1 - beta2)
                if lr == 0:
                    # the capturable form divides by the step size
                    continue
                bias_correction1 = 1 - beta1 ** step_t
                bias_correction2 = 1 - beta2 ** step_t
                step_size_neg = (lr / bias_correction1).neg()
                denom = (exp_avg_sq.sqrt()
                         / (bias_correction2.sqrt() * step_size_neg)
                         ).add_(eps / step_size_neg)
                p.addcdiv_(exp_avg, denom)
        return None


def make_sgd_step(opt: torch.optim.Optimizer,
                  loss_fn: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
                  group=None):
    """One optimizer step: ``step(*args) -> (loss, aux)``, both detached.

    ``loss_fn(*args) -> (loss, aux)``; the step backpropagates the loss and
    applies the update, the counterpart of the JAX package's
    ``(params, opt_state, rng) -> (params, opt_state, loss, aux)``. With a
    node-sharded model's ``group`` the replicated parameters' gradients
    (each rank's share) are summed over it before the update, so every
    rank applies the same one.

    Its spans (``utils.timing.span``): ``train.step`` around
    ``train.forward``, ``train.backward`` (with the all-reduce) and
    ``train.optimizer``."""

    def step(*args):
        with span("train.step"):
            opt.zero_grad(set_to_none=True)
            with span("train.forward"):
                loss, aux = loss_fn(*args)
            with span("train.backward"):
                loss.backward()
                all_reduce_grads(
                    [p for g in opt.param_groups for p in g["params"]], group)
            with span("train.optimizer"):
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
    ``make_sgd_step``'s: the model axis the replicas' nodes split over.
    The spans are ``make_sgd_step``'s."""

    def step():
        with span("train.step"):
            opt.zero_grad(set_to_none=True)
            with span("train.forward"):
                losses, aux = loss_fn()
            with span("train.backward"):
                losses.sum().backward()
                all_reduce_grads(
                    [p for g in opt.param_groups for p in g["params"]], group)
            with span("train.optimizer"):
                opt.step()
            return losses.detach(), aux.detach()

    return step
