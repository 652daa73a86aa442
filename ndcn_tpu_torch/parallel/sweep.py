"""Replica sweeps on one GPU, as ``ndcn_tpu/parallel/sweep.py`` without its
mesh (``make_sharded_ndcn_train_step(mesh=None, ...)``, the single-device
reference of a replica step).

R independent models train in one launch stream: their parameters are
stacked along a new leading axis into one module (``stack_models``), the
models' forwards run all replicas at once (``models.ndcn``,
``models.gcn_zoo``; the ODE is one batched solve and each operator product
one launch of a kernel's batched form), and one Adam step updates every
replica. Replica r computes what its own model computes:

- the loss is the SUM of the per-replica losses, so replica r's gradient is
  its own loss's gradient;
- Adam is elementwise (its moments, bias correction and weight decay), so
  replica r's update is its own model's update;
- a replica whose solve ran out of budget reads NaN through ``torch.where``
  (``ode.nan_unless``): its gradient is zero, as under ``jax.vmap`` of the
  JAX step, and the other replicas' updates do not see it.

There is no Python loop over replicas on the device's path: the host loops
over them only to draw each replica's init and dropout masks from its own
generator, on the CPU.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from ndcn_tpu_torch.models.ndcn import init_ndcn, ndcn_forward, replica_count
from ndcn_tpu_torch.ode import nan_unless
from ndcn_tpu_torch.train.optim import make_replica_sgd_step, torch_adam


def _set_parameter(module: nn.Module, name: str, value: nn.Parameter):
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    setattr(module, leaf, value)


def stack_models(models: Sequence[nn.Module]) -> nn.Module:
    """One module holding R models of one structure: every parameter is the
    R models' parameters stacked along a new leading axis, and
    ``replica_count`` of it is R."""
    if not models:
        raise ValueError("stack_models needs at least one model")
    stacked = copy.deepcopy(models[0])
    for name, _ in models[0].named_parameters():
        _set_parameter(stacked, name, nn.Parameter(torch.stack(
            [m.get_parameter(name).detach() for m in models])))
    stacked.replicas = len(models)
    return stacked


def unstack_model(stacked: nn.Module, i: int) -> nn.Module:
    """Replica ``i`` of a stacked module, as a model of its own (a copy)."""
    one = copy.deepcopy(stacked)
    for name, p in stacked.named_parameters():
        _set_parameter(one, name, nn.Parameter(p.detach()[i].clone()))
    del one.replicas
    return one


def replica_generators(seed: int, replicas: int) -> List[torch.Generator]:
    """The R generators of a sweep: replica i's is seeded ``seed + i`` (on
    the CPU), so replica i draws what a single run at seed ``seed + i``
    draws."""
    return [torch.Generator().manual_seed(seed + i) for i in range(replicas)]


def batched_init(init_fn: Callable[[torch.Generator], nn.Module],
                 generators: Sequence[torch.Generator],
                 device: Optional[torch.device] = None) -> nn.Module:
    """``init_fn`` once per generator, stacked: the counterpart of
    ``jax.vmap(init_fn)(keys)``."""
    model = stack_models([init_fn(g) for g in generators])
    return model.to(device) if device is not None else model


def replica_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The L1 loss of each replica: pred (R, ...) against a shared target
    (...), one mean per replica, (R,)."""
    diff = torch.abs(pred - target)
    return diff.reshape(diff.shape[0], -1).mean(dim=1)


def make_ndcn_replica_train_step(op, vt, x0: torch.Tensor,
                                 target: torch.Tensor, *, rtol: float = 0.01,
                                 atol: float = 0.001, method: str = "dopri5",
                                 lr: float = 0.01, weight_decay: float = 1e-3,
                                 max_steps: int = 64, hidden: int = 20,
                                 fused=False):
    """A multi-replica NDCN training step on one device; the port of
    ``make_sharded_ndcn_train_step(None, op, vt, x0, target, ...)``.

    Returns (init_fn, step_fn):
      init_fn(generators) -> (model, opt): R replicas stacked, one per
        generator, on x0's device, and their Adam;
      step_fn(model, opt) -> losses (R,): one Adam step of every replica,
        the loss of each (NaN where its solve ran out of budget).
    ``target`` is (T, n, c), the trajectory's layout."""
    in_dim = x0.shape[-1]

    def init_fn(generators):
        model = batched_init(
            lambda g: init_ndcn(g, in_dim, hidden, in_dim), generators,
            device=x0.device)
        return model, torch_adam(model.parameters(), lr, weight_decay)

    def loss_fn(model):
        out, stats = ndcn_forward(model, op, vt, x0, rtol=rtol, atol=atol,
                                  method=method, max_steps=max_steps,
                                  fused=fused)
        losses = replica_l1(out.transpose(0, 1), target)
        return nan_unless(stats.success, losses), losses

    def step_fn(model, opt):
        if replica_count(model) is None:
            raise ValueError("step_fn takes the stacked model of init_fn")
        return make_replica_sgd_step(opt, lambda: loss_fn(model))()[0]

    return init_fn, step_fn
