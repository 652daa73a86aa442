"""Replica sweeps, as ``ndcn_tpu/parallel/sweep.py``: a stacked model of R
replicas on one device (``make_sharded_ndcn_train_step(mesh=None, ...)``,
the single-device reference of a replica step), and the placement of a
problem on a mesh (``shard_operator``, ``place_problem_on_mesh``). On a
(data, model) mesh each data rank stacks its own replicas (the drivers
take them by ``mesh.replica_range``, each from its generator of the
unsharded sweep), ``replica_l1`` and ``make_replica_sgd_step`` take the
model group, and ``gather_stacked`` gathers every data rank's replicas.

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
from ndcn_tpu_torch.parallel.mesh import shard_mean
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


def gather_stacked(stacked: nn.Module, group) -> nn.Module:
    """A stacked module holding every data rank's replicas, in rank order
    (the module itself for a group of one): each rank's parameters
    all-gathered along the replica axis, into a copy."""
    if group is None:
        return stacked
    from ndcn_tpu_torch.parallel.mesh import gather_replicas

    every = copy.deepcopy(stacked)
    for name, p in stacked.named_parameters():
        _set_parameter(every, name, nn.Parameter(
            gather_replicas(p.detach(), group)))
    every.replicas = every.get_parameter(name).shape[0]
    return every


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


def replica_l1(pred: torch.Tensor, target: torch.Tensor,
               group=None) -> torch.Tensor:
    """The L1 loss of each replica: pred (R, ...) against a shared target
    (...), one mean per replica, (R,); with a node-sharded model's
    ``group``, each over every rank's rows (``mesh.shard_mean``)."""
    return shard_mean(torch.abs(pred - target), group, per_replica=True)


def make_ndcn_replica_train_step(op, vt, x0: torch.Tensor,
                                 target: torch.Tensor, *, rtol: float = 0.01,
                                 atol: float = 0.001, method: str = "dopri5",
                                 lr: float = 0.01, weight_decay: float = 1e-3,
                                 max_steps: int = 64, hidden: int = 20,
                                 fused=False, adjoint: bool = False):
    """A multi-replica NDCN training step on one device; the port of
    ``make_sharded_ndcn_train_step(None, op, vt, x0, target, ...)``. Every
    ``method`` runs; ``adjoint`` takes the gradients from the batched
    continuous adjoint (``ode.adjoint``) instead of backprop through the
    solve.

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
                                  fused=fused, adjoint=adjoint)
        losses = replica_l1(out.transpose(0, 1), target)
        return nan_unless(stats.success, losses), losses

    def step_fn(model, opt):
        if replica_count(model) is None:
            raise ValueError("step_fn takes the stacked model of init_fn")
        return make_replica_sgd_step(opt, lambda: loss_fn(model))()[0]

    return init_fn, step_fn


def shard_operator(mesh, op):
    """This rank's share of a graph operator over the mesh's model axis
    (``ndcn_tpu/parallel/sweep.py:shard_operator``): a dense operator's row
    blocks (the model axis must divide n: ``make_mesh(model_divides=n)``),
    a COO operator's row blocks (``parallel.coo_shard``). ELL and BSR have
    no model-axis placement: they stay whole, with the JAX package's
    notice, and so does every node-major tensor of their problem
    (``coo_shard.take_rows`` keeps it whole), each rank computing the
    unsharded problem."""
    from ndcn_tpu_torch.graph.sparse import CooGraph, DenseGraph
    from ndcn_tpu_torch.parallel.coo_shard import shard_coo_rows, \
        shard_dense_at

    if isinstance(op, DenseGraph):
        n = op.mat.shape[0]
        if n % mesh.model:
            raise ValueError(
                f"dense operator with {n} nodes cannot row-shard over a "
                f"model axis of {mesh.model}; build the mesh with "
                f"make_mesh(model_divides={n})")
        return shard_dense_at(op.mat, mesh.model, mesh.model_rank,
                              mesh.model_group)
    if isinstance(op, CooGraph):
        return shard_coo_rows(op, mesh)
    print(f"mesh: {type(op).__name__} operator has no 'model'-axis "
          f"placement; leaving it replicated")
    return op


def place_problem_on_mesh(mesh, op, x0: torch.Tensor, target: torch.Tensor,
                          vt):
    """The shared problem on the mesh: the operator's row blocks
    (``shard_operator``) and this rank's rows of x0 (n, c) and of the
    target (T, n, c); the time grid whole."""
    from ndcn_tpu_torch.parallel.coo_shard import take_rows

    op = shard_operator(mesh, op)
    return op, take_rows(x0, op), take_rows(target, op, axis=1), vt
