"""Process meshes over ``torch.distributed`` ranks, as
``ndcn_tpu/parallel/mesh.py`` lays JAX devices out:

- axis "data": independent replicas (the replica sweeps);
- axis "model": the graph's node dimension. The operator's rows and every
  node-major tensor are split into equal row blocks, one per rank, and A·X
  runs on each rank as its (n/p, n) block times the all-gathered state
  (``parallel.coo_shard``).

A rank is a process: ``torchrun --nproc_per_node P`` starts P of them, and
a plain ``python`` is a world of one. ``init_group`` starts the process
group (NCCL on the card, gloo on the CPU; never one for the other),
``make_mesh`` lays the ranks out as (data, model) with the JAX package's
factorization, and ``node_range`` / ``replica_range`` say which rows and
which replicas this rank holds (the counterparts of ``node_sharding`` and
``replica_sharding``).

The collectives the sharded path needs are here too: ``gather_rows``
(every rank's row block, concatenated), ``all_reduce_sum`` (a sum over the
ranks that autograd differentiates: its gradient is the sum of the ranks'
gradients), ``shard_mean`` (the mean of a node-sharded tensor over every
rank's elements) and ``all_reduce_grads``. A world of one runs none of
them.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

# the solvers' collectives, kept in ``ode`` (which imports nothing of
# ``parallel``) and re-exported here for the models and the drivers
from ndcn_tpu_torch.ode.collectives import (all_reduce_sum,  # noqa: F401
                                            all_true, sharded_sum_and_count,
                                            sum_flat)

# how long a rank waits in a collective before it fails: a rank that parts
# from the others fails there instead of hanging
GROUP_TIMEOUT = datetime.timedelta(seconds=300)


def mesh_shape(n: int, data_divides: Optional[int] = None,
               model_divides: Optional[int] = None,
               available: Optional[int] = None) -> Tuple[int, int]:
    """(data, model) for ``n`` ranks, the JAX package's ``make_mesh``
    factorization: the model axis is the largest divisor of n that is at
    most sqrt(n). With ``data_divides`` (the replica count) and
    ``model_divides`` (the node count) each axis must divide its count;
    among the admissible shapes the rank count, then the data axis, is
    largest, so the mesh shrinks when no shape of n ranks is admissible.
    ``available`` ranks fewer than n raise."""
    if available is not None and available < n:
        raise ValueError(
            f"make_mesh needs {n} ranks but the process group has "
            f"{available}; launch with torchrun --nproc_per_node {n}")
    if data_divides is not None or model_divides is not None:
        best = (1, 1)
        for data in range(1, n + 1):
            if data_divides is not None and data_divides % data != 0:
                continue
            for model in range(1, n // data + 1):
                if model_divides is not None and model_divides % model != 0:
                    continue
                if (data * model, data) > (best[0] * best[1], best[0]):
                    best = (data, model)
        return best
    model = 1
    for cand in range(1, math.isqrt(n) + 1):
        if n % cand == 0:
            model = cand
    return n // model, model


def init_group(device: torch.device, init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               timeout: datetime.timedelta = GROUP_TIMEOUT) -> None:
    """Start the default process group for ``device``: NCCL for a CUDA
    device, gloo for the CPU. The ranks come from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``), or from ``init_method``
    (a ``file://`` store) with ``rank`` and ``world_size``; without either
    the group is a world of one on an in-process store. No network is
    needed: torchrun's store is on localhost. A group already started is
    kept if its backend is the device's, and refused otherwise."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group is "
                               f"running; {device} needs {backend}")
        return
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    kw = dict(backend=backend, timeout=timeout)
    if init_method is None and "WORLD_SIZE" in os.environ:
        dist.init_process_group(init_method="env://", **kw)
    elif init_method is not None:
        dist.init_process_group(init_method=init_method, rank=rank,
                                world_size=world_size, **kw)
    else:
        dist.init_process_group(store=dist.HashStore(), rank=0, world_size=1,
                                **kw)


def world_size() -> int:
    """The ranks of this run: the started group's, else torchrun's
    ``WORLD_SIZE``, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


@contextlib.contextmanager
def process_group(device: torch.device):
    """``init_group(device)`` for the duration, destroyed afterwards if
    this call started it (a group the caller started is left running)."""
    started = not dist.is_initialized()
    init_group(device)
    try:
        yield
    finally:
        if started:
            dist.destroy_process_group()


class Mesh(NamedTuple):
    """A (data, model) layout of the process group's ranks, on
    ``torch.distributed.device_mesh``. ``data_rank`` / ``model_rank`` are
    this rank's coordinates; ``model_group`` / ``data_group`` the groups of
    the ranks that share this rank's data / model coordinate (None for an
    axis of size 1: it runs no collective)."""
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: Optional[dist.ProcessGroup]
    model_group: Optional[dist.ProcessGroup]
    device_mesh: object

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


def make_mesh(device: torch.device, data_divides: Optional[int] = None,
              model_divides: Optional[int] = None) -> Mesh:
    """The (data, model) mesh over the process group's ranks (the group
    must be started: ``init_group``), by ``mesh_shape``. A shape smaller
    than the world (the factorization shrank) raises: each rank is a
    process the caller launched, and none may sit idle."""
    from torch.distributed.device_mesh import init_device_mesh

    world = world_size()
    data, model = mesh_shape(world, data_divides, model_divides)
    if data * model != world:
        raise ValueError(
            f"{world} ranks cannot be laid out as a mesh for "
            f"data_divides={data_divides}, model_divides={model_divides}: "
            f"the largest admissible mesh is data={data} x model={model}; "
            f"launch with torchrun --nproc_per_node {data * model}")
    dm = init_device_mesh(device.type, (data, model),
                          mesh_dim_names=("data", "model"))
    data_rank, model_rank = dm.get_coordinate()
    return Mesh(data=data, model=model, data_rank=data_rank,
                model_rank=model_rank,
                data_group=dm.get_group("data") if data > 1 else None,
                model_group=dm.get_group("model") if model > 1 else None,
                device_mesh=dm)


def block_rows(n: int, p: int) -> int:
    """Rows of one row block: n padded up to a multiple of p, over p."""
    return -(-n // p)


def node_range(n: int, p: int, rank: int) -> Tuple[int, int]:
    """[start, stop) of the node rows that rank ``rank`` of a model axis of
    ``p`` holds: equal blocks of ``block_rows(n, p)`` rows, the last ones
    cut at n (a block may be empty)."""
    rows = block_rows(n, p)
    start = min(rank * rows, n)
    return start, min(start + rows, n)


def replica_range(mesh: Mesh, replicas: int) -> Tuple[int, int]:
    """[start, stop) of the replicas this rank trains: ``replicas`` over
    the data axis, which divides it."""
    if replicas % mesh.data:
        raise ValueError(f"{replicas} replicas do not split over a data axis "
                         f"of {mesh.data}")
    per = replicas // mesh.data
    return mesh.data_rank * per, (mesh.data_rank + 1) * per


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_gather_rows(x: torch.Tensor, rows: int, group) -> torch.Tensor:
    if x.shape[0] < rows:
        x = torch.cat([x, x.new_zeros((rows - x.shape[0], *x.shape[1:]))])
    x = x.contiguous()
    out = x.new_empty((group_size(group) * rows, *x.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x, group=group)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows, group):
        ctx.rows, ctx.group, ctx.m = rows, group, x.shape[0]
        return _all_gather_rows(x, rows, group)

    @staticmethod
    def backward(ctx, g):
        # every rank's copy of the gathered tensor feeds that rank's own
        # computation: this rank's rows get the sum of the ranks' gradients
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        start = dist.get_rank(ctx.group) * ctx.rows
        return g[start:start + ctx.m], None, None


def gather_rows(x: torch.Tensor, rows: int,
                group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Every rank's row block of a row-sharded tensor, concatenated: x is
    this rank's (m, ...) rows, m <= ``rows``, padded with zero rows to
    ``rows`` before the all-gather; returns (p · rows, ...). A group of
    one returns x itself. Differentiable where autograd records x (the
    gradient of this rank's rows is the sum of the ranks' gradients of
    them, one all-reduce); the operators' products call it off the tape."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, rows, group)
    return _all_gather_rows(x, rows, group)


class _ShardMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, per_replica):
        rows = x.detach().reshape(x.shape[0], -1) if per_replica else None
        total, count = sharded_sum_and_count(
            rows.sum(dim=1) if per_replica else x.detach().sum(),
            rows.shape[1] if per_replica else x.numel(), group)
        # the count stays on the device: a train step that a CUDA graph
        # records reads nothing on the host
        ctx.save_for_backward(count)
        ctx.shape, ctx.per_replica = x.shape, per_replica
        return (total / count).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        # this rank's share of the mean's gradient: its elements' terms
        # (the replicated parameters' gradients are summed afterwards)
        count, = ctx.saved_tensors
        if ctx.per_replica:
            g = g.reshape(g.shape + (1,) * (len(ctx.shape) - 1))
        return (g / count.to(g.dtype)).expand(ctx.shape), None, None


def shard_mean(x: torch.Tensor, group: Optional[dist.ProcessGroup],
               per_replica: bool = False) -> torch.Tensor:
    """The mean of a node-sharded tensor over every rank's elements (with
    ``per_replica``, one mean per index of the leading replica axis, (R,)).
    Its value is the whole mean on every rank; its gradient is this rank's
    share (1/N for each of its elements), so that summing the ranks'
    parameter gradients (``all_reduce_grads``) gives the whole gradient.
    ``torch.mean`` for a group of one."""
    if group is None:
        return (x.reshape(x.shape[0], -1).mean(dim=1) if per_replica
                else torch.mean(x))
    return _ShardMean.apply(x, group, per_replica)


def all_reduce_grads(params, group: Optional[dist.ProcessGroup]) -> None:
    """Sum the replicated parameters' gradients over ``group``, in place,
    in one collective (nothing for a group of one)."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    for g, total in zip(grads, sum_flat(grads, group)):
        g.copy_(total)


def gather_replicas(x: torch.Tensor,
                    group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Every data rank's replicas of a per-replica tensor (R_local, ...),
    concatenated in rank order: (R, ...). ``x`` itself for a group of
    one."""
    if group is None:
        return x
    return gather_rows(x, x.shape[0], group)
