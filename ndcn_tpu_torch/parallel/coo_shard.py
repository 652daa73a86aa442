"""Row-block sharded operators: the 1-D row-parallel product over the
mesh's model axis, as ``ndcn_tpu/parallel/coo_shard.py``.

The node rows split into p equal blocks of ``rows_per`` = ceil(n / p) rows,
one per rank of the model group (the last blocks cut at n). Every
node-major tensor is held the same way: a rank holds its own rows only.
A·X on a rank is its block of A's rows times the whole X, which it gets by
an all-gather of the ranks' row blocks:

- ``RowShardedCoo``: the rank's row block of A as CSR
  (``kernels.coo_spmv.CsrBlock``: ``rows_per`` output rows, global column
  indices into the gathered (n_pad, d) table) for K1, and its row block of
  Aᵀ for the backward, each with the chunk index of its long rows
  (``split_rows`` on the block). K1 takes such a block as it is: only
  the table's row count differs from the output's (``CsrBlock.n_table``).
  Each row walks the same edges in the same order as in the whole
  operator, so the row blocks' results concatenate to the whole launch's.
- ``RowShardedDense``: the rank's row blocks of A and of Aᵀ as dense
  (rows, n) matrices; the product is ``torch.matmul`` (the JAX package
  leaves dense rows to GSPMD, outside any Pallas kernel).

R replicas' states (R, rows, d) against the one operator (the replica
sweeps on a data x model mesh) gather along the node axis, and K1 runs its
batched form on the row block: the table's replica stride is its own
(n_pad rows), the output's the block's.

The backward of A·X over the rank's rows is the same product over Aᵀ's
block against the all-gathered cotangent (JAX's custom VJPs,
``_rs_bwd`` / ``_rst_bwd``): dX's rows of this rank are Σ_i A[i, j]·G[i].
The autograd ``Function`` keeps only the operator, never the gathered
state, as JAX's ``_rst_fwd`` saves only the operator: otherwise each rank
would hold p times its state per RHS evaluation. The operator is a
constant: a gradient asked of its values is NaN (``_poison_rs``).

``rs_spmv_T`` is the feature-major form (``_rs_tiled_apply_T``): the
rank's (d_sub, rows) state goes through K1-fm's pack kernel first, the
ranks' packed (rows, d_sub) tables are all-gathered into the (n_pad,
d_sub) table K1-fm reads, and K1-fm's gather runs on the row block. The
collective moves the table, and no gathered state is ever transposed.

A model group of one (``group`` None) runs no collective: the block is the
whole operator. The TPU's tile packing is not ported (K1 reads CSR).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ndcn_tpu_torch.kernels import coo_spmv
from ndcn_tpu_torch.kernels.coo_spmv import CsrBlock, csr_row_block
from ndcn_tpu_torch.parallel.mesh import (Mesh, block_rows, gather_rows,
                                          group_size, node_range)

class RowShardedCoo(NamedTuple):
    """This rank's row blocks of A and Aᵀ (``CsrBlock``) and the layout:
    rows [start, stop) of n, in blocks of ``rows_per`` (n_pad = p ·
    rows_per), over ``group`` (None for a group of one)."""
    block: CsrBlock
    block_t: CsrBlock
    n: int
    n_pad: int
    rows_per: int
    start: int
    stop: int
    group: Optional[dist.ProcessGroup]

    @property
    def device(self) -> torch.device:
        return self.block.device

    @property
    def n_nodes(self) -> int:
        return self.n


class RowShardedDense(NamedTuple):
    """This rank's rows [start, stop) of a dense A and of Aᵀ, (stop -
    start, n) each; the layout as ``RowShardedCoo``'s."""
    mat: torch.Tensor
    mat_t: torch.Tensor
    n: int
    n_pad: int
    rows_per: int
    start: int
    stop: int
    group: Optional[dist.ProcessGroup]

    @property
    def device(self) -> torch.device:
        return self.mat.device

    @property
    def n_nodes(self) -> int:
        return self.n


def is_sharded(op) -> bool:
    return isinstance(op, (RowShardedCoo, RowShardedDense))


def node_group(op) -> Optional[dist.ProcessGroup]:
    """The group a sharded operator's node rows split over (None for any
    other operator, or a group of one)."""
    return op.group if is_sharded(op) else None


def node_rows(op) -> Optional[Tuple[int, int, int]]:
    """(n, start, stop): the node rows [start, stop) of n that this rank
    holds, for a sharded operator; None for any other (every row). The
    models draw dropout masks at the whole shape and cut them to these
    rows (``models.nn.dropout``)."""
    return (op.n, op.start, op.stop) if is_sharded(op) else None


def flat_columns(op, width: int) -> Optional[Tuple[int, int]]:
    """[start · width, stop · width): the columns of a node-major
    flattening (a row-major (n, width) tensor as one n · width vector, the
    temporal baselines' cell input) that this rank's rows give, for a
    sharded operator; None for any other (every column)."""
    return ((op.start * width, op.stop * width) if is_sharded(op)
            else None)


def dense_rows(op) -> torch.Tensor:
    """This rank's rows of a sharded operator as a dense (stop - start, n)
    tensor on its device (DeepGCN3's reweighted Laplacian): the dense
    operator's row block, or the COO block's edges summed into it, as
    ``graph.sparse.to_dense_matrix`` sums the whole operator's."""
    if isinstance(op, RowShardedDense):
        return op.mat
    b = op.block
    dense = np.zeros((_local_rows(op), op.n), np.float32)
    np.add.at(dense, (b.rows.cpu().numpy(), b.cols.cpu().numpy()),
              b.vals.detach().cpu().numpy())
    return torch.as_tensor(dense, device=op.device)


def _layout(n: int, p: int, rank: int):
    rows_per = block_rows(n, p)
    start, stop = node_range(n, p, rank)
    return dict(n=n, n_pad=p * rows_per, rows_per=rows_per, start=start,
                stop=stop)


def shard_coo_at(coo, p: int, rank: int,
                 group: Optional[dist.ProcessGroup]) -> RowShardedCoo:
    """Rank ``rank``'s row blocks of a ``graph.sparse.CooGraph`` over a
    model axis of ``p`` (``group`` the axis's group, None for p = 1)."""
    lay = _layout(coo.n, p, rank)
    blocks = [csr_row_block(ptr, r, c, v, lay["start"], lay["stop"],
                            lay["rows_per"], lay["n_pad"])
              for ptr, r, c, v in ((coo.row_ptr, coo.rows, coo.cols,
                                    coo.vals),
                                   (coo.row_ptr_t, coo.rows_t, coo.cols_t,
                                    coo.vals_t))]
    return RowShardedCoo(*blocks, group=group if p > 1 else None, **lay)


def shard_coo_rows(coo, mesh: Mesh) -> RowShardedCoo:
    """This rank's row blocks of ``coo`` over the mesh's model axis: the
    host packer of the JAX package's ``shard_coo_rows`` (its row blocks
    are ``_pack_row_blocks``'s triplets without their zero-valued pad
    edges: K1 takes rows of any length)."""
    return shard_coo_at(coo, mesh.model, mesh.model_rank, mesh.model_group)


def shard_dense_at(mat: torch.Tensor, p: int, rank: int,
                   group: Optional[dist.ProcessGroup]) -> RowShardedDense:
    lay = _layout(mat.shape[0], p, rank)
    start, stop = lay["start"], lay["stop"]
    return RowShardedDense(mat=mat[start:stop].contiguous(),
                           mat_t=mat.t()[start:stop].contiguous(),
                           group=group if p > 1 else None, **lay)


def _local_rows(op) -> int:
    return op.stop - op.start


def _block_product(op, x: torch.Tensor, transpose: bool) -> torch.Tensor:
    """This rank's rows of A·X (Aᵀ·X with ``transpose``) from its rows x,
    (rows, d) or R replicas' (R, rows, d): all-gather, then the row
    block's product (K1's batched form for replicas)."""
    if x.ndim == 3:     # gather along the node axis
        table = gather_rows(x.transpose(0, 1), op.rows_per,
                            op.group).transpose(0, 1)
    else:
        table = gather_rows(x, op.rows_per, op.group)
    if isinstance(op, RowShardedDense):
        return torch.matmul(op.mat_t if transpose else op.mat,
                            table[..., :op.n, :])
    block = op.block_t if transpose else op.block
    coo_spmv._check(block, table, "the row-sharded coo_spmv", batched=True)
    return coo_spmv._apply(block, table)[..., :_local_rows(op), :]


def _block_product_T(op, xT: torch.Tensor, transpose: bool) -> torch.Tensor:
    """The feature-major form: this rank's (d_sub, rows) columns of
    (A·X)ᵀ from its columns xT. Pack, all-gather the packed tables, gather
    on the row block."""
    bf16 = coo_spmv.GATHER_BF16
    xT = xT.contiguous()
    packed = (coo_spmv.pack_rows_plain(xT, bf16) if coo_spmv.GATHER_WIDE
              else coo_spmv.pack_rows(xT, bf16))
    table = gather_rows(packed, op.rows_per, op.group)
    y = coo_spmv.gather_T(op.block_t if transpose else op.block, table)
    local = _local_rows(op)
    return y if local == op.rows_per else y[:, :local].contiguous()


def _constants(op):
    if isinstance(op, RowShardedDense):
        return op.mat, op.mat_t
    return op.block.vals, op.block_t.vals


class _ShardedProduct(torch.autograd.Function):
    """A·X over this rank's rows; the backward is Aᵀ's block against the
    gathered cotangent. Only the operator is kept for the backward."""

    @staticmethod
    def forward(ctx, op, feature_major, x, *constants):
        ctx.op, ctx.feature_major, ctx.constants = op, feature_major, \
            constants
        product = _block_product_T if feature_major else _block_product
        return product(op, x, False)

    @staticmethod
    def backward(ctx, g):
        product = _block_product_T if ctx.feature_major else _block_product
        dx = (product(ctx.op, g, True) if ctx.needs_input_grad[2]
              else None)
        nan = tuple(torch.full_like(c, float("nan"))
                    if ctx.needs_input_grad[3 + i] else None
                    for i, c in enumerate(ctx.constants))
        return (None, None, dx, *nan)


def rs_matvec(op, x: torch.Tensor) -> torch.Tensor:
    """A·X for a row-sharded operator: x is this rank's (rows, d) block
    of X, or R replicas' (R, rows, d); returns this rank's rows of A·X,
    differentiable in x."""
    if x.ndim not in (2, 3) or x.shape[-2] != _local_rows(op):
        raise ValueError(f"the row-sharded product takes this rank's "
                         f"({_local_rows(op)}, d) rows of X, or R "
                         f"replicas' (R, {_local_rows(op)}, d), got "
                         f"{tuple(x.shape)}")
    return _ShardedProduct.apply(op, False, x, *_constants(op))


def rs_spmv_T(op: RowShardedCoo, xT: torch.Tensor) -> torch.Tensor:
    """(A·X)ᵀ for a row-sharded COO operator in the feature-major layout:
    xT is this rank's (d_sub, rows) columns of Xᵀ; returns this rank's
    columns of (A·X)ᵀ, differentiable in xT."""
    if not isinstance(op, RowShardedCoo):
        raise TypeError(f"rs_spmv_T takes a RowShardedCoo, got "
                        f"{type(op).__name__}")
    if xT.ndim != 2 or xT.shape[1] != _local_rows(op):
        raise ValueError(f"rs_spmv_T takes this rank's (d_sub, "
                         f"{_local_rows(op)}) columns of Xᵀ, got "
                         f"{tuple(xT.shape)}")
    if coo_spmv.GATHER_WIDE and xT.shape[0] > coo_spmv.D_WIDE:
        raise ValueError(f"the wide gather takes d_sub <= "
                         f"{coo_spmv.D_WIDE}, got {xT.shape[0]}")
    return _ShardedProduct.apply(op, True, xT, *_constants(op))


def take_rows(t: torch.Tensor, op, axis: int = 0) -> torch.Tensor:
    """This rank's node rows of a whole (n along ``axis``) tensor, for a
    sharded ``op``; ``t`` itself for any other operator."""
    if not is_sharded(op) or (op.start == 0 and op.stop == t.shape[axis]):
        return t
    return t.narrow(axis, op.start, _local_rows(op))


def take_index(idx: torch.Tensor, op) -> torch.Tensor:
    """The node indices ``idx`` (a selection of rows, e.g. a training
    split) that fall in this rank's rows, made rank-relative, for a
    sharded ``op``; ``idx`` itself for any other operator."""
    if not is_sharded(op):
        return idx
    return idx[(idx >= op.start) & (idx < op.stop)] - op.start


def gather_nodes(t: torch.Tensor, op, axis: int = 0) -> torch.Tensor:
    """The whole tensor from every rank's node rows along ``axis`` (the
    inverse of ``take_rows``); ``t`` itself for a group of one."""
    if node_group(op) is None:
        return t
    moved = t.movedim(axis, 0)
    whole = gather_rows(moved, op.rows_per, op.group)
    rows = [whole[r * op.rows_per:r * op.rows_per + size]
            for r, size in enumerate(_block_sizes(op))]
    return torch.cat(rows).movedim(0, axis)


def _block_sizes(op):
    p = group_size(op.group)
    return [min(op.rows_per, max(0, op.n - r * op.rows_per))
            for r in range(p)]
