"""K1, K1-fm (its pack and its gather), K5, K2, K3 and K4 as
``torch.library`` operators, in the namespace ``ndcn_tpu_torch``, so that a
traced program (``torch.export``, the serving artifact of
``serve.export_ndcn``) holds the kernels themselves.

Each operator takes tensors and ints only, never the operator NamedTuples,
and has a fake implementation that gives its output's shape. Its
implementation is the kernel's wrapper below the ``autograd.Function``: the
plain version for CPU tensors, the C entry for CUDA tensors (which builds
the library at first launch, counts the launch, and raises if the kernel
cannot run). The operators are inference only: they have no backward.

The public wrappers (``coo_spmv.coo_spmv``, ``coo_spmv.spmv_T``,
``fused_rhs.fused_rhs``, ``bsr_spmm.bsr_spmm``, ``bsr_spmm.bsr_fused_rhs``)
call these operators while a program is traced
(``torch.compiler.is_compiling()``: under ``torch.export``, and in the
trace that ``torch.cond`` and ``while_loop`` make of their branches); eager
callers keep the direct path, with no dispatcher hop. Whatever the wrapper
settles on the host is settled at the trace and baked in: K1's split index
is among the operator's arrays, the bf16 switch (``GATHER_BF16``) is an
argument of K1 and of K1-fm's pack (the gather reads the table's dtype),
``GATHER_WIDE`` picks K5's operator over K1-fm's, and the launch plans
follow from the shapes.

A process that loads an artifact imports this package (``import
ndcn_tpu_torch.kernels``) for the operators, and nothing else of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndcn_tpu_torch.kernels import bsr_spmm, coo_spmv, fused_rhs
from ndcn_tpu_torch.kernels.bsr_spmm import BsrMatrix
from ndcn_tpu_torch.kernels.coo_spmv import RowSplit


class _Csr(NamedTuple):
    """A square operator's forward CSR as K1's wrapper reads it."""
    row_ptr: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    n: int
    n_table: int
    split: RowSplit


@torch.library.custom_op("ndcn_tpu_torch::coo_spmv", mutates_args=())
def coo_spmv_op(row_ptr: torch.Tensor, rows: torch.Tensor,
                cols: torch.Tensor, vals: torch.Tensor,
                long_rows: torch.Tensor, chunk_ptr: torch.Tensor,
                chunk_bounds: torch.Tensor, limit: int, x: torch.Tensor,
                bf16: bool) -> torch.Tensor:
    """K1: A · X (``coo_spmv._apply``), x (n, d) or (R, n, d)."""
    n = row_ptr.shape[0] - 1
    op = _Csr(row_ptr, rows, cols, vals, n, n,
              RowSplit(long_rows, chunk_ptr, chunk_bounds, limit))
    with coo_spmv.gather_precision(bf16):
        return coo_spmv._apply(op, x)


@coo_spmv_op.register_fake
def _(row_ptr, rows, cols, vals, long_rows, chunk_ptr, chunk_bounds, limit,
      x, bf16):
    return x.new_empty((*x.shape[:-2], row_ptr.shape[0] - 1, x.shape[-1]))


@torch.library.custom_op("ndcn_tpu_torch::pack_rows", mutates_args=())
def pack_rows_op(xT: torch.Tensor, bf16: bool) -> torch.Tensor:
    """K1-fm's pack: the feature-major (d_sub, n) state as a row-major
    (n, d_sub) table, fp32 or bf16 (``coo_spmv.pack_rows``)."""
    return coo_spmv.pack_rows(xT, bf16)


@pack_rows_op.register_fake
def _(xT, bf16):
    return xT.new_empty((xT.shape[1], xT.shape[0]),
                        dtype=torch.bfloat16 if bf16 else torch.float32)


def _gather_T(row_ptr, rows, cols, vals, long_rows, chunk_ptr, chunk_bounds,
              limit, table, wide):
    n = row_ptr.shape[0] - 1
    op = _Csr(row_ptr, rows, cols, vals, n, n,
              RowSplit(long_rows, chunk_ptr, chunk_bounds, limit))
    return coo_spmv.gather_T(op, table, wide=wide)


def _gather_T_fake(row_ptr, rows, cols, vals, long_rows, chunk_ptr,
                   chunk_bounds, limit, table):
    return table.new_empty((table.shape[1], row_ptr.shape[0] - 1),
                           dtype=torch.float32)


@torch.library.custom_op("ndcn_tpu_torch::gather_T", mutates_args=())
def gather_T_op(row_ptr: torch.Tensor, rows: torch.Tensor,
                cols: torch.Tensor, vals: torch.Tensor,
                long_rows: torch.Tensor, chunk_ptr: torch.Tensor,
                chunk_bounds: torch.Tensor, limit: int,
                table: torch.Tensor) -> torch.Tensor:
    """K1-fm's gather: (A · X)ᵀ (d_sub, n) from the packed (n, d_sub)
    table (``coo_spmv.gather_T``)."""
    return _gather_T(row_ptr, rows, cols, vals, long_rows, chunk_ptr,
                     chunk_bounds, limit, table, False)


@torch.library.custom_op("ndcn_tpu_torch::gather_T_wide", mutates_args=())
def gather_T_wide_op(row_ptr: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor, vals: torch.Tensor,
                     long_rows: torch.Tensor, chunk_ptr: torch.Tensor,
                     chunk_bounds: torch.Tensor, limit: int,
                     table: torch.Tensor) -> torch.Tensor:
    """K5: the same gather from the copied row-major table, counted as K5
    (``coo_spmv.gather_T`` under ``GATHER_WIDE``)."""
    return _gather_T(row_ptr, rows, cols, vals, long_rows, chunk_ptr,
                     chunk_bounds, limit, table, True)


gather_T_op.register_fake(_gather_T_fake)
gather_T_wide_op.register_fake(_gather_T_fake)


@torch.library.custom_op("ndcn_tpu_torch::fused_rhs", mutates_args=())
def fused_rhs_op(a: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """K2: relu((A · H) · W + b) (``fused_rhs._forward``); w may be a
    strided view."""
    return fused_rhs._forward(a, h, w, b)


@fused_rhs_op.register_fake
def _(a, h, w, b):
    return h.new_empty(h.shape)


@torch.library.custom_op("ndcn_tpu_torch::bsr_spmm", mutates_args=())
def bsr_spmm_op(row_ptr: torch.Tensor, block_rows: torch.Tensor,
                block_cols: torch.Tensor, blocks: torch.Tensor, n_rows: int,
                n_cols: int, x: torch.Tensor) -> torch.Tensor:
    """K3: A · X for a block-CSR A (``bsr_spmm._launch_spmm``)."""
    a = BsrMatrix(row_ptr, block_rows, block_cols, blocks, n_rows, n_cols)
    return bsr_spmm._launch_spmm(a, x)


@bsr_spmm_op.register_fake
def _(row_ptr, block_rows, block_cols, blocks, n_rows, n_cols, x):
    return x.new_empty((*x.shape[:-2], n_rows, x.shape[-1]))


@torch.library.custom_op("ndcn_tpu_torch::bsr_fused_rhs", mutates_args=())
def bsr_fused_rhs_op(row_ptr: torch.Tensor, block_rows: torch.Tensor,
                     block_cols: torch.Tensor, blocks: torch.Tensor,
                     n_rows: int, n_cols: int, x: torch.Tensor,
                     w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4: relu((A · X) · W + b) for a block-CSR A
    (``bsr_spmm._launch_fused``)."""
    a = BsrMatrix(row_ptr, block_rows, block_cols, blocks, n_rows, n_cols)
    return bsr_spmm._launch_fused(a, x, w, b)


@bsr_fused_rhs_op.register_fake
def _(row_ptr, block_rows, block_cols, blocks, n_rows, n_cols, x, w, b):
    return x.new_empty(x.shape)
