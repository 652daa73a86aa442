"""Graph operator containers on the device: dense, ELL, CSR-sorted COO and
BSR.

The counterpart of ``ndcn_tpu/graph/sparse.py`` with one ``matvec`` entry,
differentiable in X:

- ``DenseGraph``: an (n, n) matrix; A·X is a plain ``torch.matmul``.
- ``EllGraph``: row-padded neighbour lists (n, k), k the largest degree
  rounded up to a multiple of 8; A·X is a gather and an ``einsum``, as in
  the JAX package, which has no kernel for this format either.
- ``CooGraph``: the row-sorted triplets of A, held in CSR form (``row_ptr``,
  ``cols``, ``vals``) for the K1 kernel, plus the expanded ``rows`` for the
  plain version, plus the transpose's arrays (sorted by A's column) that
  K1's backward runs over, plus for each of the two the index that cuts
  its long rows into chunks (``kernels.coo_spmv.split_rows``).
- ``BsrGraph``: block-CSR packings of A and Aᵀ for K3 (and K4, the fused
  RHS); the backward runs over Aᵀ.

The TPU's tile packing (``pack_tiles``, ``TILE_PACK_THRESHOLD``) is not
ported: K1 reads CSR directly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import scipy.sparse as sp
import torch

from ndcn_tpu_torch.kernels.bsr_spmm import (BLOCK, BsrMatrix, bsr_spmm,
                                             from_scipy_bsr)
from ndcn_tpu_torch.kernels.coo_spmv import RowSplit, coo_spmv, split_rows
from ndcn_tpu_torch.parallel.coo_shard import (RowShardedCoo, RowShardedDense,
                                               rs_matvec)


class DenseGraph(NamedTuple):
    mat: torch.Tensor  # (n, n)

    @property
    def device(self) -> torch.device:
        return self.mat.device


class EllGraph(NamedTuple):
    """ELLPACK: row i's neighbours in ``cols[i]``, their values in
    ``vals[i]``; pad slots hold column 0 and value 0."""
    cols: torch.Tensor  # (n, k) int64
    vals: torch.Tensor  # (n, k)

    @property
    def n(self) -> int:
        return self.cols.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vals.device


class CooGraph(NamedTuple):
    """Row-sorted COO triplets of a square A, with their CSR row pointer.

    A·X[i] = sum over e in [row_ptr[i], row_ptr[i+1]) of vals[e]·X[cols[e]].
    ``*_t`` hold Aᵀ the same way (sorted by A's column), for the backward.
    ``split`` / ``split_t`` cut the rows longer than ``SPLIT_EDGES`` into
    chunks, so that the kernels spread a hub row over many warps."""
    row_ptr: torch.Tensor   # (n + 1,) int32
    rows: torch.Tensor      # (nnz,) int64, sorted
    cols: torch.Tensor      # (nnz,) int32
    vals: torch.Tensor      # (nnz,) float32
    row_ptr_t: torch.Tensor
    rows_t: torch.Tensor
    cols_t: torch.Tensor
    vals_t: torch.Tensor
    n: int
    split: RowSplit
    split_t: RowSplit

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def n_table(self) -> int:
        """Rows of the state K1 gathers from: A is square."""
        return self.n

    def transpose(self) -> "CooGraph":
        """Aᵀ from the arrays the backward holds (no copy)."""
        return CooGraph(self.row_ptr_t, self.rows_t, self.cols_t, self.vals_t,
                        self.row_ptr, self.rows, self.cols, self.vals, self.n,
                        self.split_t, self.split)


class BsrGraph(NamedTuple):
    """Block-sparse operator for K3 / K4: packings of A and of Aᵀ (the
    backward's), so A·X is differentiable in X."""
    fwd: BsrMatrix
    bwd: BsrMatrix

    @property
    def n(self) -> int:
        return self.fwd.n_rows

    @property
    def device(self) -> torch.device:
        return self.fwd.blocks.device

    def transpose(self) -> "BsrGraph":
        return BsrGraph(self.bwd, self.fwd)


GraphOperator = Union[DenseGraph, EllGraph, CooGraph, BsrGraph]


def from_dense(mat: np.ndarray, dtype=torch.float32,
               device: Optional[torch.device] = None) -> DenseGraph:
    return DenseGraph(mat=torch.as_tensor(np.asarray(mat), dtype=dtype,
                                          device=device).contiguous())


def from_scipy(mat: sp.spmatrix, pad_to_multiple: int = 8,
               dtype=torch.float32,
               device: Optional[torch.device] = None) -> EllGraph:
    """Pack a sparse matrix into ELL, as ``ndcn_tpu``'s ``from_scipy``: the
    row width is the largest number of entries in a row (at least 1),
    rounded up to ``pad_to_multiple``."""
    csr = sp.csr_matrix(mat)
    n = csr.shape[0]
    row_nnz = np.diff(csr.indptr)
    k = max(1, int(row_nnz.max()))
    k = -(-k // pad_to_multiple) * pad_to_multiple
    # each entry's slot within its row, in CSR order
    rows = np.repeat(np.arange(n), row_nnz)
    slots = np.arange(csr.nnz) - csr.indptr[rows]
    cols = np.zeros((n, k), np.int64)
    vals = np.zeros((n, k), np.float64)
    cols[rows, slots] = csr.indices
    vals[rows, slots] = csr.data
    return EllGraph(cols=torch.as_tensor(cols, device=device),
                    vals=torch.as_tensor(vals, dtype=dtype, device=device))


def _csr_arrays(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n: int,
                dtype, device):
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=row_ptr[1:])
    if row_ptr[-1] >= 2 ** 31:
        raise ValueError(f"K1 indexes edges with int32; {row_ptr[-1]} edges "
                         f"is too many")
    arrays = (torch.as_tensor(row_ptr.astype(np.int32), device=device),
              torch.as_tensor(rows.astype(np.int64), device=device),
              torch.as_tensor(cols.astype(np.int32), device=device),
              torch.as_tensor(vals, dtype=dtype, device=device))
    return arrays, split_rows(row_ptr, device=device)


def from_scipy_coo(mat: sp.spmatrix, dtype=torch.float32,
                   device: Optional[torch.device] = None) -> CooGraph:
    """Sort the triplets by row (stably, as ``ndcn_tpu``'s ``from_scipy_coo``
    does) on the host, and build the CSR row pointer from them."""
    if dtype != torch.float32:
        raise ValueError(f"the COO operator is float32 (the K1 kernel's type), "
                         f"got {dtype}")
    coo = sp.coo_matrix(mat)
    n = int(coo.shape[0])
    if coo.shape != (n, n):
        raise ValueError(f"graph operators are square, got {coo.shape}")
    order = np.argsort(coo.row, kind="stable")
    order_t = np.argsort(coo.col, kind="stable")
    fwd, split = _csr_arrays(coo.row[order], coo.col[order], coo.data[order],
                             n, dtype, device)
    bwd, split_t = _csr_arrays(coo.col[order_t], coo.row[order_t],
                               coo.data[order_t], n, dtype, device)
    return CooGraph(*fwd, *bwd, n=n, split=split, split_t=split_t)


def from_scipy_bsr_graph(mat: sp.spmatrix, block: int = BLOCK,
                         device: Optional[torch.device] = None) -> BsrGraph:
    csr = sp.csr_matrix(mat)
    return BsrGraph(fwd=from_scipy_bsr(csr, block, device),
                    bwd=from_scipy_bsr(csr.T.tocsr(), block, device))


def as_operator(mat, sparse: bool = False, dtype=torch.float32,
                format: str = "coo",
                device: Optional[torch.device] = None) -> GraphOperator:
    """Build a device operator from numpy / scipy input (the --sparse switch).

    ``format`` picks the sparse layout: 'coo' (K1), 'ell' (gather and
    einsum) or 'bsr' (K3 / K4, 128 × 128 blocks)."""
    if not sparse:
        dense = (np.asarray(mat.todense()) if sp.issparse(mat)
                 else np.asarray(mat))
        return from_dense(dense, dtype, device)
    if format == "coo":
        return from_scipy_coo(sp.csr_matrix(mat), dtype=dtype, device=device)
    if format == "bsr":
        if dtype != torch.float32:
            raise ValueError(f"format='bsr' supports float32 only, got {dtype}")
        return from_scipy_bsr_graph(mat, device=device)
    if format == "ell":
        return from_scipy(mat, dtype=dtype, device=device)
    raise ValueError(f"unknown sparse format {format!r}; "
                     f"choose 'coo', 'ell' or 'bsr'")


def use_tiled_kernel(op: GraphOperator) -> bool:
    """Does ``op`` serve the SpMV kernels here (the seam of
    ``ndcn_tpu.graph.sparse.use_tiled_kernel``)? True for a ``CooGraph`` on
    a CUDA device; the CPU tests monkeypatch it to True, as the JAX tests
    do, so that 'auto' picks the layout the JAX package picks on its
    accelerator. The JAX predicate also needs a tile packing, which exists
    above ``TILE_PACK_THRESHOLD`` (50,000 edges) or with ``tiled=True``;
    every ``CooGraph`` here serves K1, so any one qualifies. At the 'auto'
    threshold (>= 500k nodes, ~5M edges) the two choices coincide. A
    ``parallel.coo_shard.RowShardedCoo`` serves K1 on its row blocks."""
    return (isinstance(op, (CooGraph, RowShardedCoo))
            and op.device.type == "cuda")


def matvec(op: GraphOperator, x: torch.Tensor) -> torch.Tensor:
    """A @ X for X of shape (n, d), or of R replicas' X (R, n, d) against
    the one A: a broadcast ``torch.matmul`` (dense), K1 / K3's batched forms
    (COO / BSR), the gather (ELL). The hot op of every model RHS. A
    row-sharded operator (``parallel.coo_shard``) takes this rank's rows
    of X and gives this rank's rows of A·X."""
    if isinstance(op, (RowShardedCoo, RowShardedDense)):
        return rs_matvec(op, x)
    if isinstance(op, DenseGraph):
        return torch.matmul(op.mat, x)
    if isinstance(op, CooGraph):
        return coo_spmv(op, x)
    if isinstance(op, BsrGraph):
        return bsr_spmm(op.fwd, op.bwd, x)
    if isinstance(op, EllGraph):
        if x.ndim == 3:
            return torch.einsum("nk,rnkd->rnd", op.vals.to(x.dtype),
                                x[:, op.cols])
        return torch.einsum("nk,nkd->nd", op.vals.to(x.dtype), x[op.cols])
    raise TypeError(f"unknown graph operator {type(op).__name__}")


def to_dense_matrix(op: GraphOperator) -> np.ndarray:
    """The operator as an (n, n) float32 numpy matrix (tests, small graphs)."""
    if isinstance(op, DenseGraph):
        return op.mat.detach().cpu().numpy()
    if isinstance(op, CooGraph):
        dense = np.zeros((op.n, op.n), np.float32)
        np.add.at(dense, (op.rows.cpu().numpy(), op.cols.cpu().numpy()),
                  op.vals.detach().cpu().numpy())
        return dense
    if isinstance(op, BsrGraph):
        m, B = op.fwd, op.fwd.block
        full = np.zeros((m.n_row_blocks * B, -(-m.n_cols // B) * B),
                        np.float32)
        for rb, cb, blk in zip(m.block_rows.tolist(), m.block_cols.tolist(),
                               m.blocks.detach().cpu().numpy()):
            full[rb * B:(rb + 1) * B, cb * B:(cb + 1) * B] += blk
        return full[:m.n_rows, :m.n_cols]
    if isinstance(op, EllGraph):
        dense = np.zeros((op.n, op.n), np.float32)
        np.add.at(dense, (np.repeat(np.arange(op.n), op.cols.shape[1]),
                          op.cols.cpu().numpy().ravel()),
                  op.vals.detach().cpu().numpy().ravel())
        return dense
    raise TypeError(f"unknown graph operator {type(op).__name__}")

