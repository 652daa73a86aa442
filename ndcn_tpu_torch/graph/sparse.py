"""Graph operator containers on the device: dense and CSR-sorted COO.

The counterpart of ``ndcn_tpu/graph/sparse.py`` with one ``matvec`` entry:

- ``DenseGraph``: an (n, n) matrix; A·X is a plain ``torch.matmul``.
- ``CooGraph``: the row-sorted triplets of A, held in CSR form (``row_ptr``,
  ``cols``, ``vals``) for the K1 kernel, plus the expanded ``rows`` for the
  plain version, plus the transpose's arrays (sorted by A's column) that the
  training slice's backward needs.

The TPU's tile packing (``pack_tiles``, ``TILE_PACK_THRESHOLD``) is not
ported: K1 reads CSR directly. The ELL and BSR formats wait for their
ROADMAP items.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import scipy.sparse as sp
import torch

from ndcn_tpu_torch.kernels.coo_spmv import coo_spmv


class DenseGraph(NamedTuple):
    mat: torch.Tensor  # (n, n)

    @property
    def device(self) -> torch.device:
        return self.mat.device


class CooGraph(NamedTuple):
    """Row-sorted COO triplets of a square A, with their CSR row pointer.

    A·X[i] = sum over e in [row_ptr[i], row_ptr[i+1]) of vals[e]·X[cols[e]].
    ``*_t`` hold Aᵀ the same way (sorted by A's column), for the backward."""
    row_ptr: torch.Tensor   # (n + 1,) int32
    rows: torch.Tensor      # (nnz,) int64, sorted
    cols: torch.Tensor      # (nnz,) int32
    vals: torch.Tensor      # (nnz,) float32
    row_ptr_t: torch.Tensor
    rows_t: torch.Tensor
    cols_t: torch.Tensor
    vals_t: torch.Tensor
    n: int

    @property
    def device(self) -> torch.device:
        return self.vals.device


GraphOperator = Union[DenseGraph, CooGraph]


def from_dense(mat: np.ndarray, dtype=torch.float32,
               device: Optional[torch.device] = None) -> DenseGraph:
    return DenseGraph(mat=torch.as_tensor(np.asarray(mat), dtype=dtype,
                                          device=device).contiguous())


def _csr_arrays(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n: int,
                dtype, device):
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=row_ptr[1:])
    if row_ptr[-1] >= 2 ** 31:
        raise ValueError(f"K1 indexes edges with int32; {row_ptr[-1]} edges "
                         f"is too many")
    return (torch.as_tensor(row_ptr.astype(np.int32), device=device),
            torch.as_tensor(rows.astype(np.int64), device=device),
            torch.as_tensor(cols.astype(np.int32), device=device),
            torch.as_tensor(vals, dtype=dtype, device=device))


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
    fwd = _csr_arrays(coo.row[order], coo.col[order], coo.data[order], n,
                      dtype, device)
    bwd = _csr_arrays(coo.col[order_t], coo.row[order_t], coo.data[order_t], n,
                      dtype, device)
    return CooGraph(*fwd, *bwd, n=n)


def as_operator(mat, sparse: bool = False, dtype=torch.float32,
                format: str = "coo",
                device: Optional[torch.device] = None) -> GraphOperator:
    """Build a device operator from numpy / scipy input (the --sparse switch)."""
    if not sparse:
        dense = (np.asarray(mat.todense()) if sp.issparse(mat)
                 else np.asarray(mat))
        return from_dense(dense, dtype, device)
    if format == "coo":
        return from_scipy_coo(sp.csr_matrix(mat), dtype=dtype, device=device)
    if format in ("ell", "bsr"):
        raise NotImplementedError(
            f"format={format!r} is not ported yet (ELL: ROADMAP item 3; "
            f"BSR: the kernels K3/K4 in ROADMAP's kernel table); use "
            f"format='coo'")
    raise ValueError(f"unknown sparse format {format!r}; "
                     f"choose 'coo', 'ell' or 'bsr'")


def matvec(op: GraphOperator, x: torch.Tensor) -> torch.Tensor:
    """A @ X for X of shape (n, d). The hot op of every model RHS."""
    if isinstance(op, DenseGraph):
        return torch.matmul(op.mat, x)
    if isinstance(op, CooGraph):
        return coo_spmv(op, x)
    raise TypeError(f"unknown graph operator {type(op).__name__}")

