"""K1: Y = A · X for a row-sorted sparse A in CSR form, X (n, d) row-major fp32.

The CUDA kernel is ``ndcn_tpu_torch/csrc/coo_spmv.cu``; it replaces the TPU's
sliced-tile segment-sum (``ndcn_tpu/kernels/coo_spmv.py::_make_kernel``). The
plain PyTorch version beside it is the CPU path and the reference the kernel
is held against on the card.
"""

from __future__ import annotations

import torch

from ndcn_tpu_torch.kernels import build
from ndcn_tpu_torch.kernels.platform import check_no_grad, on_cuda

# launches of the CUDA kernel in this process (CPU calls do not count)
LAUNCHES = 0


def coo_spmv_plain(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                   x: torch.Tensor, n: int) -> torch.Tensor:
    """Gather, scale, scatter-add: the plain version of K1."""
    return torch.zeros((n, x.shape[1]), dtype=x.dtype,
                       device=x.device).index_add_(0, rows,
                                                   vals[:, None] * x[cols])


def _check(op, x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"coo_spmv takes float32 x, got {x.dtype}")
    if x.ndim != 2 or x.shape[0] != op.n or x.shape[1] < 1:
        raise ValueError(f"coo_spmv takes x of shape ({op.n}, d >= 1), "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("coo_spmv takes a contiguous (row-major) x")
    nnz = op.cols.shape[0]
    if (op.row_ptr.dtype != torch.int32 or op.cols.dtype != torch.int32
            or op.vals.dtype != torch.float32
            or op.row_ptr.shape != (op.n + 1,) or op.vals.shape != (nnz,)):
        raise ValueError("coo_spmv takes int32 row_ptr (n+1,), int32 cols "
                         "(nnz,) and float32 vals (nnz,)")


def coo_spmv(op, x: torch.Tensor) -> torch.Tensor:
    """A · X for a ``graph.sparse.CooGraph`` ``op``.

    A CPU ``x`` takes the plain version; a CUDA ``x`` launches the kernel on
    the current stream (and raises if it cannot)."""
    _check(op, x)
    if not on_cuda(x, op.row_ptr, op.cols, op.vals, op.rows):
        return coo_spmv_plain(op.rows, op.cols, op.vals, x, op.n)
    check_no_grad("coo_spmv", x)
    lib = build.load()
    d = x.shape[1]
    y = torch.empty((op.n, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.ndcn_coo_spmv_f32(
            op.row_ptr.data_ptr(), op.cols.data_ptr(), op.vals.data_ptr(),
            x.data_ptr(), y.data_ptr(), op.n, d,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"coo_spmv kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return y
