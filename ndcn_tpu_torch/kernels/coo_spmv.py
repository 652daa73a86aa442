"""K1: Y = A · X for a row-sorted sparse A in CSR form, X (n, d) row-major fp32,
differentiable in X.

The CUDA kernel is ``ndcn_tpu_torch/csrc/coo_spmv.cu``; it replaces the TPU's
sliced-tile segment-sum (``ndcn_tpu/kernels/coo_spmv.py::_make_kernel``). Its
backward is the same kernel over the transpose CSR that ``CooGraph`` holds
(``row_ptr_t``, ``cols_t``, ``vals_t``), as ``tiled_spmv``'s backward runs the
TPU kernel over ``tiles_t``. The operator is a constant: a gradient asked of
its values is NaN (the JAX package's NaN-poison policy), so a model that
tries to learn it fails loudly.

The plain PyTorch version beside the kernel is the CPU path, inside the same
``autograd.Function``, and the reference the kernel is held against on the
card.
"""

from __future__ import annotations

import torch

from ndcn_tpu_torch.kernels import build
from ndcn_tpu_torch.kernels.platform import on_cuda

# launches of the CUDA kernel in this process, forward and backward (CPU calls
# do not count)
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
    nnz = op.cols.shape[0]
    if (op.row_ptr.dtype != torch.int32 or op.cols.dtype != torch.int32
            or op.vals.dtype != torch.float32
            or op.row_ptr.shape != (op.n + 1,) or op.vals.shape != (nnz,)):
        raise ValueError("coo_spmv takes int32 row_ptr (n+1,), int32 cols "
                         "(nnz,) and float32 vals (nnz,)")


def _apply(row_ptr, rows, cols, vals, x: torch.Tensor, n: int) -> torch.Tensor:
    """One product over one CSR: the kernel for CUDA tensors, else the plain
    version."""
    if not on_cuda(x, row_ptr, cols, vals, rows):
        return coo_spmv_plain(rows, cols, vals, x, n)
    x = x.contiguous()
    lib = build.load()
    d = x.shape[1]
    y = torch.empty((n, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.ndcn_coo_spmv_f32(
            row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
            x.data_ptr(), y.data_ptr(), n, d,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"coo_spmv kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return y


class _CooSpmv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, vals, vals_t, x):
        ctx.op = op
        return _apply(op.row_ptr, op.rows, op.cols, vals, x, op.n)

    @staticmethod
    def backward(ctx, g):
        op = ctx.op
        dx = (_apply(op.row_ptr_t, op.rows_t, op.cols_t, op.vals_t, g, op.n)
              if ctx.needs_input_grad[3] else None)
        dvals, dvals_t = (torch.full_like(v, float("nan")) if need else None
                          for v, need in ((op.vals, ctx.needs_input_grad[1]),
                                          (op.vals_t, ctx.needs_input_grad[2])))
        return None, dvals, dvals_t, dx


def coo_spmv(op, x: torch.Tensor) -> torch.Tensor:
    """A · X for a ``graph.sparse.CooGraph`` ``op``, differentiable in x.

    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    current stream, forward and backward (and raise if it cannot)."""
    _check(op, x)
    if not x.is_contiguous():
        raise ValueError("coo_spmv takes a contiguous (row-major) x")
    return _CooSpmv.apply(op, op.vals, op.vals_t, x)
