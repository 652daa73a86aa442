"""K1 and its feature-major forms: A · X for a row-sorted sparse A in CSR
form, differentiable in X.

- ``coo_spmv(op, x)``: X (n, d) row-major fp32 → A·X (n, d). The CUDA kernel
  is ``ndcn_tpu_torch/csrc/coo_spmv.cu``; it replaces the TPU's sliced-tile
  segment-sum (``ndcn_tpu/kernels/coo_spmv.py::_make_kernel``), which the
  JAX package also reaches from the (n, d) layout (``tiled_spmv``).
- ``spmv_T(op, xT)``: xT (d_sub, n) fp32 → (A·X)ᵀ (d_sub, n), the
  feature-major solve's product (``ndcn_tpu/kernels/coo_spmv.py::spmv_T``).
  The forward is K1-fm (``csrc/coo_spmv_T.cu``), or K5 under
  ``GATHER_WIDE``, which gathers from a row-major (n, d_sub) table
  (``_make_kernel_wide``).

Each backward is the same kernel over the transpose CSR that ``CooGraph``
holds (``row_ptr_t``, ``cols_t``, ``vals_t``), as the JAX backward runs the
TPU kernel over ``tiles_t``. The operator is a constant: a gradient asked of
its values is NaN (the JAX package's NaN-poison policy).

``GATHER_BF16`` and ``GATHER_WIDE`` are the JAX package's module switches,
read at call time; the experiments set ``GATHER_BF16`` (``--kernel_precision
bf16``) through ``gather_precision``. In bf16 mode every form rounds the
state to bf16 once per call and rounds vals to bf16 (the TPU kernel folds
them into its bf16 one-hot); products of two bf16 values are exact in fp32
and the sums stay fp32. As in the JAX package, a width-1 state (the physics
solve) is never rounded: its path there is not the tiled kernel.
``GATHER_WIDE`` changes only ``spmv_T``: the row-major K1 already gathers
contiguous rows, the content of the wide mode.

The plain PyTorch versions beside the kernels (gather, scale, ``index_add_``,
with the same rounding) are the CPU path, inside the same
``autograd.Function``s, and the reference the kernels are held against on
the card. On CUDA tensors nothing falls back to them.
"""

from __future__ import annotations

import contextlib

import torch

from ndcn_tpu_torch.kernels import build
from ndcn_tpu_torch.kernels.platform import on_cuda

# launches of the CUDA kernels in this process, forward and backward (CPU
# calls do not count): row-major K1 in fp32 and in bf16, K1-fm, K5
LAUNCHES = 0
BF16_LAUNCHES = 0
T_LAUNCHES = 0
WIDE_LAUNCHES = 0

# the JAX package's switches (ndcn_tpu/kernels/coo_spmv.py), read per call
GATHER_BF16 = False
GATHER_WIDE = False

# K5's row-major table: d_sub up to the JAX package's wide lane width
D_WIDE = 128


@contextlib.contextmanager
def gather_precision(bf16: bool):
    """Set ``GATHER_BF16`` for the duration of a run, then restore it."""
    global GATHER_BF16
    saved, GATHER_BF16 = GATHER_BF16, bool(bf16)
    try:
        yield
    finally:
        GATHER_BF16 = saved


def sublane_pad(d: int) -> int:
    """The feature-major state's padded feature count: d rounded up to 8, at
    least 8 (bit-equal to ``ndcn_tpu.kernels.coo_spmv.sublane_pad``)."""
    return max(8, -(-d // 8) * 8)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to bf16 (nearest even) and back."""
    return t.to(torch.bfloat16).to(torch.float32)


def coo_spmv_plain(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                   x: torch.Tensor, n: int, bf16: bool = False) -> torch.Tensor:
    """Gather, scale, scatter-add: the plain version of K1 (and of its bf16
    instance with ``bf16``)."""
    if bf16:
        x, vals = round_bf16(x), round_bf16(vals)
    return torch.zeros((n, x.shape[1]), dtype=torch.float32,
                       device=x.device).index_add_(0, rows,
                                                   vals[:, None] * x[cols])


def coo_spmv_T_plain(rows: torch.Tensor, cols: torch.Tensor,
                     vals: torch.Tensor, xT: torch.Tensor, n: int,
                     bf16: bool = False) -> torch.Tensor:
    """The plain version of K1-fm: gather the columns of xT, scale, add
    them into the output's columns."""
    if bf16:
        xT, vals = round_bf16(xT), round_bf16(vals)
    return torch.zeros((xT.shape[0], n), dtype=torch.float32,
                       device=xT.device).index_add_(1, rows,
                                                    xT[:, cols] * vals)


def coo_spmv_T_wide_plain(rows: torch.Tensor, cols: torch.Tensor,
                          vals: torch.Tensor, xT: torch.Tensor, n: int,
                          bf16: bool = False) -> torch.Tensor:
    """The plain version of K5: gather rows of the row-major table xTᵀ,
    scale, add into rows, and return the result feature-major."""
    return coo_spmv_plain(rows, cols, vals, xT.t(), n, bf16).t().contiguous()


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


def _launch(entry: str, row_ptr, cols, vals, x: torch.Tensor, y: torch.Tensor,
            n: int, d: int) -> None:
    lib = build.load()
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(
            row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
            x.data_ptr(), y.data_ptr(), n, d,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")


def _apply(row_ptr, rows, cols, vals, x: torch.Tensor, n: int) -> torch.Tensor:
    """One row-major product over one CSR: the kernel for CUDA tensors, else
    the plain version."""
    bf16 = GATHER_BF16 and x.shape[1] > 1
    if not on_cuda(x, row_ptr, cols, vals, rows):
        return coo_spmv_plain(rows, cols, vals, x, n, bf16)
    global LAUNCHES, BF16_LAUNCHES
    x = x.contiguous()
    d = x.shape[1]
    y = torch.empty((n, d), dtype=torch.float32, device=x.device)
    if bf16:
        _launch("ndcn_coo_spmv_bf16", row_ptr, cols, vals,
                x.to(torch.bfloat16), y, n, d)
        BF16_LAUNCHES += 1
    else:
        _launch("ndcn_coo_spmv_f32", row_ptr, cols, vals, x, y, n, d)
        LAUNCHES += 1
    return y


def _apply_T(row_ptr, rows, cols, vals, xT: torch.Tensor,
             n: int) -> torch.Tensor:
    """One feature-major product over one CSR: K1-fm, or K5 under
    ``GATHER_WIDE``, for CUDA tensors; else the plain version."""
    bf16, wide = GATHER_BF16, GATHER_WIDE
    if not on_cuda(xT, row_ptr, cols, vals, rows):
        plain = coo_spmv_T_wide_plain if wide else coo_spmv_T_plain
        return plain(rows, cols, vals, xT, n, bf16)
    global T_LAUNCHES, WIDE_LAUNCHES
    d_sub = xT.shape[0]
    src = xT.to(torch.bfloat16) if bf16 else xT.contiguous()
    y = torch.empty((d_sub, n), dtype=torch.float32, device=xT.device)
    kind = "bf16" if bf16 else "f32"
    if wide:
        # the row-major (n, d_sub) table, materialised once per call
        _launch(f"ndcn_coo_spmv_T_wide_{kind}", row_ptr, cols, vals,
                src.t().contiguous(), y, n, d_sub)
        WIDE_LAUNCHES += 1
    else:
        _launch(f"ndcn_coo_spmv_T_{kind}", row_ptr, cols, vals,
                src.contiguous(), y, n, d_sub)
        T_LAUNCHES += 1
    return y


def _nan_grads(ctx, op, first: int):
    """NaN cotangents for the operator's values (inputs ``first`` and
    ``first + 1``), where asked."""
    return tuple(torch.full_like(v, float("nan"))
                 if ctx.needs_input_grad[first + i] else None
                 for i, v in enumerate((op.vals, op.vals_t)))


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
        return (None, *_nan_grads(ctx, op, 1), dx)


class _SpmvT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, vals, vals_t, xT):
        ctx.op = op
        return _apply_T(op.row_ptr, op.rows, op.cols, vals, xT, op.n)

    @staticmethod
    def backward(ctx, gT):
        op = ctx.op
        dxT = (_apply_T(op.row_ptr_t, op.rows_t, op.cols_t, op.vals_t,
                        gT.contiguous(), op.n)
               if ctx.needs_input_grad[3] else None)
        return (None, *_nan_grads(ctx, op, 1), dxT)


def coo_spmv(op, x: torch.Tensor) -> torch.Tensor:
    """A · X for a ``graph.sparse.CooGraph`` ``op``, differentiable in x.

    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    current stream, forward and backward (and raise if it cannot)."""
    _check(op, x)
    if not x.is_contiguous():
        raise ValueError("coo_spmv takes a contiguous (row-major) x")
    return _CooSpmv.apply(op, op.vals, op.vals_t, x)


def spmv_T(op, xT: torch.Tensor) -> torch.Tensor:
    """(A · X)ᵀ for xT = Xᵀ of shape (d_sub, n), differentiable in xT; the
    feature-major counterpart of ``coo_spmv`` (same device rules)."""
    if xT.ndim != 2:
        raise ValueError(f"spmv_T takes xT of shape (d_sub, {op.n}), got "
                         f"{tuple(xT.shape)}")
    _check(op, xT.t())
    if not xT.is_contiguous():
        raise ValueError("spmv_T takes a contiguous (feature-major) xT")
    if GATHER_WIDE and xT.shape[0] > D_WIDE:
        raise ValueError(f"the wide gather takes d_sub <= {D_WIDE}, got "
                         f"{xT.shape[0]}")
    return _SpmvT.apply(op, op.vals, op.vals_t, xT)
