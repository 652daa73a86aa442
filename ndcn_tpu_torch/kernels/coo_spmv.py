"""K1 and its feature-major forms: A · X for a row-sorted sparse A in CSR
form, differentiable in X.

- ``coo_spmv(op, x)``: X (n, d) row-major fp32 → A·X (n, d). The CUDA kernel
  is ``ndcn_tpu_torch/csrc/coo_spmv.cu``; it replaces the TPU's sliced-tile
  segment-sum (``ndcn_tpu/kernels/coo_spmv.py::_make_kernel``), which the
  JAX package also reaches from the (n, d) layout (``tiled_spmv``).
- ``spmv_T(op, xT)``: xT (d_sub, n) fp32 → (A·X)ᵀ (d_sub, n), the
  feature-major solve's product (``ndcn_tpu/kernels/coo_spmv.py::spmv_T``).
  The forward is K1-fm (``csrc/coo_spmv_T.cu``): a pack kernel copies xT
  into a row-major (n, d_sub) scratch (``pack_rows``), and the gather kernel
  reads whole rows of it and stores its result feature-major. Under
  ``GATHER_WIDE`` it is K5, which gathers from a row-major table made by a
  transpose copy (``_make_kernel_wide``).

K1 and K1-fm share one warp-level gather (``csrc/spmv_gather.cuh``): rows of
the gathered table are read with the widest load that divides a row's bytes
(16, 8, 4 or 2), and the lanes left over carry further edges (of further
rows too, where a row takes one or two lanes). Rows longer
than ``SPLIT_EDGES`` are cut into chunks by an index built with the operator
(``split_rows``): a warp sums each chunk into a scratch row, and a second
pass folds a row's chunks in chunk order. No atomics anywhere: the order of
every sum is fixed by the operator and the width, so results repeat bit for
bit, which the adaptive step controller needs for repeatable NFE.

Each backward is the same kernel over the transpose CSR that ``CooGraph``
holds (``row_ptr_t``, ``cols_t``, ``vals_t``, ``split_t``), as the JAX
backward runs the TPU kernel over ``tiles_t``. The operator is a constant: a
gradient asked of its values is NaN (the JAX package's NaN-poison policy).

``GATHER_BF16`` and ``GATHER_WIDE`` are the JAX package's module switches,
read at call time; the experiments set ``GATHER_BF16`` (``--kernel_precision
bf16``) through ``gather_precision``. In bf16 mode every form rounds the
state to bf16 once per call (K1-fm as it packs) and rounds vals to bf16 (the
TPU kernel folds them into its bf16 one-hot); products of two bf16 values
are exact in fp32 and the sums stay fp32. As in the JAX package, a width-1
state (the physics solve) is never rounded: its path there is not the tiled
kernel. ``GATHER_WIDE`` changes only ``spmv_T``: the row-major K1 already
gathers contiguous rows, the content of the wide mode.

The plain PyTorch versions beside the kernels (gather, scale, ``index_add_``,
with the same rounding) are the CPU path, inside the same
``autograd.Function``s, and the reference the kernels are held against on
the card. On CUDA tensors nothing falls back to them.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from ndcn_tpu_torch.kernels import build
from ndcn_tpu_torch.kernels.platform import on_cuda

# launches of the CUDA kernels in this process, forward and backward (CPU
# calls do not count): row-major K1 in fp32 and in bf16, K1-fm's gather and
# its pack kernel, K5
LAUNCHES = 0
BF16_LAUNCHES = 0
T_LAUNCHES = 0
PACK_LAUNCHES = 0
WIDE_LAUNCHES = 0

# the JAX package's switches (ndcn_tpu/kernels/coo_spmv.py), read per call
GATHER_BF16 = False
GATHER_WIDE = False

# K5's row-major table: d_sub up to the JAX package's wide lane width
D_WIDE = 128

# rows with more edges than this are cut into chunks of this many edges
SPLIT_EDGES = 256


class RowSplit(NamedTuple):
    """The chunks of one CSR's long rows. Row ``long_rows[j]`` has more than
    ``limit`` edges; its chunks are ``chunk_ptr[j] .. chunk_ptr[j + 1]``, and
    chunk c covers the edges ``chunk_bounds[c, 0] .. chunk_bounds[c, 1]``,
    consecutive and in order. Every other row is walked whole."""
    long_rows: torch.Tensor     # (n_long,) int32
    chunk_ptr: torch.Tensor     # (n_long + 1,) int32
    chunk_bounds: torch.Tensor  # (n_chunks, 2) int32
    limit: int


def split_rows(row_ptr: np.ndarray, limit: int = SPLIT_EDGES,
               device: Optional[torch.device] = None) -> RowSplit:
    """Cut the rows of a CSR pointer that are longer than ``limit`` into
    chunks of ``limit`` edges (the last one shorter), on the host."""
    if limit < 1:
        raise ValueError(f"split_rows takes a limit >= 1, got {limit}")
    row_ptr = np.asarray(row_ptr, np.int64)
    long_rows = np.flatnonzero(np.diff(row_ptr) > limit)
    starts, ends = row_ptr[long_rows], row_ptr[long_rows + 1]
    per_row = -(-(ends - starts) // limit)
    chunk_ptr = np.concatenate([[0], np.cumsum(per_row)])
    owner = np.repeat(np.arange(long_rows.size), per_row)
    lo = starts[owner] + (np.arange(chunk_ptr[-1]) - chunk_ptr[owner]) * limit
    bounds = np.stack([lo, np.minimum(lo + limit, ends[owner])], axis=1)
    return RowSplit(*(torch.as_tensor(a.astype(np.int32), device=device)
                      for a in (long_rows, chunk_ptr, bounds)), limit)


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


def coo_spmv_split_plain(row_ptr: torch.Tensor, cols: torch.Tensor,
                         vals: torch.Tensor, split: RowSplit,
                         x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """The plain version of K1's two passes over the chunk index: short rows
    are summed whole, each chunk of a long row into a scratch row, and a long
    row's scratch rows are then added in chunk order."""
    if bf16:
        x, vals = round_bf16(x), round_bf16(vals)
    n = row_ptr.shape[0] - 1
    lens = torch.diff(row_ptr.long())
    rows = torch.repeat_interleave(torch.arange(n, device=x.device), lens)
    contrib = vals[:, None] * x[cols]
    short = (lens <= split.limit)[rows]
    y = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
    y.index_add_(0, rows[short], contrib[short])
    bounds = split.chunk_bounds.long()
    n_chunks = bounds.shape[0]
    sizes = bounds[:, 1] - bounds[:, 0]
    # every edge the chunks cover, in chunk order, and its chunk
    chunk_of = torch.repeat_interleave(
        torch.arange(n_chunks, device=x.device), sizes)
    edges = (torch.arange(int(sizes.sum()), device=x.device)
             + (bounds[:, 0] - (torch.cumsum(sizes, 0) - sizes))[chunk_of])
    if not torch.equal(edges, torch.nonzero(~short).flatten()):
        raise ValueError("the chunk index does not cover the long rows' "
                         "edges once and in order")
    partial = torch.zeros((n_chunks, x.shape[1]), dtype=torch.float32,
                          device=x.device).index_add_(0, chunk_of,
                                                      contrib[edges])
    ptr = split.chunk_ptr.tolist()
    for j, row in enumerate(split.long_rows.tolist()):
        acc = torch.zeros_like(y[row])
        for c in range(ptr[j], ptr[j + 1]):
            acc = acc + partial[c]
        y[row] = acc
    return y


def pack_rows_plain(xT: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """The plain version of K1-fm's pack kernel: the feature-major (d_sub, n)
    state as a row-major (n, d_sub) table, rounded to bf16 with ``bf16``."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    return torch.empty((xT.shape[1], xT.shape[0]), dtype=dtype,
                       device=xT.device).copy_(xT.t())


def _check(op, x: torch.Tensor, what: str = "coo_spmv") -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 x, got {x.dtype}")
    if x.ndim != 2 or x.shape[0] != op.n or x.shape[1] < 1:
        raise ValueError(f"{what} takes x of shape ({op.n}, d >= 1), "
                         f"got {tuple(x.shape)}")
    nnz = op.cols.shape[0]
    if (op.row_ptr.dtype != torch.int32 or op.cols.dtype != torch.int32
            or op.vals.dtype != torch.float32
            or op.row_ptr.shape != (op.n + 1,) or op.vals.shape != (nnz,)):
        raise ValueError(f"{what} takes int32 row_ptr (n+1,), int32 cols "
                         f"(nnz,) and float32 vals (nnz,)")
    long_rows, chunk_ptr, chunk_bounds, _ = op.split
    if (any(t.dtype != torch.int32 for t in op.split[:3])
            or chunk_ptr.shape != (long_rows.shape[0] + 1,)
            or chunk_bounds.ndim != 2 or chunk_bounds.shape[1] != 2):
        raise ValueError(f"{what} takes the int32 chunk index that "
                         f"split_rows builds: long_rows (n_long,), chunk_ptr "
                         f"(n_long + 1,), chunk_bounds (n_chunks, 2)")


def _call(entry: str, device: torch.device, *args) -> None:
    """Call the C entry with ``args`` and ``device``'s current stream, and
    raise if it reports a refused launch."""
    with torch.cuda.device(device):
        rc = getattr(build.load(), entry)(
            *args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")


def _gather_width(table: torch.Tensor) -> int:
    """Bytes of one lane's load: the widest of 16, 8, 4, 2 that divides both
    a row's bytes and the table's address."""
    row_bytes = table.shape[1] * table.element_size()
    for width in (16, 8, 4, 2):
        if row_bytes % width == 0 and table.data_ptr() % width == 0:
            return width
    raise ValueError(f"the gather takes rows of whole {table.dtype} values "
                     f"at an aligned address; got {row_bytes}-byte rows at "
                     f"{table.data_ptr():#x}")


def _launch_gather(entry: str, op, table: torch.Tensor, y: torch.Tensor,
                   d: int) -> None:
    """One product of the shared gather over ``op``'s forward CSR: the rows
    kernel, and for an operator with long rows the chunk kernel into a
    scratch and the fold, all on the current stream."""
    split = op.split
    n_chunks = split.chunk_bounds.shape[0]
    partial = (torch.empty((n_chunks, d), dtype=torch.float32,
                           device=table.device) if n_chunks else None)
    _call(entry, table.device,
          op.row_ptr.data_ptr(), op.cols.data_ptr(), op.vals.data_ptr(),
          table.data_ptr(), y.data_ptr(), op.n, d, _gather_width(table),
          split.limit, split.long_rows.data_ptr(), split.chunk_ptr.data_ptr(),
          split.chunk_bounds.data_ptr(), split.long_rows.shape[0], n_chunks,
          partial.data_ptr() if n_chunks else None)


def pack_rows(xT: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """K1-fm's pack kernel: a contiguous feature-major fp32 (d_sub, n) state
    as a row-major (n, d_sub) table, fp32 or rounded to bf16. CPU tensors
    take the plain version."""
    if xT.dtype != torch.float32 or xT.ndim != 2 or not xT.is_contiguous():
        raise ValueError(f"pack_rows takes a contiguous float32 (d_sub, n) "
                         f"state, got {xT.dtype} {tuple(xT.shape)}")
    if not on_cuda(xT):
        return pack_rows_plain(xT, bf16)
    global PACK_LAUNCHES
    d_sub, n = xT.shape
    table = torch.empty((n, d_sub), device=xT.device,
                        dtype=torch.bfloat16 if bf16 else torch.float32)
    _call(f"ndcn_pack_rows_{'bf16' if bf16 else 'f32'}", xT.device,
          xT.data_ptr(), table.data_ptr(), n, d_sub)
    PACK_LAUNCHES += 1
    return table


def _apply(op, x: torch.Tensor) -> torch.Tensor:
    """One row-major product over ``op``'s forward CSR: the kernel for CUDA
    tensors, else the plain version."""
    bf16 = GATHER_BF16 and x.shape[1] > 1
    if not on_cuda(x, op.row_ptr, op.cols, op.vals, op.rows, *op.split[:3]):
        return coo_spmv_plain(op.rows, op.cols, op.vals, x, op.n, bf16)
    global LAUNCHES, BF16_LAUNCHES
    x = x.contiguous()
    d = x.shape[1]
    y = torch.empty((op.n, d), dtype=torch.float32, device=x.device)
    if bf16:
        _launch_gather("ndcn_coo_spmv_bf16", op, x.to(torch.bfloat16), y, d)
        BF16_LAUNCHES += 1
    else:
        _launch_gather("ndcn_coo_spmv_f32", op, x, y, d)
        LAUNCHES += 1
    return y


def _apply_T(op, xT: torch.Tensor) -> torch.Tensor:
    """One feature-major product over ``op``'s forward CSR: K1-fm (pack,
    then gather), or K5 under ``GATHER_WIDE``, for CUDA tensors; else the
    plain version."""
    bf16, wide = GATHER_BF16, GATHER_WIDE
    if not on_cuda(xT, op.row_ptr, op.cols, op.vals, op.rows, *op.split[:3]):
        plain = coo_spmv_T_wide_plain if wide else coo_spmv_T_plain
        return plain(op.rows, op.cols, op.vals, xT, op.n, bf16)
    global T_LAUNCHES, WIDE_LAUNCHES
    xT = xT.contiguous()
    d_sub = xT.shape[0]
    y = torch.empty((d_sub, op.n), dtype=torch.float32, device=xT.device)
    kind = "bf16" if bf16 else "f32"
    if wide:
        # the row-major (n, d_sub) table, materialised once per call
        table = (xT.to(torch.bfloat16) if bf16 else xT).t().contiguous()
        _call(f"ndcn_coo_spmv_T_wide_{kind}", xT.device,
              op.row_ptr.data_ptr(), op.cols.data_ptr(), op.vals.data_ptr(),
              table.data_ptr(), y.data_ptr(), op.n, d_sub)
        WIDE_LAUNCHES += 1
    else:
        # the scratch table lives for this call only
        _launch_gather(f"ndcn_coo_spmv_T_{kind}", op, pack_rows(xT, bf16), y,
                       d_sub)
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
        return _apply(op, x)

    @staticmethod
    def backward(ctx, g):
        op = ctx.op
        dx = (_apply(op.transpose(), g)
              if ctx.needs_input_grad[3] else None)
        return (None, *_nan_grads(ctx, op, 1), dx)


class _SpmvT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, vals, vals_t, xT):
        ctx.op = op
        return _apply_T(op, xT)

    @staticmethod
    def backward(ctx, gT):
        op = ctx.op
        dxT = (_apply_T(op.transpose(), gT)
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
