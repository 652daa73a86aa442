"""K1-w: the mutualistic interaction over a COO operator, differentiable in x.

    coo_mutual_inter(op, x, d, e, h)[r, m]
        = sum over the edges (r, c, v) of A of v · x[r,m] x[c,m] / D,
          D = d + e·x[r,m] + h·x[c,m]   (a zero D divides as 1)

It is ``ndcn_tpu/dynamics/rhs.py::_coo_mutual_inter``. There, with a tile
packing on the TPU, the pair term and the two partials of the backward are
evaluated per tile slot and reduced by the Pallas segment-sum
(``_tiled_weighted_reduce``, :109, reaching ``pl.pallas_call`` at
``ndcn_tpu/kernels/coo_spmv.py:314``): the forward over ``op.tiles``, the
backward over ``op.tiles`` (the x_i side) and ``op.tiles_t`` (the x_j side,
whose cotangent is gathered at the edge's row). The CUDA kernel
(``csrc/coo_mutual.cu``) evaluates the same three sums as it walks the
``CooGraph``'s CSR and transpose CSR with K1's warp layout
(``csrc/spmv_gather.cuh``): long rows through ``split`` / ``split_t``, fp32
sums in a fixed order, no atomics, so two calls agree bit for bit.

fp32 only: ``coo_spmv.GATHER_BF16`` does not reach it. In the JAX package
the mutualistic physics always runs on the CPU backend, where the tiled
path is off, so its answers there are fp32 too.

``coo_mutual_inter_plain`` is the JAX package's untiled branch (gather both
endpoints, weight, ``index_add_`` at the row; the backward by the same
explicit formulas, not by autograd of the forward). CPU tensors take it;
CUDA tensors take the kernel, which raises if it cannot build or launch.
The forward saves x; the operator's values get NaN cotangents, as in K1.
"""

from __future__ import annotations

import torch

from ndcn_tpu_torch.kernels.coo_spmv import (_call, _check, _gather_width,
                                             _nan_grads)
from ndcn_tpu_torch.kernels.platform import on_cuda

# calls of the C entry in this process (the forward is one, the backward
# two: its row side and its column side); CPU calls do not count
LAUNCHES = 0

# the C entry's three sums
FORWARD, ROW_SIDE, COLUMN_SIDE = 0, 1, 2


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return num / torch.where(den == 0.0, 1.0, den)


def mutual_forward_plain(op, x: torch.Tensor, d: float, e: float,
                         h: float) -> torch.Tensor:
    """The forward sum by gather, weight and ``index_add_``."""
    xi, xj = x[op.rows], x[op.cols]
    contrib = op.vals[:, None] * _safe_div(xi * xj, d + e * xi + h * xj)
    return torch.zeros_like(x).index_add_(0, op.rows, contrib)


def mutual_backward_plain(op, x: torch.Tensor, g: torch.Tensor, d: float,
                          e: float, h: float) -> torch.Tensor:
    """dx from the per-edge partials of p = x_i x_j / D: ∂p/∂x_i = x_j (d +
    h x_j) / D² summed at the edge's row, ∂p/∂x_j = x_i (d + e x_i) / D²
    summed at its column over the transpose triplets."""
    xi, xj = x[op.rows], x[op.cols]
    den = d + e * xi + h * xj
    term_i = op.vals[:, None] * g[op.rows] * _safe_div(xj * (d + h * xj),
                                                       den * den)
    dx = torch.zeros_like(x).index_add_(0, op.rows, term_i)
    xi_t, xj_t = x[op.cols_t], x[op.rows_t]   # the edge's row, its column
    den_t = d + e * xi_t + h * xj_t
    term_j = op.vals_t[:, None] * g[op.cols_t] * _safe_div(
        xi_t * (d + e * xi_t), den_t * den_t)
    return dx + torch.zeros_like(x).index_add_(0, op.rows_t, term_j)


def _launch(side: int, op, x: torch.Tensor, g: torch.Tensor,
            y: torch.Tensor, coef, accumulate: bool) -> None:
    """One side of the kernel over ``op``'s forward CSR (for the column
    side, the caller passes the transpose)."""
    global LAUNCHES
    dim = x.shape[1]
    split = op.split
    n_chunks = split.chunk_bounds.shape[0]
    partial = (torch.empty((n_chunks, dim), dtype=torch.float32,
                           device=x.device) if n_chunks else None)
    _call("ndcn_coo_mutual_f32", x.device, side, op.row_ptr.data_ptr(),
          op.rows.data_ptr(), op.cols.data_ptr(), op.vals.data_ptr(),
          x.data_ptr(), g.data_ptr(), y.data_ptr(), op.n, dim,
          min(_gather_width(x), _gather_width(g)), *coef, int(accumulate),
          split.limit, split.long_rows.data_ptr(),
          split.chunk_ptr.data_ptr(), split.chunk_bounds.data_ptr(),
          split.long_rows.shape[0], n_chunks,
          partial.data_ptr() if n_chunks else None)
    LAUNCHES += 1


def mutual_forward(op, x: torch.Tensor, d: float, e: float,
                   h: float) -> torch.Tensor:
    """The forward sum by the kernel (one launch), for contiguous CUDA
    tensors."""
    y = torch.empty_like(x)
    _launch(FORWARD, op, x, x, y, (d, e, h), False)
    return y


def mutual_backward(op, x: torch.Tensor, g: torch.Tensor, d: float,
                    e: float, h: float) -> torch.Tensor:
    """dx by the kernel: the row side over A's CSR writes it, the column
    side over the transpose CSR adds to it (two launches)."""
    dx = torch.empty_like(x)
    _launch(ROW_SIDE, op, x, g, dx, (d, e, h), False)
    _launch(COLUMN_SIDE, op.transpose(), x, g, dx, (d, e, h), True)
    return dx


class _CooMutual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, vals, vals_t, x, d, e, h, plain):
        ctx.op, ctx.coef, ctx.plain = op, (d, e, h), plain
        ctx.save_for_backward(x)
        fwd = mutual_forward_plain if plain else mutual_forward
        return fwd(op, x, d, e, h)

    @staticmethod
    def backward(ctx, g):
        op = ctx.op
        (x,) = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[3]:
            bwd = mutual_backward_plain if ctx.plain else mutual_backward
            dx = bwd(op, x, g.contiguous(), *ctx.coef)
        return (None, *_nan_grads(ctx, op, 1), dx, None, None, None, None)


def _apply(op, x: torch.Tensor, d, e, h, plain: bool) -> torch.Tensor:
    _check(op, x, "coo_mutual_inter")
    _check(op.transpose(), x, "coo_mutual_inter")
    if not x.is_contiguous():
        raise ValueError("coo_mutual_inter takes a contiguous (row-major) x")
    return _CooMutual.apply(op, op.vals, op.vals_t, x, float(d), float(e),
                            float(h), plain)


def coo_mutual_inter(op, x: torch.Tensor, d: float, e: float,
                     h: float) -> torch.Tensor:
    """The interaction for a ``graph.sparse.CooGraph`` ``op`` and x (n, d)
    fp32. CPU tensors take the plain version; CUDA tensors launch the
    kernel, forward and backward (and raise if it cannot)."""
    plain = not on_cuda(x, *op[:8], *op.split[:3], *op.split_t[:3])
    return _apply(op, x, d, e, h, plain)


def coo_mutual_inter_plain(op, x: torch.Tensor, d: float, e: float,
                           h: float) -> torch.Tensor:
    """The plain version on any device, differentiable by the same
    explicit backward."""
    return _apply(op, x, d, e, h, True)
