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
whose cotangent is gathered at the edge's row). The CUDA kernels evaluate
the same three sums over the ``CooGraph``'s CSR and transpose CSR in one of
two forms, which ``mutual_plan`` picks by width:

- the edge form (``csrc/coo_mutual_edges.cu``; d up to
  ``EDGE_MAX_WIDTH``, and every driver runs d = 1): a CTA of 256 threads
  owns a run of consecutive edges, each thread 4 of them, with their rows
  from an int32 copy of the operator's sorted rows (``rows32``); runs of
  equal row are summed by a segmented warp reduction in a fixed order.
  The CTA where a row starts sums it to its end; where the CSR has long
  rows (``split``), the runs at a CTA's edges go through a small carry
  scratch (two slots a CTA) that a second kernel adds in CTA order
  instead, so a hub row is many CTAs' work and needs no chunk index.
- the warp form (``csrc/coo_mutual.cu``; wider rows): K1's warp layout
  (``csrc/spmv_gather.cuh``), long rows through ``split`` / ``split_t``.

Both sum in fp32 in a fixed order without atomics, so two calls agree bit
for bit. The rule is by width alone, from ``tools/tune_mutual_plan.py`` on
an H100 (PERF.md, PR 8). The edge form wins on hub rows (d = 1: 0.43× the
warp form's forward time, 0.53× its backward), on the 1M adjacency (0.91×
/ 0.93×) and at d = 3 to 8 on the 200k one (0.52-0.99×). It loses where
the warp form's rows are short and even: at d = 1 and 2 on the drivers'
200k adjacency by 3 % in the forward and up to 6 % in the backward (its 4
bytes an edge of rows), level at 50k; on the hub graph at d = 6 by 3 %;
and by ~1 µs in the forward over the hub graph's transpose, whose
backward it halves. Those losses are accepted for one path a width on
every graph, in place of a threshold on the edge count fitted to a few
graphs: the drivers' mutualistic ground truth makes its K1-w calls from a
host-bound solver loop, where 4 µs a backward does not show.

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

from typing import NamedTuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ndcn_tpu_torch.kernels.coo_spmv import (_call, _check, _gather_width,
                                             _nan_grads)
from ndcn_tpu_torch.kernels.platform import on_cuda

# calls of the C entries in this process (the forward is one, the backward
# two: its row side and its column side), of either form; CPU calls do not
# count
LAUNCHES = 0
# those of them that ran the edge form
EDGE_LAUNCHES = 0

# the C entries' three sums
FORWARD, ROW_SIDE, COLUMN_SIDE = 0, 1, 2

# the edge form: threads a CTA, edges a thread (8 lost to 4 at every width
# and graph measured: tools/tune_mutual_plan.py)
EDGE_THREADS = 256
EDGES_PER_THREAD = 4
# the widest state the edge form is built for and takes (to d = 8 a
# thread's terms still fit its registers, and it wins at d = 3 to 8 on
# the 200k adjacency and the hub graph but at d = 6); wider ones take the
# warp form
EDGE_MAX_WIDTH = 8

# the int32 copies of operators' sorted rows that the edge form reads, by
# the int64 rows tensor they copy (an operator's, or its transpose's)
_ROWS32 = WeakIdKeyDictionary()


class MutualPlan(NamedTuple):
    """How one side of K1-w is launched over a CSR of ``nnz`` edges.

    ``form`` is "edges" or "rows" (the warp form). For the edge form CTA b
    owns edges ``[b · cta_edges, (b + 1) · cta_edges)``, thread t of it the
    ``edges_per_thread`` from ``b · cta_edges + t · edges_per_thread``.
    Where the CSR has long rows, the CTA's first and last run go to carry
    slots 2b and 2b + 1 and a second kernel adds them (``carry_slots`` =
    2 · ctas); else the CTA where a row starts sums it to its end, reading
    on past its range, and there are no carries (``carry_slots`` = 0)."""
    form: str
    edges_per_thread: int
    cta_edges: int
    ctas: int
    carry_slots: int


def row_load(d: int) -> int:
    """Floats of one load of a state row in the edge form: the largest of 4,
    2, 1 that divides d."""
    return 4 if d % 4 == 0 else 2 if d % 2 == 0 else 1


def mutual_plan(d: int, nnz: int, aligned: bool = True,
                long_rows: bool = False) -> MutualPlan:
    """The launch of one side at width d: the edge form up to
    ``EDGE_MAX_WIDTH`` where the state's rows are ``aligned`` to
    ``row_load(d)`` floats, the warp form otherwise; carry slots where the
    CSR has ``long_rows``."""
    if d > EDGE_MAX_WIDTH or not aligned:
        return MutualPlan("rows", 0, 0, 0, 0)
    cta_edges = EDGE_THREADS * EDGES_PER_THREAD
    ctas = -(-nnz // cta_edges)
    return MutualPlan("edges", EDGES_PER_THREAD, cta_edges, ctas,
                      2 * ctas if long_rows else 0)


def rows32(rows: torch.Tensor) -> torch.Tensor:
    """An operator's sorted int64 ``rows`` (or its transpose's) as int32, as
    the edge form reads them: made at the first call that needs them and
    kept while ``rows`` lives, 4 bytes an edge of device memory (44 MB a
    direction at 1M nodes / 11M entries)."""
    out = _ROWS32.get(rows)
    if out is None:
        out = _ROWS32[rows] = rows.to(torch.int32)
    return out


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
    side, the caller passes the transpose), in ``mutual_plan``'s form."""
    global LAUNCHES, EDGE_LAUNCHES
    dim = x.shape[1]
    nnz = op.cols.shape[0]
    split = op.split
    widths = min(_gather_width(x), _gather_width(g))
    plan = mutual_plan(dim, nnz, aligned=widths >= 4 * row_load(dim),
                       long_rows=bool(split.long_rows.shape[0]))
    if plan.form == "edges":
        rows = rows32(op.rows)
        carry_rows = torch.empty(plan.carry_slots, dtype=torch.int32,
                                 device=x.device)
        carry_sums = torch.empty((plan.carry_slots, dim),
                                 dtype=torch.float32, device=x.device)
        aligned = all(t.data_ptr() % 16 == 0 for t in (rows, op.cols, op.vals))
        _call("ndcn_coo_mutual_edges_f32", x.device, side, rows.data_ptr(),
              op.cols.data_ptr(), op.vals.data_ptr(), x.data_ptr(),
              g.data_ptr(), y.data_ptr(), op.n, nnz, dim, *coef,
              int(accumulate), int(aligned), int(plan.carry_slots == 0),
              carry_rows.data_ptr(), carry_sums.data_ptr())
        LAUNCHES += 1
        EDGE_LAUNCHES += 1
        return
    n_chunks = split.chunk_bounds.shape[0]
    partial = (torch.empty((n_chunks, dim), dtype=torch.float32,
                           device=x.device) if n_chunks else None)
    _call("ndcn_coo_mutual_f32", x.device, side, op.row_ptr.data_ptr(),
          op.rows.data_ptr(), op.cols.data_ptr(), op.vals.data_ptr(),
          x.data_ptr(), g.data_ptr(), y.data_ptr(), op.n, dim, widths,
          *coef, int(accumulate), split.limit, split.long_rows.data_ptr(),
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
