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
  ``GATHER_WIDE`` it is K5 (``_make_kernel_wide``): the same gather over a
  row-major table that one PyTorch copy makes, as the JAX package's wide
  mode materialises its table.

K1, K1-fm and K5 share one warp-level gather (``csrc/spmv_gather.cuh``):
rows of the gathered table are read with the widest load that divides a
row's bytes (16, 8, 4 or 2), and the lanes left over carry further edges (of
further rows too, where a row takes one or two lanes). Rows longer
than ``SPLIT_EDGES`` are cut into chunks by an index built with the operator
(``split_rows``): a warp sums each chunk into a scratch row, and a second
pass folds a row's chunks in chunk order. No atomics anywhere: the order of
every sum is fixed by the operator and the width, so results repeat bit for
bit, which the adaptive step controller needs for repeatable NFE.

A row of K1 wider than one warp's 32 lanes (the raw features of the
citation graphs, and any d past 32 loads) takes K1's wide form
(``ndcn_coo_spmv_wide_*``): a warp for each tile of each row (32 lanes,
each taking up to 4 of the row's lanes), so a wide row's tiles run side
by side, with the same sums in the same order (bit-equal to the narrow
form at those widths). ``gather_plan`` says which form a width takes and
lays out the wide form's grid; K1-fm and K5 keep the narrow form.

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

``coo_spmv`` also takes R replicas' states at once, x (R, n, d) against
the one shared A (the replica sweeps): one launch of the batched form
(``ndcn_coo_spmv_batched_*``, the replica as ``gridDim.y``) per product,
each replica bit-equal to its own launch; its backward is the batched form
over the transpose.

K1 and the gather of K1-fm / K5 also take a ``CsrBlock``, one rank's row
block of the operator on the mesh path (``parallel.coo_shard``): ``n``
output rows against a gathered table of ``n_table`` rows, as they are.
Their launches on a block are counted apart (``ROWBLOCK_LAUNCHES``,
``T_ROWBLOCK_LAUNCHES``), and K1's wide form on a block there too
(``ROWBLOCK_WIDE_LAUNCHES``).

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
# calls do not count): row-major K1 in fp32 and in bf16, its batched form
# (fp32, bf16), each in either form, and counted there too, the wide form
# (fp32 and bf16; one replica, batched); K1-fm's gather and its pack
# kernel, K5; and, counted there alone, K1 in any form and the gather of
# K1-fm or K5 on a ``CsrBlock``, K1's wide form on one also counted apart
LAUNCHES = 0
BF16_LAUNCHES = 0
BATCHED_LAUNCHES = 0
BATCHED_BF16_LAUNCHES = 0
K1_WIDE_LAUNCHES = 0
K1_WIDE_BATCHED_LAUNCHES = 0
T_LAUNCHES = 0
PACK_LAUNCHES = 0
WIDE_LAUNCHES = 0
ROWBLOCK_LAUNCHES = 0
ROWBLOCK_WIDE_LAUNCHES = 0
T_ROWBLOCK_LAUNCHES = 0

# the JAX package's switches (ndcn_tpu/kernels/coo_spmv.py), read per call
GATHER_BF16 = False
GATHER_WIDE = False

# K5's row-major table: d_sub up to the JAX package's wide lane width
D_WIDE = 128

# rows with more edges than this are cut into chunks of this many edges
SPLIT_EDGES = 256
# K1's wide form starts the warps of rows with more edges than this (and
# at most SPLIT_EDGES) before the others: one load of a warp's indices
HEAVY_EDGES = 32

# lanes of a warp: K1's rows wider than this many loads take the wide form
WARP_LANES = 32
# the wide form's lanes take 4 or 2 of a row's lanes only where that leaves
# a row this many tiles (``gather_plan``)
WIDE_MIN_TILES = 8
# warps of a block of the gather kernels (``kGatherThreads`` / 32)
BLOCK_WARPS = 8


class GatherPlan(NamedTuple):
    """How K1 lays a product of rows of d values over the card. A lane
    loads ``lane_values`` values of a row (E: the widest load that divides
    a row's bytes), so a row takes ``row_lanes`` = d / E lanes. Up to a
    warp's 32 the narrow form shares a warp among a row's edges or among
    rows (``csrc/spmv_gather.cuh``); past it (``wide``) a warp takes one
    tile of one row, 32 lanes of ``lane_columns`` row lanes each (32
    apart), ``tiles`` warps a row side by side, and the replica is the
    grid's second axis."""
    wide: bool
    lane_values: int
    row_lanes: int
    lane_columns: int
    tiles: int

    def grid(self, rows: int, replicas: int = 1) -> tuple:
        """(gridDim.x, gridDim.y) of the wide form over ``rows`` rows (or
        chunks) of ``replicas`` states: a warp a tile, 8 warps a block."""
        return -(-rows * self.tiles // BLOCK_WARPS), replicas


def gather_plan(d: int, width: int, itemsize: int,
                columns: Optional[int] = None) -> GatherPlan:
    """K1's form for rows of ``d`` values of ``itemsize`` bytes read
    ``width`` bytes a lane (``_gather_width``): wide where a row takes more
    lanes than a warp has. A wide lane takes ``columns`` row lanes (1, 2 or
    4, at most 4 words of loads an edge) and keeps 32 words of loads in
    flight, so 32 / columns edges' worth at 4-byte loads.

    By default the most row lanes a lane can take that still leave a row
    ``WIDE_MIN_TILES`` tiles, else one. The rule follows the card's numbers
    (``tools/tune_wide_plan.py``, NVIDIA H100 80GB HBM3, 700.00 W): at cora's
    d = 1433 (12 tiles of 128 lanes) 4 columns take 0.0446 ms against 0.062
    for 2 and 0.112 for 1, at citeseer's 3703 0.125 against 0.205 / 0.361
    (fewer waves of warps, and 8 edges in flight enough for rows of some
    five edges); at d = 129 one column takes 0.0148 against 0.0383 for 4,
    whose second tile would hold one live lane in 128."""
    lane_values = width // itemsize
    row_lanes = d // lane_values
    if columns is None:
        words = max(1, width // 4)
        columns = next((c for c in (4, 2) if c * words <= 4 and -(
            -row_lanes // (WARP_LANES * c)) >= WIDE_MIN_TILES), 1)
    return GatherPlan(row_lanes > WARP_LANES, lane_values, row_lanes,
                      columns, -(-row_lanes // (WARP_LANES * columns)))


class RowSplit(NamedTuple):
    """The chunks of one CSR's long rows. Row ``long_rows[j]`` has more than
    ``limit`` edges; its chunks are ``chunk_ptr[j] .. chunk_ptr[j + 1]``, and
    chunk c covers the edges ``chunk_bounds[c, 0] .. chunk_bounds[c, 1]``,
    consecutive and in order. Every other row is walked whole.
    ``heavy_rows``: the rows walked whole that have more than
    ``HEAVY_EDGES`` edges, in order; K1's wide form starts their warps
    first, so that their longer chains run beside the short rows' instead
    of after them (None: no such list, every row in row order)."""
    long_rows: torch.Tensor     # (n_long,) int32
    chunk_ptr: torch.Tensor     # (n_long + 1,) int32
    chunk_bounds: torch.Tensor  # (n_chunks, 2) int32
    limit: int
    heavy_rows: Optional[torch.Tensor] = None   # (n_heavy,) int32


def split_rows(row_ptr: np.ndarray, limit: int = SPLIT_EDGES,
               device: Optional[torch.device] = None) -> RowSplit:
    """Cut the rows of a CSR pointer that are longer than ``limit`` into
    chunks of ``limit`` edges (the last one shorter), and list the heavy
    rows, on the host."""
    if limit < 1:
        raise ValueError(f"split_rows takes a limit >= 1, got {limit}")
    row_ptr = np.asarray(row_ptr, np.int64)
    lens = np.diff(row_ptr)
    long_rows = np.flatnonzero(lens > limit)
    starts, ends = row_ptr[long_rows], row_ptr[long_rows + 1]
    per_row = -(-(ends - starts) // limit)
    chunk_ptr = np.concatenate([[0], np.cumsum(per_row)])
    owner = np.repeat(np.arange(long_rows.size), per_row)
    lo = starts[owner] + (np.arange(chunk_ptr[-1]) - chunk_ptr[owner]) * limit
    bounds = np.stack([lo, np.minimum(lo + limit, ends[owner])], axis=1)
    heavy = np.flatnonzero((lens > HEAVY_EDGES) & (lens <= limit))
    long_rows, chunk_ptr, bounds, heavy = (
        torch.as_tensor(a.astype(np.int32), device=device)
        for a in (long_rows, chunk_ptr, bounds, heavy))
    return RowSplit(long_rows, chunk_ptr, bounds, limit, heavy)


class CsrBlock(NamedTuple):
    """Rows [start, start + n) of a CSR operator, the operand of K1 and of
    K1-fm's gather on one rank's row block (``parallel.coo_shard``):
    ``row_ptr`` from 0 (rows past the operator's end are empty), ``rows``
    the block-relative row of each edge (the plain version's), ``cols``
    global indices into a table of ``n_table`` rows."""
    row_ptr: torch.Tensor   # (n + 1,) int32
    rows: torch.Tensor      # (nnz,) int64
    cols: torch.Tensor      # (nnz,) int32
    vals: torch.Tensor      # (nnz,) float32
    n: int                  # output rows: the block's rows_per
    n_table: int            # rows of the gathered table: n_pad
    split: RowSplit

    @property
    def device(self) -> torch.device:
        return self.vals.device


def csr_row_block(row_ptr: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor, vals: torch.Tensor, start: int,
                  stop: int, rows_per: int, n_table: int) -> CsrBlock:
    """Rows [start, stop) of a CSR operator as a block of ``rows_per``
    output rows (the rows past ``stop`` empty), on the operator's device,
    in arrays of its own (the whole operator can be freed). Each row keeps
    its edges in order and ``split_rows`` cuts the same chunks, so the
    blocks' products concatenate to the whole operator's."""
    ptr = row_ptr[start:stop + 1].long()
    e0, e1 = int(ptr[0]), int(ptr[-1])
    local = torch.cat([ptr - e0, ptr.new_full((rows_per - (stop - start),),
                                              e1 - e0)])
    return CsrBlock(row_ptr=local.to(torch.int32), rows=rows[e0:e1] - start,
                    cols=cols[e0:e1].clone(), vals=vals[e0:e1].clone(),
                    n=rows_per, n_table=n_table,
                    split=split_rows(local.cpu().numpy(),
                                     device=row_ptr.device))


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
    instance with ``bf16``), for x (n, d) or R replicas' x (R, n, d)."""
    if bf16:
        x, vals = round_bf16(x), round_bf16(vals)
    return torch.zeros((*x.shape[:-2], n, x.shape[-1]), dtype=torch.float32,
                       device=x.device).index_add_(
                           x.ndim - 2, rows, vals[:, None] * x[..., cols, :])


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


def _check(op, x: torch.Tensor, what: str = "coo_spmv",
           batched: bool = False) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 x, got {x.dtype}")
    ndim = 3 if batched else 2
    if (x.ndim not in (2, ndim) or x.shape[-2] != op.n_table
            or x.shape[-1] < 1
            or x.ndim == 3 and not 1 <= x.shape[0] <= 65535):
        shapes = f"({op.n_table}, d >= 1)" + (
            f" or (R <= 65535, {op.n_table}, d)" if batched else "")
        raise ValueError(f"{what} takes x of shape {shapes}, got "
                         f"{tuple(x.shape)}")
    nnz = op.cols.shape[0]
    if (op.row_ptr.dtype != torch.int32 or op.cols.dtype != torch.int32
            or op.vals.dtype != torch.float32
            or op.row_ptr.shape != (op.n + 1,) or op.vals.shape != (nnz,)):
        raise ValueError(f"{what} takes int32 row_ptr (n+1,), int32 cols "
                         f"(nnz,) and float32 vals (nnz,)")
    long_rows, chunk_ptr, chunk_bounds = op.split[:3]
    heavy = op.split.heavy_rows
    if (any(t.dtype != torch.int32 for t in op.split[:3])
            or chunk_ptr.shape != (long_rows.shape[0] + 1,)
            or chunk_bounds.ndim != 2 or chunk_bounds.shape[1] != 2
            or heavy is not None and (heavy.dtype != torch.int32
                                      or heavy.ndim != 1)):
        raise ValueError(f"{what} takes the int32 chunk index that "
                         f"split_rows builds: long_rows (n_long,), chunk_ptr "
                         f"(n_long + 1,), chunk_bounds (n_chunks, 2), "
                         f"heavy_rows (n_heavy,) or None")


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
                   d: int, replicas: int = 1, tail: tuple = ()) -> None:
    """One product of the shared gather over ``op``'s forward CSR: the rows
    kernel, and for an operator with long rows the chunk kernel into a
    scratch and the fold, all on the current stream. ``table`` holds
    ``replicas`` (op.n_table, d) states and ``y`` that many (op.n, d)
    results; ``tail`` is what the entry takes after the scratch (a batched
    entry's replica count and table rows, the wide form's plan too)."""
    split = op.split
    n_chunks = split.chunk_bounds.shape[0]
    partial = (torch.empty((replicas * n_chunks, d), dtype=torch.float32,
                           device=table.device) if n_chunks else None)
    _call(entry, table.device,
          op.row_ptr.data_ptr(), op.cols.data_ptr(), op.vals.data_ptr(),
          table.data_ptr(), y.data_ptr(), op.n, d,
          _gather_width(table.view(-1, table.shape[-1])), split.limit,
          split.long_rows.data_ptr(), split.chunk_ptr.data_ptr(),
          split.chunk_bounds.data_ptr(), split.long_rows.shape[0], n_chunks,
          partial.data_ptr() if n_chunks else None, *tail)


def coo_spmv_narrow(op, x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """K1's narrow form at any width, one replica of CUDA x (n_table, d):
    the one-replica entry, which walks a row wider than a warp 32 lanes at
    a time (the form every width took before the wide one, whose sums the
    wide form keeps). Tests, tools and the chip smoke script hold the wide
    form against it; the port does not call it."""
    y = torch.empty((op.n, x.shape[1]), dtype=torch.float32, device=x.device)
    _launch_gather(f"ndcn_coo_spmv_{'bf16' if bf16 else 'f32'}", op,
                   x.to(torch.bfloat16) if bf16 else x, y, x.shape[1])
    return y


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
    """One row-major product over ``op``'s forward CSR, of x (n, d) or of R
    replicas' x (R, n, d): the kernel for CUDA tensors, else the plain
    version."""
    bf16 = GATHER_BF16 and x.shape[-1] > 1
    if not on_cuda(x, op.row_ptr, op.cols, op.vals, op.rows, *op.split[:3]):
        return coo_spmv_plain(op.rows, op.cols, op.vals, x, op.n, bf16)
    global LAUNCHES, BF16_LAUNCHES, BATCHED_LAUNCHES, BATCHED_BF16_LAUNCHES
    global ROWBLOCK_LAUNCHES, K1_WIDE_LAUNCHES, K1_WIDE_BATCHED_LAUNCHES
    global ROWBLOCK_WIDE_LAUNCHES
    x = x.contiguous()
    d = x.shape[-1]
    y = torch.empty((*x.shape[:-2], op.n, d), dtype=torch.float32,
                    device=x.device)
    batched = x.ndim == 3
    replicas = x.shape[0] if batched else 1
    table = x.to(torch.bfloat16) if bf16 else x
    dtype = "bf16" if bf16 else "f32"
    plan = gather_plan(d, _gather_width(table.view(-1, d)),
                       table.element_size())
    if plan.wide:
        heavy = op.split.heavy_rows
        n_heavy = 0 if heavy is None else heavy.shape[0]
        _launch_gather(f"ndcn_coo_spmv_wide_{dtype}", op, table, y, d,
                       replicas, (heavy.data_ptr() if n_heavy else None,
                                  n_heavy, HEAVY_EDGES, replicas, op.n_table,
                                  plan.lane_columns, plan.tiles,
                                  plan.grid(op.n + n_heavy)[0]))
    else:
        _launch_gather(f"ndcn_coo_spmv_{'batched_' if batched else ''}"
                       f"{dtype}", op, table, y, d, replicas,
                       (replicas, op.n_table) if batched else ())
    if isinstance(op, CsrBlock):
        ROWBLOCK_LAUNCHES += 1
        if plan.wide:
            ROWBLOCK_WIDE_LAUNCHES += 1
        return y
    if plan.wide and batched:
        K1_WIDE_BATCHED_LAUNCHES += 1
    elif plan.wide:
        K1_WIDE_LAUNCHES += 1
    if batched and bf16:
        BATCHED_BF16_LAUNCHES += 1
    elif batched:
        BATCHED_LAUNCHES += 1
    elif bf16:
        BF16_LAUNCHES += 1
    else:
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
    xT = xT.contiguous()
    # K5's row-major (n, d_sub) table is materialised once per call in one
    # copy, as the JAX package materialises its (n, 128) table; K1-fm's is
    # the pack kernel's scratch, for this call only
    return gather_T(op, pack_rows_plain(xT, bf16) if wide
                    else pack_rows(xT, bf16))


def gather_T(op, table: torch.Tensor,
             wide: Optional[bool] = None) -> torch.Tensor:
    """The gather of K1-fm (of K5 under ``GATHER_WIDE``, or with ``wide``)
    over ``op``'s forward CSR from a row-major (op.n_table, d_sub) table,
    fp32 or bf16 (``pack_rows``'s): (A·X)ᵀ, (d_sub, op.n) fp32. A bf16
    table is the bf16 instance. CPU tensors take the plain version."""
    wide = GATHER_WIDE if wide is None else wide
    bf16 = table.dtype == torch.bfloat16
    if table.ndim != 2 or table.shape[0] != op.n_table:
        raise ValueError(f"gather_T takes a ({op.n_table}, d_sub) table, got "
                         f"{tuple(table.shape)}")
    if not on_cuda(table, op.row_ptr, op.cols, op.vals, op.rows,
                   *op.split[:3]):
        plain = coo_spmv_T_wide_plain if wide else coo_spmv_T_plain
        return plain(op.rows, op.cols, op.vals, table.t().float(), op.n,
                     bf16)
    global T_LAUNCHES, WIDE_LAUNCHES, T_ROWBLOCK_LAUNCHES
    d_sub = table.shape[1]
    y = torch.empty((d_sub, op.n), dtype=torch.float32, device=table.device)
    _launch_gather(f"ndcn_coo_spmv_T_{'bf16' if bf16 else 'f32'}", op,
                   table.contiguous(), y, d_sub)
    if isinstance(op, CsrBlock):
        T_ROWBLOCK_LAUNCHES += 1
    elif wide:
        WIDE_LAUNCHES += 1
    else:
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
    """A · X for a ``graph.sparse.CooGraph`` ``op``, differentiable in x;
    x is (n, d), or (R, n, d) for R replicas against the same A.

    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    current stream, forward and backward (and raise if it cannot). While a
    program is traced it is the operator ``ndcn_tpu_torch::coo_spmv``
    (``kernels.ops``), forward only."""
    _check(op, x, batched=True)
    if not x.is_contiguous():
        raise ValueError("coo_spmv takes a contiguous (row-major) x")
    if torch.compiler.is_compiling():
        # a traced program holds the operator (``kernels.ops``)
        return torch.ops.ndcn_tpu_torch.coo_spmv(
            op.row_ptr, op.rows, op.cols, op.vals, *op.split[:3],
            op.split.limit, x, GATHER_BF16)
    return _CooSpmv.apply(op, op.vals, op.vals_t, x)


def spmv_T(op, xT: torch.Tensor) -> torch.Tensor:
    """(A · X)ᵀ for xT = Xᵀ of shape (d_sub, n), differentiable in xT; the
    feature-major counterpart of ``coo_spmv`` (same device rules). While a
    program is traced it is the operators ``ndcn_tpu_torch::pack_rows``
    and ``ndcn_tpu_torch::gather_T`` (K1-fm), or the copied table and
    ``ndcn_tpu_torch::gather_T_wide`` (K5) under ``GATHER_WIDE``
    (``kernels.ops``), forward only; both switches are read at the
    trace."""
    if xT.ndim != 2:
        raise ValueError(f"spmv_T takes xT of shape (d_sub, {op.n_table}), "
                         f"got {tuple(xT.shape)}")
    _check(op, xT.t())
    if not xT.is_contiguous():
        raise ValueError("spmv_T takes a contiguous (feature-major) xT")
    if GATHER_WIDE and xT.shape[0] > D_WIDE:
        raise ValueError(f"the wide gather takes d_sub <= {D_WIDE}, got "
                         f"{xT.shape[0]}")
    if torch.compiler.is_compiling():
        # a traced program holds the operators (``kernels.ops``)
        ops = torch.ops.ndcn_tpu_torch
        csr = (op.row_ptr, op.rows, op.cols, op.vals, *op.split[:3],
               op.split.limit)
        if GATHER_WIDE:
            return ops.gather_T_wide(*csr, pack_rows_plain(xT, GATHER_BF16))
        return ops.gather_T(*csr, ops.pack_rows(xT, GATHER_BF16))
    return _SpmvT.apply(op, op.vals, op.vals_t, xT)
