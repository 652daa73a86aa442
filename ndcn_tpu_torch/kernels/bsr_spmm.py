"""K3 and K4: block-sparse (BSR) A times a dense X, and the fused RHS
relu((A · X) · W + b) over the same A; fp32, differentiable in X (and W, b).

The CUDA kernels are ``ndcn_tpu_torch/csrc/bsr_spmm.cu``; they replace the TPU
kernels ``ndcn_tpu/kernels/bsr_spmm.py::_spmm_kernel`` (K3) and
``::_spmm_fused_kernel`` (K4). The packing keeps the logical matrix of the
JAX package's ``from_scipy_bsr`` (B × B float32 blocks, B = 128 by default,
a rectangular tail where n is not a multiple of B) but stores it as plain
block-CSR: a row-block pointer, the block columns and the blocks, with no
ELL padding and no reserved zero block.

Backward, as the JAX package's custom VJPs: K3's is K3 over the packing of
Aᵀ; K4's recomputes A·X with K3, forms dX = K3(Aᵀ, G·Wᵀ) and dW, db with
``torch.matmul``. The operator is a constant whose cotangent is ZERO (the JAX
package's BSR policy, unlike COO's NaN).

Both multiply on the tensor cores with split-TF32 products
(``csrc/mma_split.cuh``), cut by the plan K4 shares with K2
(``kernels.fused_rhs.panel_plan``); K3's plan (``bsr_spmm_plan``) also cuts
the columns into slabs.

Both also take R replicas at once against the one shared A (the replica
sweeps): x (R, n, d), and for K4 w (R, d, d) and b (R, d), in one launch of
the batched forms (``ndcn_bsr_spmm_batched_f32``, the replica as
``gridDim.z``; ``ndcn_bsr_fused_rhs_batched_f32``, as ``gridDim.y``), each
replica bit-equal to its own launch; the backward is the same, batched.
Where K3's one-replica plan has every warp split the depth (slabs of up to
32 columns), its batched form takes replica groups instead
(``ndcn_bsr_spmm_grouped_f32``, ``bsr_batched_plan``): a CTA stages each
chunk of A once for a group of replicas, whose X chunks lie side by side,
with each value's sum as in the one-replica launch.

The plain PyTorch versions beside the kernels (a per-block batched product
and a scatter over row blocks) are the CPU path, inside the same
``autograd.Function``s, and the references the kernels are held against on
the card. ``bsr_spmm_split_plain`` and ``bsr_fused_rhs_split_plain`` emulate
the kernels' split arithmetic in plain PyTorch; tests and the chip smoke
script use them, the port does not.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ndcn_tpu_torch.kernels import build
from ndcn_tpu_torch.kernels.fused_rhs import (SMEM_LIMIT, SMS,
                                              TWO_CTAS_SMEM, WARPS,
                                              PanelPlan, panel_plan,
                                              plan_smem_bytes, split_matmul)
from ndcn_tpu_torch.kernels.platform import on_cuda

BLOCK = 128

# launches of each CUDA kernel in this process, forward and backward (CPU
# calls do not count); K3's batched form in either grid, and counted there
# too, in replica groups
SPMM_LAUNCHES = 0
FUSED_LAUNCHES = 0
BATCHED_SPMM_LAUNCHES = 0
GROUPED_SPMM_LAUNCHES = 0
BATCHED_FUSED_LAUNCHES = 0

# widest X the fused kernel takes: 8 warps of 16 n8 tiles each, where
# ``panel_plan`` places a 16-row tile and a ring of two 16-deep chunks in
# 232,192 of the 232,448 bytes a block may use
K_MAX = 1024

# K3's column slabs (``bsr_spmm_plan``): the kernel is built for 4 n8 tiles
# a warp, so for slabs of up to 256 columns (8 warps across them); the plan
# cuts at 128, and no narrower than 32 unless X is
SLAB_MAX = 128
SLAB_MIN = 32
# the CTAs a K3 launch aims at: one for each SM of the card's 132, in
# whole row blocks' worth
SPMM_MIN_CTAS = 128


class BsrMatrix(NamedTuple):
    """Block-CSR of B × B blocks: the nonzero blocks of row block i are
    ``blocks[row_ptr[i]:row_ptr[i+1]]``, at block columns ``block_cols``."""
    row_ptr: torch.Tensor     # (n_row_blocks + 1,) int32
    block_rows: torch.Tensor  # (nnzb,) int64, each block's row block
    block_cols: torch.Tensor  # (nnzb,) int32
    blocks: torch.Tensor      # (nnzb, B, B) float32
    n_rows: int
    n_cols: int

    @property
    def block(self) -> int:
        return self.blocks.shape[-1]

    @property
    def n_row_blocks(self) -> int:
        return self.row_ptr.shape[0] - 1


def from_scipy_bsr(mat: sp.spmatrix, block: int = BLOCK,
                   device: Optional[torch.device] = None) -> BsrMatrix:
    """Pack ``mat`` into block-CSR (float32), as ``ndcn_tpu``'s
    ``from_scipy_bsr``: the CSR is padded to whole blocks (extra rows empty,
    extra columns unused) and cut into sorted B × B blocks."""
    m = sp.csr_matrix(mat)
    n_rows, n_cols = m.shape
    nrb = -(-n_rows // block)
    ncb = -(-n_cols // block)
    indptr = np.concatenate([m.indptr,
                             np.full(nrb * block - n_rows, m.indptr[-1],
                                     dtype=m.indptr.dtype)])
    padded = sp.csr_matrix((m.data, m.indices, indptr),
                           shape=(nrb * block, ncb * block))
    bsr = padded.tobsr(blocksize=(block, block))
    bsr.sort_indices()
    counts = np.diff(bsr.indptr)
    return BsrMatrix(
        row_ptr=torch.as_tensor(bsr.indptr.astype(np.int32), device=device),
        block_rows=torch.as_tensor(np.repeat(np.arange(nrb), counts),
                                   device=device),
        block_cols=torch.as_tensor(bsr.indices.astype(np.int32),
                                   device=device),
        blocks=torch.as_tensor(bsr.data.astype(np.float32).reshape(
            -1, block, block), device=device),
        n_rows=n_rows, n_cols=n_cols)


def bsr_spmm_plain(a: BsrMatrix, x: torch.Tensor,
                   bmm=torch.bmm) -> torch.Tensor:
    """The plain version of K3: each stored block times its X row block in
    one batched product (``bmm``), summed into the row blocks. R replicas'
    x (R, n, d) go through as the columns of one (n, R·d) X."""
    if x.ndim == 3:
        r, n, d = x.shape
        y = bsr_spmm_plain(a, x.permute(1, 0, 2).reshape(n, r * d), bmm)
        return y.view(-1, r, d).permute(1, 0, 2).contiguous()
    B, d = a.block, x.shape[1]
    ncb = -(-a.n_cols // B)
    xb = torch.nn.functional.pad(x, (0, 0, 0, ncb * B - a.n_cols))
    prod = bmm(a.blocks, xb.view(ncb, B, d)[a.block_cols.long()])
    y = torch.zeros((a.n_row_blocks, B, d), dtype=x.dtype, device=x.device)
    return y.index_add_(0, a.block_rows, prod).view(-1, d)[:a.n_rows]


def bsr_fused_rhs_plain(a: BsrMatrix, x: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """The plain version of K4 (one replica, or R with a leading axis)."""
    return torch.relu(bsr_spmm_plain(a, x) @ w + b.unsqueeze(-2))


def bsr_spmm_split_plain(a: BsrMatrix, x: torch.Tensor,
                         passes: int = 3) -> torch.Tensor:
    """The plain version of K3 with the kernel's split-TF32 products."""
    return bsr_spmm_plain(a, x, bmm=lambda p, q: split_matmul(p, q, passes,
                                                              torch.bmm))


def bsr_fused_rhs_split_plain(a: BsrMatrix, x: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """The plain version of K4 with the kernel's split-TF32 products."""
    return torch.relu(split_matmul(bsr_spmm_split_plain(a, x, passes), w,
                                   passes) + b.unsqueeze(-2))


@functools.lru_cache(maxsize=None)
def bsr_fused_plan(n_row_blocks: int, block: int, d: int) -> PanelPlan:
    """K4's plan: CTAs are the row tiles of every row block."""
    return panel_plan(d, block, lambda rows: n_row_blocks * -(-block // rows),
                      max_rows=block)


class SpmmPlan(NamedTuple):
    """How one launch of K3 is cut: X's columns into slabs of ``slab``
    (the last one ragged; ``gridDim.y`` is ``slabs``), and each slab's panel
    product as ``panel`` says."""
    slab: int
    slabs: int
    panel: PanelPlan


def spmm_plan_for(n_row_blocks: int, block: int, d: int, slab: int,
                  rows: Optional[int] = None,
                  smem_limit: int = SMEM_LIMIT) -> SpmmPlan:
    """K3's plan at a given slab width: ``panel_plan``'s panel for it (at
    panel height ``rows`` and under ``smem_limit`` where given), with the
    slabs counted among the CTAs."""
    slabs = -(-d // slab)
    return SpmmPlan(slab, slabs, panel_plan(
        slab, block, lambda r: n_row_blocks * -(-block // r) * slabs,
        max_rows=block, rows=rows, smem_limit=smem_limit))


@functools.lru_cache(maxsize=None)
def bsr_spmm_plan(n_row_blocks: int, block: int, d: int) -> SpmmPlan:
    """K3's plan for an A of ``n_row_blocks`` row blocks of ``block`` rows
    and an X of ``d`` columns.

    The rules follow the card's numbers (``tools/tune_fused_plan.py k3``:
    every slab, panel height and chunk depth on the 400-node grid's 4 row
    blocks and a 2000-node 5 % matrix's 16, d in {20, 128, 256, 512, 1100};
    NVIDIA H100 80GB HBM3, 700.00 W); the plan below was the fastest, or
    within 7 %, at each of the ten shapes:
    - Slabs: as wide as ``SLAB_MAX`` (every slab but the last of whole n8
      tiles, so it starts on a 16-byte boundary), halved while the CTAs are
      fewer than ``SPMM_MIN_CTAS`` and a slab stays ``SLAB_MIN`` wide. A
      CTA's time is a chain of dependent chunk copies, so more CTAs in
      flight win where there are SMs without one: on the grid at d = 256,
      8 slabs of 32 take 0.0108 ms where 2 of 128 take 0.0198 and one of
      256 0.0306. Slabs of 256 won nowhere (2000 nodes, d = 256: 0.133
      against 0.074 for two of 128).
    - Rows: 32 where that reaches ``SPMM_MIN_CTAS`` CTAs at some slab, else
      16 (at the narrowest slab, where even that falls short): at d = 512
      on the grid 8 slabs of 64 in 32-row tiles take 0.0138 against 0.018
      for 4 of 128 in 16-row ones.
    - Chunk: the deepest that fits, where the CTAs fit on the card at once;
      beyond ``SMS`` CTAs the deepest that lets two share an SM (2000 nodes,
      d = 512, 256 CTAs: 0.129 at 64 deep against 0.143 at 128)."""
    options = []   # (slab, slabs), widest first
    slabs = -(-d // SLAB_MAX)
    while True:
        slab = d if slabs == 1 else -(-d // (8 * slabs)) * 8
        if options and slab < SLAB_MIN:
            break
        options.append((slab, -(-d // slab)))
        slabs *= 2

    def ctas(rows, slabs):
        return n_row_blocks * -(-block // rows) * slabs

    heights = (32, 16) if block > 16 else (16,)
    rows, slab, slabs = next(
        ((r, s, n) for r in heights for s, n in options
         if ctas(r, n) >= SPMM_MIN_CTAS), (16, *options[-1]))
    limit = TWO_CTAS_SMEM if ctas(rows, slabs) > SMS else SMEM_LIMIT
    return spmm_plan_for(n_row_blocks, block, d, slab, rows, limit)


class GroupPlan(NamedTuple):
    """How one launch of K3's batched form is cut. ``group`` 1: a CTA a
    replica, each replica's CTAs as ``base`` says (the replica grid).
    Otherwise ``groups`` CTAs (``gridDim.z``) for each row tile and slab of
    ``base``, each for ``group`` replicas (the last group may hold fewer),
    whose X chunks lie ``rep_cols`` columns apart in a panel of ``rows``
    rows and ``nt`` n8 tiles a warp; ``base``'s slab, chunk depth and
    depth split are kept, so each replica is bit-equal to its own
    launch."""
    base: SpmmPlan
    group: int
    groups: int
    rows: int
    nt: int
    rep_cols: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def bsr_batched_plan(n_row_blocks: int, block: int, d: int,
                     replicas: int) -> GroupPlan:
    """K3's batched plan for ``replicas`` states of ``d`` columns.

    Groups where the one-replica plan has all 8 warps split a chunk's depth
    (``wn`` 1, slabs of up to 32 columns): there a CTA's X chunk is a
    sliver beside its A tile, so a group shares the A tile, the larger part
    of each chunk. A group is as many replicas as 8 n8 tiles a warp hold
    beside a 32-row panel (a 16-row one with 16 tiles where a block is no
    taller), fewer (down to 2) while the CTAs number fewer than
    ``SPMM_MIN_CTAS`` (a CTA's time is a chain of chunk copies, as in
    ``bsr_spmm_plan``); the replicas then spread evenly over the groups.
    Wider slabs keep a CTA a replica: their X chunks outweigh the A
    tile. The rule follows the card's numbers (``tools/tune_wide_plan.py``,
    NVIDIA H100 80GB HBM3, 700.00 W): cora at d = 16, R = 25 takes 0.310 ms
    in 7 groups of 4 against 0.353 / 0.486 for groups of 3 / 2, 0.46-1.03
    with 16-row panels and 0.671 for the replica grid; grid400 at d = 20 and
    5, R = 16, 0.0157 / 0.0150 in groups of 2 (128 CTAs) against 0.0170 /
    0.0163 in groups of 3 and 0.0213 / 0.0227 for the replica grid."""
    base = bsr_spmm_plan(n_row_blocks, block, d)
    p = base.panel
    if replicas == 1 or p.wn != 1:
        return GroupPlan(base, 1, replicas, p.rows, p.nt, base.slab,
                         p.smem_bytes)
    rep_cols = -(-base.slab // 4) * 4
    rows, nt = (32, 8) if block > 16 else (16, 16)
    tiles = n_row_blocks * -(-block // rows) * base.slabs
    most = min(replicas, 8 * nt // rep_cols)
    while most > 2 and tiles * -(-replicas // most) < SPMM_MIN_CTAS:
        most -= 1
    groups = -(-replicas // most)
    group = -(-replicas // groups)
    return GroupPlan(base, group, groups, rows, nt, rep_cols,
                     plan_smem_bytes(rows, nt, WARPS, p.bk,
                                     group * rep_cols))


def _check_bsr(a: BsrMatrix, x: torch.Tensor, name: str) -> None:
    """x is (n_cols, d), or (R, n_cols, d) for R replicas."""
    if (a.row_ptr.dtype != torch.int32 or a.block_cols.dtype != torch.int32
            or a.blocks.dtype != torch.float32 or a.blocks.ndim != 3
            or not a.blocks.is_contiguous()):
        raise ValueError(f"{name} takes int32 row_ptr and block_cols and "
                         f"contiguous float32 (nnzb, B, B) blocks")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 x, got {x.dtype}")
    if (x.ndim not in (2, 3) or x.shape[-2] != a.n_cols or x.shape[-1] < 1
            or x.ndim == 3 and not 1 <= x.shape[0] <= 65535):
        raise ValueError(f"{name} takes x of shape ({a.n_cols}, d >= 1) or "
                         f"(R <= 65535, {a.n_cols}, d), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous (row-major) x")


def _launch_spmm(a: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    if not on_cuda(x, a.row_ptr, a.block_rows, a.block_cols, a.blocks):
        return bsr_spmm_plain(a, x)
    x = x.contiguous()
    lib = build.load()
    d = x.shape[-1]
    plan = bsr_spmm_plan(a.n_row_blocks, a.block, d)
    p = plan.panel
    y = torch.empty((*x.shape[:-2], a.n_rows, d), dtype=torch.float32,
                    device=x.device)
    ptrs = (a.row_ptr.data_ptr(), a.block_cols.data_ptr(),
            a.blocks.data_ptr(), x.data_ptr(), y.data_ptr(), a.n_row_blocks,
            a.block, a.n_rows, a.n_cols, d, plan.slab)
    args = (*ptrs, p.rows, p.wn, p.bk, p.smem_bytes)
    group = (bsr_batched_plan(a.n_row_blocks, a.block, d, x.shape[0])
             if x.ndim == 3 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if group is not None and group.group > 1:
            rc = lib.ndcn_bsr_spmm_grouped_f32(
                *ptrs, group.rows, group.nt, p.bk, group.smem_bytes,
                x.shape[0], group.group, stream)
        elif x.ndim == 3:
            rc = lib.ndcn_bsr_spmm_batched_f32(*args, x.shape[0], stream)
        else:
            rc = lib.ndcn_bsr_spmm_f32(*args, stream)
    if rc != 0:
        raise RuntimeError(f"bsr_spmm kernel launch failed: CUDA error {rc}")
    global SPMM_LAUNCHES, BATCHED_SPMM_LAUNCHES, GROUPED_SPMM_LAUNCHES
    if x.ndim == 3:
        BATCHED_SPMM_LAUNCHES += 1
        if group.group > 1:
            GROUPED_SPMM_LAUNCHES += 1
    else:
        SPMM_LAUNCHES += 1
    return y


def _launch_fused(a: BsrMatrix, x, w, b) -> torch.Tensor:
    if not on_cuda(x, w, b, a.row_ptr, a.block_rows, a.block_cols, a.blocks):
        return bsr_fused_rhs_plain(a, x, w, b)
    lib = build.load()
    d = x.shape[-1]
    plan = bsr_fused_plan(a.n_row_blocks, a.block, d)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    args = (a.row_ptr.data_ptr(), a.block_cols.data_ptr(),
            a.blocks.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), a.n_row_blocks, a.block, a.n_rows, a.n_cols, d,
            w.stride(-2), w.stride(-1), plan.rows, plan.nt, plan.wn, plan.bk,
            plan.smem_bytes)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if x.ndim == 3:
            rc = lib.ndcn_bsr_fused_rhs_batched_f32(*args, x.shape[0],
                                                    w.stride(0), stream)
        else:
            rc = lib.ndcn_bsr_fused_rhs_f32(*args, stream)
    if rc != 0:
        raise RuntimeError(f"bsr_fused_rhs kernel launch failed: CUDA error "
                           f"{rc}")
    global FUSED_LAUNCHES, BATCHED_FUSED_LAUNCHES
    if x.ndim == 3:
        BATCHED_FUSED_LAUNCHES += 1
    else:
        FUSED_LAUNCHES += 1
    return out


def _zero_cotangents(ctx, *blocks):
    return tuple(torch.zeros_like(t) if ctx.needs_input_grad[i] else None
                 for i, t in enumerate(blocks, start=2))


class _BsrSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, at, blocks, blocks_t, x):
        ctx.a, ctx.at = a, at
        return _launch_spmm(a, x)

    @staticmethod
    def backward(ctx, g):
        dx = _launch_spmm(ctx.at, g) if ctx.needs_input_grad[4] else None
        return (None, None, *_zero_cotangents(ctx, ctx.a.blocks,
                                              ctx.at.blocks), dx)


class _BsrFusedRhs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, at, blocks, blocks_t, x, w, b):
        ctx.a, ctx.at = a, at
        out = _launch_fused(a, x, w, b)
        ctx.save_for_backward(x, w, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        g = g * (out > 0).to(g.dtype)          # relu mask (out == 0: blocked)
        ah = _launch_spmm(ctx.a, x)            # recomputed, not stored
        dx = _launch_spmm(ctx.at, g @ w.transpose(-1, -2))
        return (None, None, *_zero_cotangents(ctx, ctx.a.blocks,
                                              ctx.at.blocks),
                dx, ah.transpose(-1, -2) @ g, g.sum(-2))


def _op_args(a: BsrMatrix) -> tuple:
    """``a`` as the operators of ``kernels.ops`` take it."""
    return (a.row_ptr, a.block_rows, a.block_cols, a.blocks, a.n_rows,
            a.n_cols)


def bsr_spmm(a: BsrMatrix, at: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """A · X, differentiable in X; ``at`` packs Aᵀ for the backward. x is
    (n, d), or (R, n, d) for R replicas against the same A.

    CPU tensors take the plain version; CUDA tensors launch K3 on the current
    stream, forward and backward (and raise if it cannot). While a program
    is traced it is the operator ``ndcn_tpu_torch::bsr_spmm``
    (``kernels.ops``), forward only."""
    _check_bsr(a, x, "bsr_spmm")
    if torch.compiler.is_compiling():
        return torch.ops.ndcn_tpu_torch.bsr_spmm(*_op_args(a), x)
    return _BsrSpmm.apply(a, at, a.blocks, at.blocks, x)


def bsr_fused_rhs(a: BsrMatrix, at: BsrMatrix, x: torch.Tensor,
                  w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu((A · X) · W + b) for a square A, x (n, d), w (d, d) (possibly a
    strided view), b (d,); or for R replicas, x (R, n, d), w (R, d, d) and
    b (R, d). Differentiable in x, w and b.

    CPU tensors take the plain version; CUDA tensors launch K4 on the current
    stream and K3 in the backward (and raise if it cannot). While a program
    is traced it is the operator ``ndcn_tpu_torch::bsr_fused_rhs``
    (``kernels.ops``), forward only."""
    _check_bsr(a, x, "bsr_fused_rhs")
    d = x.shape[-1]
    lead = tuple(x.shape[:-2])
    if a.n_rows != a.n_cols:
        raise ValueError(f"bsr_fused_rhs takes a square A, got "
                         f"({a.n_rows}, {a.n_cols})")
    for name, t in (("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"bsr_fused_rhs takes float32 tensors; {name} is "
                            f"{t.dtype}")
    if (w.shape != (*lead, d, d) or b.shape != (*lead, d)
            or not b.is_contiguous() or d > K_MAX):
        raise ValueError(f"bsr_fused_rhs takes w (d, d), contiguous b (d,) "
                         f"(for R replicas w (R, d, d), b (R, d)) "
                         f"with d <= {K_MAX}; got x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    bsr_fused_plan(a.n_row_blocks, a.block, d)  # raises if nothing fits
    if torch.compiler.is_compiling():
        return torch.ops.ndcn_tpu_torch.bsr_fused_rhs(*_op_args(a), x, w, b)
    return _BsrFusedRhs.apply(a, at, a.blocks, at.blocks, x, w, b)
