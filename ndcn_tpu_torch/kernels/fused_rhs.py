"""K2: the fused graph-ODE right-hand side relu((A · H) · W + b), dense fp32,
differentiable in H, W and b.

The CUDA kernel is ``ndcn_tpu_torch/csrc/fused_rhs.cu``; it replaces the TPU
kernel ``ndcn_tpu/kernels/fused_rhs.py::_kernel``. ``w`` is (k_in, k_out), the
JAX package's layout; it may be strided, so ``nn.Linear.weight.t()`` passes as
the view it is and its gradient reaches the weight through the view. The
backward is the JAX package's ``_fused_bwd``, which runs in XLA outside any
Pallas kernel: it recomputes A·H and forms dh, dw and db with
``torch.matmul``. The operator is a constant: a gradient asked of ``a`` is
NaN, never a silent zero.

The kernel multiplies on the tensor cores with every fp32 operand split into
two TF32 parts and three products summed in fp32
(``csrc/mma_split.cuh``). How a launch is cut (the panel of rows one CTA
owns, the warps' split of columns and depth, the ring of staged chunks) is
decided here on the host by ``panel_plan``, which K4 shares.

``fused_rhs`` also takes R replicas at once: h (R, n, k) with their own w
(R, k, k) and b (R, k) against the one shared a (the replica sweeps), in one
launch of the batched form (``ndcn_fused_rhs_batched_f32``, the replica as
``gridDim.y``), each replica bit-equal to its own launch; the backward is
the same recompute with batched products.

The plain PyTorch version beside the kernel is the CPU path, inside the same
``autograd.Function``, and the reference the kernel is held against on the
card. ``fused_rhs_split_plain`` emulates the kernel's split arithmetic in
plain PyTorch; tests and the chip smoke script use it, the port does not.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from ndcn_tpu_torch.kernels import build
from ndcn_tpu_torch.kernels.platform import on_cuda

# launches of the CUDA kernel in this process, one replica and batched (CPU
# calls do not count)
LAUNCHES = 0
BATCHED_LAUNCHES = 0

# widest hidden state the kernel takes: 8 warps of 16 n8 tiles each; there
# ``panel_plan`` places a 16-row panel (16 · 1028 · 4 bytes) and a ring of
# two 16-deep chunks (1024 columns of W, 20 floats each, as the widest
# form), 232,192 of the 232,448 bytes a block may use
K_MAX = 1024

SMEM_LIMIT = 232448     # bytes of shared memory one block may use (227 KB)
# the most dynamic shared memory a CTA may take for two to share an SM (228
# KB an SM, 1 KB of it kept per CTA)
TWO_CTAS_SMEM = 115712
SMS = 132               # the card's streaming multiprocessors
STAGES = 2              # the cp.async ring's depth (kStages in mma_split.cuh)
WARPS = 8               # warps of one CTA of the fused kernels
# fewest CTAs (of the card's 132 SMs' worth) for which 32-row panels are taken
TALL_PANEL_MIN_CTAS = 100


class PanelPlan(NamedTuple):
    """How one launch of a fused RHS kernel (K2, K4) is cut."""
    rows: int        # rows of the panel one CTA owns, for all columns
    nt: int          # n8 column tiles a warp keeps in registers
    wn: int          # warps across the columns
    wk: int          # warps across the depth of a staged chunk (wn · wk = 8)
    bk: int          # depth of one staged chunk
    smem_bytes: int  # dynamic shared memory: panel + max(ring, fold scratch)

    def column_ranges(self, width: int) -> list:
        """[begin, end) of the columns each of the wn column warps owns."""
        span = 8 * self.nt
        return [(min(i * span, width), min((i + 1) * span, width))
                for i in range(self.wn)]

    def row_ranges(self, n: int) -> list:
        """[begin, end) of the rows of each panel of an n-row output."""
        return [(r, min(r + self.rows, n)) for r in range(0, n, self.rows)]

    def depth_steps(self) -> list:
        """The k8 steps of a chunk that each of the wk depth warps takes."""
        return [list(range(i, self.bk // 8, self.wk)) for i in range(self.wk)]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_smem_bytes(rows: int, nt: int, wk: int, bk: int, width: int) -> int:
    """The dynamic shared memory of a plan, as ``make_layout`` in
    ``csrc/mma_split.cuh`` lays it out (the C entry refuses a plan whose
    number differs)."""
    cols = _round_up(width, 8 * nt)
    lda = bk + 4
    ldb = _round_up(cols, 32) + 8
    ldp = _round_up(max(cols, _round_up(width, bk)), 32) + 4
    ring = STAGES * (rows * lda + max(bk * ldb, cols * lda))
    return 4 * (rows * ldp + max(ring, (wk - 1) * rows * ldp))


def panel_plan(width: int, depth: int, panels: Callable[[int], int],
               max_rows: int = 32, rows: Optional[int] = None,
               smem_limit: int = SMEM_LIMIT) -> PanelPlan:
    """The plan for a fused RHS of ``width`` columns whose A·X sums run over
    contiguous stretches of ``depth`` (n for a dense A, the block size for a
    BSR one); ``panels(rows)`` is the number of CTAs a panel height gives
    (at most ``max_rows`` rows are of use). K3's plan passes its own panel
    height (``rows``) and shared-memory cap (``smem_limit``).

    The rules follow the card's numbers (``tools/tune_fused_plan.py``, NVIDIA
    H100 80GB HBM3, 700.00 W):
    - Columns: a warp keeps 4, 8 or 16 n8 tiles in registers, and as many
      warps as the width needs share the columns; the other warps split the
      depth of each chunk.
    - Rows: 32 where that still gives ``TALL_PANEL_MIN_CTAS`` CTAs (and the
      registers allow: up to 8 tiles a warp), else 16. At n = 4000 the 125
      panels of 32 rows take 0.083 ms against 0.103 for 250 of 16; at
      n = 1000, 32 panels of 32 lose to 63 of 16 (0.029 against 0.024).
    - Chunk: the deepest (up to 128, and no deeper than ``depth`` needs)
      whose ring of two stages fits beside the panel. What a chunk costs is
      mostly fixed (the copies' address arithmetic, a barrier, a fold of the
      fragment), so deeper chunks won at every measured shape; a ring of
      three or four stages was measured too and won at none, so the ring is
      two stages deep in the kernels and no part of the plan."""
    tiles = -(-width // 8)
    if width < 1 or tiles > 16 * WARPS:
        raise ValueError(f"the fused kernels take 1 <= width <= {K_MAX} "
                         f"(8 warps of 16 n8 tiles); got {width}")
    nt, wn = next((nt, wn) for nt, wn in ((4, 1), (4, 2), (4, 4), (4, 8),
                                          (8, 8), (16, 8))
                  if nt * wn >= tiles)
    wk = WARPS // wn
    if rows is None:
        tall = nt <= 8 and max_rows > 16 and panels(32) >= TALL_PANEL_MIN_CTAS
        rows = 32 if tall else 16
    for bk in (128, 64, 32, 16, 8):
        smem = plan_smem_bytes(rows, nt, wk, bk, width)
        fits = bk >= 8 * wk and smem <= smem_limit
        if fits and (bk // 2 < depth or bk == 8 * wk):
            return PanelPlan(rows, nt, wn, wk, bk, smem)
    raise ValueError(f"no panel of width {width} fits the {SMEM_LIMIT} "
                     f"bytes of shared memory a block may use")


@functools.lru_cache(maxsize=None)
def fused_rhs_plan(n: int, k: int) -> PanelPlan:
    """K2's plan for an (n, n) operator and an (n, k) state."""
    return panel_plan(k, n, lambda rows: -(-n // rows))


def fused_rhs_plain(a: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """relu((a @ h) @ w + b), one replica or R (h, w and b with a leading
    replica axis)."""
    return torch.relu((a @ h) @ w + b.unsqueeze(-2))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, ties away from zero), as
    ``cvt.rna.tf32.f32`` rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_matmul(x: torch.Tensor, y: torch.Tensor, passes: int = 3,
                 matmul=torch.matmul) -> torch.Tensor:
    """x · y as the kernels form it: each operand split into hi = tf32(v) and
    lo = tf32(v - hi), the products lo·hi + hi·lo + hi·hi summed in float32.
    ``passes=1`` keeps hi·hi only (plain TF32, which the kernels must not
    be)."""
    x_hi, y_hi = tf32_round(x), tf32_round(y)
    if passes == 1:
        return matmul(x_hi, y_hi)
    x_lo, y_lo = tf32_round(x - x_hi), tf32_round(y - y_hi)
    return (matmul(x_lo, y_hi) + matmul(x_hi, y_lo)) + matmul(x_hi, y_hi)


def fused_rhs_split_plain(a: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """The plain version with the kernel's split-TF32 products."""
    return torch.relu(split_matmul(split_matmul(a, h, passes), w, passes)
                      + b.unsqueeze(-2))


def _check(a, h, w, b) -> None:
    for name, t in (("a", a), ("h", h), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_rhs takes float32 tensors; {name} is "
                            f"{t.dtype}")
        if t is not w and not t.is_contiguous():
            raise ValueError(f"fused_rhs takes contiguous a, h and b; {name} "
                             f"is not")
    if h.ndim not in (2, 3) or h.ndim == 3 and not 1 <= h.shape[0] <= 65535:
        raise ValueError(f"fused_rhs takes h of shape (n, k) or (R <= "
                         f"65535, n, k), got {tuple(h.shape)}")
    *lead, n, k = h.shape
    lead = tuple(lead)
    if (a.shape != (n, n) or w.shape != (*lead, k, k) or b.shape != (*lead, k)
            or not 1 <= k <= K_MAX or n < 1):
        raise ValueError(f"fused_rhs takes a (n, n), h (n, k), w (k, k), "
                         f"b (k,) (for R replicas h (R, n, k), w (R, k, k), "
                         f"b (R, k)) with 1 <= k <= {K_MAX}; got a "
                         f"{tuple(a.shape)}, h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    fused_rhs_plan(n, k)    # raises for a shape no plan can place


def _forward(a, h, w, b) -> torch.Tensor:
    if not on_cuda(a, h, w, b):
        return fused_rhs_plain(a, h, w, b)
    lib = build.load()
    n, k = h.shape[-2:]
    plan = fused_rhs_plan(n, k)
    out = torch.empty(h.shape, dtype=torch.float32, device=h.device)
    args = (a.data_ptr(), h.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, k, w.stride(-2), w.stride(-1), plan.rows,
            plan.nt, plan.wn, plan.bk, plan.smem_bytes)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        if h.ndim == 3:
            rc = lib.ndcn_fused_rhs_batched_f32(*args, h.shape[0],
                                                w.stride(0), stream)
        else:
            rc = lib.ndcn_fused_rhs_f32(*args, stream)
    if rc != 0:
        raise RuntimeError(f"fused_rhs kernel launch failed: CUDA error {rc}")
    global LAUNCHES, BATCHED_LAUNCHES
    if h.ndim == 3:
        BATCHED_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def fused_rhs_backward(a, h, w, out, g, need_a: bool = False):
    """(da, dh, dw, db) of relu((a @ h) @ w + b) at its output ``out``, for
    the cotangent ``g``; da is NaN when asked for, else None."""
    g = g * (out > 0).to(g.dtype)              # relu mask (out == 0: blocked)
    dh = a.t() @ (g @ w.transpose(-1, -2))
    dw = (a @ h).transpose(-1, -2) @ g         # A·H recomputed, not stored
    db = g.sum(-2)
    da = torch.full_like(a, float("nan")) if need_a else None
    return da, dh, dw, db


class _FusedRhs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, h, w, b):
        out = _forward(a, h, w, b)
        ctx.save_for_backward(a, h, w, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, h, w, out = ctx.saved_tensors
        return fused_rhs_backward(a, h, w, out, g,
                                  need_a=ctx.needs_input_grad[0])


def fused_rhs(a: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """relu((a @ h) @ w + b) with a (n, n), h (n, k), w (k, k), b (k,); or
    for R replicas against the same a, h (R, n, k), w (R, k, k) (each
    possibly a strided view) and b (R, k).

    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    current stream (and raise if it cannot). While a program is traced it
    is the operator ``ndcn_tpu_torch::fused_rhs`` (``kernels.ops``),
    forward only."""
    _check(a, h, w, b)
    if torch.compiler.is_compiling():
        return torch.ops.ndcn_tpu_torch.fused_rhs(a, h, w, b)
    return _FusedRhs.apply(a, h, w, b)
