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

The plain PyTorch version beside the kernel is the CPU path, inside the same
``autograd.Function``, and the reference the kernel is held against on the
card.
"""

from __future__ import annotations

import torch

from ndcn_tpu_torch.kernels import build
from ndcn_tpu_torch.kernels.platform import on_cuda

# launches of the CUDA kernel in this process (CPU calls do not count)
LAUNCHES = 0

# widest hidden state the kernel takes: its (32, k) A·H panel lives in shared
# memory (32 · 1025 · 4 bytes at the limit)
K_MAX = 1024


def fused_rhs_plain(a: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    return torch.relu((a @ h) @ w + b)


def _check(a, h, w, b) -> None:
    for name, t in (("a", a), ("h", h), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_rhs takes float32 tensors; {name} is "
                            f"{t.dtype}")
        if t is not w and not t.is_contiguous():
            raise ValueError(f"fused_rhs takes contiguous a, h and b; {name} "
                             f"is not")
    if h.ndim != 2:
        raise ValueError(f"fused_rhs takes h of shape (n, k), got "
                         f"{tuple(h.shape)}")
    n, k = h.shape
    if (a.shape != (n, n) or w.shape != (k, k) or b.shape != (k,)
            or not 1 <= k <= K_MAX or n < 1):
        raise ValueError(f"fused_rhs takes a (n, n), h (n, k), w (k, k), "
                         f"b (k,) with 1 <= k <= {K_MAX}; got a "
                         f"{tuple(a.shape)}, h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")


def _forward(a, h, w, b) -> torch.Tensor:
    if not on_cuda(a, h, w, b):
        return fused_rhs_plain(a, h, w, b)
    lib = build.load()
    n, k = h.shape
    out = torch.empty((n, k), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        rc = lib.ndcn_fused_rhs_f32(
            a.data_ptr(), h.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, k, w.stride(0), w.stride(1),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_rhs kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def fused_rhs_backward(a, h, w, out, g, need_a: bool = False):
    """(da, dh, dw, db) of relu((a @ h) @ w + b) at its output ``out``, for
    the cotangent ``g``; da is NaN when asked for, else None."""
    g = g * (out > 0).to(g.dtype)              # relu mask (out == 0: blocked)
    dh = a.t() @ (g @ w.t())
    dw = (a @ h).t() @ g                       # A·H recomputed, not stored
    db = g.sum(0)
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
    """relu((a @ h) @ w + b) with a (n, n), h (n, k), w (k, k), b (k,).

    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    current stream (and raise if it cannot)."""
    _check(a, h, w, b)
    return _FusedRhs.apply(a, h, w, b)
