"""The reference's matrix products, in the precision the comparison asks for.

Every product of the reference goes through ``Products``: the dense
``mm`` (the linear layers, a dense operator) and ``spmm`` (a sparse CSR
operator). Three modes:

- ``float64``: the reference itself, every tensor in float64;
- ``float32``: float32 tensors, full float32 products (TF32 off);
- ``tf32``: the control: float32 tensors whose every product rounds both
  operands to TF32 (10 mantissa bits, round to nearest even) and sums in
  float32, forward and backward, which is what a TF32 tensor-core product
  computes. The rounding is explicit, so the control reads the same on the
  card and on the CPU, and also for the sparse product, which no library
  switch would round.

The backward of a product is written out (``_Mm``, ``_Spmm``) so that its
two products round too.
"""

from __future__ import annotations

import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest even;
    inf and NaN pass through."""
    bits = x.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + keep) & ~0x1FFF
    out = rounded.view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


class _Mm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd):
        ctx.rnd = rnd
        ctx.save_for_backward(a, b)
        return rnd(a) @ rnd(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        rnd = ctx.rnd
        ga = rnd(g) @ rnd(b).transpose(-1, -2) if ctx.needs_input_grad[0] \
            else None
        gb = rnd(a).transpose(-1, -2) @ rnd(g) if ctx.needs_input_grad[1] \
            else None
        return ga, gb, None


class _Spmm(torch.autograd.Function):
    """``a @ x`` for a constant sparse CSR ``a`` (its transpose given), in x."""

    @staticmethod
    def forward(ctx, a, a_t, x, rnd):
        ctx.a_t, ctx.rnd = a_t, rnd
        return a @ rnd(x)

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.a_t @ ctx.rnd(g), None


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class Products:
    """The products and the dtype of one precision mode (see the module)."""

    MODES = ("float64", "float32", "tf32")

    def __init__(self, mode: str):
        if mode not in self.MODES:
            raise ValueError(f"unknown precision {mode!r}; one of {self.MODES}")
        self.mode = mode
        self.dtype = torch.float64 if mode == "float64" else torch.float32
        self._rnd = to_tf32 if mode == "tf32" else _identity

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _Mm.apply(a, b, self._rnd)

    def operator(self, mat: torch.Tensor):
        """``mat`` (dense, or sparse CSR) in this mode's dtype, rounded to
        TF32 under ``tf32``, as a function x -> mat @ x."""
        if mat.layout == torch.sparse_csr:
            vals = self._rnd(mat.values().to(self.dtype))
            a = torch.sparse_csr_tensor(mat.crow_indices(), mat.col_indices(),
                                        vals, mat.shape)
            a_t = a.t().to_sparse_csr()
            return lambda x: _Spmm.apply(a, a_t, x, self._rnd)
        dense = mat.to(self.dtype)
        return lambda x: self.mm(dense, x)
