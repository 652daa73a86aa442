"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version
and a backward.

- K1 ``coo_spmv``: CSR SpMV, replaces ``ndcn_tpu/kernels/coo_spmv.py``; its
  backward is K1 over the transpose.
- K2 ``fused_rhs``: relu((A·H)·W + b), replaces ``ndcn_tpu/kernels/fused_rhs.py``.
- K3 and K4 ``bsr_spmm``: BSR SpMM and its fused RHS, replace
  ``ndcn_tpu/kernels/bsr_spmm.py``.
"""

from ndcn_tpu_torch.kernels import bsr_spmm, coo_spmv, fused_rhs


def launch_counts() -> dict:
    return {"coo_spmv": coo_spmv.LAUNCHES, "fused_rhs": fused_rhs.LAUNCHES,
            "bsr_spmm": bsr_spmm.SPMM_LAUNCHES,
            "bsr_fused_rhs": bsr_spmm.FUSED_LAUNCHES}


def reset_launch_counts() -> None:
    coo_spmv.LAUNCHES = 0
    fused_rhs.LAUNCHES = 0
    bsr_spmm.SPMM_LAUNCHES = 0
    bsr_spmm.FUSED_LAUNCHES = 0
