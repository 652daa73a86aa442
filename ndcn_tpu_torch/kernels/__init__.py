"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

- K1 ``coo_spmv``: CSR SpMV, replaces ``ndcn_tpu/kernels/coo_spmv.py``.
- K2 ``fused_rhs``: relu((A·H)·W + b), replaces ``ndcn_tpu/kernels/fused_rhs.py``.
"""

from ndcn_tpu_torch.kernels import coo_spmv, fused_rhs


def launch_counts() -> dict:
    return {"coo_spmv": coo_spmv.LAUNCHES, "fused_rhs": fused_rhs.LAUNCHES}


def reset_launch_counts() -> None:
    coo_spmv.LAUNCHES = 0
    fused_rhs.LAUNCHES = 0
