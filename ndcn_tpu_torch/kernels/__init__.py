"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version
and a backward.

- K1 ``coo_spmv``: CSR SpMV, replaces ``ndcn_tpu/kernels/coo_spmv.py``; its
  backward is K1 over the transpose; a bf16 instance; and the feature-major
  forms of ``spmv_T``, K1-fm (a pack kernel, then the gather) and K5 (the
  wide gather).
- K1-w ``coo_mutual``: the mutualistic interaction over the COO operator,
  forward and both sides of its backward; replaces the weighted reduce that
  ``ndcn_tpu/dynamics/rhs.py`` runs on K1's Pallas kernel.
- K2 ``fused_rhs``: relu((A·H)·W + b), replaces ``ndcn_tpu/kernels/fused_rhs.py``.
- K3 and K4 ``bsr_spmm``: BSR SpMM and its fused RHS, replace
  ``ndcn_tpu/kernels/bsr_spmm.py``. K2 and K4 multiply on the tensor cores
  (split TF32, ``csrc/mma_split.cuh``).
- P1a and P1b / P2 ``sparse_bench``: the sparse microbenchmarks' sliced-tile
  reduce and row gather, replace the Pallas kernels of
  ``tools/microbench_sparse.py`` and ``tools/probe_inkernel_gather.py``.
"""

from ndcn_tpu_torch.kernels import (bsr_spmm, coo_mutual, coo_spmv, fused_rhs,
                                    sparse_bench)

# kernel name -> (module, counter attribute)
_COUNTERS = {
    "coo_spmv": (coo_spmv, "LAUNCHES"),
    "coo_spmv_bf16": (coo_spmv, "BF16_LAUNCHES"),
    "coo_spmv_T": (coo_spmv, "T_LAUNCHES"),
    "coo_spmv_T_pack": (coo_spmv, "PACK_LAUNCHES"),
    "coo_spmv_T_wide": (coo_spmv, "WIDE_LAUNCHES"),
    "coo_mutual": (coo_mutual, "LAUNCHES"),
    "fused_rhs": (fused_rhs, "LAUNCHES"),
    "bsr_spmm": (bsr_spmm, "SPMM_LAUNCHES"),
    "bsr_fused_rhs": (bsr_spmm, "FUSED_LAUNCHES"),
    "sliced_tile_reduce": (sparse_bench, "SLICED_LAUNCHES"),
    "row_gather": (sparse_bench, "GATHER_LAUNCHES"),
}


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
