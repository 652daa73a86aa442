"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version
and a backward.

- K1 ``coo_spmv``: CSR SpMV, replaces ``ndcn_tpu/kernels/coo_spmv.py``; its
  backward is K1 over the transpose; a bf16 instance; and the feature-major
  forms of ``spmv_T``, K1-fm (a pack kernel, then the gather) and K5 (a
  copied table, then the same gather).
- K1-w ``coo_mutual``: the mutualistic interaction over the COO operator,
  forward and both sides of its backward (an edge-parallel segmented reduce
  to width 8, K1's warp layout above); replaces the weighted reduce that
  ``ndcn_tpu/dynamics/rhs.py`` runs on K1's Pallas kernel.
- K2 ``fused_rhs``: relu((A·H)·W + b), replaces ``ndcn_tpu/kernels/fused_rhs.py``.
- K3 and K4 ``bsr_spmm``: BSR SpMM and its fused RHS, replace
  ``ndcn_tpu/kernels/bsr_spmm.py``. K2, K3 and K4 multiply on the tensor
  cores (split TF32, ``csrc/mma_split.cuh``).
- K1, K2, K3 and K4 each also have a batched form for the replica sweeps:
  R replicas' states (and K2 / K4's R weights) against one shared operator
  in one launch, the replica a grid dimension (K3 at narrow widths: a CTA
  for a group of replicas, which share each staged chunk of A).
- K1's rows wider than a warp's 32 loads (the citation graphs' raw
  features) take its wide form, a warp for each 32-lane tile of a row;
  counted by entry as K1 is, and alone as ``coo_spmv_wide`` /
  ``coo_spmv_wide_batched``; K3's replica groups alike as
  ``bsr_spmm_grouped_batched``.
- P1a and P1b / P2 ``sparse_bench``: the sparse microbenchmarks' sliced-tile
  reduce and row gather, replace the Pallas kernels of
  ``tools/microbench_sparse.py`` and ``tools/probe_inkernel_gather.py``.
- The mesh path (``parallel.coo_shard``) launches K1 and K1-fm's gather on
  each rank's row block (``coo_spmv.CsrBlock``); those launches are counted
  as ``coo_spmv_rowblock`` / ``coo_spmv_T_rowblock`` alone.
- ``ops``: K1, K1-fm (pack, gather), K5, K2, K3 and K4 as
  ``torch.library`` operators (namespace
  ``ndcn_tpu_torch``), which a traced program (the serving artifact) holds;
  importing this package registers them. Their launches count as the
  wrappers' do.
"""

from ndcn_tpu_torch.kernels import (bsr_spmm, coo_mutual, coo_spmv, fused_rhs,
                                    ops, sparse_bench)

# kernel name -> (module, counter attribute)
_COUNTERS = {
    "coo_spmv": (coo_spmv, "LAUNCHES"),
    "coo_spmv_bf16": (coo_spmv, "BF16_LAUNCHES"),
    "coo_spmv_batched": (coo_spmv, "BATCHED_LAUNCHES"),
    "coo_spmv_batched_bf16": (coo_spmv, "BATCHED_BF16_LAUNCHES"),
    # K1's wide form alone (fp32, bf16), also counted above by entry
    "coo_spmv_wide": (coo_spmv, "K1_WIDE_LAUNCHES"),
    "coo_spmv_wide_batched": (coo_spmv, "K1_WIDE_BATCHED_LAUNCHES"),
    "coo_spmv_T": (coo_spmv, "T_LAUNCHES"),
    "coo_spmv_T_pack": (coo_spmv, "PACK_LAUNCHES"),
    "coo_spmv_T_wide": (coo_spmv, "WIDE_LAUNCHES"),
    "coo_spmv_rowblock": (coo_spmv, "ROWBLOCK_LAUNCHES"),      # any form
    "coo_spmv_wide_rowblock": (coo_spmv, "ROWBLOCK_WIDE_LAUNCHES"),
    "coo_spmv_T_rowblock": (coo_spmv, "T_ROWBLOCK_LAUNCHES"),
    "coo_mutual": (coo_mutual, "LAUNCHES"),             # either form
    "coo_mutual_edges": (coo_mutual, "EDGE_LAUNCHES"),  # the edge form
    "fused_rhs": (fused_rhs, "LAUNCHES"),
    "fused_rhs_batched": (fused_rhs, "BATCHED_LAUNCHES"),
    "bsr_spmm": (bsr_spmm, "SPMM_LAUNCHES"),
    "bsr_spmm_batched": (bsr_spmm, "BATCHED_SPMM_LAUNCHES"),  # either grid
    "bsr_spmm_grouped_batched": (bsr_spmm, "GROUPED_SPMM_LAUNCHES"),
    "bsr_fused_rhs": (bsr_spmm, "FUSED_LAUNCHES"),
    "bsr_fused_rhs_batched": (bsr_spmm, "BATCHED_FUSED_LAUNCHES"),
    "sliced_tile_reduce": (sparse_bench, "SLICED_LAUNCHES"),
    "row_gather": (sparse_bench, "GATHER_LAUNCHES"),
}


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
