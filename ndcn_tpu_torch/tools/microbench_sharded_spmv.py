"""Microbenchmark: the row-sharded COO SpMV on the card, as the JAX
package's ``tools/microbench_sharded_spmv.py``.

The JAX tool's graph (n nodes, 11 edges a node with row-sorted random rows
and random columns from ``RandomState(0)``, d = 20; argv: n, default
200000), each row timed over K = 30 chained data-dependent calls between
CUDA events (``tools.chain_time``). Rows 1 and 2 are timed alternately,
whole, sharded, sharded, whole, over ``ROUNDS`` rounds, so that neither
is timed only on a cold card or only on a warm one; the record holds every
run and the medians:

1. K1 on the whole operator (``kernels.coo_spmv``), one card;
2. the row-sharded product (``parallel.coo_shard``) on a one-rank NCCL
   group: K1 on the rank's row block (here the whole operator) against the
   gathered state, with the sharded path's wrapper and its autograd
   ``Function`` around it;
3. the plain version of the row-block product (gather, scale,
   ``index_add_``), what the JAX tool's XLA row-block route stands for.

One card makes a one-rank mesh, so the numbers are the sharded path's own
cost per device, not a collective's; the parity of more ranks is the
dryrun's (``python -m ndcn_tpu_torch.parallel.dryrun``). Prints one line
per row on stderr and one JSON line on stdout.

Usage: python -m ndcn_tpu_torch.tools.microbench_sharded_spmv [n]
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import scipy.sparse as sp
import torch

from ndcn_tpu_torch.tools import K, chain_time, log, require_cuda

ROUNDS = 3   # rounds of whole, sharded, sharded, whole


def main(argv=None) -> dict:
    import torch.distributed as dist

    from ndcn_tpu_torch.graph.sparse import from_scipy_coo, matvec
    from ndcn_tpu_torch.kernels import coo_spmv
    from ndcn_tpu_torch.parallel.coo_shard import shard_coo_rows
    from ndcn_tpu_torch.parallel.mesh import make_mesh, process_group

    argv = sys.argv[1:] if argv is None else argv
    dev = require_cuda()
    n = int(argv[0]) if argv else 200_000
    deg, d = 11, 20
    rng = np.random.RandomState(0)
    nnz = n * deg
    mat = sp.coo_matrix(
        (rng.rand(nnz).astype(np.float32) / deg,
         (np.sort(rng.randint(0, n, size=nnz)).astype(np.int32),
          rng.randint(0, n, size=nnz).astype(np.int32))),
        shape=(n, n)).tocsr()
    coo = from_scipy_coo(mat, device=dev)
    x = torch.as_tensor(rng.rand(n, d).astype(np.float32), device=dev)
    name = torch.cuda.get_device_name(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    log(f"device={name} n={n:,} nnz={nnz:,} d={d} chainK={K}")

    with process_group(dev):
        rs = shard_coo_rows(coo, make_mesh(dev))
        runs = {"whole": (lambda y: coo_spmv.coo_spmv(coo, y)),
                "sharded": (lambda y: matvec(rs, y))}
        times = {"whole": [], "sharded": []}
        out = {}
        for _ in range(ROUNDS):
            for which in ("whole", "sharded", "sharded", "whole"):
                t, out[which] = chain_time(runs[which], x)
                times[which].append(t)
        t_single = statistics.median(times["whole"])
        t_sharded = statistics.median(times["sharded"])
        y_single, y_sharded = out["whole"], out["sharded"]
        log(f"K1, whole operator:          {t_single * 1e3:8.4f} ms/SpMV "
            f"(median of {len(times['whole'])})")
        log(f"K1, row-sharded (1 rank):    {t_sharded * 1e3:8.4f} ms/SpMV "
            f"({dist.get_backend()})")
        block = rs.block
        t_plain, y_plain = chain_time(
            lambda y: coo_spmv.coo_spmv_plain(block.rows, block.cols,
                                              block.vals, y, block.n), x)
        log(f"plain row-block route:       {t_plain * 1e3:8.4f} ms/SpMV")
    if not torch.equal(y_single, y_sharded):
        raise RuntimeError("the row-sharded product parts from the whole "
                           "launch")
    rel = float((y_sharded - y_plain).abs().max()
                / y_plain.abs().max().clamp_min(1e-30))
    record = {
        "n": n, "nnz": int(nnz), "d": d, "device": name, "card": card,
        "mesh_devices": 1,
        "order": "whole, sharded, sharded, whole" + f" x {ROUNDS}",
        "single_card_k1_ms": t_single * 1e3,
        "sharded_k1_ms": t_sharded * 1e3,
        "single_card_k1_runs_ms": [t * 1e3 for t in times["whole"]],
        "sharded_k1_runs_ms": [t * 1e3 for t in times["sharded"]],
        "sharded_plain_rowblock_ms": t_plain * 1e3,
        "sharded_over_single": t_sharded / t_single,
        "k1_speedup_vs_plain": t_plain / t_sharded,
        "sharded_vs_plain_rel_err": rel,
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
