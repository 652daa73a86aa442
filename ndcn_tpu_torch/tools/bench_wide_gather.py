"""Measure the wide-gather SpMV (K5) against the narrow feature-major one
(K1-fm) on the card, as the JAX package's ``tools/bench_wide_gather.py``.

Both modes compute ``spmv_T``, the feature-major solve's product, on the
tool's graph (n nodes, deg 11 random edges per node from ``RandomState(0)``,
d features; argv n, d, and an optional output path; defaults 1000000, 20):
K1-fm reads the (d_sub, n) state directly, one 4-byte value per feature and
edge; K5 first copies it into a row-major (n, d_sub) table and gathers
contiguous rows. Each mode runs in split2 (fp32) and bf16 (the state and A
rounded to bf16, fp32 sums), timed over K = 30 chained calls between CUDA
events (``tools.chain_time``), with ``rel_err`` = max|Δ| / max|y| against a
float64 oracle.

Usage: python -m ndcn_tpu_torch.tools.bench_wide_gather [n] [d] [out.json]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import scipy.sparse as sp
import torch

from ndcn_tpu_torch.graph.sparse import from_scipy_coo
from ndcn_tpu_torch.kernels import coo_spmv
from ndcn_tpu_torch.tools import chain_time, log, require_cuda


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    dev = require_cuda()
    n = int(argv[0]) if len(argv) > 0 else 1_000_000
    d = int(argv[1]) if len(argv) > 1 else 20
    out_path = argv[2] if len(argv) > 2 else None
    deg = 11
    rng = np.random.RandomState(0)
    nnz = n * deg
    rows = np.sort(rng.randint(0, n, size=nnz)).astype(np.int32)
    cols = rng.randint(0, n, size=nnz).astype(np.int32)
    vals = rng.rand(nnz).astype(np.float32)
    x = rng.rand(n, d).astype(np.float32)
    log(f"device={torch.cuda.get_device_name(dev)} n={n} nnz={nnz} d={d}")

    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    ref = a.tocsr().astype(np.float64) @ x.astype(np.float64)
    ref_scale = np.abs(ref).max()
    op = from_scipy_coo(a, device=dev)
    d_sub = coo_spmv.sublane_pad(d)
    xT = torch.zeros((d_sub, n), device=dev)
    xT[:d] = torch.as_tensor(x.T.copy(), device=dev)

    results = {"n": n, "nnz": nnz, "d": d, "d_sub": d_sub,
               "device": torch.cuda.get_device_name(dev), "modes": []}
    saved = coo_spmv.GATHER_WIDE, coo_spmv.GATHER_BF16
    try:
        for wide in (False, True):
            for precision in ("split2", "bf16"):
                coo_spmv.GATHER_WIDE = wide
                coo_spmv.GATHER_BF16 = precision == "bf16"

                def step_T(yT):
                    out = coo_spmv.spmv_T(op, yT)
                    return out / torch.clamp(out.abs().max(), min=1.0)

                t, _ = chain_time(step_T, xT)
                with torch.no_grad():
                    got = coo_spmv.spmv_T(op, xT)[:d].t().cpu().numpy()
                row = dict(mode="wide" if wide else "narrow",
                           precision=precision, ms=t * 1e3,
                           rel_err=float(np.abs(got - ref).max() / ref_scale))
                log(row)
                results["modes"].append(row)
    finally:
        coo_spmv.GATHER_WIDE, coo_spmv.GATHER_BF16 = saved
    line = json.dumps(results)
    print(line)
    if out_path:
        with open(out_path, "w") as f:
            f.write(line)
    return results


if __name__ == "__main__":
    main()
