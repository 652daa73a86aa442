"""Microbenchmark: the sparse SpMV building blocks on the card, as the JAX
package's ``tools/microbench_sparse.py``.

The same graph: n nodes, deg 11 edges per node with row-sorted random rows
and random columns from ``RandomState(0)``, and d features (argv: n, d;
defaults 200000, 20). Each row is timed over K = 30 chained data-dependent
calls between CUDA events (``tools.chain_time``) and checked against a
float64 numpy oracle where it computes A·X:

- [1] index + index_add (the plain SpMV), [2a]/[2b] the major gather
  y[cols] at d and at 128, [3]/[3b] the minor gather yT[:, cols] with
  random and with sorted columns, [4]/[4b] the segment sum ``index_add_``
  over sorted and unsorted rows;
- [6] P1a, the sliced-tile reduce (``kernels/sparse_bench.py``) over its
  inline packing (R = 128 rows per tile, E = 2048 slots per slice), end to
  end after the minor gather, and [6b] the reduce alone, each against its
  plain version;
- [7] P1b, the row gather of 512 rows from a (1024, 128) table, against
  ``x[idx]``.

Usage: python -m ndcn_tpu_torch.tools.microbench_sparse [n] [d]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import scipy.sparse as sp
import torch

from ndcn_tpu_torch.kernels import sparse_bench
from ndcn_tpu_torch.tools import K, chain_time, log, require_cuda


def _rel(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    dev = require_cuda()
    n = int(argv[0]) if len(argv) > 0 else 200_000
    d = int(argv[1]) if len(argv) > 1 else 20
    deg = 11
    rng = np.random.RandomState(0)
    nnz = n * deg
    rows = np.sort(rng.randint(0, n, size=nnz)).astype(np.int32)
    cols = rng.randint(0, n, size=nnz).astype(np.int32)
    vals = rng.rand(nnz).astype(np.float32)
    x = rng.rand(n, d).astype(np.float32)
    log(f"device={torch.cuda.get_device_name(dev)} n={n} nnz={nnz} d={d} "
        f"chainK={K}")
    results = {"n": n, "nnz": nnz, "d": d,
               "device": torch.cuda.get_device_name(dev)}

    ref = (sp.csr_matrix((vals.astype(np.float64), (rows, cols)),
                         shape=(n, n)) @ x.astype(np.float64))
    rows_t = torch.as_tensor(rows.astype(np.int64), device=dev)
    cols_t = torch.as_tensor(cols.astype(np.int64), device=dev)
    vals_t = torch.as_tensor(vals, device=dev)
    x_t = torch.as_tensor(x, device=dev)
    xT_t = x_t.t().contiguous()

    def spmv(y):
        return torch.zeros_like(y).index_add_(0, rows_t,
                                              vals_t[:, None] * y[cols_t])

    # [1] the plain SpMV, chained out -> x
    t, _ = chain_time(lambda y: (lambda o: o / torch.clamp(
        o.abs().max(), min=1.0))(spmv(y)), x_t)
    err = _rel(spmv(x_t).cpu().numpy(), ref)
    log(f"[1] index+index_add (n,{d}): {t*1e3:.3f} ms ({nnz/t/1e6:,.0f}M "
        f"edges/s), rel err {err:.2e}")
    results.update(take_segsum_ms=t * 1e3, take_segsum_err=err)

    # [2a] / [2b] gather major
    t, _ = chain_time(lambda y: y + 1e-12 * y[cols_t][:n], x_t)
    log(f"[2a] gather major (nnz,{d}): {t*1e3:.3f} ms "
        f"({nnz/t/1e6:,.0f}M rows/s)")
    results["gather_major_ms"] = t * 1e3
    x128 = torch.as_tensor(rng.rand(n, 128).astype(np.float32), device=dev)
    t, _ = chain_time(lambda y: y + 1e-12 * y[cols_t][:n], x128)
    log(f"[2b] gather major (nnz,128): {t*1e3:.3f} ms "
        f"({nnz/t/1e6:,.0f}M rows/s)")
    results["gather_major_128_ms"] = t * 1e3
    del x128

    # [3] / [3b] gather minor, random and column-sorted indices
    t, _ = chain_time(lambda y: y + 1e-12 * y[:, cols_t][:, :n], xT_t)
    log(f"[3] gather minor ({d},nnz): {t*1e3:.3f} ms "
        f"({nnz/t/1e6:,.0f}M cols/s)")
    results["gather_minor_ms"] = t * 1e3
    cols_sorted = torch.sort(cols_t).values
    t, _ = chain_time(lambda y: y + 1e-12 * y[:, cols_sorted][:, :n], xT_t)
    log(f"[3b] gather minor SORTED ({d},nnz): {t*1e3:.3f} ms "
        f"({nnz/t/1e6:,.0f}M cols/s)")
    results["gather_minor_sorted_ms"] = t * 1e3
    del cols_sorted

    # [4] / [4b] the segment sum alone, sorted and unsorted rows
    contrib0 = vals_t[:, None] * x_t[cols_t]

    def segsum(index):
        def step(cb):
            out = torch.zeros((n, d), device=dev).index_add_(0, index, cb)
            return cb * (1.0 + 1e-12 * out[0, 0])
        return step

    t, _ = chain_time(segsum(rows_t), contrib0)
    log(f"[4] sorted segsum (nnz,{d}): {t*1e3:.3f} ms "
        f"({nnz/t/1e6:,.0f}M rows/s)")
    results["segsum_ms"] = t * 1e3
    perm = torch.as_tensor(rng.permutation(nnz), device=dev)
    t, _ = chain_time(segsum(rows_t[perm]), contrib0[perm])
    log(f"[4b] UNSORTED segsum (nnz,{d}): {t*1e3:.3f} ms "
        f"({nnz/t/1e6:,.0f}M rows/s)")
    results["segsum_unsorted_ms"] = t * 1e3
    del contrib0, perm

    # [6] P1a: the sliced-tile reduce over its inline packing
    tiles = sparse_bench.pack_sliced_tiles(rows, cols, vals, n, device=dev)
    S = tiles.local_rows.shape[0] // tiles.E
    log(f"[6] packing: T={tiles.n_pad // tiles.R} S={S} E={tiles.E} "
        f"pad_ratio={S * tiles.E / max(nnz, 1):.2f}")
    d_sub = -(-d // 8) * 8
    xT_pad = torch.zeros((d_sub, n), device=dev)
    xT_pad[:d] = xT_t
    slot_cols = tiles.cols.long()
    results.update(R=tiles.R, E=tiles.E, slices=S)

    def reduce_spmv_T(reduce):
        def f(yT):
            return reduce(tiles, yT[:, slot_cols].contiguous())[:, :n]
        return f

    for label, reduce in (("kernel", sparse_bench.sliced_tile_reduce),
                          ("plain", sparse_bench.sliced_tile_reduce_plain)):
        f = reduce_spmv_T(reduce)
        t, _ = chain_time(lambda y: (lambda o: o / torch.clamp(
            o.abs().max(), min=1.0))(f(y)), xT_pad)
        got = f(xT_pad)[:d].t().cpu().numpy()
        err = _rel(got, ref)
        log(f"[6] sliced-tile spmv e2e, {label} reduce: {t*1e3:.3f} ms "
            f"({nnz/t/1e6:,.0f}M edges/s), rel err vs oracle {err:.2e}")
        results[f"sliced_spmv_{label}_ms"] = t * 1e3
        results[f"sliced_spmv_{label}_err"] = err
    gathered0 = xT_pad[:, slot_cols].contiguous()
    out_k = sparse_bench.sliced_tile_reduce(tiles, gathered0)
    out_p = sparse_bench.sliced_tile_reduce_plain(tiles, gathered0)
    diff = float((out_k - out_p).abs().max())
    results["sliced_reduce_max_abs_err"] = diff
    results["sliced_reduce_kernel_vs_plain"] = diff / float(
        out_p.abs().max())
    for label, reduce in (("kernel", sparse_bench.sliced_tile_reduce),
                          ("plain", sparse_bench.sliced_tile_reduce_plain)):
        t, _ = chain_time(lambda g: g * (1.0 + 1e-12 * reduce(tiles, g)[0, 0]),
                          gathered0)
        log(f"[6b] sliced-tile reduce only, {label}: {t*1e3:.3f} ms")
        results[f"sliced_reduce_{label}_ms"] = t * 1e3
    del gathered0, tiles

    # [7] P1b: the row gather of 512 rows from a (1024, 128) table
    m, kk = 1024, 128
    idx_np = rng.randint(0, m, size=512).astype(np.int32)
    x_small_np = rng.rand(m, kk).astype(np.float32)
    x_small = torch.as_tensor(x_small_np, device=dev)
    idx = torch.as_tensor(idx_np, device=dev)
    got = sparse_bench.row_gather(x_small, idx).cpu().numpy()
    ok = bool(np.array_equal(got, x_small_np[idx_np]))
    results["row_gather_max_abs_err"] = float(
        np.abs(got - x_small_np[idx_np]).max())
    t, _ = chain_time(lambda y: y + 1e-12 * sparse_bench.row_gather(
        y, idx)[:1], x_small)
    t_plain, _ = chain_time(lambda y: y + 1e-12 * y[idx.long()][:1], x_small)
    log(f"[7] row gather kernel: correct={ok}, {t*1e6:.1f} us "
        f"(plain x[idx] {t_plain*1e6:.1f} us) per 512-row gather")
    results.update(inkernel_take=ok, row_gather_us=t * 1e6,
                   row_gather_plain_us=t_plain * 1e6)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
