"""How K1's wide form and K3's replica groups depend on their host plans.

K1's wide form (rows wider than a warp's 32 loads) takes its lane columns
(the row lanes one lane takes, C; the edges in flight follow, 32 words of
loads a lane) from ``kernels.coo_spmv.gather_plan``, and starts the
operator's heavy rows (``RowSplit.heavy_rows``) first. K3's batched form
takes its replica group and panel from ``kernels.bsr_spmm.
bsr_batched_plan``. This tool times both under the plan's choice and under
the others the kernels are built for, at the shapes the records quote, so
that the plans' rules rest on the card's numbers:

    python -m ndcn_tpu_torch.tools.tune_wide_plan

- K1 on cora's and citeseer's operators at their raw features' widths
  (1433, 3703), and cora's at 1433 with 25 replicas: C in {1, 2, 4}, the
  heavy rows first or in row order; cora with every row cut to its first
  16 edges (the short rows alone); cora at d = 129 (the first wide width
  of 4-byte loads), beside ``torch.sparse.mm``.
- K3 batched on cora's BSR operator at d = 16 with 25 replicas and on
  grid400 at d = 20 and 5 with 16: every group the panel takes (32 rows
  and 8 n8 tiles a warp, or 16 and 16), beside the replica grid (a CTA a
  replica) and the one-replica plan's.

Times are ms per call of ten calls (three at 25 replicas) queued behind a
spin kernel (``tune_fused_plan.device_ms``). Every variant is held bit-equal
to the narrow form (K1) or to the one-replica launches (K3): the plans
change where the work runs, not a value's sum. One JSON line on stdout; a
line per shape on stderr.
"""

from __future__ import annotations

import json
import os

import numpy as np
import scipy.sparse as sp
import torch

from ndcn_tpu_torch.data import load_planetoid
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import from_scipy_bsr_graph, from_scipy_coo
from ndcn_tpu_torch.kernels import build, bsr_spmm, coo_spmv
from ndcn_tpu_torch.kernels.fused_rhs import WARPS, plan_smem_bytes
from ndcn_tpu_torch.tools import log, require_cuda
from ndcn_tpu_torch.tools.tune_fused_plan import device_ms

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data")


def wide_k1(op, x: torch.Tensor, columns: int, heavy: bool) -> torch.Tensor:
    """K1's wide form on x (n, d) or (R, n, d) fp32 with ``columns`` lane
    columns, the heavy rows first or not."""
    d = x.shape[-1]
    replicas = x.shape[0] if x.ndim == 3 else 1
    plan = coo_spmv.gather_plan(d, coo_spmv._gather_width(x.view(-1, d)), 4,
                                columns)
    rows = op.split.heavy_rows
    n_heavy = rows.numel() if heavy else 0
    y = torch.empty((*x.shape[:-2], op.n, d), device=x.device)
    coo_spmv._launch_gather(
        "ndcn_coo_spmv_wide_f32", op, x, y, d, replicas,
        (rows.data_ptr() if n_heavy else None, n_heavy, coo_spmv.HEAVY_EDGES,
         replicas, op.n_table, columns, plan.tiles,
         plan.grid(op.n + n_heavy)[0]))
    return y


def k1_variants(op, x: torch.Tensor, columns=(1, 2, 4)) -> dict:
    """K1's wide form under each C, heavy rows first and not: bit-equal to
    the narrow form (one replica) or to the one-replica wide launches."""
    ref = (torch.stack([coo_spmv.coo_spmv(op, x[i]) for i in
                        range(x.shape[0])]) if x.ndim == 3
           else coo_spmv.coo_spmv_narrow(op, x))
    batch = 3 if x.ndim == 3 else 10
    out = {"plan_columns": coo_spmv.gather_plan(
        x.shape[-1], coo_spmv._gather_width(x.view(-1, x.shape[-1])),
        4).lane_columns}
    for c in columns:
        for heavy in (False, True):
            y = wide_k1(op, x, c, heavy)
            if not torch.equal(y, ref):
                raise RuntimeError(f"K1's wide form at C = {c} parts from "
                                   f"the narrow form")
            out[f"C{c}_heavy_first" if heavy else f"C{c}_row_order"] = \
                device_ms(lambda: wide_k1(op, x, c, heavy), batch=batch)
    return out


def rows_cut(mat: sp.csr_matrix, keep: int) -> sp.csr_matrix:
    """``mat`` with each row cut to its first ``keep`` entries."""
    lens = np.minimum(np.diff(mat.indptr), keep)
    take = np.concatenate([np.arange(s, s + k) for s, k in
                           zip(mat.indptr[:-1], lens)])
    return sp.csr_matrix((mat.data[take], mat.indices[take],
                          np.concatenate([[0], np.cumsum(lens)])),
                         shape=mat.shape)


def k3_groups(op, x: torch.Tensor) -> dict:
    """K3's batched form on x (R, n, d) under every group the panel takes,
    beside the replica grid and the plan's choice; each bit-equal to the
    one-replica launches."""
    a, r, d = op.fwd, x.shape[0], x.shape[-1]
    lib = build.load()
    base = bsr_spmm.bsr_spmm_plan(a.n_row_blocks, a.block, d)
    p = base.panel
    ref = torch.stack([bsr_spmm.bsr_spmm(op.fwd, op.bwd, x[i])
                       for i in range(r)])
    stream = torch.cuda.current_stream().cuda_stream
    head = (a.row_ptr.data_ptr(), a.block_cols.data_ptr(),
            a.blocks.data_ptr(), x.data_ptr())

    def grouped(rows, nt, group):
        y = torch.empty_like(x)
        rc = lib.ndcn_bsr_spmm_grouped_f32(
            *head, y.data_ptr(), a.n_row_blocks, a.block, a.n_rows,
            a.n_cols, d, base.slab, rows, nt, p.bk,
            plan_smem_bytes(rows, nt, WARPS, p.bk,
                            group * (-(-base.slab // 4) * 4)), r, group,
            stream)
        if rc != 0:
            raise RuntimeError(f"the grouped K3 launch failed: {rc}")
        return y

    def replica_grid():
        y = torch.empty_like(x)
        rc = lib.ndcn_bsr_spmm_batched_f32(
            *head, y.data_ptr(), a.n_row_blocks, a.block, a.n_rows, a.n_cols,
            d, base.slab, p.rows, p.wn, p.bk, p.smem_bytes, r, stream)
        if rc != 0:
            raise RuntimeError(f"the batched K3 launch failed: {rc}")
        return y

    plan = bsr_spmm.bsr_batched_plan(a.n_row_blocks, a.block, d, r)
    out = {"plan": dict(group=plan.group, groups=plan.groups,
                        rows=plan.rows, nt=plan.nt),
           "replica_grid": device_ms(replica_grid, batch=3)}
    if not torch.equal(replica_grid(), ref):
        raise RuntimeError("the replica grid parts from one-replica launches")
    rep = -(-base.slab // 4) * 4
    for rows, nt in ((32, 8), (16, 16)):
        for group in range(2, min(r, 8 * nt // rep) + 1):
            if not torch.equal(grouped(rows, nt, group), ref):
                raise RuntimeError(f"the group of {group} ({rows} x {nt}) "
                                   f"parts from one-replica launches")
            out[f"{rows}x{nt}_group{group}"] = device_ms(
                lambda: grouped(rows, nt, group), batch=3)
    return out


def main(argv=None) -> dict:
    dev = require_cuda()
    results = {"device": torch.cuda.get_device_name(dev), "k1": {}, "k3": {}}
    rng = np.random.RandomState(0)
    cite = {name: load_planetoid(name, alpha=0.5, data_dir=DATA)
            for name in ("cora", "citeseer")}
    for name, d in (("cora", 1433), ("citeseer", 3703)):
        mat = cite[name].operator
        op = from_scipy_coo(mat, device=dev)
        x = torch.as_tensor(rng.randn(op.n, d).astype(np.float32),
                            device=dev)
        a = torch.sparse_csr_tensor(op.row_ptr, op.cols, op.vals,
                                    size=(op.n, op.n))
        rec = k1_variants(op, x)
        rec.update(library=device_ms(lambda: torch.sparse.mm(a, x)),
                   max_row_edges=int(np.diff(mat.indptr).max()),
                   heavy_rows=int(op.split.heavy_rows.numel()))
        results["k1"][f"{name}_d{d}"] = rec
        log(f"K1 {name} d={d}: {rec}")
        if name == "cora":
            cut = from_scipy_coo(rows_cut(sp.csr_matrix(mat), 16),
                                 device=dev)
            results["k1"]["cora_d1433_rows_cut_16"] = rec = k1_variants(
                cut, x, (2, 4))
            log(f"K1 cora, rows cut to 16 edges: {rec}")
            xr = torch.as_tensor(rng.randn(25, op.n, d).astype(np.float32),
                                 device=dev)
            results["k1"]["cora_d1433_r25"] = rec = k1_variants(op, xr,
                                                                (2, 4))
            log(f"K1 cora d=1433 R=25: {rec}")
            del xr
            x129 = torch.as_tensor(rng.randn(op.n, 129).astype(np.float32),
                                   device=dev)
            results["k1"]["cora_d129"] = rec = k1_variants(op, x129)
            log(f"K1 cora d=129: {rec}")
    grid = sp.csr_matrix(operators.normalized_laplacian(
        generators.build_network("grid", 400)).astype(np.float32))
    for label, mat, d, r in (("cora_d16_r25", cite["cora"].operator, 16, 25),
                             ("grid400_d20_r16", grid, 20, 16),
                             ("grid400_d5_r16", grid, 5, 16)):
        op = from_scipy_bsr_graph(sp.csr_matrix(mat).astype(np.float32),
                                  device=dev)
        x = torch.as_tensor(rng.rand(r, op.n, d).astype(np.float32),
                            device=dev)
        results["k3"][label] = rec = k3_groups(op, x)
        log(f"K3 {label}: {rec}")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
