"""How the fused RHS kernels' time depends on the host's plan.

K2 (``fused_rhs``) and K4 (``bsr_fused_rhs``) take their panel height and
chunk depth from ``kernels.fused_rhs.panel_plan``. This tool times
each kernel under the plan's own choice and under every other choice the
kernels are built for, at the shapes the records quote, so that the plan's
rules rest on the card's numbers:

    python -m ndcn_tpu_torch.tools.tune_fused_plan

Times are ms per call of ten calls queued behind a spin kernel (the card's
part, without the wrapper's host work), the median of five runs. One JSON line
on stdout; one line per shape on stderr. Every variant's result is held
bit-equal or within 2e-6·max|y| of the plan's own (another panel height is
the same sum; another chunk depth folds it in other places).
"""

from __future__ import annotations

import json
import statistics

import numpy as np
import scipy.sparse as sp
import torch

from ndcn_tpu_torch.graph.sparse import from_scipy_bsr_graph
from ndcn_tpu_torch.kernels import bsr_spmm, fused_rhs
from ndcn_tpu_torch.kernels.fused_rhs import SMEM_LIMIT, plan_smem_bytes
from ndcn_tpu_torch.tools import log, require_cuda

ROWS_FOR_NT = {4: (16, 32), 8: (16, 32), 16: (16,)}


def device_ms(fn, batch: int = 10, runs: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def variants(base, width: int, max_rows: int = 64):
    """The plans the kernels take for this width that fit a block: the
    base's warp layout at every panel height and chunk depth."""
    seen = set()
    for rows in ROWS_FOR_NT[base.nt]:
        if rows > max(16, -(-max_rows // 16) * 16):
            continue
        for bk in (8, 16, 32, 64, 128):
            if bk % (8 * base.wk):
                continue
            smem = plan_smem_bytes(rows, base.nt, base.wk, bk, width)
            plan = base._replace(rows=rows, bk=bk, smem_bytes=smem)
            if smem <= SMEM_LIMIT and plan not in seen:
                seen.add(plan)
                yield plan


def sweep(call, module, attr, base, width, max_rows=64) -> dict:
    """Time ``call`` with ``module.attr`` returning each variant plan."""
    original = getattr(module, attr)
    ref = call()
    rows = []
    try:
        for plan in variants(base, width, max_rows):
            setattr(module, attr, lambda *a, plan=plan: plan)
            got = call()
            err = float((got - ref).abs().max() / ref.abs().max())
            if err > 2e-6:
                raise RuntimeError(f"plan {plan} changes the answer: {err}")
            rows.append(dict(rows=plan.rows, bk=plan.bk,
                             smem_bytes=plan.smem_bytes,
                             device_ms=device_ms(call),
                             is_plan=plan == base))
    finally:
        setattr(module, attr, original)
    rows.sort(key=lambda r: r["device_ms"])
    return {"plan": next(r for r in rows if r["is_plan"]), "best": rows[0],
            "all": rows}


def main(argv=None) -> dict:
    dev = require_cuda()
    rng = np.random.RandomState(0)
    results = {"device": torch.cuda.get_device_name(dev), "k2": {}, "k4": {}}
    for n, k in ((400, 20), (1000, 20), (1000, 64), (1000, 128), (4000, 64),
                 (4000, 128), (10000, 20), (10000, 128)):
        a = torch.as_tensor(rng.rand(n, n).astype(np.float32), device=dev)
        h = torch.as_tensor(rng.rand(n, k).astype(np.float32), device=dev)
        # W as nn.Linear hands it over: the transposed view of its weight
        w = torch.as_tensor(rng.randn(k, k).astype(np.float32), device=dev).t()
        b = torch.as_tensor(rng.randn(k).astype(np.float32), device=dev)
        res = sweep(lambda: fused_rhs.fused_rhs(a, h, w, b), fused_rhs,
                    "fused_rhs_plan", fused_rhs.fused_rhs_plan(n, k), k)
        results["k2"][f"{n}x{k}"] = res
        log(f"K2 {n}x{k}: plan {res['plan']} best {res['best']}")
        del a
    mat = sp.csr_matrix((rng.rand(2000, 2000) * (rng.rand(2000, 2000) < 0.05))
                        .astype(np.float32))
    op = from_scipy_bsr_graph(mat, device=dev)
    for d in (20, 128, 256, 512):
        x = torch.as_tensor(rng.rand(2000, d).astype(np.float32), device=dev)
        w = torch.as_tensor((rng.randn(d, d) / np.sqrt(d)).astype(np.float32),
                            device=dev).t()
        b = torch.as_tensor(0.1 * rng.randn(d).astype(np.float32), device=dev)
        base = bsr_spmm.bsr_fused_plan(op.fwd.n_row_blocks, op.fwd.block, d)
        res = sweep(lambda: bsr_spmm.bsr_fused_rhs(op.fwd, op.bwd, x, w, b),
                    bsr_spmm, "bsr_fused_plan", base, d, op.fwd.block)
        results["k4"][f"2000_d{d}"] = res
        log(f"K4 2000/5% d={d}: plan {res['plan']} best {res['best']}")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
