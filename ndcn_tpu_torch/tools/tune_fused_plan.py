"""How the tensor-core kernels' time depends on the host's plan.

K2 (``fused_rhs``) and K4 (``bsr_fused_rhs``) take their panel height and
chunk depth from ``kernels.fused_rhs.panel_plan``; K3 (``bsr_spmm``) takes
its column slabs and each slab's panel from ``kernels.bsr_spmm.
bsr_spmm_plan``. This tool times each kernel under the plan's own choice and
under every other choice the kernels are built for, at the shapes the records
quote, so that the plans' rules rest on the card's numbers:

    python -m ndcn_tpu_torch.tools.tune_fused_plan        # K2 and K4
    python -m ndcn_tpu_torch.tools.tune_fused_plan k3     # K3

Times are ms per call of ten calls queued behind a spin kernel (the card's
part, without the wrapper's host work), the median of five runs. One JSON line
on stdout; one line per shape on stderr. Every variant's result is held
bit-equal or within 2e-6·max|y| of the plan's own (another panel height or
slab is the same sum; another chunk depth or depth split folds it in other
places).
"""

from __future__ import annotations

import json
import statistics
import sys

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


def k3_variants(n_row_blocks: int, block: int, d: int):
    """K3's plans for this shape: every slab width of whole n8 tiles the
    kernel takes (d itself, and 32 to 256, 8 warps of 4 n8 tiles, where
    narrower than d), each with ``panel_plan``'s warp layout at every panel
    height and chunk depth."""
    for slab in sorted({min(d, w) for w in (d, 32, 64, 128, 256)
                        if w <= 256}):
        base = bsr_spmm.spmm_plan_for(n_row_blocks, block, d, slab)
        for panel in variants(base.panel, slab, block):
            yield base._replace(panel=panel)


def describe(plan) -> dict:
    if isinstance(plan, bsr_spmm.SpmmPlan):
        return dict(slab=plan.slab, slabs=plan.slabs, wn=plan.panel.wn,
                    **describe(plan.panel))
    return dict(rows=plan.rows, bk=plan.bk, smem_bytes=plan.smem_bytes)


def sweep(call, module, attr, base, plans) -> dict:
    """Time ``call`` with ``module.attr`` returning each of ``plans``."""
    original = getattr(module, attr)
    ref = call()
    rows = []
    try:
        for plan in plans:
            setattr(module, attr, lambda *a, plan=plan: plan)
            got = call()
            err = float((got - ref).abs().max() / ref.abs().max())
            if err > 2e-6:
                raise RuntimeError(f"plan {plan} changes the answer: {err}")
            rows.append(dict(describe(plan), device_ms=device_ms(call),
                             is_plan=plan == base))
    finally:
        setattr(module, attr, original)
    rows.sort(key=lambda r: r["device_ms"])
    return {"plan": next(r for r in rows if r["is_plan"]), "best": rows[0],
            "all": rows}


def tune_k3(dev, rng) -> dict:
    """K3 on the 400-node grid's Laplacian (4 row blocks) and a 2000-node
    5 % matrix (16), at the widths of [7] and [7b] and one beyond K_MAX."""
    from ndcn_tpu_torch.graph import generators, operators

    mats = {"grid400": sp.csr_matrix(operators.normalized_laplacian(
        generators.build_network("grid", 400)).astype(np.float32)),
        "2000": sp.csr_matrix((rng.rand(2000, 2000)
                               * (rng.rand(2000, 2000) < 0.05))
                              .astype(np.float32))}
    out = {}
    for label, mat in mats.items():
        op = from_scipy_bsr_graph(mat, device=dev)
        for d in (20, 128, 256, 512, 1100):
            x = torch.as_tensor(rng.randn(mat.shape[1], d).astype(np.float32),
                                device=dev)
            m = op.fwd
            base = bsr_spmm.bsr_spmm_plan(m.n_row_blocks, m.block, d)
            plans = list(k3_variants(m.n_row_blocks, m.block, d))
            res = sweep(lambda: bsr_spmm.bsr_spmm(m, op.bwd, x), bsr_spmm,
                        "bsr_spmm_plan", base,
                        plans + [base] * (base not in plans))
            out[f"{label}_d{d}"] = res
            log(f"K3 {label} d={d}: plan {res['plan']} best {res['best']}")
    return out


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    dev = require_cuda()
    rng = np.random.RandomState(0)
    if argv[:1] == ["k3"]:
        results = {"device": torch.cuda.get_device_name(dev),
                   "k3": tune_k3(dev, rng)}
        print(json.dumps(results))
        return results
    results = {"device": torch.cuda.get_device_name(dev), "k2": {}, "k4": {}}
    for n, k in ((400, 20), (1000, 20), (1000, 64), (1000, 128), (4000, 64),
                 (4000, 128), (10000, 20), (10000, 128)):
        a = torch.as_tensor(rng.rand(n, n).astype(np.float32), device=dev)
        h = torch.as_tensor(rng.rand(n, k).astype(np.float32), device=dev)
        # W as nn.Linear hands it over: the transposed view of its weight
        w = torch.as_tensor(rng.randn(k, k).astype(np.float32), device=dev).t()
        b = torch.as_tensor(rng.randn(k).astype(np.float32), device=dev)
        base = fused_rhs.fused_rhs_plan(n, k)
        res = sweep(lambda: fused_rhs.fused_rhs(a, h, w, b), fused_rhs,
                    "fused_rhs_plan", base, list(variants(base, k)))
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
                    bsr_spmm, "bsr_fused_plan", base,
                    list(variants(base, d, op.fwd.block)))
        results["k4"][f"2000_d{d}"] = res
        log(f"K4 2000/5% d={d}: plan {res['plan']} best {res['best']}")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
