"""K1-w, K5 and the 1M train step timed in several checkouts of the
repository, one process each, in the order given:

    python -m ndcn_tpu_torch.tools.time_checkouts build/parent . . build/parent

Each process puts its checkout first on ``sys.path``, so it builds (into the
checkout's own ``build/kernels/``) and runs that checkout's package through
the public functions every version of the port has:
- K1-w (``coo_mutual.mutual_forward`` / ``mutual_backward``) on the
  adjacencies of ``chip_smoke.py`` [14]: 50k and 200k at d = 1, 200k at
  d = 2 and 8, 1M at d = 1, the hub graph at d = 20;
- ``spmv_T`` under ``GATHER_WIDE`` (K5), fp32 and bf16, on the 200k and 1M
  normalized Laplacians (d = 20, d_sub = 24), and fp32 on the hub graph,
  forward and over its transpose; K1-fm at 1M fp32 beside them, unchanged;
- the scale driver at 1M for 10 iterations in [12]'s three solves:
  feature-major (K1-fm), feature-major under ``GATHER_WIDE`` (K5), the
  (n, d) layout (K1); ``train_steps_per_sec`` of each.
Kernel times are ms per call of ten calls queued behind a spin kernel (the
card's part), the median of five runs; every kernel result is first held
within 1e-5 · max|y| of its plain version. One JSON line per checkout on
stdout, with the card's name and power limit.

With ``--adams`` first, each checkout times instead the paths of the masked
VCABM machine that ``chip_smoke.py`` [20] / [21] run, through functions
every version of the port since its Adams replicas has:

    python -m ndcn_tpu_torch.tools.time_checkouts --adams build/parent . . build/parent

- [21] a's adams replica train step (``parallel.sweep``, R = 4, the heat
  driver's grid400 data, dense ``fused="auto"``: K2's batched form,
  ``max_steps`` 256, a backward recorded): ms per step (wall, the median
  of 7 after a warm one), and the device kernels and host reads of one
  step;
- the grid400 dense adams artifact (``serve.export_ndcn`` at the serving
  fixture's weights, rtol 0.01, atol 0.001, no backward): ms per request
  (the median of 20), its device kernels and host reads.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ITERS_1M = "10"


def _worker(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import scipy.sparse as sp
    import torch

    from ndcn_tpu_torch.experiments import large_graph
    from ndcn_tpu_torch.graph.generators import build_sparse_graph
    from ndcn_tpu_torch.graph.operators import normalized_laplacian_sparse
    from ndcn_tpu_torch.graph.sparse import from_scipy_coo
    from ndcn_tpu_torch.kernels import coo_mutual, coo_spmv
    from ndcn_tpu_torch.kernels.platform import pin_fp32

    import ndcn_tpu_torch
    assert Path(ndcn_tpu_torch.__file__).resolve().is_relative_to(
        Path(root).resolve()), ndcn_tpu_torch.__file__
    pin_fp32()
    dev = torch.device("cuda", 0)

    def device_ms(fn, batch=10, runs=5):
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

    def held(y, ref, what):
        rel = float((y - ref).abs().max() / ref.abs().max())
        if not rel <= 1e-5:
            raise RuntimeError(f"{root}: {what} off its plain version: {rel}")
        return rel

    out = {"root": root}
    coef = (5.0, 0.1, 0.9)

    def k1w(label, a, d, seed):
        op = from_scipy_coo(a, device=dev)
        rs = np.random.RandomState(seed)
        x = torch.as_tensor((rs.rand(op.n, d) * 3 + 0.2).astype(np.float32),
                            device=dev)
        g = torch.as_tensor(rs.randn(op.n, d).astype(np.float32), device=dev)
        fwd = lambda: coo_mutual.mutual_forward(op, x, *coef)  # noqa: E731
        bwd = lambda: coo_mutual.mutual_backward(op, x, g, *coef)  # noqa: E731
        held(fwd(), coo_mutual.mutual_forward_plain(op, x, *coef), label)
        held(bwd(), coo_mutual.mutual_backward_plain(op, x, g, *coef), label)
        out[f"k1w_{label}"] = dict(fwd_ms=device_ms(fwd),
                                   bwd_ms=device_ms(bwd))

    def spmv_t(label, op, wide, bf16, d=20):
        d_sub = coo_spmv.sublane_pad(d)
        xT = torch.zeros((d_sub, op.n), device=dev)
        xT[:d] = torch.as_tensor(np.random.RandomState(21).randn(d, op.n)
                                 .astype(np.float32), device=dev)
        plain = (coo_spmv.coo_spmv_T_wide_plain if wide
                 else coo_spmv.coo_spmv_T_plain)
        saved = coo_spmv.GATHER_WIDE, coo_spmv.GATHER_BF16
        coo_spmv.GATHER_WIDE, coo_spmv.GATHER_BF16 = wide, bf16
        try:
            with torch.no_grad():
                held(coo_spmv.spmv_T(op, xT),
                     plain(op.rows, op.cols, op.vals, xT, op.n, bf16), label)
                out[label] = device_ms(lambda: coo_spmv.spmv_T(op, xT))
        finally:
            coo_spmv.GATHER_WIDE, coo_spmv.GATHER_BF16 = saved

    rng = np.random.RandomState(3)
    n_hub, m = 20_000, 200_000
    rows = np.concatenate([rng.zipf(1.5, m) % n_hub, np.full(5_000, 7)])
    cols = np.concatenate([rng.randint(0, n_hub, m),
                           rng.choice(n_hub, 5_000, replace=False)])
    hub = sp.coo_matrix((rng.randn(rows.size).astype(np.float32),
                         (rows, cols)), shape=(n_hub, n_hub)).tocsr()
    hub.sum_duplicates()
    adj_200k = build_sparse_graph(200_000, 10, seed=0)
    k1w("50k_d1", build_sparse_graph(50_000, 10, seed=0), 1, 31)
    k1w("200k_d1", adj_200k, 1, 32)
    k1w("200k_d2", adj_200k, 2, 35)
    k1w("200k_d8", adj_200k, 8, 37)
    k1w("hub_d20", abs(hub), 20, 33)
    op_hub = from_scipy_coo(hub, device=dev)
    spmv_t("k5_f32_hub", op_hub, True, False)
    spmv_t("k5_f32_hub_transposed", op_hub.transpose(), True, False)
    op_200k = from_scipy_coo(normalized_laplacian_sparse(adj_200k),
                             device=dev)
    spmv_t("k5_f32_200k", op_200k, True, False)
    del op_200k, op_hub
    adj_1m = build_sparse_graph(1_000_000, 10, seed=0)
    k1w("1m_d1", adj_1m, 1, 36)
    op_1m = from_scipy_coo(normalized_laplacian_sparse(adj_1m), device=dev)
    del adj_1m
    spmv_t("k5_f32_1m", op_1m, True, False)
    spmv_t("k5_bf16_1m", op_1m, True, True)
    spmv_t("k1fm_f32_1m", op_1m, False, False)
    del op_1m
    torch.cuda.empty_cache()

    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    gt = os.path.join(root, "build", "gt_1m_heat.npz")
    for label, wide, layout in (("fm", False, "auto"), ("fm_wide", True,
                                                         "auto"),
                                ("nd", False, "nd")):
        coo_spmv.GATHER_WIDE = wide
        rec = large_graph.run(large_graph.build_parser().parse_args(
            ["--n", "1000000", "--iters", ITERS_1M, "--layout", layout,
             "--gt_cache", gt]))
        coo_spmv.GATHER_WIDE = False
        out[f"1m_{label}"] = dict(
            train_steps_per_sec=rec["train_steps_per_sec"],
            solve_layout=rec["solve_layout"],
            rel_loss_final=rec["rel_loss_final"])
        torch.cuda.empty_cache()
    return out


def _adams_worker(root: str) -> dict:
    """``--adams``: the masked VCABM machine's replica step and artifact
    request in the checkout at ``root`` (see the module docstring)."""
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ndcn_tpu_torch.graph.sparse import as_operator, from_dense
    from ndcn_tpu_torch.kernels.platform import pin_fp32
    from ndcn_tpu_torch.parallel.sweep import (make_ndcn_replica_train_step,
                                               replica_generators)
    from ndcn_tpu_torch.serve import export_ndcn, load_ndcn
    from ndcn_tpu_torch.tools import smoke_references as sr
    from ndcn_tpu_torch.tools.serve_artifact import host_reads

    import ndcn_tpu_torch
    assert Path(ndcn_tpu_torch.__file__).resolve().is_relative_to(
        Path(root).resolve()), ndcn_tpu_torch.__file__
    pin_fp32()
    dev = torch.device("cuda", 0)

    def wall_ms(fn, runs):
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def launches(fn):
        """The device kernels and host reads of one call."""
        with host_reads() as reads, profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        trace = os.path.join(root, "build", "time_checkouts_trace.json")
        os.makedirs(os.path.dirname(trace), exist_ok=True)
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
        os.remove(trace)
        return dict(
            device_kernels=sum(1 for e in events if e.get("cat") == "kernel"),
            host_reads=reads[0])

    lap, t_h, x0_h, target_h = sr.heat_replica_problem()
    op = as_operator(lap, sparse=False, format="dense", device=dev)
    init_fn, step_fn = make_ndcn_replica_train_step(
        op, t_h, x0_h.to(dev), target_h.to(dev), method="adams",
        fused="auto", max_steps=256)
    model, opt = init_fn(replica_generators(0, 4))
    step = lambda: step_fn(model, opt)   # noqa: E731
    step()
    out = {"root": root, "replica_step": dict(
        launches(step), ms=wall_ms(step, 7))}
    del model, opt, init_fn, step_fn

    mdl, op_s, vt, x0 = sr.serving_problem()
    op_s = from_dense(op_s.mat.numpy(), device=dev)
    serve = load_ndcn(export_ndcn(mdl.to(dev), op_s, vt, x0.shape,
                                  rtol=0.01, atol=0.001, method="adams",
                                  fused="auto"))
    request = lambda: serve(x0)   # noqa: E731
    request()
    out["artifact_request"] = dict(launches(request),
                                   ms=wall_ms(request, 20))
    return out


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        print(json.dumps(_worker(argv[1])), flush=True)
        return []
    if argv[:1] == ["--worker-adams"]:
        print(json.dumps(_adams_worker(argv[1])), flush=True)
        return []
    worker = "--worker"
    if argv[:1] == ["--adams"]:
        worker, argv = "--worker-adams", argv[1:]
    if not argv:
        raise SystemExit(__doc__)
    from ndcn_tpu_torch.tools import require_cuda

    require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rows = []
    for root in argv:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), worker,
             os.path.abspath(root)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{root} failed:\n{proc.stderr[-4000:]}")
        row = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                   card=smi)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
