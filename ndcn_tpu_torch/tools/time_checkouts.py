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
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
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


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        print(json.dumps(_worker(argv[1])), flush=True)
        return []
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
            [sys.executable, os.path.abspath(__file__), "--worker",
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
