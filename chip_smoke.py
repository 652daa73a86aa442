#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``ndcn_tpu_torch``) once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line each:
  1. device: torch / CUDA versions, the card's name and power limit; TF32 off.
  2. build: the CUDA kernels from ``ndcn_tpu_torch/csrc`` with nvcc.
  3. K1 (CSR SpMV) against its plain PyTorch version: the 200k-node / ~2M-edge
     normalized Laplacian at d = 20 and d = 1, and a power-law graph with a
     hub row; max|Δ| / max|y| <= 1e-5; median CUDA-event times of both.
  4. K2 (fused relu((A·H)·W + b)) against its plain version at (400, 20) and
     (275, 13), rtol 1e-5 / atol 1e-5·max|y|, plus kernel-vs-plain times at
     larger (n, k) for the fused-vs-unfused crossover.
  5. serve the 400-node grid (dense, fused="auto") with the oracle fixture's
     weights: 3 requests, the first within 1e-4 rel-L1 of the oracle.
  6. serve the 200k-node COO graph: 3 requests, the first again on the CPU
     (plain versions), GPU and CPU answers within 1e-4 rel-L1.
  p. where one request's time goes, per serving setting: kernels against
     plain versions end to end, and a torch.profiler breakdown (traces to
     build/traces/).
Then the kernels' JSON record, and last the device JSON line. Launch counts
are zeroed just before phase 5 and read just after phase 6's GPU requests.

Exits non-zero, printing no result, when there is no CUDA device or the
package is missing; any failed check raises.
"""

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import torch


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def rel_l1(a, b) -> float:
    return float((a - b).abs().mean() / (b.abs().mean() + 1e-12))


def profile_request(server, x0, label: str, root: str) -> dict:
    """Where one request's time goes.

    First the end-to-end latency with the CUDA kernels against the same
    server with the kernels' plain versions patched in, alternating plain,
    kernel, kernel, plain. Then one request under torch.profiler: wall time,
    summed device-kernel time from the trace, their ratio (the device's busy
    share while profiled), and the kernels by device time; the trace goes to
    build/traces/."""
    from torch.profiler import ProfilerActivity, profile

    from ndcn_tpu_torch.graph import sparse
    from ndcn_tpu_torch.kernels import coo_spmv, fused_rhs
    from ndcn_tpu_torch.models import ndcn

    def timed():
        t0 = time.perf_counter()
        server(x0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def plain_k1(op, x):
        return coo_spmv.coo_spmv_plain(op.rows, op.cols, op.vals, x, op.n)

    timed()
    e2e = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "plain":
            sparse.coo_spmv, ndcn.fused_rhs = plain_k1, fused_rhs.fused_rhs_plain
        try:
            e2e[which].append(timed())
        finally:
            sparse.coo_spmv, ndcn.fused_rhs = (coo_spmv.coo_spmv,
                                               fused_rhs.fused_rhs)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = timed()
    out_dir = os.path.join(root, "build", "traces")
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, f"serve_{label}.trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    by_kernel, copies = {}, 0
    for e in events:
        if e.get("cat") == "kernel":
            name = e["name"][:60]
            ms, count = by_kernel.get(name, (0.0, 0))
            by_kernel[name] = (ms + e["dur"] / 1e3, count + 1)
        elif e.get("cat") == "gpu_memcpy":
            copies += 1
    rows = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    device_ms = sum(ms for ms, _ in by_kernel.values())
    return {"e2e_ms": e2e, "profiled_wall_ms": wall_ms,
            "device_kernel_ms": device_ms, "busy_share": device_ms / wall_ms,
            "kernel_launches": sum(c for _, c in by_kernel.values()),
            "memcpys": copies,
            "top": [dict(name=k, ms=ms, count=c) for k, (ms, c) in rows[:8]]}


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on a "
              "GPU", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import scipy.sparse as sp

    from ndcn_tpu_torch import kernels
    from ndcn_tpu_torch.convert import params_from_jax
    from ndcn_tpu_torch.graph.generators import (build_network,
                                                 build_sparse_graph)
    from ndcn_tpu_torch.graph.operators import (normalized_laplacian,
                                                normalized_laplacian_sparse)
    from ndcn_tpu_torch.graph.sparse import from_dense, from_scipy_coo
    from ndcn_tpu_torch.kernels import build, coo_spmv, fused_rhs
    from ndcn_tpu_torch.kernels.platform import device_report, pin_fp32
    from ndcn_tpu_torch.models import init_ndcn
    from ndcn_tpu_torch.serve import make_server
    from ndcn_tpu_torch.train.sampling import sample_times

    root = os.path.dirname(os.path.abspath(__file__))
    dev = torch.device("cuda", 0)

    def cuda_ms(fn, warmup: int = 3, iters: int = 25) -> float:
        """Median CUDA-event time of one call, after warm-up."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def serve_all(server, requests, what):
        """Answer each request, timing it to the end of its device work;
        returns the per-request records and the first answer."""
        answers, first = [], None
        for x0 in requests:
            t0 = time.perf_counter()
            out, ok = server(x0)
            torch.cuda.synchronize()
            lat = time.perf_counter() - t0
            st = server.last_stats
            check(ok and bool(torch.isfinite(out).all()),
                  f"{what} request failed: {st}")
            first = out if first is None else first
            answers.append(dict(latency_ms=lat * 1e3, nfe=st.nfe,
                                accepted=st.n_accepted,
                                rejected=st.n_rejected,
                                host_syncs=st.host_syncs))
        return answers, first

    # ---- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    pin_fp32()
    report = device_report()
    check(report["sm90"], f"the kernels need compute capability 9.0: {report}")
    print(f"[1] device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{report['name']} sm_{report['capability'][0]}"
          f"{report['capability'][1]}, TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}")
    print(smi)

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    build_s = time.perf_counter() - t0
    log = lib_path.with_name(lib_path.name + ".log").read_text()
    regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
            if "Used" in line and "registers" in line]
    print(f"[2] build: {build_s:.3f} s for {[p.name for p in build.sources()]}"
          f" -> {lib_path.relative_to(root)}; ptxas: {regs}")

    # ---- 3. K1 against its plain version
    t0 = time.perf_counter()
    adj = build_sparse_graph(200_000, 10, seed=0)
    lap = normalized_laplacian_sparse(adj)
    op_big = from_scipy_coo(lap, device=dev)
    host_build_s = time.perf_counter() - t0

    def k1_case(op, d, seed):
        x = torch.as_tensor(np.random.RandomState(seed).randn(op.n, d)
                            .astype(np.float32), device=dev)
        y = coo_spmv.coo_spmv(op, x)
        ref = coo_spmv.coo_spmv_plain(op.rows, op.cols, op.vals, x, op.n)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        rel = err / float(ref.abs().max())
        check(rel <= 1e-5, f"K1 disagrees at n={op.n}, d={d}: {rel}")
        ms = cuda_ms(lambda: coo_spmv.coo_spmv(op, x))
        plain_ms = cuda_ms(lambda: coo_spmv.coo_spmv_plain(
            op.rows, op.cols, op.vals, x, op.n))
        return dict(n=op.n, nnz=int(op.cols.shape[0]), d=d, max_abs_err=err,
                    rel_err=rel, ms=ms, plain_ms=plain_ms)

    k1_main = k1_case(op_big, 20, 1)
    k1_d1 = k1_case(op_big, 1, 2)
    rng = np.random.RandomState(3)
    n_hub, m = 20_000, 200_000
    rows = np.concatenate([rng.zipf(1.5, m) % n_hub,
                           np.full(5_000, 7)])       # row 7: a 5k-edge hub
    cols = np.concatenate([rng.randint(0, n_hub, m),
                           rng.choice(n_hub, 5_000, replace=False)])
    hub = sp.coo_matrix((rng.randn(rows.size).astype(np.float32),
                         (rows, cols)), shape=(n_hub, n_hub)).tocsr()
    hub.sum_duplicates()
    op_hub = from_scipy_coo(hub, device=dev)
    k1_hub = k1_case(op_hub, 20, 4)
    k1_hub["max_row_degree"] = int(np.diff(hub.indptr).max())
    check(k1_hub["max_row_degree"] >= 4_000, "hub graph has no hub row")
    print(f"[3] K1 coo_spmv vs plain (host graph build {host_build_s:.3f} s): "
          + json.dumps({"200k_d20": k1_main, "200k_d1": k1_d1,
                        "hub_d20": k1_hub}))

    # ---- 4. K2 against its plain version, and the crossover sweep
    def k2_case(n, k, seed, compare=True):
        r = np.random.RandomState(seed)
        a = torch.as_tensor(r.rand(n, n).astype(np.float32), device=dev)
        h = torch.as_tensor(r.rand(n, k).astype(np.float32), device=dev)
        w = torch.as_tensor(r.randn(k, k).astype(np.float32), device=dev)
        b = torch.as_tensor(r.randn(k).astype(np.float32), device=dev)
        out = dict(n=n, k=k)
        if compare:
            y = fused_rhs.fused_rhs(a, h, w, b)
            ref = fused_rhs.fused_rhs_plain(a, h, w, b)
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            check(torch.allclose(y, ref, rtol=1e-5, atol=1e-5 * scale),
                  f"K2 disagrees at ({n}, {k})")
            out["max_abs_err"] = float((y - ref).abs().max())
        out["ms"] = cuda_ms(lambda: fused_rhs.fused_rhs(a, h, w, b))
        out["plain_ms"] = cuda_ms(lambda: fused_rhs.fused_rhs_plain(a, h, w, b))
        return out

    k2_main = k2_case(400, 20, 5)
    k2_ragged = k2_case(275, 13, 6)
    sweep = [k2_case(n, k, 7, compare=False)
             for n, k in ((1000, 20), (4000, 20), (4000, 64), (10000, 20),
                          (10000, 128))]
    print("[4] K2 fused_rhs vs plain: "
          + json.dumps({"400x20": k2_main, "275x13": k2_ragged,
                        "crossover": sweep}))

    # ---- 5. serve the 400-node grid, dense operator, fused="auto"
    kernels.reset_launch_counts()
    fx = dict(np.load(os.path.join(root, "tests", "fixtures",
                                   "ndcn_forward_grid400.npz")))
    tree = {name: {"w": fx[f"{name}_w"].T, "b": fx[f"{name}_b"]}
            for name in ("enc1", "enc2", "wt", "dec")}
    model = params_from_jax(tree, device=dev)
    op_grid = from_dense(normalized_laplacian(build_network("grid", 400)),
                         device=dev)
    serve_kw = dict(rtol=0.01, atol=0.001, method="dopri5", fused="auto")
    server = make_server(model, op_grid, fx["t"], **serve_kw)
    rs = np.random.RandomState(11)
    requests = [fx["x0"]] + [rs.uniform(0.0, 25.0, (400, 1)).astype(np.float32)
                             for _ in range(2)]
    answers, first = serve_all(server, requests, "grid400")
    grid_err = rel_l1(first.cpu(), torch.as_tensor(fx["out"]))
    check(grid_err <= 1e-4, f"grid400 answer off the oracle: {grid_err}")
    check(fused_rhs.LAUNCHES > 0, "grid400 serving never launched K2")
    print("[5] serve grid400 dense fused=auto: "
          + json.dumps({"rel_l1_vs_oracle": grid_err,
                        "k2_launches": fused_rhs.LAUNCHES,
                        "requests": answers}))

    # ---- 6. serve the 200k-node COO graph
    splits = sample_times(5.0, 40, "irregular", seed=0)
    gen = torch.Generator().manual_seed(0)
    model_big = init_ndcn(gen, 1, 20, 1, device=dev)
    server_big = make_server(model_big, op_big, splits.t, **serve_kw)
    requests = [np.random.RandomState(s).uniform(0.0, 25.0, (op_big.n, 1))
                .astype(np.float32) for s in (0, 1, 2)]
    torch.cuda.reset_peak_memory_stats(dev)
    answers, first = serve_all(server_big, requests, "200k")
    check(first.shape == (len(splits.t), op_big.n, 1),
          f"200k answer has shape {tuple(first.shape)}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = kernels.launch_counts()
    check(coo_spmv.LAUNCHES > 0, "200k serving never launched K1")

    t0 = time.perf_counter()
    server_cpu = make_server(copy.deepcopy(model_big).cpu(),
                             from_scipy_coo(lap), splits.t, **serve_kw)
    out_cpu, ok_cpu = server_cpu(requests[0])
    cpu_s = time.perf_counter() - t0
    gpu_cpu = rel_l1(first.cpu(), out_cpu)
    check(ok_cpu and gpu_cpu <= 1e-4, f"200k GPU vs CPU: {gpu_cpu}")
    print("[6] serve 200k COO: " + json.dumps(
        {"nodes": op_big.n, "edges": k1_main["nnz"], "T": len(splits.t),
         "k1_launches": coo_spmv.LAUNCHES, "peak_allocated_gb": peak_gb,
         "requests": answers, "rel_l1_gpu_vs_cpu": gpu_cpu,
         "cpu_nfe": server_cpu.last_stats.nfe, "cpu_seconds": cpu_s}))

    for label, srv, x0 in (("grid400", server, fx["x0"]),
                           ("200k", server_big, requests[0])):
        print(f"[p] {label}: " + json.dumps(
            profile_request(srv, x0, label, root)))

    # ---- records
    print(json.dumps({"kernels": [
        {"name": "coo_spmv", "route": "cuda",
         "source": "ndcn_tpu_torch/csrc/coo_spmv.cu",
         "replaces": "ndcn_tpu/kernels/coo_spmv.py:159",
         "launches": launches["coo_spmv"],
         "max_abs_err": k1_main["max_abs_err"], "ms": k1_main["ms"],
         "plain_ms": k1_main["plain_ms"]},
        {"name": "fused_rhs", "route": "cuda",
         "source": "ndcn_tpu_torch/csrc/fused_rhs.cu",
         "replaces": "ndcn_tpu/kernels/fused_rhs.py:30",
         "launches": launches["fused_rhs"],
         "max_abs_err": k2_main["max_abs_err"], "ms": k2_main["ms"],
         "plain_ms": k2_main["plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
