#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``ndcn_tpu_torch``) once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line each:
  1. device: torch / CUDA versions, the card's name and power limit; TF32 off.
  2. build: the CUDA kernels from ``ndcn_tpu_torch/csrc`` with nvcc.
  3. K1 (CSR SpMV) against its plain PyTorch version: the 200k-node / ~2M-edge
     normalized Laplacian at d = 20 and d = 1, and a power-law graph with
     hub rows (the chunk kernels); max|Δ| / max|y| <= 1e-5; two calls
     bit-equal; median CUDA-event times of both, the bound, and the library
     call (``torch.sparse.mm`` over a CSR tensor).
  4. K2 (fused relu((A·H)·W + b), split TF32 on the tensor cores) against
     its plain version at (400, 20), (275, 13) and at every size of the
     sweep n in {400, 1000, 4000, 10000} x k in {20, 64, 128}: rtol 1e-5 /
     atol 1e-5·max|y| (the inputs are uniform on (0, 1), so a sum of n
     positive terms has no cancellation and every output is of the scale's
     order: the bar is in effect the port's max|Δ| <= 1e-5·max|y|, which two
     fp32 sums of 10,000 terms in different orders keep by a factor of ten);
     two calls bit-equal; within 2e-6 of the PyTorch emulation of the split
     product; times of the kernel, its plain version, the library call and
     the unfused route of ``ode_func`` (``fused=False``), and whether
     ``fused_profitable`` picks the route that was no slower on the card
     (ten calls behind a spin kernel; within 1.10x the routes are a tie).
  5. serve the 400-node grid (dense, fused="auto") with the oracle fixture's
     weights: 3 requests, the first within 1e-4 rel-L1 of the oracle.
  6. serve the 200k-node COO graph: 3 requests, the first again on the CPU
     (plain versions), GPU and CPU answers within 1e-4 rel-L1.
  7. the backward kernels and the BSR kernels against their plain versions,
     max|Δ| / max|y| <= 1e-5, with the median CUDA-event times of both: K1ᵀ
     (K1 over the transpose CSR) on the non-symmetric hub graph at d = 20;
     K2's backward (dh, dw, db) at 400 × 20 against autograd of the plain
     version; K3 and K3ᵀ (split TF32 on the tensor cores, as K4) on the
     grid400 Laplacian (d = 20) and on a 2000-node 5 % matrix (d = 20,
     256), bit-equal on a repeat and within 2e-6 of the emulation of its
     split product; K4 forward and backward on grid400 (d = 20)
     and on the 2000-node matrix (d = 256, 512), bit-equal on a repeat and
     within 2e-6 of the emulation of its split product (the backward's
     cotangent is zero within 1e-5·max|z| of relu's kink, the forward's
     own bound, where its last bits decide the mask: at most one element
     in 10,000, which the phase checks); and the BSR half of
     the ``fused_profitable`` sweep (both matrices, d in {20, 64, 128, 256,
     512}: K4 against K3 + linear + relu).
  8. train grid400, dense, fused="auto" (K2 forward and backward): the first
     step from the ``ndcn_grads_grid400`` weights within 1e-4 of the
     fixture's loss and 1e-3 rel-L1 of its gradients; steady per-step ms and
     NFE; then the heat experiment (``--fused_kernel``, 20 iterations), whose
     train loss must fall.
  9. train grid400, BSR, fused=False (K3) and fused=True (K4): the same
     fixture check, per-step ms, and the heat experiment with ``--sparse
     --sparse_format bsr`` for a few iterations.
 10. train the 200k-node COO graph (K1 and K1ᵀ): target from the port's heat
     ground truth at rtol 1e-6 / atol 1e-8, 5 steps, the first step's
     gradients within 1e-3 rel-L1 of the same step with the plain versions
     patched in; per-step ms and peak allocated memory.
 11. the scale path's SpMV kernels against their plain versions: K1's bf16
     instance, K1-fm and K5 (fp32 and bf16), forward and over the transpose,
     on the 200k / 2.2M and 1M / 11M normalized Laplacians at d = 20, K1
     fp32 at 1M, K1-fm and K5 on the hub graph, and K1-fm's pack kernel;
     max|Δ| / max|y| <= 1e-5 against the plain version of the same
     rounding; two calls bit-equal; median CUDA-event times of both, the
     bound and the library call.
 12. the scale experiment (``experiments.large_graph``) in process at 1M nodes,
     ``--iters 60 --roofline --hbm_probe`` (the iterations of the JAX
     record ``results/scale_1m_heat.json``, whose final rel-L1 its
     ``rel_loss_final`` is printed beside): 'auto' resolves to the
     feature-major solve, the train loss falls, K1-fm launches; its
     ``--estimate`` (with the attempts it assumed) beside the measured peak
     (with the attempts a step took); the first train step's
     gradients within 1e-3 rel-L1 of the same step with the plain versions;
     the run again with ``--emission_precision bf16 --residual_precision
     bf16``; then at 200k with ``--kernel_precision bf16`` (the (n, d)
     layout, K1's bf16 instance) and with ``--layout feature_major`` under
     ``GATHER_WIDE`` (K5), 3 iterations each; and the three solves of the
     1M step side by side (feature-major, feature-major under
     ``GATHER_WIDE``, the (n, d) layout), 10 iterations each.
 13. the three microbenchmarks at their defaults (``ndcn_tpu_torch.tools``):
     P1a (the sliced-tile reduce) and P1b / P2 (the row gather) against
     their plain versions and the oracle, and the narrow / wide table; P1a
     once more at the tool's size, bit-equal on a repeat; P1b's device time
     beside that of an empty launch (``torch.cuda._sleep(0)``, queued
     alike).
 14. K1-w (the mutualistic interaction, ``kernels.coo_mutual``) forward
     and backward against its plain version (gather, weight,
     ``index_add_``; no single PyTorch call computes the pair term, so the
     plain version is also the library yardstick) on the 50k, 200k and 1M
     adjacencies at d = 1, 200k at d = 2 and at the edge form's widest
     width, the hub graph at d = 1 (the edge form with carries) and 20, and
     its transpose at d = 20, each with the form that ran, read from the
     edge form's own launch count (it must be the edge form up to the
     crossover width, the warp form above): max|Δ| / max|y| <= 1e-5, two
     calls bit-equal, times and the bytes' bound; the mutualistic ground
     truth of a 5,000-node graph on the card within 1e-4 rel-L1 of the
     CPU's, its NFE within 2 %; then the scale
     experiment at 50k nodes with ``--dynamics mutualistic --iters 60``
     (the ground truth on the card through K1-w, training through K1) and
     ``--dynamics gene --iters 10``, and the mutualistic experiment on its
     defaults (euler, grid 400, dense), the gene experiment with ``--method
     dopri5 --sparse`` (ELL) and the mutualistic one with ``--method dopri5
     --sparse --sparse_format coo``, 20 iterations each: every train loss
     falls.
  15. the continuous adjoint, the other solvers and checkpoint / resume
     (input 1, hidden 20, output 1; rtol 0.01, atol 0.001): (a) a grid400
     adjoint train step at the ``ndcn_grads_grid400`` weights on three
     routes, dense ``fused="auto"`` (K2 forward, K2's backward products in
     the VJPs), COO (K1, K1 over the transpose CSR) and BSR ``fused=True``
     (K4, K3 over Aᵀ): loss within 1e-4 and gradients within 1e-3 rel-L1
     of the fixture's adjoint half, every gradient finite; forward and
     backward NFE, step ms and peak memory beside the backprop step's;
     (b) serving grid400 dense with tsit5, adams, fixed_adams and
     explicit_adams: the card's answer within 1e-4 rel-L1 of the CPU's,
     or within twice the CPU's own float32-vs-float64 distance where that
     is larger (explicit_adams, order 11 near its stability limit), NFE
     within 2 %; (c) the heat driver for 20 iterations with
     ``--adjoint`` and with ``--method adams`` (the train loss falls), and
     20 iterations against 10 checkpointed (``--ckpt_dir`` under build/,
     ``--ckpt_freq 10``) and a resumed 10: the losses bit-equal.
  16. the classification tasks on cora and citeseer (``data/``): (a) K1 and
     K1ᵀ on both operators at d = 7 / 6 (the classes), 16 (the hidden
     width) and 1433 / 3703 (the raw features), and K3 and K3ᵀ on cora's
     BSR operator at d = 7, 16, 1433, against their plain versions with
     [3] / [7]'s bars, bit-equal repeats, times, bounds and library calls;
     (b) one cora differential_gcn train step (weights from CPU generator
     seed 0, dropout 0, rtol = atol = 0.1) on dense, COO and BSR, on the
     card against the CPU: loss within 1e-4, gradients within 1e-3
     rel-L1, NFE equal, K1 / K3 launched; (c) the driver on its defaults
     (seed 0; its accuracy is printed, with no bar: the showcase is
     another recipe), then the recipe of
     ``results/showcase_cora_100.json`` (README.md:64: hidden 256, dropout
     0, T 1.2, tick 16, 100 epochs, weight decay 0.024, no control, alpha
     0) through ``experiments.dgnn`` in process at seeds 0-2, dense: the
     mean test accuracy within that record's 0.8317 ± 3 · 0.0098 / √3;
     seed 0 with ``--sparse`` (K1) and ``--sparse --sparse_format bsr``
     (K3), whose train loss must fall; citeseer seed 0 within 0.7065 ± 3 ·
     0.0061 (``results/showcase_citeseer_12.json``); (d) every zoo model
     through the driver on cora with ``--sparse`` for 200 epochs
     (DeepGCN3 dense, 50), the train loss falling, GCN's test accuracy
     within 2 points of the same run with ``--platform cpu`` (the same
     dropout masks); (e) the phase's own wall time.
  p. where the time goes: one request per serving setting and one train step
     per training setting (the 1M feature-major step included), one cora
     differential_gcn epoch (the driver's defaults, train and eval) on
     dense, COO and BSR, kernels against plain versions end to end (plain,
     kernel, kernel, plain), a torch.profiler breakdown (traces to
     build/traces/), and each kernel's launches in that one steady step or
     epoch.
Then the kernels' JSON record, and last the device JSON line. Launch counts
are zeroed just before each main-path phase (5-6, 8, 9, 10, each run of 12,
13, 14, each part of 15 and each run of 16) and read just after its GPU
work; the record's launches are their sums.

``ms`` is the median CUDA-event time of one call on an idle card, as in
every earlier record; every kernel also gives ``device_ms``, the time per
call of ten calls queued behind a spin kernel, which leaves the host's part
out. Every timed kernel also gets ``bound_ms``, the least time the card could
take: the larger of the bytes the function must move (each input read once,
each output written once) over 3.35 TB/s and its operations over the peak
for their type, computed from this run's shapes: 67 TFLOP/s for fp32 outside
the tensor cores, and for the split-TF32 products of K2, K3 and K4 three
times the operations over the tensor cores' 495 TFLOP/s; and
``library_ms``, the time of one PyTorch call that computes the same function
on the same inputs, where there is one. The port calls none of those library
functions.

Exits non-zero, printing no result, when there is no CUDA device or the
package is missing; any failed check raises.
"""

import contextlib
import copy
import json
import os
import shutil
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


# the card's published peaks: HBM bytes/s, fp32 FLOP/s outside the tensor
# cores, and dense TF32 FLOP/s on them. A split-TF32 product (K2-K4) runs
# three tensor-core passes for every fp32 product it stands for.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "split_tf32": 495e12 / 3}

# 'auto' must pick the route whose time on the card is no more than this
# factor over the other's; shapes inside the factor are printed as ties
ROUTE_TIE = 1.10


def bound(n_bytes: float, flops: float, kind: str = "fp32") -> dict:
    """The least time the card could take for ``n_bytes`` moved and ``flops``
    operations of arithmetic ``kind``, and which of the two sets it."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[kind] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": int(n_bytes), "flops": int(flops), "arithmetic": kind}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def profile_call(fn, label: str, root: str) -> dict:
    """Where one call of ``fn`` (a served request or a train step) spends its
    time.

    First the end-to-end time with the CUDA kernels against the same call
    with the kernels' plain versions patched in, alternating plain, kernel,
    kernel, plain. Then one call under torch.profiler: wall time, summed
    device-kernel time from the trace, their ratio (the device's busy share
    while profiled), and the kernels by device time; the trace goes to
    build/traces/."""
    from torch.profiler import ProfilerActivity, profile

    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    timed()
    e2e = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        with plain_versions(which == "plain"):
            e2e[which].append(timed())

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = timed()
    out_dir = os.path.join(root, "build", "traces")
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, f"{label}.trace.json")
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
            "top": [dict(name=k, ms=ms, count=c) for k, (ms, c) in rows[:12]]}


@contextlib.contextmanager
def plain_versions(on: bool = True):
    """Route the model's operator products through the kernels' plain
    versions (autograd of plain PyTorch, forward and backward) while on."""
    from ndcn_tpu_torch.graph import sparse
    from ndcn_tpu_torch.kernels import bsr_spmm, coo_spmv, fused_rhs
    from ndcn_tpu_torch.models import ndcn

    saved = (sparse.coo_spmv, sparse.bsr_spmm, ndcn.fused_rhs,
             ndcn.bsr_fused_rhs, ndcn.spmv_T)
    if on:
        sparse.coo_spmv = lambda op, x: coo_spmv.coo_spmv_plain(
            op.rows, op.cols, op.vals, x, op.n,
            coo_spmv.GATHER_BF16 and x.shape[1] > 1)
        sparse.bsr_spmm = lambda a, at, x: bsr_spmm.bsr_spmm_plain(a, x)
        ndcn.fused_rhs = fused_rhs.fused_rhs_plain
        ndcn.bsr_fused_rhs = (lambda a, at, x, w, b:
                              bsr_spmm.bsr_fused_rhs_plain(a, x, w, b))
        ndcn.spmv_T = lambda op, xT: (
            coo_spmv.coo_spmv_T_wide_plain if coo_spmv.GATHER_WIDE
            else coo_spmv.coo_spmv_T_plain)(op.rows, op.cols, op.vals, xT,
                                            op.n, coo_spmv.GATHER_BF16)
    try:
        yield
    finally:
        (sparse.coo_spmv, sparse.bsr_spmm, ndcn.fused_rhs,
         ndcn.bsr_fused_rhs, ndcn.spmv_T) = saved


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
    from ndcn_tpu_torch.experiments import large_graph
    from ndcn_tpu_torch.experiments.dynamics import (build_parser,
                                                     ground_truth,
                                                     heat_ground_truth, run)
    from ndcn_tpu_torch.graph.generators import (build_network,
                                                 build_sparse_graph)
    from ndcn_tpu_torch.graph.operators import (normalized_laplacian,
                                                normalized_laplacian_sparse)
    from ndcn_tpu_torch.graph.sparse import (as_operator, from_dense,
                                             from_scipy_coo)
    from ndcn_tpu_torch.kernels import (build, bsr_spmm, coo_mutual,
                                        coo_spmv, fused_rhs, sparse_bench)
    from ndcn_tpu_torch.kernels.platform import device_report, pin_fp32
    from ndcn_tpu_torch.graph.sparse import DenseGraph
    from ndcn_tpu_torch.models import init_ndcn, ndcn, ndcn_forward
    from ndcn_tpu_torch.serve import make_server
    from ndcn_tpu_torch.train.budget import probe_step_budget
    from ndcn_tpu_torch.train.losses import l1_loss
    from ndcn_tpu_torch.train.optim import make_sgd_step, torch_adam
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

    def queued_ms(fn, batch: int = 10, iters: int = 7) -> float:
        """Median device time of one call when the card never waits for the
        host: ``batch`` calls are enqueued behind a spin kernel (~2 ms, or
        three times what the host took to enqueue a batch, if that is more),
        and the events bracket their back-to-back run. ``cuda_ms`` brackets
        one call on an idle card, so for a kernel shorter than its wrapper's
        host work (tens of µs) it reads the host's time; this reads the
        card's."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        spin = max(4_000_000, int(3 * host_s * 2e9))
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            start.record()
            for _ in range(batch):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / batch)
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

    def max_rel(y, ref):
        err = float((y - ref).abs().max())
        return err, err / max(float(ref.abs().max()), 1e-30)

    csr_tensors = {}

    def library_csr(o, bf16=False):
        """A as a ``torch.sparse_csr_tensor`` (values rounded to bf16 with
        ``bf16``) for the library yardstick, built once per operator."""
        key = (o.vals.data_ptr(), bf16)
        if key not in csr_tensors:
            vals = coo_spmv.round_bf16(o.vals) if bf16 else o.vals
            csr_tensors[key] = torch.sparse_csr_tensor(
                o.row_ptr, o.cols, vals, size=(o.n, o.n))
        return csr_tensors[key]

    def spmv_record(what, o, d, kern, plain, library, state):
        """One SpMV form on one operator: the kernel against its plain
        version (<= 1e-5), two calls bit-equal, the library call on the same
        inputs (<= 1e-5 too: it computes the same function), the three
        median times and the bound from the bytes of A, the state and the
        result. Returns (record, kernel output)."""
        y, ref, lib = kern(), plain(), library()
        torch.cuda.synchronize()
        err, rel = max_rel(y, ref)
        check(rel <= 1e-5, f"{what} disagrees with its plain version: {rel}")
        check(torch.equal(y, kern()), f"{what}: two calls differ")
        check(max_rel(lib, ref)[1] <= 1e-5,
              f"{what}: the library call computes something else")
        nnz = int(o.cols.shape[0])
        rec = dict(max_abs_err=err, rel_err=rel, repeat_equal=True,
                   ms=cuda_ms(kern, iters=15), device_ms=queued_ms(kern),
                   library_device_ms=queued_ms(library),
                   plain_ms=cuda_ms(plain, iters=15),
                   library_ms=cuda_ms(library, iters=15),
                   **bound(nbytes(o.row_ptr, o.cols, o.vals, state, y),
                           2 * nnz * d))
        return rec, y

    def k1_case(op, d, seed):
        x = torch.as_tensor(np.random.RandomState(seed).randn(op.n, d)
                            .astype(np.float32), device=dev)
        a = library_csr(op)
        rec, _ = spmv_record(
            f"K1 n={op.n} d={d}", op, d, lambda: coo_spmv.coo_spmv(op, x),
            lambda: coo_spmv.coo_spmv_plain(op.rows, op.cols, op.vals, x,
                                            op.n),
            lambda: torch.sparse.mm(a, x), x)
        return dict(n=op.n, nnz=int(op.cols.shape[0]), d=d, **rec)

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
    k1_hub["split_rows"] = int(op_hub.split.long_rows.shape[0])
    k1_hub["chunks"] = int(op_hub.split.chunk_bounds.shape[0])
    check(k1_hub["max_row_degree"] >= 4_000 and k1_hub["chunks"] > 0,
          "hub graph has no hub row")
    print(f"[3] K1 coo_spmv vs plain (host graph build {host_build_s:.3f} s): "
          + json.dumps({"200k_d20": k1_main, "200k_d1": k1_d1,
                        "hub_d20": k1_hub}))

    # ---- 4. K2 against its plain version, and the fused-vs-unfused sweep
    def routes(kind, op, width, n, seed):
        """One shape of the ``fused_profitable`` sweep: ``ode_func`` with the
        fused kernel and with the route it takes otherwise (``matvec`` +
        ``linear_apply`` + relu), same model and state; whether 'auto'
        picks the route that was no slower on an idle card."""
        model = init_ndcn(torch.Generator().manual_seed(seed), 1, width, 1,
                          device=dev)
        h = torch.as_tensor(np.random.RandomState(seed).rand(n, width)
                            .astype(np.float32), device=dev)
        with torch.no_grad():
            def fused():
                return ndcn.ode_func(model, op, 0.0, h, fused=True)

            def unfused():
                return ndcn.ode_func(model, op, 0.0, h, fused=False)

            check(max_rel(fused(), unfused())[1] <= 1e-5,
                  f"the two routes of ode_func disagree ({kind}, {n}, {width})")
            rec = dict(kind=kind, n=n, width=width, fused_ms=cuda_ms(fused),
                       unfused_ms=cuda_ms(unfused),
                       fused_device_ms=queued_ms(fused),
                       unfused_device_ms=queued_ms(unfused))
        rec["auto_fuses"] = ndcn.fused_profitable(kind, width, n)
        # decided on the card's part alone (ten calls behind the spin
        # kernel, which repeats to 2 %): the idle-card ms of calls this
        # short is mostly the host's time and varies by tens of percent.
        # Within ROUTE_TIE the two routes count as tied and either may be
        # picked.
        fused_over_unfused = rec["fused_device_ms"] / rec["unfused_device_ms"]
        rec["fused_no_slower"] = fused_over_unfused <= 1.0
        rec["tie"] = 1.0 / ROUTE_TIE <= fused_over_unfused <= ROUTE_TIE
        rec["picked_over_other"] = (fused_over_unfused if rec["auto_fuses"]
                                    else 1.0 / fused_over_unfused)
        return rec

    def check_routes(records):
        """'auto' picks no route more than ROUTE_TIE slower than the other
        (checked once the whole sweep is printed)."""
        slower = [r for r in records if r["picked_over_other"] > ROUTE_TIE]
        check(not slower, f"fused_profitable picks the slower route: "
              f"{slower}")

    def k2_case(n, k, seed, sweep=False):
        r = np.random.RandomState(seed)
        a = torch.as_tensor(r.rand(n, n).astype(np.float32), device=dev)
        h = torch.as_tensor(r.rand(n, k).astype(np.float32), device=dev)
        w = torch.as_tensor(r.randn(k, k).astype(np.float32), device=dev)
        b = torch.as_tensor(r.randn(k).astype(np.float32), device=dev)

        def kern():
            return fused_rhs.fused_rhs(a, h, w, b)

        y = kern()
        ref = fused_rhs.fused_rhs_plain(a, h, w, b)
        emu = fused_rhs.fused_rhs_split_plain(a, h, w, b)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        check(torch.allclose(y, ref, rtol=1e-5, atol=1e-5 * scale),
              f"K2 disagrees at ({n}, {k})")
        check(torch.equal(y, kern()), f"K2 ({n}, {k}): two calls differ")
        out = dict(n=n, k=k, max_abs_err=float((y - ref).abs().max()),
                   rel_err=max_rel(y, ref)[1], repeat_equal=True,
                   rel_err_vs_split_emulation=max_rel(y, emu)[1],
                   plan=fused_rhs.fused_rhs_plan(n, k)._asdict())
        check(out["rel_err_vs_split_emulation"] <= 2e-6,
              f"K2 ({n}, {k}) is not the split product: {out}")
        del emu
        out["ms"] = cuda_ms(kern)
        out["device_ms"] = queued_ms(kern)
        out["plain_ms"] = cuda_ms(lambda: fused_rhs.fused_rhs_plain(a, h, w, b))
        out["library_ms"] = cuda_ms(
            lambda: torch.relu(torch.addmm(b, a @ h, w)))
        out["library_device_ms"] = queued_ms(
            lambda: torch.relu(torch.addmm(b, a @ h, w)))
        out.update(bound(nbytes(a, h, w, b, h), 2 * n * n * k + 2 * n * k * k,
                         "split_tf32"))
        if sweep:
            out["routes"] = routes("dense", DenseGraph(a), k, n, seed)
        return out

    k2_main = k2_case(400, 20, 5)
    k2_ragged = k2_case(275, 13, 6)
    sweep = {f"{n}x{k}": k2_case(n, k, 7, sweep=True)
             for n in (400, 1000, 4000, 10000) for k in (20, 64, 128)}
    torch.cuda.empty_cache()
    print("[4] K2 fused_rhs vs plain: "
          + json.dumps({"400x20": k2_main, "275x13": k2_ragged,
                        "sweep": sweep}))
    check_routes([c["routes"] for c in sweep.values()])

    # ---- 5. serve the 400-node grid, dense operator, fused="auto"
    kernels.reset_launch_counts()
    fx = dict(np.load(os.path.join(root, "tests", "fixtures",
                                   "ndcn_forward_grid400.npz")))
    tree = {name: {"w": fx[f"{name}_w"].T, "b": fx[f"{name}_b"]}
            for name in ("enc1", "enc2", "wt", "dec")}
    model = model_grid = params_from_jax(tree, device=dev)
    op_grid = from_dense(normalized_laplacian(build_network("grid", 400)),
                         device=dev)
    serve_kw = dict(rtol=0.01, atol=0.001, method="dopri5", fused="auto")
    server = make_server(model, op_grid, fx["t"], **serve_kw)
    rs = np.random.RandomState(11)
    requests = [fx["x0"]] + [rs.uniform(0.0, 25.0, (400, 1)).astype(np.float32)
                             for _ in range(2)]
    answers, first = serve_all(server, requests, "grid400")
    requests_grid = requests                  # [15] serves them again
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

    main_launches = dict(launches)   # the main paths' launches, summed

    def add_launches(what: str, needed) -> dict:
        """Read the counts after a main-path phase, fail on a kernel of the
        path that never launched, and add them to the record."""
        counts = kernels.launch_counts()
        for name in needed:
            check(counts[name] > 0, f"{what} never launched {name}")
        for name, c in counts.items():
            main_launches[name] += c
        return counts

    # ---- 7. backward and BSR kernels against their plain versions
    def grads_of(fn, ins, g):
        """(outputs of fn, a timed closure of the backward alone)."""
        ins = [t.detach().clone().requires_grad_() for t in ins]
        out = fn(*ins)
        return (out, torch.autograd.grad(out, ins, g, retain_graph=True),
                lambda: torch.autograd.grad(out, ins, g, retain_graph=True))

    def compare(what, got, ref, ms, plain_ms, **extra):
        errs = [max_rel(a, b) for a, b in zip(got, ref)]
        err, rel = max(e for e, _ in errs), max(r for _, r in errs)
        check(rel <= 1e-5, f"{what} disagrees with its plain version: {rel}")
        return dict(extra, max_abs_err=err, rel_err=rel, ms=ms,
                    plain_ms=plain_ms)

    g_hub = torch.as_tensor(np.random.RandomState(8).randn(op_hub.n, 20)
                            .astype(np.float32), device=dev)
    hub_t = op_hub.transpose()
    a_hub_t = library_csr(hub_t)
    k1t, _ = spmv_record(
        "K1T", hub_t, 20, lambda: coo_spmv.coo_spmv(hub_t, g_hub),
        lambda: coo_spmv.coo_spmv_plain(hub_t.rows, hub_t.cols, hub_t.vals,
                                        g_hub, hub_t.n),
        lambda: torch.sparse.mm(a_hub_t, g_hub), g_hub)
    k1t.update(n=op_hub.n, d=20)
    # and through autograd: the backward of K1 is K1ᵀ
    x_hub = torch.as_tensor(np.random.RandomState(16).randn(op_hub.n, 20)
                            .astype(np.float32), device=dev)
    _, dx, _ = grads_of(lambda x: coo_spmv.coo_spmv(op_hub, x), [x_hub], g_hub)
    _, dx_ref, _ = grads_of(lambda x: coo_spmv.coo_spmv_plain(
        op_hub.rows, op_hub.cols, op_hub.vals, x, op_hub.n), [x_hub], g_hub)
    k1t["autograd_rel_err"] = max_rel(dx[0], dx_ref[0])[1]
    check(k1t["autograd_rel_err"] <= 1e-5, "K1's autograd backward is off")

    r = np.random.RandomState(9)
    k2_ins = [torch.as_tensor(v, device=dev) for v in (
        r.rand(400, 400).astype(np.float32), r.rand(400, 20).astype(np.float32),
        r.randn(20, 20).astype(np.float32), r.randn(20).astype(np.float32))]
    a_k2 = k2_ins[0]
    g_k2 = torch.as_tensor(r.randn(400, 20).astype(np.float32), device=dev)
    out_k2 = fused_rhs.fused_rhs(*k2_ins)
    got = fused_rhs.fused_rhs_backward(a_k2, k2_ins[1], k2_ins[2], out_k2,
                                       g_k2)[1:]
    _, ref, plain_bwd = grads_of(
        lambda h, w, b: fused_rhs.fused_rhs_plain(a_k2, h, w, b),
        k2_ins[1:], g_k2)
    def k2_bwd():
        return fused_rhs.fused_rhs_backward(a_k2, k2_ins[1], k2_ins[2],
                                            out_k2, g_k2)

    k2b = compare("K2 backward", got, ref, cuda_ms(k2_bwd),
                  cuda_ms(plain_bwd), n=400, k=20, library_ms=None,
                  device_ms=queued_ms(k2_bwd),
                  **bound(nbytes(a_k2, *k2_ins[1:3], out_k2, g_k2, *got),
                          4 * 400 * 400 * 20 + 4 * 400 * 20 * 20))

    grid_lap = normalized_laplacian(build_network("grid", 400))
    rand2k = (r.rand(2000, 2000) * (r.rand(2000, 2000) < 0.05)) \
        .astype(np.float32)

    def bsr_library(m):
        """(x -> A·x by one PyTorch call, its name) for the BSR matrix m: a
        ``torch.sparse_bsr_tensor`` product where this PyTorch runs one on
        the card, else the dense ``torch.matmul``. Neither is used by the
        port."""
        B = m.block
        rows_p, cols_p = m.n_row_blocks * B, -(-m.n_cols // B) * B
        try:
            a = torch.sparse_bsr_tensor(m.row_ptr, m.block_cols, m.blocks,
                                        size=(rows_p, cols_p))
            a @ torch.zeros((cols_p, 8), device=dev)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError):
            dense = torch.zeros((rows_p, cols_p), device=dev)
            for rb, cb, blk in zip(m.block_rows.tolist(),
                                   m.block_cols.tolist(), m.blocks):
                dense[rb * B:(rb + 1) * B, cb * B:(cb + 1) * B] = blk
            dense = dense[:m.n_rows, :m.n_cols].contiguous()
            return (lambda x: dense @ x), "torch.matmul (dense A)"
        pad = cols_p - m.n_cols
        return (lambda x: (a @ torch.nn.functional.pad(x, (0, 0, 0, pad)))
                [:m.n_rows]), "torch.sparse_bsr_tensor @"

    def bsr_bound(m, d, *more, products=1, dense_products=0, kind="fp32"):
        """Bound of ``products`` BSR products at width d and
        ``dense_products`` (n, d) × (d, d) ones in arithmetic ``kind``, over
        m's arrays, ``more`` tensors and nothing else."""
        B, nnzb = m.block, int(m.blocks.shape[0])
        return bound(nbytes(m.row_ptr, m.block_cols, m.blocks, *more),
                     products * 2 * nnzb * B * B * d
                     + dense_products * 2 * m.n_rows * d * d, kind)

    def k3_case(mat, d, seed):
        """K3 and K3 over Aᵀ against the plain version (<= 1e-5) and the
        emulation of its split-TF32 product (<= 2e-6), bit-equal on a
        repeat; its times, the library call's and the bound."""
        op = as_operator(sp.csr_matrix(mat), sparse=True, format="bsr",
                         device=dev)
        x = torch.as_tensor(np.random.RandomState(seed).randn(mat.shape[0], d)
                            .astype(np.float32), device=dev)
        out = {}
        for label, o in (("fwd", op), ("transpose", op.transpose())):
            lib, lib_name = bsr_library(o.fwd)
            ref = bsr_spmm.bsr_spmm_plain(o.fwd, x)
            check(max_rel(lib(x), ref)[1] <= 1e-5,
                  f"K3 {label}: the library call computes something else")

            def kern():
                return bsr_spmm.bsr_spmm(o.fwd, o.bwd, x)

            y = kern()
            check(torch.equal(y, kern()), f"K3 {label} d={d}: two calls "
                  f"differ")
            vs_emu = max_rel(y, bsr_spmm.bsr_spmm_split_plain(o.fwd, x))[1]
            check(vs_emu <= 2e-6, f"K3 {label} d={d} is not the split "
                  f"product: {vs_emu}")
            plan = bsr_spmm.bsr_spmm_plan(o.fwd.n_row_blocks, o.fwd.block, d)
            out[label] = compare(
                f"K3 {label} n={op.n} d={d}", [y], [ref], cuda_ms(kern),
                cuda_ms(lambda: bsr_spmm.bsr_spmm_plain(o.fwd, x)),
                device_ms=queued_ms(kern),
                library_ms=cuda_ms(lambda: lib(x)),
                library_device_ms=queued_ms(lambda: lib(x)), library=lib_name,
                repeat_equal=True, rel_err_vs_split_emulation=vs_emu,
                plan=dict(slab=plan.slab, slabs=plan.slabs,
                          **plan.panel._asdict()),
                **bsr_bound(o.fwd, d, x, ref, kind="split_tf32"))
        return dict(n=op.n, nnz_blocks=int(op.fwd.blocks.shape[0]), d=d,
                    **out)

    k3 = {"grid400_d20": k3_case(grid_lap, 20, 10),
          "rand2000_d20": k3_case(rand2k, 20, 11),
          "rand2000_d256": k3_case(rand2k, 256, 12)}

    def k4_case(mat, d, seed):
        op = as_operator(sp.csr_matrix(mat), sparse=True, format="bsr",
                         device=dev)
        rs = np.random.RandomState(seed)
        ins = [torch.as_tensor(v, device=dev) for v in (
            rs.rand(op.n, d).astype(np.float32),
            (rs.randn(d, d) / np.sqrt(d)).astype(np.float32),
            (0.1 * rs.randn(d)).astype(np.float32))]
        g = torch.as_tensor(rs.randn(op.n, d).astype(np.float32), device=dev)
        # no cotangent where the forward's bound (1e-5·max) leaves relu's
        # mask open: there a kernel and its plain version may differ
        z = bsr_spmm.bsr_spmm_plain(op.fwd, ins[0]) @ ins[1].t() + ins[2]
        open_mask = z.abs() <= 1e-5 * z.abs().max()
        check(int(open_mask.sum()) <= max(2, 1e-4 * open_mask.numel()),
              f"K4 backward d={d}: {int(open_mask.sum())} of "
              f"{open_mask.numel()} cotangents lie at relu's kink")
        g = g.masked_fill(open_mask, 0.0)
        del z, open_mask

        def fused(x, weight, b):   # w as nn.Linear hands it over: a view
            return bsr_spmm.bsr_fused_rhs(op.fwd, op.bwd, x, weight.t(), b)

        def plain(x, weight, b):
            return bsr_spmm.bsr_fused_rhs_plain(op.fwd, x, weight.t(), b)

        lib, lib_name = bsr_library(op.fwd)

        def library(x, weight, b):
            return torch.relu(torch.addmm(b, lib(x), weight.t()))

        ref_out = plain(*ins)
        check(max_rel(library(*ins), ref_out)[1] <= 1e-5,
              "K4: the library call computes something else")
        y = fused(*ins)
        check(torch.equal(y, fused(*ins)), f"K4 d={d}: two calls differ")
        vs_emu = max_rel(y, bsr_spmm.bsr_fused_rhs_split_plain(
            op.fwd, ins[0], ins[1].t(), ins[2]))[1]
        check(vs_emu <= 2e-6, f"K4 d={d} is not the split product: {vs_emu}")
        with torch.no_grad():
            fwd = compare(f"K4 n={op.n} d={d}", [y], [ref_out],
                          cuda_ms(lambda: fused(*ins)),
                          cuda_ms(lambda: plain(*ins)),
                          device_ms=queued_ms(lambda: fused(*ins)),
                          library_ms=cuda_ms(lambda: library(*ins)),
                          library_device_ms=queued_ms(lambda: library(*ins)),
                          library=f"relu(addmm(b, {lib_name}, w))",
                          repeat_equal=True, rel_err_vs_split_emulation=vs_emu,
                          plan=bsr_spmm.bsr_fused_plan(
                              op.fwd.n_row_blocks, op.fwd.block, d)._asdict(),
                          **bsr_bound(op.fwd, d, *ins, ref_out,
                                      dense_products=1, kind="split_tf32"))
        _, got, kernel_bwd = grads_of(fused, ins, g)
        _, ref, plain_bwd = grads_of(plain, ins, g)
        # reads Aᵀ, x, w, the saved output and g; writes dx, dw, db;
        # recomputes A·x: two BSR products and two dense ones
        bwd = compare(f"K4 backward n={op.n} d={d}", got, ref,
                      cuda_ms(kernel_bwd), cuda_ms(plain_bwd),
                      device_ms=queued_ms(kernel_bwd), library_ms=None,
                      **bsr_bound(op.bwd, d, *ins[:2], ref_out, g, *got,
                                  products=2, dense_products=2))
        return dict(n=op.n, d=d, fwd=fwd, bwd=bwd)

    k4 = {"grid400_d20": k4_case(grid_lap, 20, 13),
          "rand2000_d256": k4_case(rand2k, 256, 14),
          "rand2000_d512": k4_case(rand2k, 512, 15)}
    bsr_routes = [
        routes("bsr", as_operator(sp.csr_matrix(mat), sparse=True,
                                  format="bsr", device=dev), d, mat.shape[0],
               17)
        for mat in (grid_lap, rand2k) for d in (20, 64, 128, 256, 512)]
    print("[7] backward and BSR kernels vs plain: " + json.dumps(
        {"k1t_hub_d20": k1t, "k2_bwd_400x20": k2b, "k3": k3, "k4": k4}))
    dense_routes = [c["routes"] for c in sweep.values()]
    print("[7b] fused_profitable sweep (card: " + smi + "): " + json.dumps(
        {"dense": dense_routes, "bsr": bsr_routes,
         "ties": [f"{r['kind']} {r['n']}x{r['width']}"
                  for r in dense_routes + bsr_routes if r["tie"]]}))
    check_routes(bsr_routes)

    # ---- 8-10. training
    gx = dict(np.load(os.path.join(root, "tests", "fixtures",
                                   "ndcn_grads_grid400.npz")))
    g_tree = {name: {"w": gx[f"{name}_w"].T, "b": gx[f"{name}_b"]}
              for name in ("enc1", "enc2", "wt", "dec")}
    train_kw = dict(rtol=0.01, atol=0.001, method="dopri5")

    def rhs_vjps():
        """Count the learned RHS's evaluations and their backward calls."""
        counts = {"fwd": 0, "bwd": 0}
        base = ndcn.ode_func

        def counted(*args, **kwargs):
            out = base(*args, **kwargs)
            counts["fwd"] += 1
            if out.requires_grad:
                out.register_hook(
                    lambda g: counts.__setitem__("bwd", counts["bwd"] + 1))
            return out

        return counts, base, counted

    def train(model, op, vt, x0, target, steps, fused, max_steps):
        """``steps`` optimizer steps through ``make_sgd_step`` (torch-parity
        Adam); returns the first step's loss, gradients and RHS counts, and
        the per-step ms."""
        opt = torch_adam(model.parameters(), 0.01, 1e-3)
        first, stats_box = {}, []

        def loss_fn():
            out, stats = ndcn_forward(model, op, vt, x0, fused=fused,
                                      max_steps=max_steps, **train_kw)
            stats_box.append(stats)
            loss = l1_loss(out, target)
            return loss, loss / torch.mean(target)

        def keep_first_grads(_opt, _args, _kwargs):
            if not first:
                first["grads"] = {n: p.grad.detach().clone()
                                  for n, p in model.named_parameters()}

        hook = opt.register_step_pre_hook(keep_first_grads)
        step = make_sgd_step(opt, loss_fn)
        counts, base, counted = rhs_vjps()
        ms = []
        try:
            for i in range(steps):
                ndcn.ode_func = counted if i == 0 else base
                t0 = time.perf_counter()
                loss, _ = step()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    first["loss"] = float(loss)
        finally:
            ndcn.ode_func = base
            hook.remove()
        check(all(s.success for s in stats_box), "a train solve failed")
        check(np.isfinite(float(loss)), "the train loss is not finite")
        return dict(first_loss=first["loss"], first_grads=first["grads"],
                    step_ms=ms, nfe_per_step=[s.nfe for s in stats_box],
                    rhs_evals=counts["fwd"], rhs_vjps=counts["bwd"],
                    last_loss=float(loss))

    def fixture_check(res, what):
        ref = float(gx["loss_backprop"])
        loss_rel = abs(res["first_loss"] - ref) / abs(ref)
        errs = {}
        for name in ("enc1", "enc2", "wt", "dec"):
            for leaf, key in (("weight", "w"), ("bias", "b")):
                got = res["first_grads"][f"{name}.{leaf}"].cpu().numpy()
                want = gx[f"g_{name}_{key}_backprop"]
                errs[f"{name}_{key}"] = float(np.abs(got - want).sum()
                                              / np.abs(want).sum())
        check(loss_rel <= 1e-4, f"{what}: loss off the fixture: {loss_rel}")
        check(max(errs.values()) <= 1e-3, f"{what}: gradients off the "
              f"fixture: {errs}")
        return dict(loss_rel_err=loss_rel, max_grad_rel_l1=max(errs.values()))

    def summary(res):
        return {k: v for k, v in res.items() if k != "first_grads"}

    target_g = torch.as_tensor(gx["target"].T[..., None], device=dev)
    x0_g = torch.as_tensor(gx["x0"], device=dev)

    def heat_experiment(*extra):
        return run("heat", build_parser("heat").parse_args(
            ["--network", "grid", "--n", "400", "--method", "dopri5",
             "--platform", "gpu", *extra]))

    # 8. grid400 dense, fused="auto": K2 forward and backward
    kernels.reset_launch_counts()
    op_g = from_dense(grid_lap, device=dev)
    res = train(params_from_jax(g_tree, device=dev), op_g, gx["t"], x0_g,
                target_g, 6, "auto", 64)
    fix = fixture_check(res, "grid400 dense")
    drv = heat_experiment("--fused_kernel", "--niters", "20", "--test_freq",
                          "10")
    check(drv["train_losses"][-1] < drv["train_losses"][0],
          f"grid400 heat experiment: train loss did not fall "
          f"{drv['train_losses']}")
    counts = add_launches("grid400 dense training", ["fused_rhs"])
    print("[8] train grid400 dense fused=auto: " + json.dumps(
        dict(summary(res), fixture=fix, launches=counts,
             experiment={k: drv[k] for k in ("train_losses", "final",
                                             "max_steps", "total_time")})))

    # 9. grid400 BSR: fused=False (K3) and fused=True (K4)
    kernels.reset_launch_counts()
    op_gb = as_operator(sp.csr_matrix(grid_lap), sparse=True, format="bsr",
                        device=dev)
    bsr_res = {}
    for fused in (False, True):
        res = train(params_from_jax(g_tree, device=dev), op_gb, gx["t"],
                    x0_g, target_g, 6, fused, 64)
        bsr_res[f"fused_{fused}"] = dict(
            summary(res), fixture=fixture_check(res, f"grid400 bsr {fused}"))
    drv = heat_experiment("--sparse", "--sparse_format", "bsr", "--niters",
                          "10", "--test_freq", "5")
    check(drv["train_losses"][-1] < drv["train_losses"][0],
          f"grid400 BSR heat experiment: train loss did not fall "
          f"{drv['train_losses']}")
    counts = add_launches("grid400 BSR training",
                          ["bsr_spmm", "bsr_fused_rhs"])
    print("[9] train grid400 BSR: " + json.dumps(
        dict(bsr_res, launches=counts,
             experiment={k: drv[k] for k in ("train_losses", "final",
                                             "max_steps", "total_time")})))

    # 10. 200k COO: K1 forward, K1ᵀ backward
    id_train = splits.id_train
    x0_big = torch.as_tensor(np.random.RandomState(0).uniform(
        0.0, 25.0, (op_big.n, 1)).astype(np.float32), device=dev)
    t0 = time.perf_counter()
    truth, gt_stats = heat_ground_truth(op_big, x0_big, splits.t, rtol=1e-6,
                                        atol=1e-8)
    torch.cuda.synchronize()
    gt_s = time.perf_counter() - t0
    check(gt_stats.success, f"200k ground truth failed: {gt_stats}")
    target_big = truth[id_train]
    del truth
    t_train = splits.t[id_train]
    model_t = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1,
                        device=dev)
    model_p = copy.deepcopy(model_t)
    budget = probe_step_budget(
        lambda: ndcn_forward(model_t, op_big, t_train, x0_big, nondiff=True,
                             max_steps=1 << 14, **train_kw)[1],
        floor=8, headroom=1.5, slack=2, quantum=4)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    res = train(model_t, op_big, t_train, x0_big, target_big, 5, False,
                budget)
    peak_train_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    counts = add_launches("200k COO training", ["coo_spmv"])
    # the first step again, with the plain versions patched in
    with plain_versions():
        out, _ = ndcn_forward(model_p, op_big, t_train, x0_big,
                              max_steps=budget, **train_kw)
        l1_loss(out, target_big).backward()
    errs = {n: rel_l1(res["first_grads"][n], p.grad)
            for n, p in model_p.named_parameters()}
    check(max(errs.values()) <= 1e-3, f"200k kernel vs plain grads: {errs}")
    print("[10] train 200k COO: " + json.dumps(
        dict(summary(res), ground_truth=dict(nfe=gt_stats.nfe, seconds=gt_s),
             max_steps=budget, peak_allocated_gb=peak_train_gb,
             launches=counts, grad_rel_l1_kernel_vs_plain=max(errs.values()))))

    # ---- 11. the scale path's SpMV kernels against their plain versions
    t0 = time.perf_counter()
    adj_1m = build_sparse_graph(1_000_000, 10, seed=0)   # [14] takes it too
    op_1m = from_scipy_coo(normalized_laplacian_sparse(adj_1m), device=dev)
    host_build_1m_s = time.perf_counter() - t0

    @contextlib.contextmanager
    def gather_mode(wide: bool, bf16: bool):
        saved = coo_spmv.GATHER_WIDE, coo_spmv.GATHER_BF16
        coo_spmv.GATHER_WIDE, coo_spmv.GATHER_BF16 = wide, bf16
        try:
            yield
        finally:
            coo_spmv.GATHER_WIDE, coo_spmv.GATHER_BF16 = saved

    def scale_case(op, form, bf16, d=20):
        """One scale-path SpMV form, forward and over the transpose CSR,
        against its plain version and the library call; returns the
        record."""
        d_sub = coo_spmv.sublane_pad(d)
        rs = np.random.RandomState(21)
        out = dict(n=op.n, nnz=int(op.cols.shape[0]), d=d)
        for label, o in (("fwd", op), ("transpose", op.transpose())):
            a = library_csr(o, bf16)
            if form == "k1":
                x = torch.as_tensor(rs.randn(op.n, d).astype(np.float32),
                                    device=dev)

                def kern():
                    return coo_spmv.coo_spmv(o, x)

                def plain():
                    return coo_spmv.coo_spmv_plain(o.rows, o.cols, o.vals, x,
                                                   o.n, bf16)

                def library():
                    return torch.sparse.mm(
                        a, coo_spmv.round_bf16(x) if bf16 else x)
            else:
                x = torch.zeros((d_sub, op.n), device=dev)
                x[:d] = torch.as_tensor(rs.randn(d, op.n).astype(np.float32),
                                        device=dev)
                plain_fn = (coo_spmv.coo_spmv_T_wide_plain if form == "k5"
                            else coo_spmv.coo_spmv_T_plain)

                def kern():
                    return coo_spmv.spmv_T(o, x)

                def plain():
                    return plain_fn(o.rows, o.cols, o.vals, x, o.n, bf16)

                def library():   # the same function: both transposes timed
                    xr = coo_spmv.round_bf16(x) if bf16 else x
                    return torch.sparse.mm(a, xr.t()).t().contiguous()
            with gather_mode(form == "k5", bf16), torch.no_grad():
                out[label], y = spmv_record(
                    f"{form} bf16={bf16} {label} n={op.n}", o,
                    d if form == "k1" else d_sub, kern, plain, library, x)
                if form != "k1":
                    check(not y[d:].any(), f"{form} wrote the pad rows")
        return out

    def pack_case(n, bf16, d_sub=24):
        """K1-fm's pack kernel against its plain version (exact) and the
        library's transpose copy."""
        xT = torch.as_tensor(np.random.RandomState(22).randn(d_sub, n)
                             .astype(np.float32), device=dev)
        table = coo_spmv.pack_rows(xT, bf16)
        ref = coo_spmv.pack_rows_plain(xT, bf16)
        torch.cuda.synchronize()
        check(torch.equal(table, ref), f"the pack kernel is off at n={n}")

        def library():
            t = xT.t()
            return (t.to(torch.bfloat16) if bf16 else t).contiguous()

        return dict(n=n, d_sub=d_sub, max_abs_err=0.0, repeat_equal=True,
                    ms=cuda_ms(lambda: coo_spmv.pack_rows(xT, bf16)),
                    device_ms=queued_ms(lambda: coo_spmv.pack_rows(xT, bf16)),
                    library_device_ms=queued_ms(library),
                    plain_ms=cuda_ms(lambda: coo_spmv.pack_rows_plain(xT,
                                                                      bf16)),
                    library_ms=cuda_ms(library),
                    **bound(nbytes(xT, table), 0))

    k11 = {}
    k11["k1_f32_1m"] = scale_case(op_1m, "k1", False)
    for bf16 in (False, True):
        kind = "bf16" if bf16 else "f32"
        k11[f"k1fm_{kind}_hub"] = scale_case(op_hub, "k1fm", bf16)
        k11[f"k5_{kind}_hub"] = scale_case(op_hub, "k5", bf16)
        k11[f"pack_{kind}_1m"] = pack_case(op_1m.n, bf16)
    k11["pack_f32_200k"] = pack_case(op_big.n, False)
    for size, op in (("200k", op_big), ("1m", op_1m)):
        k11[f"k1_bf16_{size}"] = scale_case(op, "k1", True)
        for form in ("k1fm", "k5"):
            for bf16 in (False, True):
                k11[f"{form}_{'bf16' if bf16 else 'f32'}_{size}"] = \
                    scale_case(op, form, bf16)
    print(f"[11] scale SpMV kernels vs plain (1M host build "
          f"{host_build_1m_s:.3f} s): " + json.dumps(k11))
    del op_1m
    csr_tensors.clear()
    torch.cuda.empty_cache()

    # ---- 12. the scale experiment at 1M nodes (and 200k, bf16 and wide)
    def scale_args(*argv):
        return large_graph.build_parser().parse_args(list(argv))

    def scale_run(what, needed, *argv):
        kernels.reset_launch_counts()
        rec = large_graph.run(scale_args(*argv))
        counts = add_launches(what, needed)
        torch.cuda.empty_cache()
        return rec, counts

    def scale_summary(rec, counts):
        keep = ("train_steps_per_sec", "rel_loss_initial", "rel_loss_final",
                "max_steps", "attempts_taken", "elastic_rollbacks",
                "hbm_peak_gb",
                "hbm_peak_source", "roofline", "layout", "solve_layout",
                "train_losses", "ground_truth_s", "node_evals_per_sec")
        return dict({k: rec[k] for k in keep}, launches=counts)

    est = large_graph.run(scale_args("--n", "1000000", "--estimate"))
    est_bf = large_graph.run(scale_args(
        "--n", "1000000", "--estimate", "--emission_precision", "bf16",
        "--residual_precision", "bf16"))
    rec_1m, c_1m = scale_run("1M scale experiment",
                             ["coo_spmv", "coo_spmv_T", "coo_spmv_T_pack"],
                             "--n", "1000000", "--iters", "60", "--roofline",
                             "--hbm_probe")
    check(rec_1m["layout"] == "auto"
          and rec_1m["solve_layout"] == "feature_major",
          f"1M: layout auto resolved to {rec_1m['solve_layout']}")
    check(rec_1m["train_losses"][-1] < rec_1m["train_losses"][0],
          f"1M: the train loss did not fall {rec_1m['train_losses']}")
    rec_bf, c_bf = scale_run("1M scale experiment, bf16 levers",
                             ["coo_spmv_T", "coo_spmv_T_pack"],
                             "--n", "1000000", "--iters", "10", "--hbm_probe",
                             "--emission_precision", "bf16",
                             "--residual_precision", "bf16")
    check(rec_bf["train_losses"][-1] < rec_bf["train_losses"][0],
          f"1M bf16 levers: the train loss did not fall "
          f"{rec_bf['train_losses']}")

    # the first train step again, kernels against plain versions
    args_1m = scale_args("--n", "1000000")
    prob = large_graph.build_problem(args_1m, dev)
    truth_1m, _, _ = large_graph.ground_truth(args_1m, prob)
    target_1m = truth_1m[torch.as_tensor(prob.splits.id_train, device=dev)]
    del truth_1m
    model_1m = large_graph.new_model(args_1m, dev)
    budget_1m, _ = large_graph.probe_budget(args_1m, prob, model_1m)
    grads, first_step_peak_gb = {}, {}
    for which in ("kernel", "plain"):
        m_ = copy.deepcopy(model_1m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        resident_gb = torch.cuda.memory_allocated(dev) / 1e9
        with plain_versions(which == "plain"):
            loss, _ = large_graph.train_objective(args_1m, prob, m_,
                                                  target_1m, budget_1m)()
            loss.backward()
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        first_step_peak_gb[which] = dict(peak=peak_gb, resident=resident_gb,
                                         step=peak_gb - resident_gb)
        grads[which] = {n: p.grad for n, p in m_.named_parameters()}
    errs_1m = {n: rel_l1(grads["kernel"][n], grads["plain"][n])
               for n in grads["kernel"]}
    check(max(errs_1m.values()) <= 1e-3, f"1M kernel vs plain grads: "
          f"{errs_1m}")
    del grads
    torch.cuda.empty_cache()

    rec_k1bf, c_k1bf = scale_run("200k scale experiment, kernel bf16",
                                 ["coo_spmv_bf16"], "--n", "200000",
                                 "--iters", "3", "--kernel_precision", "bf16")
    check(rec_k1bf["solve_layout"] == "nd", "200k auto should stay nd")
    with gather_mode(True, False):
        rec_wide, c_wide = scale_run("200k scale experiment, wide gather",
                                     ["coo_spmv_T_wide"], "--n", "200000",
                                     "--iters", "3", "--layout",
                                     "feature_major")
    # the three solves of the 1M step side by side: 'auto' (feature-major,
    # K1-fm) above, feature-major under GATHER_WIDE (K5), the (n, d) layout
    with gather_mode(True, False):
        rec_1m_wide, c_1m_wide = scale_run(
            "1M scale experiment, wide gather", ["coo_spmv_T_wide"], "--n",
            "1000000", "--iters", "10", "--hbm_probe")
    rec_1m_nd, c_1m_nd = scale_run(
        "1M scale experiment, (n, d) layout", ["coo_spmv"], "--n", "1000000",
        "--iters", "10", "--hbm_probe", "--layout", "nd")
    check(rec_1m_wide["solve_layout"] == "feature_major"
          and rec_1m_nd["solve_layout"] == "nd", "1M layouts resolved wrong")
    print("[12] scale experiment: " + json.dumps({
        "1m": scale_summary(rec_1m, c_1m),
        # the JAX package's record of the same 60 iterations (a TPU run:
        # information, not a target)
        "1m_rel_loss_final_beside_jax_record": {
            "port": rec_1m["rel_loss_final"],
            "results/scale_1m_heat.json": 0.0562},
        "1m_fm_wide": scale_summary(rec_1m_wide, c_1m_wide),
        "1m_nd": scale_summary(rec_1m_nd, c_1m_nd),
        "1m_estimate": est, "1m_bf16_levers": scale_summary(rec_bf, c_bf),
        "1m_bf16_levers_estimate": est_bf,
        "1m_first_step_grad_rel_l1_kernel_vs_plain": max(errs_1m.values()),
        "1m_first_step_peak_allocated_gb": first_step_peak_gb,
        "200k_kernel_bf16": scale_summary(rec_k1bf, c_k1bf),
        "200k_fm_wide": scale_summary(rec_wide, c_wide)}))

    # ---- 13. the microbenchmarks at their defaults
    from ndcn_tpu_torch.tools import (bench_wide_gather, microbench_sparse,
                                      probe_inkernel_gather)
    kernels.reset_launch_counts()
    mb = microbench_sparse.main([])
    probe = probe_inkernel_gather.main([])
    wide_tab = bench_wide_gather.main([])
    c_tools = add_launches("the microbenchmarks",
                           ["sliced_tile_reduce", "row_gather", "coo_spmv_T",
                            "coo_spmv_T_wide"])
    torch.cuda.empty_cache()
    check(mb["sliced_spmv_kernel_err"] <= 1e-5
          and mb["sliced_reduce_kernel_vs_plain"] <= 1e-5
          and mb["take_segsum_err"] <= 1e-5 and mb["inkernel_take"],
          f"microbench_sparse checks: {mb}")
    check(all(isinstance(probe[f], float) for f in
              ("kernel", "index", "index_select", "take_along_dim")),
          f"probe_inkernel_gather: {probe}")
    for row in wide_tab["modes"]:
        check(row["rel_err"] <= (2e-2 if row["precision"] == "bf16"
                                 else 1e-5), f"bench_wide_gather: {row}")
    print("[13] microbenchmarks: " + json.dumps(
        {"microbench_sparse": mb, "probe_inkernel_gather": probe,
         "bench_wide_gather": wide_tab, "launches": c_tools}))

    # ---- 14. K1-w and the mutualistic and gene dynamics
    def k1w_case(a, d, seed):
        """K1-w forward and backward on the adjacency ``a`` at width d
        against the plain version, which is also the library yardstick."""
        op = from_scipy_coo(a, device=dev)
        rs = np.random.RandomState(seed)
        x = torch.as_tensor((rs.rand(op.n, d) * 3 + 0.2).astype(np.float32),
                            device=dev)
        g = torch.as_tensor(rs.randn(op.n, d).astype(np.float32), device=dev)
        coef = (5.0, 0.1, 0.9)     # d, e, h after the reference's swap
        nnz = int(op.cols.shape[0])
        out = dict(n=op.n, nnz=nnz, d=d,
                   split_rows=int(op.split.long_rows.shape[0]),
                   split_rows_t=int(op.split_t.long_rows.shape[0]))
        # per edge and feature: the denominator, the pair term and its sum
        # (8 operations); each side of the backward 12
        for label, kern, plain, n_bytes, flops in (
                ("fwd", lambda: coo_mutual.mutual_forward(op, x, *coef),
                 lambda: coo_mutual.mutual_forward_plain(op, x, *coef),
                 nbytes(op.row_ptr, op.cols, op.vals, x, x), 8 * nnz * d),
                ("bwd", lambda: coo_mutual.mutual_backward(op, x, g, *coef),
                 lambda: coo_mutual.mutual_backward_plain(op, x, g, *coef),
                 nbytes(op.row_ptr, op.cols, op.vals, op.row_ptr_t,
                        op.cols_t, op.vals_t, x, g, x), 24 * nnz * d)):
            edge_before = coo_mutual.EDGE_LAUNCHES
            y, ref = kern(), plain()
            torch.cuda.synchronize()
            # the form that ran, from the edge form's own launch count
            form = ("edges" if coo_mutual.EDGE_LAUNCHES
                    == edge_before + (1 if label == "fwd" else 2) else "rows")
            err, rel = max_rel(y, ref)
            check(rel <= 1e-5, f"K1-w {label} n={op.n} d={d} disagrees with "
                  f"its plain version: {rel}")
            check(torch.equal(y, kern()), f"K1-w {label}: two calls differ")
            plain_ms = cuda_ms(plain, iters=15)
            out[label] = dict(
                form=form, max_abs_err=err, rel_err=rel, repeat_equal=True,
                ms=cuda_ms(kern, iters=15), device_ms=queued_ms(kern),
                plain_ms=plain_ms, library_ms=plain_ms,
                library_device_ms=queued_ms(plain),
                library="the plain version (gather, weight, index_add_)",
                **bound(n_bytes, flops))
        return out

    hub_abs = abs(hub)
    k1w = {"50k_d1": k1w_case(build_sparse_graph(50_000, 10, seed=0), 1, 31),
           "200k_d1": k1w_case(adj, 1, 32),
           "200k_d2": k1w_case(adj, 2, 35),
           "hub_d1": k1w_case(hub_abs, 1, 38),
           "hub_d20": k1w_case(hub_abs, 20, 33),
           "hub_transposed_d20": k1w_case(hub_abs.T.tocsr(), 20, 34),
           "1m_d1": k1w_case(adj_1m, 1, 36)}
    crossover = coo_mutual.EDGE_MAX_WIDTH
    if f"200k_d{crossover}" not in k1w:
        k1w[f"200k_d{crossover}"] = k1w_case(adj, crossover, 37)
    del adj_1m
    check(k1w["hub_d20"]["split_rows"] > 0, "the hub graph has no split row")
    wrong_form = {f"{k} {label}": c[label]["form"] for k, c in k1w.items()
                  for label in ("fwd", "bwd")
                  if (c[label]["form"] == "edges") != (c["d"] <= crossover)}
    check(not wrong_form, f"K1-w ran the wrong form (the edge form to "
          f"d = {crossover}, the warp form above): {wrong_form}")

    # the physics on the card against the CPU: a 5,000-node graph
    a5k = build_sparse_graph(5_000, 10, seed=0)
    x0_5k = np.random.RandomState(0).uniform(0.0, 25.0, (5_000, 1)) \
        .astype(np.float32)
    t_5k = sample_times(5.0, 40, "irregular", seed=0).t
    gt5k = {}
    for where in ("gpu", "cpu"):
        d_ = dev if where == "gpu" else torch.device("cpu")
        sol, st = ground_truth("mutualistic", from_scipy_coo(a5k, device=d_),
                               torch.as_tensor(x0_5k, device=d_), t_5k,
                               rtol=1e-6, atol=1e-8)
        check(st.success, f"5k mutualistic ground truth on the {where}: {st}")
        gt5k[where] = (sol.cpu(), st.nfe)
    gt5k_rel = rel_l1(gt5k["gpu"][0], gt5k["cpu"][0])
    # the step counts may part by an attempt or two: at rtol 1e-6 an
    # attempt near the accept boundary is decided by fp32 sums taken in
    # another order (650 evaluations on the card against 644 on the CPU:
    # one more rejected attempt; the CPU alone gives 650 with the sum
    # reversed or taken in float64, tests/test_torch_dynamics.py::
    # test_ground_truth_step_count_follows_the_sum_order)
    nfe_gap = abs(gt5k["gpu"][1] - gt5k["cpu"][1]) / gt5k["cpu"][1]
    check(gt5k_rel <= 1e-4 and nfe_gap <= 0.02,
          f"5k mutualistic ground truth, card vs CPU: {gt5k_rel}, NFE "
          f"{gt5k['gpu'][1]} vs {gt5k['cpu'][1]}")

    def falls(losses, what):
        check(losses[-1] < losses[0],
              f"{what}: the train loss did not fall {losses}")

    rec_mut, c_mut = scale_run("50k mutualistic scale experiment",
                               ["coo_mutual", "coo_mutual_edges",
                                "coo_spmv"], "--n", "50000",
                               "--dynamics", "mutualistic", "--iters", "60")
    falls(rec_mut["train_losses"], "50k mutualistic")
    rec_gene, c_gene = scale_run("50k gene scale experiment", ["coo_spmv"],
                                 "--n", "50000", "--dynamics", "gene",
                                 "--iters", "10")
    falls(rec_gene["train_losses"], "50k gene")
    drivers = {}
    for kind, extra, needed in (
            ("mutualistic", [], []),
            ("gene", ["--method", "dopri5", "--sparse"], []),
            ("mutualistic", ["--method", "dopri5", "--sparse",
                             "--sparse_format", "coo"], ["coo_spmv"])):
        what = " ".join([kind, *extra]) or kind
        kernels.reset_launch_counts()
        drv = run(kind, build_parser(kind).parse_args(
            ["--niters", "20", "--test_freq", "10", *extra]))
        counts = add_launches(f"the {what} experiment", needed)
        falls(drv["train_losses"], f"the {what} experiment")
        drivers[what] = dict({k: drv[k] for k in (
            "train_losses", "final", "max_steps", "total_time")},
            launches=counts)
    print("[14] K1-w and the mutualistic / gene dynamics (card: " + smi
          + "): " + json.dumps({
              "k1w": k1w, "5k_ground_truth_rel_l1_card_vs_cpu": gt5k_rel,
              "5k_ground_truth_nfe_card_cpu": [gt5k["gpu"][1],
                                               gt5k["cpu"][1]],
              "50k_mutualistic": dict(
                  scale_summary(rec_mut, c_mut),
                  coo_mutual_launches_per_ground_truth=c_mut["coo_mutual"],
                  # the JAX package's record of this argv (a TPU run:
                  # information, not a target)
                  rel_loss_final_of_results_scale_50k_mutualistic=0.0511),
              "50k_gene": scale_summary(rec_gene, c_gene),
              "drivers": drivers}))
    del hub_abs
    torch.cuda.empty_cache()

    # ---- 15. the continuous adjoint, the other solvers, checkpoint / resume
    t15 = time.perf_counter()
    gx_t = torch.as_tensor(gx["target"].T[..., None], device=dev)

    def adjoint_step(op, fused, adjoint):
        """One grid400 train step at the fixture's weights: its loss,
        gradients, forward and backward NFE, ms and peak memory."""
        model = params_from_jax(g_tree, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        out, stats = ndcn_forward(model, op, gx["t"], x0_g, fused=fused,
                                  adjoint=adjoint, max_steps=64, **train_kw)
        loss = (out - gx_t).abs().mean()
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(stats.success, f"grid400 adjoint={adjoint} solve failed")
        back = stats.backward if adjoint else []
        check(all(s.success for s in back), "an adjoint interval failed")
        return dict(loss=float(loss.detach()), ms=ms, nfe_forward=stats.nfe,
                    nfe_backward=sum(s.nfe for s in back) if adjoint
                    else None,
                    # the step's own peak, above what was allocated when
                    # it started (the earlier phases' operators and models)
                    step_peak_mb=(torch.cuda.max_memory_allocated(dev)
                                  - base) / 1e6,
                    grads={n: p.grad.cpu() for n, p in
                           model.named_parameters()})

    adj = {}
    for route, op, fused, needed in (
            ("dense_auto", op_g, "auto", ["fused_rhs"]),
            ("coo", as_operator(sp.csr_matrix(grid_lap), sparse=True,
                                format="coo", device=dev), False,
             ["coo_spmv"]),
            ("bsr_fused", op_gb, True, ["bsr_fused_rhs", "bsr_spmm"])):
        adjoint_step(op, fused, True)              # warm
        kernels.reset_launch_counts()
        res = adjoint_step(op, fused, True)
        counts = add_launches(f"grid400 {route} adjoint step", needed)
        bp = adjoint_step(op, fused, False)
        ref = float(gx["loss_adjoint"])
        loss_rel = abs(res["loss"] - ref) / abs(ref)
        errs = {}
        for name in ("enc1", "enc2", "wt", "dec"):
            for leaf, key in (("weight", "w"), ("bias", "b")):
                got = res["grads"][f"{name}.{leaf}"]
                check(bool(torch.isfinite(got).all()),
                      f"{route} adjoint: a non-finite gradient in {name}")
                want = torch.as_tensor(gx[f"g_{name}_{key}_adjoint"])
                errs[f"{name}_{key}"] = float((got - want).abs().sum()
                                              / want.abs().sum())
        check(loss_rel <= 1e-4, f"{route} adjoint loss off the fixture: "
              f"{loss_rel}")
        check(max(errs.values()) <= 1e-3, f"{route} adjoint gradients off "
              f"the fixture: {errs}")
        adj[route] = dict(
            {k: v for k, v in res.items() if k != "grads"},
            loss_rel_err=loss_rel, max_grad_rel_l1=max(errs.values()),
            launches={k: v for k, v in counts.items() if v},
            backprop={k: v for k, v in bp.items() if k != "grads"})

    # (b) serve grid400 dense with the other methods, card against CPU
    methods = {}
    model_cpu = params_from_jax(tree)
    op_grid_cpu = from_dense(normalized_laplacian(build_network("grid", 400)))
    for method in ("tsit5", "adams", "fixed_adams", "explicit_adams"):
        kw = dict(serve_kw, method=method)
        kernels.reset_launch_counts()
        srv = make_server(model_grid, op_grid, fx["t"], **kw)
        answers, first = serve_all(srv, requests_grid, f"grid400 {method}")
        counts = add_launches(f"grid400 {method} serving", ["fused_rhs"])
        srv_cpu = make_server(model_cpu, op_grid_cpu, fx["t"], **kw)
        out_cpu, ok_cpu = srv_cpu(requests_grid[0])
        err = rel_l1(first.cpu(), out_cpu)
        nfe_gpu, nfe_cpu = answers[0]["nfe"], srv_cpu.last_stats.nfe
        # the same solve in float64 on the CPU: how far float32 rounding
        # alone moves this method's answer (explicit_adams at order 11 is
        # near its stability limit on this problem and amplifies it); the
        # card is held to 1e-4 of the CPU or to twice that distance
        with torch.no_grad():
            out64, _ = ndcn_forward(
                copy.deepcopy(model_cpu).double(),
                DenseGraph(op_grid_cpu.mat.double()), fx["t"],
                torch.as_tensor(requests_grid[0], dtype=torch.float64),
                nondiff=True, **dict(kw, fused=False))
        f32_gap = rel_l1(out_cpu.double(), out64)
        bar = max(1e-4, 2 * f32_gap)
        check(ok_cpu and err <= bar, f"grid400 {method}: card vs CPU "
              f"{err} (bar {bar})")
        check(abs(nfe_gpu - nfe_cpu) <= 0.02 * nfe_cpu,
              f"grid400 {method}: NFE {nfe_gpu} on the card, {nfe_cpu} on "
              f"the CPU")
        methods[method] = dict(rel_l1_gpu_vs_cpu=err, bar=bar,
                               rel_l1_cpu_f32_vs_f64=f32_gap,
                               nfe_gpu=nfe_gpu,
                               nfe_cpu=nfe_cpu, requests=answers,
                               fused_rhs_launches=counts["fused_rhs"])

    # (c) the heat driver under --adjoint and --method adams, and a run cut
    # at a checkpoint and resumed against the uninterrupted one
    drv15 = {}
    for label, extra in (("adjoint_dopri5", ["--adjoint"]),
                         ("adams", ["--method", "adams"])):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = heat_experiment(*extra, "--niters", "20", "--test_freq", "5")
        counts = add_launches(f"the heat driver {label}", [])
        falls(out["train_losses"], f"the heat driver {label}")
        drv15[label] = dict(train_losses=out["train_losses"],
                            final=out["final"], seconds=time.perf_counter()
                            - t0, max_steps=out["max_steps"])
    ckpt_dir = os.path.join(root, "build", "smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    kernels.reset_launch_counts()
    ckpt_args = ("--test_freq", "5", "--ckpt_dir", ckpt_dir, "--ckpt_freq",
                 "10")
    full = heat_experiment("--niters", "20", "--test_freq", "5")
    half = heat_experiment("--niters", "10", *ckpt_args)
    rest = heat_experiment("--niters", "20", *ckpt_args)
    add_launches("the checkpointed heat driver", [])
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    resumed = half["train_losses"] + rest["train_losses"]
    check(resumed == full["train_losses"] and rest["final"] == full["final"],
          f"a resumed run parts from the uninterrupted one: {resumed} vs "
          f"{full['train_losses']}")
    drv15["resume"] = dict(uninterrupted=full["train_losses"],
                           resumed=resumed, bit_equal=True)
    print("[15] adjoint, solvers, checkpoint (card: " + smi + "): "
          + json.dumps({"adjoint_grid400": adj, "serve_grid400": methods,
                        "drivers": drv15,
                        "seconds": time.perf_counter() - t15}))

    # ---- 16. the classification tasks: K1 and K3 at the citation widths,
    # the card's train step against the CPU's, the showcase, the GCN zoo
    t16 = time.perf_counter()
    from ndcn_tpu_torch.data import load_planetoid
    from ndcn_tpu_torch.experiments import dgnn
    from ndcn_tpu_torch.models.gcn_zoo import ZOO
    from ndcn_tpu_torch.train.losses import cross_entropy

    cora = load_planetoid("cora", alpha=0.5, data_dir=os.path.join(root,
                                                                   "data"))
    citeseer = load_planetoid("citeseer", alpha=0.5,
                              data_dir=os.path.join(root, "data"))

    # (a) K1 and K1ᵀ on both graphs, K3 and K3ᵀ on cora's BSR operator
    def k1_both(mat, d, seed):
        """K1 and K1ᵀ (over the transpose CSR) at width d: [3] / [7]'s
        bars, bit-equal repeats, times, the bound, ``torch.sparse.mm``."""
        op = from_scipy_coo(mat, device=dev)
        out = dict(n=op.n, nnz=int(op.cols.shape[0]), d=d,
                   max_row_degree=int(np.diff(mat.indptr).max()),
                   split_rows=int(op.split.long_rows.shape[0]))
        x = torch.as_tensor(np.random.RandomState(seed).randn(op.n, d)
                            .astype(np.float32), device=dev)
        for label, o in (("fwd", op), ("transpose", op.transpose())):
            a = library_csr(o)
            out[label], _ = spmv_record(
                f"K1 {label} n={o.n} d={d}", o, d,
                lambda: coo_spmv.coo_spmv(o, x),
                lambda: coo_spmv.coo_spmv_plain(o.rows, o.cols, o.vals, x,
                                                o.n),
                lambda: torch.sparse.mm(a, x), x)
        return out

    k1_cite = {f"cora_d{d}": k1_both(cora.operator, d, 40 + d)
               for d in (7, 16, 1433)}
    k1_cite.update({f"citeseer_d{d}": k1_both(citeseer.operator, d, 50 + d)
                    for d in (6, 16, 3703)})
    k3_cite = {f"cora_d{d}": k3_case(cora.operator, d, 60 + d)
               for d in (7, 16, 1433)}
    torch.cuda.empty_cache()

    # (b) one cora differential_gcn step on the card and on the CPU
    def cora_step(device, fmt):
        model = init_ndcn(torch.Generator().manual_seed(0), 1433, 16, 7,
                          encoder_layers=1, device=device)
        op = as_operator(cora.operator, sparse=fmt != "dense", format=fmt,
                         device=device)
        x = torch.as_tensor(cora.features, device=device)
        idx = torch.as_tensor(cora.idx_train, device=device).long()
        labels = torch.as_tensor(cora.labels, device=device).long()
        vt = np.linspace(0, 2.0, 5).astype(np.float32)
        t0 = time.perf_counter()
        out, stats = ndcn_forward(model, op, vt, x, rtol=0.1, atol=0.1,
                                  method="dopri5", terminal=True,
                                  max_steps=64)
        loss = cross_entropy(out[idx], labels[idx])
        loss.backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
        check(stats.success, f"cora {fmt} step failed on {device}")
        return dict(loss=float(loss.detach()), nfe=stats.nfe,
                    ms=(time.perf_counter() - t0) * 1e3,
                    grads={n: p.grad.cpu() for n, p in
                           model.named_parameters()})

    steps16 = {}
    for fmt, needed in (("dense", []), ("coo", ["coo_spmv"]),
                        ("bsr", ["bsr_spmm"])):
        cora_step(dev, fmt)                                  # warm
        kernels.reset_launch_counts()
        gpu = cora_step(dev, fmt)
        counts = add_launches(f"the cora {fmt} step", needed)
        cpu = cora_step(torch.device("cpu"), fmt)
        grad_err = max(rel_l1(gpu["grads"][k], v)
                       for k, v in cpu["grads"].items())
        loss_err = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
        check(loss_err <= 1e-4 and grad_err <= 1e-3
              and gpu["nfe"] == cpu["nfe"],
              f"cora {fmt} step, card vs CPU: loss {loss_err}, gradients "
              f"{grad_err}, NFE {gpu['nfe']} vs {cpu['nfe']}")
        steps16[fmt] = dict(loss_rel_err=loss_err, max_grad_rel_l1=grad_err,
                            nfe=gpu["nfe"], ms=gpu["ms"], cpu_ms=cpu["ms"],
                            launches={k: v for k, v in counts.items() if v})

    # (c) the showcase: the recipe of results/showcase_cora_100.json
    # (README.md:64) through the driver, in process
    recipe = ["--model", "differential_gcn", "--iter", "1", "--dropout", "0",
              "--hidden", "256", "--T", "1.2", "--time_tick", "16",
              "--epochs", "100", "--weight_decay", "0.024", "--no_control",
              "--method", "dopri5", "--alpha", "0", "--fastmode",
              "--data_dir", os.path.join(root, "data")]

    def driver(what, needed, *argv):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = dgnn.run(dgnn.build_parser().parse_args(list(argv)))
        torch.cuda.synchronize()
        counts = add_launches(what, needed)
        check(np.isfinite(out["rows"][-1][1]), f"{what}: test loss "
              f"{out['rows'][-1][1]}")
        return dict(test_acc=out["rows"][-1][2], test_loss=out["rows"][-1][1],
                    seconds=time.perf_counter() - t0,
                    first_loss=out["train_losses"][0],
                    last_loss=out["train_losses"][-1],
                    max_steps=out.get("max_steps"),
                    launches={k: v for k, v in counts.items() if v}), out

    # the driver on its own defaults (hidden 16, dropout 0.5, T 2, 200
    # epochs): not the showcase's recipe, so no accuracy bar
    rec, out = driver("the cora driver on its defaults", [], "--dataset",
                      "cora", "--model", "differential_gcn", "--seed", "0",
                      "--data_dir", os.path.join(root, "data"))
    show = {"cora_defaults_seed0": rec}
    falls(out["train_losses"], "the cora driver on its defaults")
    for seed in (0, 1, 2):
        show[f"cora_dense_seed{seed}"], _ = driver(
            f"the cora showcase, seed {seed}", [], "--dataset", "cora",
            *recipe, "--seed", str(seed))
    accs = [show[f"cora_dense_seed{s}"]["test_acc"] for s in (0, 1, 2)]
    mean_acc = float(np.mean(accs))
    # results/showcase_cora_100.json: mean 0.8317, std 0.0098 over 100
    # models (a TPU run: the bar is its mean ± 3 standard errors of 3)
    band = (0.8317 - 3 * 0.0098 / np.sqrt(3), 0.8317 + 3 * 0.0098 / np.sqrt(3))
    check(band[0] <= mean_acc <= band[1], f"cora showcase mean accuracy "
          f"{mean_acc} ({accs}) outside {band}")
    for label, extra, needed in (("cora_coo_seed0", ["--sparse"],
                                  ["coo_spmv"]),
                                 ("cora_bsr_seed0", ["--sparse",
                                                     "--sparse_format",
                                                     "bsr"], ["bsr_spmm"])):
        show[label], out = driver(f"the cora showcase {label}", needed,
                                  "--dataset", "cora", *recipe, "--seed",
                                  "0", *extra)
        falls(out["train_losses"], f"the cora showcase {label}")
    show["citeseer_dense_seed0"], _ = driver(
        "the citeseer showcase", [], "--dataset", "citeseer", *recipe,
        "--seed", "0")
    cite_band = (0.7065 - 3 * 0.0061, 0.7065 + 3 * 0.0061)
    check(cite_band[0] <= show["citeseer_dense_seed0"]["test_acc"]
          <= cite_band[1], f"citeseer showcase accuracy "
          f"{show['citeseer_dense_seed0']['test_acc']} outside {cite_band}")

    # (d) the GCN zoo through the driver on cora with --sparse (K1 at 7,
    # 16 and 1433 inside training); DeepGCN3 dense, 50 epochs
    zoo = {}
    base = ["--dataset", "cora", "--seed", "0", "--data_dir",
            os.path.join(root, "data")]
    for name in ZOO:
        extra = (["--epochs", "50", "-nhl", "2"] if name == "DeepGCN3" else
                 ["--sparse", "--epochs", "200"]
                 + ([] if name in ("GCN", "DeepGCN2") else ["-nhl", "2"])
                 + (["--Euler"] if name == "resGCN" else []))
        zoo[name], out = driver(
            f"the {name} driver", [] if name == "DeepGCN3" else ["coo_spmv"],
            "--model", name, *base, *extra)
        falls(out["train_losses"], f"the {name} driver")
    t0 = time.perf_counter()
    gcn_cpu = dgnn.run(dgnn.build_parser().parse_args(
        ["--model", "GCN", *base, "--sparse", "--epochs", "200",
         "--platform", "cpu"]))
    zoo["GCN"]["cpu_test_acc"] = gcn_cpu["rows"][-1][2]
    zoo["GCN"]["cpu_seconds"] = time.perf_counter() - t0
    check(abs(zoo["GCN"]["test_acc"] - zoo["GCN"]["cpu_test_acc"]) <= 0.02,
          f"GCN on the card {zoo['GCN']['test_acc']} against the CPU "
          f"{zoo['GCN']['cpu_test_acc']}")
    print("[16] classification (card: " + smi + "): " + json.dumps({
        "k1_citation": k1_cite, "k3_cora": k3_cite,
        "cora_step_card_vs_cpu": steps16, "showcase": show,
        "cora_mean_acc_seeds_0_2": mean_acc, "cora_band": band,
        "citeseer_band": cite_band, "zoo": zoo,
        "seconds": time.perf_counter() - t16}))
    torch.cuda.empty_cache()

    # ---- p. where the time goes
    for label, srv, x0 in (("grid400", server, fx["x0"]),
                           ("200k", server_big, requests[0])):
        print(f"[p] serve {label}: " + json.dumps(
            profile_call(lambda: srv(x0), f"serve_{label}", root)))

    def one_step(model, op, vt, x0, target, fused, max_steps, layout="auto",
                 wide=False, bf16=False):
        opt = torch_adam(model.parameters(), 0.01, 1e-3)

        def loss_fn():
            out, _ = ndcn_forward(model, op, vt, x0, fused=fused,
                                  max_steps=max_steps, layout=layout,
                                  **train_kw)
            loss = l1_loss(out, target)
            return loss, loss

        step = make_sgd_step(opt, loss_fn)

        def in_mode():
            with gather_mode(wide, bf16):
                return step()

        return in_mode

    big = (op_big, t_train, x0_big, target_big, False, budget)
    step_launches = {}   # the kernels' launches in one steady train step
    for label, args, mode in (
            ("grid400_dense", (op_g, gx["t"], x0_g, target_g, "auto", 64), {}),
            ("grid400_bsr_k3", (op_gb, gx["t"], x0_g, target_g, False, 64),
             {}),
            ("grid400_bsr_k4", (op_gb, gx["t"], x0_g, target_g, True, 64),
             {}),
            ("200k_coo", big, {}),
            ("200k_coo_bf16", big, dict(bf16=True)),
            ("200k_fm_wide", big, dict(layout="feature_major", wide=True)),
            ("1m_feature_major", (prob.op, prob.t_train, prob.x0, target_1m,
                                  False, budget_1m), {})):
        model = (params_from_jax(g_tree, device=dev) if "grid" in label
                 else copy.deepcopy(model_1m if "1m" in label else model_p))
        step = one_step(model, *args, **mode)
        step()
        kernels.reset_launch_counts()
        step()
        torch.cuda.synchronize()
        step_launches[label] = kernels.launch_counts()
        print(f"[p] train {label}: " + json.dumps(
            dict(profile_call(step, f"train_{label}", root),
                 launches_per_step=step_launches[label])))

    # one steady cora differential_gcn epoch (the driver's defaults:
    # hidden 16, dropout 0.5, T 2, tick 5, rtol = atol = 0.1; train step,
    # eval re-forward, the five statistics read once) on each format
    epoch_launches = {}
    x_c = torch.as_tensor(cora.features, device=dev)
    lab_c = torch.as_tensor(cora.labels, device=dev).long()
    idx_tr = torch.as_tensor(cora.idx_train, device=dev).long()
    idx_va = torch.as_tensor(cora.idx_val, device=dev).long()
    vt_c = np.linspace(0, 2.0, 5).astype(np.float32)
    for fmt in ("dense", "coo", "bsr"):
        op_c = as_operator(cora.operator, sparse=fmt != "dense", format=fmt,
                           device=dev)
        model = init_ndcn(torch.Generator().manual_seed(0), 1433, 16, 7,
                          encoder_layers=1, device=dev)
        kw = dict(rtol=0.1, atol=0.1, method="dopri5", terminal=True)
        ms_c = probe_step_budget(
            lambda: ndcn_forward(model, op_c, vt_c, x_c, nondiff=True,
                                 max_steps=1 << 14, **kw)[1],
            floor=8, headroom=2.5, slack=4, quantum=4)
        opt = torch_adam(model.parameters(), 0.01, 5e-4)
        gen = torch.Generator().manual_seed(1)

        def epoch():
            opt.zero_grad(set_to_none=True)
            out, _ = ndcn_forward(model, op_c, vt_c, x_c, dropout=0.5,
                                  rng=gen, max_steps=ms_c, **kw)
            loss = cross_entropy(out[idx_tr], lab_c[idx_tr])
            loss.backward()
            opt.step()
            with torch.no_grad():
                ev, _ = ndcn_forward(model, op_c, vt_c, x_c, max_steps=ms_c,
                                     **kw)
                return torch.stack([
                    loss.detach(), cross_entropy(ev[idx_tr], lab_c[idx_tr]),
                    (ev[idx_tr].argmax(-1) == lab_c[idx_tr]).float().mean(),
                    cross_entropy(ev[idx_va], lab_c[idx_va]),
                    (ev[idx_va].argmax(-1) == lab_c[idx_va]).float().mean(),
                ]).cpu()

        epoch()
        kernels.reset_launch_counts()
        epoch()
        torch.cuda.synchronize()
        epoch_launches[fmt] = kernels.launch_counts()
        print(f"[p] cora differential_gcn epoch {fmt}: " + json.dumps(
            dict(profile_call(epoch, f"epoch_cora_{fmt}", root),
                 max_steps=ms_c, launches_per_epoch=epoch_launches[fmt])))

    def per_step(name):
        """The most launches of ``name`` in one steady train step of any
        setting above, and that setting (0 and None for a tool's kernel)."""
        label = max(step_launches, key=lambda k: step_launches[k][name])
        count = step_launches[label][name]
        return {"launches_per_step": count,
                "step_of": label if count else None}

    def per_epoch(name):
        """Launches of ``name`` in one steady cora epoch, by format."""
        return {fmt: c[name] for fmt, c in epoch_launches.items()}

    def citation_cases(cases):
        """[16] a's cases of one kernel: each shape's forward and transpose
        times, bound and library time."""
        keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_device_ms")
        return {label: dict(n=c["n"], d=c["d"], **{
            part: {k: c[part].get(k) for k in keys}
            for part in ("fwd", "transpose")}) for label, c in cases.items()}

    # ---- records
    def entry(name, src, replaces, fwd, bwd=None, **extra):
        """One kernel's line: its launches on the main paths and in one
        steady train step, and the forward case's error, times and bound
        (and the backward case's, as ``bwd_*``)."""
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms", "library_device_ms")
        rec = {"name": name, "route": "cuda",
               "source": f"ndcn_tpu_torch/csrc/{src}", "replaces": replaces,
               "launches": main_launches[name], **per_step(name),
               **{k: fwd.get(k) for k in keys}}
        if bwd is not None:
            rec.update({f"bwd_{k}": bwd.get(k) for k in keys})
        return dict(rec, **extra)

    # the sliced-tile reduce reads the gathered slots, their local rows and
    # values, and writes the padded (d_sub, n) result; the row gather reads
    # and writes rows × k floats and reads the indices
    d_sub_mb = coo_spmv.sublane_pad(mb["d"])
    slots = mb["slices"] * mb["E"]
    # the two kernels once more at the tools' sizes (the packing of the
    # tool's own edge list), queued behind a spin kernel: their device time
    rs = np.random.RandomState(0)
    tiles = sparse_bench.pack_sliced_tiles(
        np.sort(rs.randint(0, mb["n"], size=mb["nnz"])).astype(np.int32),
        rs.randint(0, mb["n"], size=mb["nnz"]).astype(np.int32),
        rs.rand(mb["nnz"]).astype(np.float32), mb["n"], device=dev)
    gathered = torch.rand((d_sub_mb, tiles.cols.shape[0]), device=dev)
    x_pr = torch.rand((probe["m"], probe["k"]), device=dev)
    idx_pr = torch.as_tensor(rs.randint(0, probe["m"], probe["rows"])
                             .astype(np.int32), device=dev)
    idx64_pr = idx_pr.long()
    p1a_out = sparse_bench.sliced_tile_reduce(tiles, gathered)
    check(torch.equal(p1a_out, sparse_bench.sliced_tile_reduce(tiles,
                                                                gathered)),
          "P1a: two calls differ")
    check(max_rel(p1a_out, sparse_bench.sliced_tile_reduce_plain(
        tiles, gathered))[1] <= 1e-5, "P1a disagrees with its plain version")
    del p1a_out
    p1a = dict(max_abs_err=mb["sliced_reduce_max_abs_err"],
               rel_err=mb["sliced_reduce_kernel_vs_plain"], repeat_equal=True,
               # the tool's [6]: the minor gather yT[:, slot_cols], then the
               # reduce, kernel and plain
               spmv_e2e_ms=mb["sliced_spmv_kernel_ms"],
               spmv_e2e_plain_ms=mb["sliced_spmv_plain_ms"],
               device_ms=queued_ms(
                   lambda: sparse_bench.sliced_tile_reduce(tiles, gathered)),
               library_device_ms=queued_ms(
                   lambda: sparse_bench.sliced_tile_reduce_plain(tiles,
                                                                 gathered)),
               ms=mb["sliced_reduce_kernel_ms"],
               plain_ms=mb["sliced_reduce_plain_ms"],
               library_ms=mb["sliced_reduce_plain_ms"],
               **bound(slots * (d_sub_mb * 4 + 8)
                       + d_sub_mb * -(-mb["n"] // mb["R"]) * mb["R"] * 4,
                       2 * slots * d_sub_mb))
    p1b = dict(max_abs_err=mb["row_gather_max_abs_err"],
               device_ms=queued_ms(
                   lambda: sparse_bench.row_gather(x_pr, idx_pr)),
               # the launch floor: the spin kernel for 0 cycles, queued alike
               empty_kernel_device_ms=queued_ms(
                   lambda: torch.cuda._sleep(0)),
               library_device_ms=queued_ms(
                   lambda: torch.index_select(x_pr, 0, idx64_pr)),
               ms=probe["kernel_us"] / 1e3, plain_ms=probe["index_us"] / 1e3,
               library_ms=probe["index_select_us"] / 1e3,
               **bound(probe["rows"] * (2 * probe["k"] * 4 + 4), 0))
    K1 = "ndcn_tpu/kernels/coo_spmv.py:159"
    print(json.dumps({"kernels": [
        entry("coo_spmv", "coo_spmv.cu", K1, k1_main, k1t,
              citation=citation_cases(k1_cite),
              launches_per_cora_epoch=per_epoch("coo_spmv")),
        entry("fused_rhs", "fused_rhs.cu", "ndcn_tpu/kernels/fused_rhs.py:30",
              k2_main, k2b),
        entry("bsr_spmm", "bsr_spmm.cu", "ndcn_tpu/kernels/bsr_spmm.py:91",
              k3["grid400_d20"]["fwd"], k3["grid400_d20"]["transpose"],
              citation=citation_cases(k3_cite),
              launches_per_cora_epoch=per_epoch("bsr_spmm")),
        entry("bsr_fused_rhs", "bsr_spmm.cu",
              "ndcn_tpu/kernels/bsr_spmm.py:176", k4["grid400_d20"]["fwd"],
              k4["grid400_d20"]["bwd"]),
        entry("coo_spmv_bf16", "coo_spmv.cu",
              "ndcn_tpu/kernels/coo_spmv.py:172",
              k11["k1_bf16_200k"]["fwd"], k11["k1_bf16_200k"]["transpose"]),
        # the Pallas kernel at :159, reached through _spmv_T (:322)
        entry("coo_spmv_T", "coo_spmv_T.cu", K1, k11["k1fm_f32_1m"]["fwd"],
              k11["k1fm_f32_1m"]["transpose"],
              reached_through="ndcn_tpu/kernels/coo_spmv.py:322"),
        entry("coo_spmv_T_pack", "coo_spmv_T.cu", K1, k11["pack_f32_1m"],
              reached_through="ndcn_tpu/kernels/coo_spmv.py:322"),
        entry("coo_spmv_T_wide", "coo_spmv_T.cu",
              "ndcn_tpu/kernels/coo_spmv.py:207", k11["k5_f32_1m"]["fwd"],
              k11["k5_f32_1m"]["transpose"]),
        # the Pallas kernel at coo_spmv.py:314, driven with per-edge weights
        # by the mutualistic interaction: at d = 1 its edge form (the warp
        # form, coo_mutual.cu, takes d > 8); launches of either form, and
        # of the edge form alone
        entry("coo_mutual", "coo_mutual_edges.cu",
              "ndcn_tpu/dynamics/rhs.py:109",
              k1w["50k_d1"]["fwd"], k1w["50k_d1"]["bwd"],
              pallas_site="ndcn_tpu/kernels/coo_spmv.py:314",
              edge_form_launches=main_launches["coo_mutual_edges"],
              warp_form_source="ndcn_tpu_torch/csrc/coo_mutual.cu",
              launches_per_ground_truth=c_mut["coo_mutual"]),
        entry("sliced_tile_reduce", "sparse_bench.cu",
              "tools/microbench_sparse.py:235", p1a,
              spmv_e2e_ms=p1a["spmv_e2e_ms"],
              spmv_e2e_plain_ms=p1a["spmv_e2e_plain_ms"]),
        entry("row_gather", "sparse_bench.cu",
              "tools/microbench_sparse.py:288", p1b,
              also_replaces="tools/probe_inkernel_gather.py:60",
              empty_kernel_device_ms=p1b["empty_kernel_device_ms"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
