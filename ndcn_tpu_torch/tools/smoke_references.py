"""The CPU references ``chip_smoke.py`` holds the card against in [15] b,
[16] b / d, [17] b / d and [21] a, computed once on the CPU and kept as a
fixture, so that the smoke's call spends no time on them:

- [15] b: the grid400 dense serving problem (the ``ndcn_forward_grid400``
  weights and x0) served on the CPU with tsit5, adams, fixed_adams and
  explicit_adams: the answer, its success flag and NFE, and the same solve
  in float64 (its float32-vs-float64 rel-L1, the bar's second term);
- [21] a: the heat driver's replica step at R = 4 (grid400, T 5, tick
  100, explicit_adams tick 20, irregular, seed 0; replica i seeded i) on
  each of [21]'s settings:
  the first step's losses, gradients and NFE on the CPU (the plain
  versions of the kernels), and the gradients of the same step in
  float64 on the dense unfused route;
- [16] b: one cora differential_gcn step (``cora_step``) on dense, COO and
  BSR: its loss, NFE and gradients; [16] d: the GCN driver's test
  accuracy after 100 epochs on cora with ``--sparse``;
- [17] b: one train step of each temporal baseline (``temporal_step``,
  lstm / gru / rnn on dense, COO and BSR) on the heat driver's grid400
  data: its loss and gradients;
- [17] d: the LV demo's first 20 train losses, rk4 and dopri5
  ``--adjoint``;
- [24] a / b: the first bounded train step (the solve's ``scan`` option)
  of one model (seed 0) on the heat driver's grid400 data at each of
  [24]'s settings (``SCAN_SETTINGS``: adams and explicit_adams, the
  continuous adjoint with dopri5 on dense, COO and BSR and with adams, the
  adjoint's on a grid cut to fewer train points): its loss, NFE and
  gradients on the CPU.

``cora_step``, ``temporal_step`` and ``scan_step`` are the steps the
smoke also runs on the card.

    python -m ndcn_tpu_torch.tools.smoke_references [--out PATH]

writes ``tests/fixtures/smoke_cpu_references.npz`` (compressed). Rerun it
after a change that moves the port's CPU arithmetic on these paths:
``tests/test_torch_smoke_references.py`` recomputes the cheapest entries
and fails when the fixture is stale.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PATH = os.path.join(ROOT, "tests", "fixtures", "smoke_cpu_references.npz")

SERVE_METHODS = ("tsit5", "adams", "fixed_adams", "explicit_adams")
R = 4
# [21] a's settings: format, fused, method, adjoint
REPLICA_SETTINGS = {
    "adams_dense": ("dense", "auto", "adams", False),
    "fixed_adams_dense": ("dense", "auto", "fixed_adams", False),
    "explicit_adams_dense": ("dense", "auto", "explicit_adams", False),
    "dopri5_adjoint_dense": ("dense", "auto", "dopri5", True),
    "dopri5_adjoint_coo": ("coo", False, "dopri5", True),
    "dopri5_adjoint_bsr": ("bsr", "auto", "dopri5", True),
    "adams_adjoint_dense": ("dense", "auto", "adams", True),
}
# [21] a's --time_tick where it is not the heat driver's 100: explicit_adams
# diverges on this model from tick 40 on (see ``SCAN_SETTINGS``)
REPLICA_TIME_TICK = {"explicit_adams_dense": 20}


# [24]'s settings: format, fused, method, adjoint, the heat driver's
# --time_tick, max_steps. The grids are cut from the driver's tick 100 (80
# train points) where a graph would hold too many attempts: adams at tick
# 20 (~19 of 32 live), the adjoint at tick 6 (4 intervals, each with the
# whole budget: 12 for dopri5, the driver's auto budget there, 16 for
# adams). explicit_adams (one step a grid interval, its order rising to
# 12) at tick 20 too: from tick 40 on its solve of this model diverges
# (loss 276 at tick 40, 5.6e6 at tick 100, where adams' is ~3.8), and
# float32's rounding, grown with it, moves its gradients by up to 8%
# (enc1.weight, tick 100) from float64's; at tick 20 the two are within
# 1.7e-6 rel-L1 and the bar is the others' 1e-3
SCAN_SETTINGS = {
    "adams_dense": ("dense", "auto", "adams", False, 20, 32),
    "explicit_adams_dense": ("dense", "auto", "explicit_adams", False, 20,
                             256),
    "dopri5_adjoint_dense": ("dense", "auto", "dopri5", True, 6, 12),
    "dopri5_adjoint_coo": ("coo", False, "dopri5", True, 6, 12),
    "dopri5_adjoint_bsr": ("bsr", "auto", "dopri5", True, 6, 12),
    "adams_adjoint_dense": ("dense", "auto", "adams", True, 6, 16),
}


def rel_l1(a, b) -> float:
    """chip_smoke.py's rel-L1."""
    return float((a - b).abs().mean() / (b.abs().mean() + 1e-12))


def serving_problem():
    """([15] b) the grid400 serving model on the CPU, its dense operator,
    the grid and the first request."""
    from ndcn_tpu_torch.convert import params_from_jax
    from ndcn_tpu_torch.graph.generators import build_network
    from ndcn_tpu_torch.graph.operators import normalized_laplacian
    from ndcn_tpu_torch.graph.sparse import from_dense

    fx = dict(np.load(os.path.join(ROOT, "tests", "fixtures",
                                   "ndcn_forward_grid400.npz")))
    tree = {name: {"w": fx[f"{name}_w"].T, "b": fx[f"{name}_b"]}
            for name in ("enc1", "enc2", "wt", "dec")}
    op = from_dense(normalized_laplacian(build_network("grid", 400)))
    return params_from_jax(tree), op, fx["t"], fx["x0"]


def serve_reference(method: str) -> Dict[str, np.ndarray]:
    from ndcn_tpu_torch.graph.sparse import DenseGraph
    from ndcn_tpu_torch.models import ndcn_forward
    from ndcn_tpu_torch.serve import make_server

    model, op, t, x0 = serving_problem()
    kw = dict(rtol=0.01, atol=0.001, method=method, fused="auto")
    srv = make_server(model, op, t, **kw)
    out, ok = srv(x0)
    with torch.no_grad():
        out64, _ = ndcn_forward(
            copy.deepcopy(model).double(), DenseGraph(op.mat.double()), t,
            torch.as_tensor(x0, dtype=torch.float64), nondiff=True,
            **dict(kw, fused=False))
    return {"out": out.numpy(), "ok": np.bool_(ok),
            "nfe": np.int64(srv.last_stats.nfe),
            "f32_vs_f64": np.float64(rel_l1(out.double(), out64))}


def heat_replica_problem(time_tick: int = 100):
    """([21] a, [18] b, [23] and [24]) the heat driver's grid400 problem on
    the CPU at its ``--time_tick``: the normalized Laplacian, the train
    grid, x0 and the target."""
    from ndcn_tpu_torch.experiments.dynamics import heat_ground_truth
    from ndcn_tpu_torch.graph.generators import (build_network,
                                                 grid_block_initial_value)
    from ndcn_tpu_torch.graph.operators import (laplacian_dense,
                                                normalized_laplacian)
    from ndcn_tpu_torch.graph.sparse import as_operator
    from ndcn_tpu_torch.train.sampling import sample_times

    adj = build_network("grid", 400)
    hs = sample_times(5.0, time_tick, "irregular", seed=0)
    x0 = torch.as_tensor(grid_block_initial_value(20).astype(np.float32))
    sol, _ = heat_ground_truth(as_operator(laplacian_dense(adj)), x0, hs.t)
    return normalized_laplacian(adj), hs.t[hs.id_train], x0, \
        sol[hs.id_train]


def first_grads(op, fused, method: str, adjoint: bool, problem,
                dtype=torch.float32):
    """The first step of the heat driver's replica step over R replicas
    (replica i seeded i) on the CPU: (losses, gradients, stats)."""
    from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
    from ndcn_tpu_torch.ode import nan_unless
    from ndcn_tpu_torch.parallel.sweep import replica_l1, stack_models

    _, t_h, x0_h, target_h = problem
    model = stack_models([init_ndcn(torch.Generator().manual_seed(s), 1, 20,
                                    1) for s in range(R)]).to(dtype)
    out, stats = ndcn_forward(model, op, t_h, x0_h.to(dtype), method=method,
                              fused=fused, adjoint=adjoint, max_steps=256,
                              rtol=0.01, atol=0.001)
    losses = nan_unless(stats.success, replica_l1(out.transpose(0, 1),
                                                  target_h.to(dtype)))
    losses.sum().backward()
    return losses.detach(), [p.grad for p in model.parameters()], stats


def replica_reference(label: str, problem) -> Dict[str, np.ndarray]:
    import scipy.sparse as sp

    from ndcn_tpu_torch.graph.sparse import as_operator, from_dense

    fmt, fused, method, adjoint = REPLICA_SETTINGS[label]
    lap = problem[0]
    mat = sp.csr_matrix(lap) if fmt != "dense" else lap
    op = as_operator(mat, sparse=fmt != "dense", format=fmt)
    loss, grads, stats = first_grads(op, fused, method, adjoint, problem)
    _, grads64, _ = first_grads(from_dense(lap, dtype=torch.float64), False,
                                method, adjoint, problem, torch.float64)
    out = {"loss": loss.numpy(), "nfe": np.array(stats.nfe, np.int64)}
    for i, (g, g64) in enumerate(zip(grads, grads64)):
        out[f"grad{i}"] = g.numpy()
        out[f"grad64_{i}"] = g64.numpy()
    return out


def scan_step(label: str, device, problem) -> dict:
    """[24]'s first bounded train step of ``label`` (``SCAN_SETTINGS``) on
    ``device``: one model (seed 0), its loss, NFE and gradients by
    parameter name."""
    import scipy.sparse as sp

    from ndcn_tpu_torch.graph.sparse import as_operator
    from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
    from ndcn_tpu_torch.train.losses import l1_loss

    fmt, fused, method, adjoint, _, max_steps = SCAN_SETTINGS[label]
    lap, t_h, x0, target = problem
    op = as_operator(sp.csr_matrix(lap) if fmt != "dense" else lap,
                     sparse=fmt != "dense", format=fmt, device=device)
    model = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1).to(device)
    out, stats = ndcn_forward(
        model, op, torch.as_tensor(t_h, dtype=torch.float32, device=device),
        x0.to(device), method=method, fused=fused, adjoint=adjoint,
        max_steps=max_steps, scan=True, rtol=0.01, atol=0.001)
    loss = l1_loss(out[..., 0].T, target[..., 0].T.to(device))
    loss.backward()
    if not bool(stats.success):
        raise RuntimeError(f"[24] {label}: the bounded step ran out of its "
                           f"{max_steps} attempts")
    return {"loss": float(loss.detach()), "nfe": int(stats.nfe),
            "grads": {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()}}


def scan_reference(label: str, problem) -> Dict[str, np.ndarray]:
    return _step_entry(scan_step(label, torch.device("cpu"), problem))


def data_dir() -> str:
    return os.path.join(ROOT, "data")


def load_cora():
    from ndcn_tpu_torch.data import load_planetoid

    return load_planetoid("cora", alpha=0.5, data_dir=data_dir())


CORA_FORMATS = ("dense", "coo", "bsr")


def cora_step(device, fmt: str, cora) -> dict:
    """([16] b) one differential_gcn step on cora from seed 0's weights
    (hidden 16, T 2 in 5 ticks, dopri5 at rtol = atol = 0.1, terminal):
    its loss, NFE, wall ms and gradients (CPU tensors by name)."""
    from ndcn_tpu_torch.graph.sparse import as_operator
    from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
    from ndcn_tpu_torch.train.losses import cross_entropy

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
                              method="dopri5", terminal=True, max_steps=64)
    loss = cross_entropy(out[idx], labels[idx])
    loss.backward()
    if device.type == "cuda":
        torch.cuda.synchronize()
    if not stats.success:
        raise RuntimeError(f"cora {fmt} step failed on {device}")
    return dict(loss=float(loss.detach()), nfe=stats.nfe,
                ms=(time.perf_counter() - t0) * 1e3,
                grads={n: p.grad.cpu() for n, p in model.named_parameters()})


def gcn_driver_accuracy() -> float:
    """([16] d) the dgnn driver's GCN on cora with ``--sparse``, 100
    epochs, seed 0, on the CPU: the last row's test accuracy."""
    from ndcn_tpu_torch.experiments import dgnn

    out = dgnn.run(dgnn.build_parser().parse_args(
        ["--model", "GCN", "--dataset", "cora", "--seed", "0", "--data_dir",
         data_dir(), "--sparse", "--epochs", "100", "--platform", "cpu"]))
    return float(out["rows"][-1][2])


RNN_TYPES = ("lstm", "gru", "rnn")


def temporal_problem():
    """([17] b) the grid400 Kipf operator and the heat driver's train
    observations (n, T) (T 5, tick 100, irregular, seed 0)."""
    from ndcn_tpu_torch.graph.generators import build_network
    from ndcn_tpu_torch.graph.operators import zipf_smoothing

    _, _, _, target = heat_replica_problem()
    return (zipf_smoothing(build_network("grid", 400)),
            target[..., 0].T.contiguous())


def temporal_step(rnn_type: str, fmt: str, device, problem,
                  launch_counts=None) -> dict:
    """([17] b) one train step of the ``rnn_type`` baseline (5 graph and 10
    recurrent units, seed 0) one step ahead over the train grid: its loss,
    wall ms, gradients (CPU tensors by name) and, with ``launch_counts``
    (a callable), the counts it returns after the forward."""
    from ndcn_tpu_torch.graph.sparse import as_operator
    from ndcn_tpu_torch.models import init_temporal_gcn, temporal_gcn_forward
    from ndcn_tpu_torch.train.losses import l1_loss

    kipf, y_train = problem
    model = init_temporal_gcn(torch.Generator().manual_seed(0), 1, 5, 400,
                              10, rnn_type, device=device)
    op = as_operator(kipf, sparse=fmt != "dense", format=fmt, device=device)
    y = y_train.to(device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = temporal_gcn_forward(model, op, y[:, :-1], rnn_type)
    loss = l1_loss(pred, y[:, 1:])
    fwd = launch_counts() if launch_counts is not None else None
    loss.backward()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return dict(loss=float(loss.detach()), fwd_counts=fwd,
                ms=(time.perf_counter() - t0) * 1e3,
                grads={n: p.grad.cpu() for n, p in model.named_parameters()})


LV_RUNS = {"rk4": ["--method", "rk4"],
           "dopri5_adjoint": ["--method", "dopri5", "--adjoint"]}


def lv_losses(label: str) -> np.ndarray:
    """([17] d) the LV demo's first 20 train losses on the CPU."""
    from ndcn_tpu_torch.experiments import lv

    out = lv.main(["--niters", "20", "--platform", "cpu", *LV_RUNS[label]])
    return np.asarray(out["train_losses"], np.float64)


def _step_entry(rec: dict) -> Dict[str, np.ndarray]:
    out = {"loss": np.float64(rec["loss"])}
    if rec.get("nfe") is not None:
        out["nfe"] = np.int64(rec["nfe"])
    out.update({f"grad/{n}": g.numpy() for n, g in rec["grads"].items()})
    return out


def step_grads(ref: Dict[str, np.ndarray], key: str) -> dict:
    """A step entry's gradients as CPU tensors by name."""
    head = f"{key}/grad/"
    return {k[len(head):]: torch.as_tensor(v) for k, v in ref.items()
            if k.startswith(head)}


def compute(keys: Optional[Sequence[str]] = None,
            log=print) -> Dict[str, np.ndarray]:
    """The references as flat npz keys ``serve/<method>/...``,
    ``replicas/<label>/...``, ``cora/<fmt>/...``, ``gcn_driver/...``,
    ``temporal/<rnn>_<fmt>/...``, ``lv/<label>/...`` and
    ``scan/<label>/...``; ``keys`` limits them to those settings."""
    out: Dict[str, np.ndarray] = {}
    problems = {}    # the heat driver's grid400 problem by --time_tick

    def heat(tick: int):
        if tick not in problems:
            problems[tick] = heat_replica_problem(tick)
        return problems[tick]

    for method in SERVE_METHODS:
        if keys is None or f"serve/{method}" in keys:
            t0 = time.perf_counter()
            out.update({f"serve/{method}/{k}": v
                        for k, v in serve_reference(method).items()})
            log(f"serve/{method}: {time.perf_counter() - t0:.1f} s")
    for label in REPLICA_SETTINGS:
        if keys is None or f"replicas/{label}" in keys:
            t0 = time.perf_counter()
            problem = heat(REPLICA_TIME_TICK.get(label, 100))
            out.update({f"replicas/{label}/{k}": v
                        for k, v in replica_reference(label,
                                                      problem).items()})
            log(f"replicas/{label}: {time.perf_counter() - t0:.1f} s")
    cora = None
    for fmt in CORA_FORMATS:
        if keys is None or f"cora/{fmt}" in keys:
            t0 = time.perf_counter()
            cora = cora or load_cora()
            out.update({f"cora/{fmt}/{k}": v for k, v in _step_entry(
                cora_step(torch.device("cpu"), fmt, cora)).items()})
            log(f"cora/{fmt}: {time.perf_counter() - t0:.1f} s")
    if keys is None or "gcn_driver" in keys:
        t0 = time.perf_counter()
        out["gcn_driver/test_acc"] = np.float64(gcn_driver_accuracy())
        log(f"gcn_driver: {time.perf_counter() - t0:.1f} s")
    tp = None
    for rnn_type in RNN_TYPES:
        for fmt in CORA_FORMATS:
            key = f"temporal/{rnn_type}_{fmt}"
            if keys is None or key in keys:
                t0 = time.perf_counter()
                tp = tp or temporal_problem()
                out.update({f"{key}/{k}": v for k, v in _step_entry(
                    temporal_step(rnn_type, fmt, torch.device("cpu"),
                                  tp)).items()})
                log(f"{key}: {time.perf_counter() - t0:.1f} s")
    for label in LV_RUNS:
        if keys is None or f"lv/{label}" in keys:
            t0 = time.perf_counter()
            out[f"lv/{label}/train_losses"] = lv_losses(label)
            log(f"lv/{label}: {time.perf_counter() - t0:.1f} s")
    for label, setting in SCAN_SETTINGS.items():
        if keys is None or f"scan/{label}" in keys:
            t0 = time.perf_counter()
            out.update({f"scan/{label}/{k}": v for k, v in scan_reference(
                label, heat(setting[4])).items()})
            log(f"scan/{label}: {time.perf_counter() - t0:.1f} s")
    return out


def load(path: str = PATH) -> Dict[str, np.ndarray]:
    with np.load(path) as f:
        return dict(f)


def replica_grads(ref: Dict[str, np.ndarray], label: str,
                  f64: bool = False):
    """[21] a's CPU gradients of ``label`` (float64 with ``f64``) as
    tensors, in the stacked model's parameter order."""
    key = "grad64_" if f64 else "grad"
    grads, i = [], 0
    while f"replicas/{label}/{key}{i}" in ref:
        grads.append(torch.as_tensor(ref[f"replicas/{label}/{key}{i}"]))
        i += 1
    return grads


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("smoke_references")
    ap.add_argument("--out", default=PATH)
    args = ap.parse_args(argv)
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    refs = compute()
    np.savez_compressed(args.out, **refs)
    print(f"wrote {len(refs)} arrays to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
