"""The scale experiment: learn network dynamics on a random sparse graph of
50k-1M nodes, as ``examples/large_graph.py``.

Usage:
    python -m ndcn_tpu_torch.experiments.large_graph --n 1000000 \\
        [--layout {auto,nd,feature_major}] [--kernel_precision {split2,bf16}] \\
        [--emission_precision {f32,bf16}] [--residual_precision {f32,bf16}] \\
        [--roofline] [--hbm_probe] [--estimate] [--gt_cache PATH [--gt_only]] \\
        [--dynamics {heat,mutualistic,gene}] [--fmt {coo,ell}] \\
        [--out PATH] [--platform {gpu,cpu}]

The flow is the JAX example's: ``build_sparse_graph(n, deg, seed)`` → the
normalized Laplacian as a COO (or ``--fmt ell``: ELL) operator, the model's
and the heat physics'; mutualistic and gene couple through the raw
adjacency in the same format (mutualistic needs COO, K1-w) →
``sample_times(T, time_tick, "irregular", seed)`` → x0 ~ U(0, 25) →
ground truth (the inference solve at rtol 1e-6, atol 1e-8) → NDCN from a
``torch.Generator`` → the step budget from a probe of the inference solve
(floor 8, headroom 1.5, slack 2, quantum 4) → ``iters`` train steps after a
first one, with ``ElasticBudget`` rollback checked every 10 iterations → one
JSON line with the JAX record's keys (plus ``solve_layout``, what
``--layout`` resolved to).

``--layout auto`` picks the feature-major (d_sub, n) solve from 500k nodes
on a CUDA COO operator (``models.ndcn.resolve_layout``; an ELL operator
stays in the (n, d) layout). ``--kernel_precision
bf16`` sets ``coo_spmv.GATHER_BF16`` for the run; the emission and residual
levers reach ``ndcn_forward``.

``--estimate`` prints a byte census of the port's train step and exits:
- ``tape``: the autograd tape one step attempt keeps, per node, times n
  and the step budget. The per-node bytes are counted, not modelled: one
  differentiable train forward of the same configuration (layout, levers,
  hidden width, time grid) runs on the CPU at ``_CENSUS_NODES`` nodes under
  ``saved_tensors_hooks``, and the distinct storages it saves are summed and
  divided by nodes × attempts. Every state-sized tensor scales with n, and
  the kernels' ``autograd.Function``s save no per-edge tensor, so the count
  scales. It includes the observations' read-out dense output.
- ``trajectory``: the (T, n, 1) training output.
- ``operator``: the model's operator as held (COO: A's CSR and its
  transpose's).
- ``data``: the target and x0.
The JAX census's other terms (lane padding, scan slots, tile packing)
describe XLA on a TPU and have no counterpart here. The record names the
attempts per step it assumed (``attempts_assumed``, the step budget); the
run's record names the most attempts a train step took (``attempts_taken``).

What the port does not have raises ``NotImplementedError`` naming its
ROADMAP item before any work: ``--mesh`` (item 8), ``--precision high``
(item 4).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

_CENSUS_NODES = 2000


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
    """The flag surface of ``examples/large_graph.py``."""
    ap = argparse.ArgumentParser("large_graph")
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--deg", type=int, default=10)
    ap.add_argument("--dynamics", type=str, default="heat",
                    choices=["heat", "mutualistic", "gene"])
    ap.add_argument("--hidden", type=int, default=20)
    ap.add_argument("--time_tick", type=int, default=40)
    ap.add_argument("--T", type=float, default=5.0)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fmt", type=str, default="coo", choices=["coo", "ell"])
    ap.add_argument("--kernel_precision", type=str, default="split2",
                    choices=["split2", "bf16"],
                    help="split2: fp32 SpMV; bf16: the state and A rounded "
                         "to bf16 in the gather, fp32 sums")
    ap.add_argument("--layout", type=str, default="auto",
                    choices=["auto", "nd", "feature_major"],
                    help="ODE-state layout; auto picks feature_major from "
                         "500k nodes on the card")
    ap.add_argument("--emission_precision", type=str, default="f32",
                    choices=["f32", "bf16"],
                    help="dtype the observations' dense output is rounded "
                         "through")
    ap.add_argument("--residual_precision", type=str, default="f32",
                    choices=["f32", "bf16"],
                    help="dtype the SpMV output is rounded to and kept in on "
                         "the tape")
    ap.add_argument("--gt_cache", type=str, default=None,
                    help="npz of the ground-truth trajectory; loaded if "
                         "present (refused when its run parameters differ), "
                         "written otherwise; readable by both packages")
    ap.add_argument("--gt_only", action="store_true",
                    help="compute (and --gt_cache) the ground truth, then "
                         "exit; requires --gt_cache")
    ap.add_argument("--estimate", action="store_true",
                    help="print the byte census of the train step and exit")
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--roofline", action="store_true",
                    help="after the timed loop, time spmv_T forward and over "
                         "the transpose at this shape and record the step's "
                         "SpMV floor (train/roofline.py)")
    ap.add_argument("--hbm_probe", action="store_true",
                    help="record the step's peak device memory; the caching "
                         "allocator reports it, so no ballast bisection runs")
    ap.add_argument("--out", type=str, default=None,
                    help="also write the record (plus argv) to this path")
    ap.add_argument("--platform", type=str, default="gpu",
                    choices=["gpu", "cpu"],
                    help="gpu: the first CUDA device and the CUDA kernels "
                         "(raises without one); cpu: the plain versions")
    ap.add_argument("--precision", type=str, default="default",
                    choices=["default", "high", "float32", "highest"],
                    help="matmul precision; the port pins full fp32, high "
                         "(TF32) is not ported")
    return ap


def _refuse_unported(args: argparse.Namespace) -> None:
    if args.dynamics == "mutualistic" and args.fmt != "coo":
        # ELL pads every row to the largest degree
        raise SystemExit("mutualistic at this scale requires --fmt coo")
    refused = [
        (args.mesh, "--mesh: ROADMAP item 8"),
        (args.precision == "high", "--precision high (TF32): ROADMAP item 4"),
    ]
    for cond, what in refused:
        if cond:
            raise NotImplementedError(f"not ported yet: {what}")
    if args.gt_only and not args.gt_cache:
        raise SystemExit("--gt_only without --gt_cache computes a trajectory "
                         "nobody keeps; pass --gt_cache")


class Problem(NamedTuple):
    """The run's graph, operators, time grid and initial state."""
    n: int
    nnz: int
    op: Any                 # the model's: the normalized Laplacian
    physics_op: Any         # the ground truth's (op itself for heat)
    splits: Any             # TimeSplits
    t_train: np.ndarray
    x0: torch.Tensor        # (n, 1) on the run's device


def build_problem(args: argparse.Namespace, device: torch.device) -> Problem:
    """The graph, operator, time grid and x0 of ``examples/large_graph.py``
    (same numpy RNG calls, so the same problem for the same seed)."""
    from ndcn_tpu_torch.graph.generators import build_sparse_graph
    from ndcn_tpu_torch.graph.operators import normalized_laplacian_sparse
    from ndcn_tpu_torch.graph.sparse import as_operator
    from ndcn_tpu_torch.train.sampling import sample_times

    t0 = time.time()
    adj = build_sparse_graph(args.n, args.deg, args.seed)
    n = adj.shape[0]
    # the model and the heat physics both propagate through the normalized
    # Laplacian (the JAX example's choice: spectrum in [0, 2], so the
    # explicit solve is not stability-limited); mutualistic and gene couple
    # through the raw adjacency
    lap = normalized_laplacian_sparse(adj)
    op = as_operator(lap, sparse=True, format=args.fmt, device=device)
    physics_op = (op if args.dynamics == "heat" else
                  as_operator(adj, sparse=True, format=args.fmt,
                              device=device))
    log(f"graph: {n:,} nodes, {adj.nnz:,} directed edges "
        f"({time.time() - t0:.1f}s host build, {lap.nnz:,} Laplacian "
        f"entries, {args.fmt})")
    splits = sample_times(args.T, args.time_tick, "irregular", seed=args.seed)
    x0 = np.random.RandomState(args.seed).uniform(
        0.0, 25.0, size=(n, 1)).astype(np.float32)
    return Problem(n=n, nnz=int(adj.nnz), op=op, physics_op=physics_op,
                   splits=splits,
                   t_train=splits.t[splits.id_train],
                   x0=torch.as_tensor(x0, device=device))


def new_model(args: argparse.Namespace, device: torch.device):
    from ndcn_tpu_torch.models import init_ndcn

    return init_ndcn(torch.Generator().manual_seed(args.seed), 1, args.hidden,
                     1, device=device)


def solve_kwargs(args: argparse.Namespace, max_steps: int) -> Dict[str, Any]:
    """The training solve's options (``ndcn_forward`` keywords)."""
    bf16 = torch.bfloat16
    return dict(rtol=0.01, atol=0.001, method="dopri5", max_steps=max_steps,
                layout=args.layout,
                emission_dtype=bf16 if args.emission_precision == "bf16"
                else None,
                residual_dtype=bf16 if args.residual_precision == "bf16"
                else None)


def probe_budget(args, problem: Problem, model):
    """The step budget from one inference solve on the training device and
    layout; returns (max_steps, the probe's nfe)."""
    from ndcn_tpu_torch.models import ndcn_forward
    from ndcn_tpu_torch.train.budget import probe_step_budget

    box = []

    def probe():
        stats = ndcn_forward(model, problem.op, problem.t_train, problem.x0,
                             rtol=0.01, atol=0.001, method="dopri5",
                             max_steps=1 << 14, nondiff=True,
                             layout=args.layout)[1]
        box.append(stats.nfe)
        return stats

    ms = probe_step_budget(probe, floor=8, headroom=1.5, slack=2, quantum=4)
    return ms, box[0]


def ground_truth(args, problem: Problem):
    """The physics trajectory (T, n, 1) from x0 over the full grid, from
    ``--gt_cache`` when it holds this run's parameters; returns (truth on
    the run's device, seconds, whether it was cached)."""
    from ndcn_tpu_torch.experiments.dynamics import ground_truth as solve

    key = dict(n=problem.n, deg=args.deg, dynamics=args.dynamics,
               seed=args.seed, T=args.T, time_tick=args.time_tick)
    if args.gt_cache and os.path.exists(args.gt_cache):
        blob = np.load(args.gt_cache)
        if not all(blob[k] == v for k, v in key.items()):
            raise SystemExit(f"--gt_cache {args.gt_cache} was generated for "
                             f"different run parameters; delete it or point "
                             f"at a fresh path")
        log(f"ground truth: loaded from {args.gt_cache}")
        return (torch.as_tensor(blob["truth"], device=problem.x0.device),
                0.0, True)
    # On the run's device: the JAX example moves this solve to the CPU only
    # because the TPU pads an (n, 1) state 128-fold in its lanes; the card
    # has no such padding, and the width-1 solve runs K1 (K1-w for the
    # mutualistic interaction).
    t0 = time.time()
    truth, stats = solve(args.dynamics, problem.physics_op, problem.x0,
                         problem.splits.t, rtol=1e-6, atol=1e-8)
    if problem.x0.device.type == "cuda":
        torch.cuda.synchronize(problem.x0.device)
    gt_s = time.time() - t0
    if not stats.success:
        raise RuntimeError(f"the ground-truth solve failed: {stats}")
    log(f"ground truth: {stats.nfe} RHS evals in {gt_s:.2f}s "
        f"({stats.nfe * problem.n / max(gt_s, 1e-9):,.0f} node-evals/s)")
    if args.gt_cache:
        np.savez(args.gt_cache, truth=truth.cpu().numpy(), **key)
    return truth, gt_s, False


def tape_bytes_per_node_attempt(args: argparse.Namespace,
                                layout: str) -> float:
    """Bytes the autograd tape keeps per node and step attempt in this
    configuration and solve ``layout``, counted on the CPU at
    ``_CENSUS_NODES`` nodes (see the module docstring)."""
    from ndcn_tpu_torch.graph import sparse as graph_sparse
    from ndcn_tpu_torch.models import ndcn as ndcn_mod

    small = argparse.Namespace(**{**vars(args), "n": _CENSUS_NODES})
    problem = build_problem(small, torch.device("cpu"))
    model = new_model(small, torch.device("cpu"))
    kw = dict(solve_kwargs(small, 1 << 10), layout=layout)
    storages = {}

    def pack(t):
        s = t.untyped_storage()
        storages[s.data_ptr()] = s           # held: no address is reused
        return t

    # the CPU proxy takes the card's answer from the seam, so that it can
    # run the feature-major solve the real run resolved to
    saved_seam = graph_sparse.use_tiled_kernel
    graph_sparse.use_tiled_kernel = lambda op: True
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            _, stats = ndcn_mod.ndcn_forward(model, problem.op,
                                             problem.t_train, problem.x0, **kw)
    finally:
        graph_sparse.use_tiled_kernel = saved_seam
    attempts = stats.n_accepted + stats.n_rejected
    return sum(s.nbytes() for s in storages.values()) / (
        _CENSUS_NODES * max(attempts, 1))


def solve_layout(args: argparse.Namespace, problem: Problem) -> str:
    """What ``--layout`` resolves to for this run's operator, as
    ``ndcn_forward`` resolves it ('auto' picks the feature-major solve from
    ``_FEATURE_MAJOR_AUTO_NODES`` nodes when the operator serves the
    kernels); an ineligible explicit 'feature_major' raises here."""
    from ndcn_tpu_torch.models.ndcn import resolve_layout

    h = torch.empty((problem.n, args.hidden), device="meta")
    return resolve_layout(args.layout, problem.op, h)


def estimate(args, problem: Problem, model, device) -> Dict[str, Any]:
    """The byte census of the train step (module docstring)."""
    from ndcn_tpu_torch.train.budget import accelerator_memory_limit

    ms, _ = probe_budget(args, problem, model)
    n = problem.n
    layout = solve_layout(args, problem)
    per_node = tape_bytes_per_node_attempt(args, layout)
    op = problem.op
    terms = {
        "tape": int(per_node * n * ms),
        "trajectory": len(problem.t_train) * n * 4,
        # the operator's arrays (a CooGraph's: A's CSR and its transpose's)
        "operator": sum(t.numel() * t.element_size() for t in op
                        if isinstance(t, torch.Tensor)),
        "data": (len(problem.t_train) + 1) * n * 4,
    }
    for name, b in terms.items():
        log(f"  {name:<12s} {b / 1e9:6.2f} GB")
    total = sum(terms.values())
    limit = accelerator_memory_limit(device)
    return {
        "estimate_gb": round(total / 1e9, 2),
        "hbm_limit_gb": None if limit is None else round(limit / 1e9, 2),
        "fits": None if limit is None else total < 0.85 * limit,
        "max_steps": int(ms), "attempts_assumed": int(ms),
        "layout": layout, "n_nodes": n, "nnz": problem.nnz,
        "hidden": args.hidden,
        "emission_precision": args.emission_precision,
        "residual_precision": args.residual_precision,
        "tape_bytes_per_node_attempt": round(per_node, 1),
        "terms_gb": {k: round(v / 1e9, 3) for k, v in terms.items()},
    }


def train_objective(args, problem: Problem, model, target, max_steps,
                    attempts: Optional[list] = None):
    """loss_fn for ``make_sgd_step``: (L1 loss, NaN when the solve ran out
    of budget; relative L1). Each solve's step attempts are appended to
    ``attempts`` when given."""
    from ndcn_tpu_torch.models import ndcn_forward
    from ndcn_tpu_torch.train.losses import l1_loss, relative_l1

    kw = solve_kwargs(args, max_steps)

    def loss_fn():
        out, stats = ndcn_forward(model, problem.op, problem.t_train,
                                  problem.x0, **kw)
        if attempts is not None:
            attempts.append(stats.n_accepted + stats.n_rejected)
        loss = l1_loss(out, target)
        if not stats.success:
            loss = torch.full_like(loss, float("nan"))
        return loss, relative_l1(out.detach(), target)

    return loss_fn


def run(args: argparse.Namespace) -> Optional[Dict[str, Any]]:
    """The scale run; returns the record (the estimate or the ground-truth
    record with ``--estimate`` / ``--gt_only``)."""
    from ndcn_tpu_torch.experiments.dynamics import select_device
    from ndcn_tpu_torch.kernels import coo_spmv

    _refuse_unported(args)
    device = select_device(args.platform)
    with coo_spmv.gather_precision(args.kernel_precision == "bf16"):
        return _run(args, device)


def _run(args: argparse.Namespace, device: torch.device) -> Dict[str, Any]:
    from ndcn_tpu_torch.kernels.platform import pin_fp32
    from ndcn_tpu_torch.train.elastic import ElasticBudget
    from ndcn_tpu_torch.train.optim import make_sgd_step, torch_adam

    pin_fp32()
    problem = build_problem(args, device)
    solve_layout(args, problem)          # an ineligible layout raises here
    model = new_model(args, device)
    if args.estimate:
        record = estimate(args, problem, model, device)
        print(json.dumps(record))
        return record

    truth, gt_s, cached = ground_truth(args, problem)
    if args.gt_only:
        record = {"gt_only": True, "gt_cache": args.gt_cache,
                  "ground_truth_s": round(gt_s, 2), "n_nodes": problem.n,
                  "cached": cached}
        print(json.dumps(record))
        return record
    target = truth[torch.as_tensor(problem.splits.id_train,
                                   device=truth.device)]
    del truth

    max_steps, probe_nfe = probe_budget(args, problem, model)
    log(f"step budget: {max_steps} (train solve nfe {probe_nfe})")

    elastic = ElasticBudget(max_steps, enabled=True)
    opt = torch_adam(model.parameters(), 0.01, 1e-3)
    attempts = []

    def build_step():
        return make_sgd_step(opt, train_objective(args, problem, model,
                                                  target, elastic.max_steps,
                                                  attempts))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def state():
        return model.state_dict(), opt.state_dict()

    def restore(snap):
        model.load_state_dict(snap[0])
        opt.load_state_dict(snap[1])

    if device.type == "cuda":
        # the peak below is the training's: the ground truth is freed
        torch.cuda.reset_peak_memory_stats(device)
    step = build_step()
    elastic.snapshot(0, None, state())
    c_t0 = time.time()
    while True:
        loss, rel = step()
        if elastic.exhausted(float(loss)):
            _, _, snap = elastic.rollback()
            restore(snap)
            log(f"[elastic] first step exhausted the budget; regrown to "
                f"max_steps={elastic.max_steps}")
            step = build_step()
            continue
        break
    rel0 = float(rel)
    log(f"train step first in {time.time() - c_t0:.1f}s; initial rel loss "
        f"{rel0:.4f}")
    elastic.snapshot(0, None, state())

    check_freq = 10
    losses = [float(loss)]
    t_run = time.time()
    i = 0
    while i < args.iters:
        loss, rel = step()
        i += 1
        if i % check_freq == 0 or i == args.iters:
            if elastic.exhausted(float(loss)):      # one read per 10 iters
                prev = i
                i, _, snap = elastic.rollback()
                restore(snap)
                log(f"[elastic] budget exhausted by iter {prev}; rolled back "
                    f"to iter {i} with max_steps={elastic.max_steps}")
                step = build_step()
                continue
            losses.append(float(loss))
            elastic.snapshot(i, None, state())
    sync()
    dt = time.time() - t_run
    steps_per_s = args.iters / dt if args.iters else float("nan")
    relf = float(rel)
    if not np.isfinite(float(loss)):
        raise RuntimeError("training diverged or exhausted the step budget")
    if not np.isfinite(relf):
        raise RuntimeError(f"the final relative loss is not finite: {relf}")

    # The caching allocator reports the peak, so --hbm_probe needs no
    # ballast bisection (the JAX example bisects only where the backend
    # reports none). Eager PyTorch has no compiled buffer assignment, so
    # hbm_program_gb and hbm_breakdown_gb stay null.
    hbm_peak_gb = hbm_peak_source = None
    if device.type == "cuda":
        hbm_peak_gb = round(torch.cuda.max_memory_allocated(device) / 1e9, 2)
        hbm_peak_source = "max_memory_allocated"
    elif args.hbm_probe:
        log("hbm probe: the CPU has no device arena; skipped")

    roofline = None
    if args.roofline and device.type != "cuda":
        log("roofline: measures the SpMV on the card; skipped on the CPU")
    elif args.roofline and args.fmt != "coo":
        log("roofline: measures the COO kernels; skipped for --fmt ell")
    elif args.roofline:
        from ndcn_tpu_torch.train.roofline import gather_floor_s, measure_spmv

        spmv = measure_spmv(problem.op, args.hidden,
                            kernel_precision=args.kernel_precision)
        floor = gather_floor_s(probe_nfe, spmv)
        step_s = 1.0 / steps_per_s
        roofline = {**spmv, "nfe_init": probe_nfe,
                    "gather_floor_s": round(floor, 3),
                    "pct_of_gather_floor": round(100 * floor / step_s, 1)}
        log(f"roofline: SpMV fwd {spmv['spmv_fwd_ms']} ms / transpose "
            f"{spmv['spmv_t_ms']} ms ({spmv['slot_rate_m_per_s']}M slots/s); "
            f"floor {floor:.3f}s = {roofline['pct_of_gather_floor']}% of the "
            f"{step_s:.3f}s step")

    record = {
        "n_nodes": problem.n, "nnz": problem.nnz,
        "train_steps_per_sec": round(steps_per_s, 3),
        "node_evals_per_sec": round(steps_per_s * probe_nfe * problem.n, 0),
        "ground_truth_s": round(gt_s, 2),
        "rel_loss_initial": round(rel0, 4), "rel_loss_final": round(relf, 4),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "fmt": args.fmt, "dynamics": args.dynamics,
        "max_steps": int(elastic.max_steps),
        "attempts_taken": max(attempts),
        "elastic_rollbacks": int(elastic.total_rollbacks),
        "mesh_devices": 1, "mesh_parity": None,
        "hbm_peak_gb": hbm_peak_gb, "hbm_peak_source": hbm_peak_source,
        "roofline": roofline,
        "hbm_program_gb": None, "hbm_breakdown_gb": None,
        "layout": args.layout,
        "solve_layout": solve_layout(args, problem),
        "kernel_precision": args.kernel_precision,
        "emission_precision": args.emission_precision,
        "residual_precision": args.residual_precision,
        "iters": args.iters, "hidden": args.hidden,
        "train_losses": losses,
    }
    print(json.dumps(record))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**record, "argv": sys.argv[1:]}, f, indent=1)
    return record


def main(argv=None) -> Optional[Dict[str, Any]]:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
