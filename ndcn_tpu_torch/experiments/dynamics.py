"""The dynamics experiments (heat, mutualistic, gene), as
``ndcn_tpu/experiments/dynamics.py``.

Same flag surface, defaults, split semantics, losses and printed progress
lines as the JAX package's experiment (and the reference's). The flow: graph →
``sample_times`` → operator → ground truth (the inference solve of the
physics at rtol 1e-7, atol 1e-9, on the CPU as the JAX package does) → NDCN
from a ``torch.Generator`` → step budget (probed on the training device for
the adaptive solve, 256 otherwise) → train loop with elastic rollback and an
evaluation every ``test_freq`` iterations, and with ``--ckpt_dir`` a
checkpoint every ``ckpt_freq`` iterations and a resume from the newest one.
Every ``--method`` of the JAX driver runs, with ``--adjoint`` (the continuous
adjoint's gradients), and every ``--network`` with ``--layout`` and
``--seed`` for the graph. The physics propagates through L = D - A for heat
and through the raw adjacency for mutualistic and gene; mutualistic cannot
use BSR blocks, so there its physics operator is COO.

The temporal-GNN baselines (``--baseline lstm_gnn / gru_gnn / rnn_gnn``,
``models.temporal_gcn``) train on the Kipf operator whatever
``--operator`` says, with 5 graph and 10 recurrent hidden units, one step
ahead on the observed train grid (no step budget: they solve nothing), and
are evaluated by rolling out the extrapolation steps after teacher-forcing
the whole train grid. ``--dump`` records an evaluation at each
``test_freq`` and dumps the JAX package's results dict (``report.results``)
under ``--results_dir``; ``--viz`` plots the adjacency and the dynamics
(``report.viz``); ``--profile_dir`` traces three training steps (one
chunk with ``--scan_chunk``) on copies
of the model, the optimizer and the dropout generator
(``utils.timing.profile_trace``), so the run's own losses do not change.
``--export PATH`` writes the trained model's inference forward over the
full observation grid, x0 → (trajectory, success), as the serving
artifact (``serve.export_ndcn``; the continuous baselines, one model, one
device, every ``--method``).

``--replicas R`` trains R independent models (replica i initialised and
dropping out from generators seeded ``--seed`` + i, + 1 + i) at once, the
JAX driver's vmapped sweep: one stacked model (``parallel.sweep``), one
batched solve and one launch stream a step, the step budget sized from the
hardest of min(4, R) probed inits, no rollback (one replica cannot be
rolled back: a replica that exhausts the budget reads NaN, and the others
are unaffected); ``--dump`` writes one results file per replica
(``replicaNNN``), which ``experiments.summarize`` aggregates. The
continuous baselines only, with every ``--method`` and with ``--adjoint``
(the batched continuous adjoint, ``ode.adjoint``); the budget is probed
for dopri5 and tsit5 only, 256 otherwise, as the JAX driver sizes it.

``--mesh`` under ``torchrun --nproc_per_node P`` (P > 1) lays the ranks
out as ``make_mesh(data_divides=R, model_divides=n)`` (R the replica
count, 1 without ``--replicas``) and shards the operator and every
node-major tensor over the model axis (``parallel.sweep.shard_operator``:
K1 on each rank's row block, dense rows through ``torch.matmul``; ELL and
BSR stay whole, with the JAX notice); the losses are means over every
rank's rows and the replicated parameters' gradients are summed over the
model axis, so every rank takes the unsharded run's steps. With
``--replicas`` each data rank trains its R / data replicas (replica i's
generators are the unsharded sweep's), and the log line's mean and std
gather every replica. Rank 0 writes the checkpoints, the dump and the
figures. A world of one prints the JAX driver's notice and runs unsharded.
``--adjoint`` runs on any model axis (the backward solve's parameter VJPs
summed over it, ``ode.adjoint``), and the temporal baselines on the
rank's rows (``models.temporal_gcn``).

``--scan_chunk k`` trains k steps a host read, the JAX driver's chunked
dispatch: the train solve is the bounded one (``ode.adaptive.solve_scan``
for dopri5 and tsit5, ``ode.vcabm.solve_vcabm_scan`` for adams; the
fixed-grid and fixed-order methods and the temporal baselines are static
already), with ``--adjoint`` the continuous adjoint on the bounded
inference solve (``ode.adjoint``), and Adam ``optim.CapturableAdam``; on
the card each step is one CUDA graph replay (``train.chunk``), on the CPU
it runs eagerly. Under ``--mesh`` the chunk is each rank's step on its row
block: the solve's norms and the gradients' sum run over the model axis
inside the graph (NCCL collectives captured with it). The chunk bounds are
the JAX driver's (the next ``test_freq`` and ``ckpt_freq`` boundary,
``niters``), so the log and checkpoint iterations are the same; the loss
is read once a chunk, and an elastic rollback builds a new chunk at the
doubled budget (a capture again on the card). With dropout the graph
draws its masks from a generator on the card.

``--platform gpu`` (the default) trains on the first CUDA device and raises
without one; ``--platform cpu`` runs the kernels' plain versions. Matrix
products are pinned to full fp32 on both; ``--precision high`` runs
PyTorch's float32 products in TF32 for the run instead
(``kernels.platform.matmul_precision``). Every flag of the JAX driver
runs; the JAX driver's own argument errors are raised before any work.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import os
import time
from typing import Any, Dict

import numpy as np
import torch

TEMPORAL_BASELINES = ("lstm_gnn", "rnn_gnn", "gru_gnn")


def build_parser(name: str) -> argparse.ArgumentParser:
    """The flag surface of the dynamics experiments (heat_dynamics.py:19-64)."""
    p = argparse.ArgumentParser(name)
    p.add_argument("--method", type=str, default="euler",
                   choices=["dopri5", "adams", "explicit_adams", "fixed_adams",
                            "tsit5", "euler", "midpoint", "rk4"])
    p.add_argument("--rtol", type=float, default=0.01)
    p.add_argument("--atol", type=float, default=0.001)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--weight_decay", type=float, default=1e-3)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--hidden", type=int, default=20)
    p.add_argument("--time_tick", type=int, default=100)
    p.add_argument("--sampled_time", type=str, default="irregular",
                   choices=["irregular", "equal"])
    p.add_argument("--niters", type=int, default=2000)
    p.add_argument("--test_freq", type=int, default=20)
    p.add_argument("--viz", action="store_true")
    p.add_argument("--n", type=int, default=400)
    p.add_argument("--sparse", action="store_true")
    p.add_argument("--sparse_format", type=str, default="ell",
                   choices=["coo", "ell", "bsr"],
                   help="sparse layout: coo (K1; K1-w for the mutualistic "
                        "physics), ell (gather and einsum) or bsr (K3, and "
                        "K4 where fused); the mutualistic physics takes "
                        "coo for bsr")
    p.add_argument("--kernel_precision", type=str, default="split2",
                   choices=["split2", "bf16"],
                   help="split2: full-accuracy SpMV (K1 is fp32); bf16: the "
                        "state and A rounded to bf16 in K1's gather, fp32 "
                        "sums")
    p.add_argument("--emission_precision", type=str, default="f32",
                   choices=["f32", "bf16"],
                   help="dtype the observations' dense output is rounded "
                        "through (differentiable dopri5 only)")
    p.add_argument("--residual_precision", type=str, default="f32",
                   choices=["f32", "bf16"],
                   help="dtype the SpMV output is rounded to and kept in on "
                        "the tape")
    p.add_argument("--network", type=str, default="grid",
                   choices=["grid", "random", "power_law", "small_world",
                            "community"])
    p.add_argument("--layout", type=str, default="community",
                   choices=["community", "degree"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--T", type=float, default=5.0)
    p.add_argument("--operator", type=str, default="norm_lap",
                   choices=["lap", "norm_lap", "kipf", "norm_adj"])
    p.add_argument("--baseline", type=str, default="ndcn",
                   choices=["ndcn", "no_embed", "no_control", "no_graph",
                            *TEMPORAL_BASELINES])
    p.add_argument("--dump", action="store_true")
    p.add_argument("--adjoint", action="store_true")
    p.add_argument("--max_steps", type=int, default=0,
                   help="adaptive step budget for the differentiable solve "
                        "(0 = auto-size from a probe solve at init)")
    p.add_argument("--results_dir", type=str, default=None)
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument("--ckpt_freq", type=int, default=200)
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--fused_kernel", action="store_true",
                   help="route the NDCN RHS through the fused kernel where "
                        "profitable (fused='auto': K2 on a dense operator)")
    p.add_argument("--scan_chunk", type=int, default=0,
                   help="train this many steps per host read (the bounded "
                        "solve; one CUDA graph replay a step on the card); "
                        "0 = one step at a time on the host loop")
    p.add_argument("--mesh", action="store_true")
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--export", type=str, default=None, metavar="PATH")
    p.add_argument("--platform", type=str, default="gpu",
                   choices=["gpu", "cpu"],
                   help="gpu: the first CUDA device and the CUDA kernels "
                        "(raises without one); cpu: the plain versions")
    p.add_argument("--precision", type=str, default="default",
                   choices=["default", "high", "float32", "highest"],
                   help="matmul precision of PyTorch's float32 products: "
                        "full fp32 (default = highest = float32) or high "
                        "(TF32); the hand-written kernels keep theirs")
    return p


def _refuse_arguments(dynamics_kind: str, args: argparse.Namespace) -> None:
    """The JAX driver's own argument errors, before any work."""
    if args.export:
        if args.baseline in TEMPORAL_BASELINES:
            raise SystemExit("--export serializes the continuous-time "
                             "inference forward; use a continuous baseline "
                             "(ndcn / no_embed / no_control / no_graph)")
        if args.replicas > 1:
            raise SystemExit("--export needs the single-model path "
                             "(drop --replicas)")
        if args.mesh:
            raise SystemExit("--export produces a single-device serving "
                             "artifact (drop --mesh)")
    if args.emission_precision != "f32" and (
            args.method not in ("dopri5", "tsit5") or args.adjoint):
        # the emission options reach the differentiable adaptive solve only;
        # accepting the flag elsewhere would be a silent no-op
        raise SystemExit("--emission_precision bf16 applies only to the "
                         "differentiable adaptive solve (--method dopri5/"
                         "tsit5, without --adjoint); it would be a silent "
                         "no-op for this configuration")
    if args.replicas > 1:
        if args.baseline in TEMPORAL_BASELINES:
            raise SystemExit("--replicas currently supports the continuous "
                             "(ndcn/ablation) baselines")
        if args.ckpt_dir or args.profile_dir or args.scan_chunk:
            raise SystemExit("--replicas is incompatible with --ckpt_dir/"
                             "--profile_dir/--scan_chunk (per-replica "
                             "training runs as one vmapped program)")


def nan_unless_ok(success, loss: torch.Tensor) -> torch.Tensor:
    """``loss``, or NaN where the solve ran out of its budget: a
    ``torch.where`` on the solve's ``success``, the bounded solve's device
    flag as it is (no host read), the host loop's bool filled on the
    device (no copy from the host, which a CUDA graph may not record: the
    fixed-grid methods' bool is on the graphed step)."""
    ok = (success if isinstance(success, torch.Tensor)
          else torch.full((), bool(success), device=loss.device))
    return torch.where(ok, loss, torch.full_like(loss, float("nan")))


def select_device(platform: str) -> torch.device:
    """The run's device: the CPU for ``--platform cpu``, else the card of
    torchrun's ``LOCAL_RANK`` (the first for a plain ``python``)."""
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--platform gpu needs a CUDA device and none is "
                           "visible; pass --platform cpu to run the plain "
                           "versions on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def ground_truth(dynamics_kind: str, physics_op, x0: torch.Tensor, t,
                 rtol: float = 1e-7, atol: float = 1e-9):
    """The physics trajectory of ``make_rhs(dynamics_kind, physics_op)``
    from x0 over the grid ``t``: the inference solve (dopri5). Returns
    (solution (T, n, 1), SolveStats)."""
    from ndcn_tpu_torch.dynamics import make_rhs
    from ndcn_tpu_torch.ode import odeint_with_stats

    return odeint_with_stats(make_rhs(dynamics_kind, physics_op), x0, t,
                             rtol=rtol, atol=atol, method="dopri5",
                             options={"differentiable": False})


def heat_ground_truth(physics_op, x0: torch.Tensor, t, rtol: float = 1e-7,
                      atol: float = 1e-9):
    """``ground_truth`` of heat diffusion dX/dt = -L X."""
    return ground_truth("heat", physics_op, x0, t, rtol, atol)


def run(dynamics_kind: str, args: argparse.Namespace) -> Dict[str, Any]:
    from ndcn_tpu_torch.kernels import coo_spmv
    from ndcn_tpu_torch.kernels.platform import matmul_precision
    from ndcn_tpu_torch.parallel.mesh import process_group, world_size

    _refuse_arguments(dynamics_kind, args)
    device = select_device(args.platform)
    # --kernel_precision bf16 sets the JAX package's GATHER_BF16 for the run
    with (process_group(device) if args.mesh and world_size() > 1
          else contextlib.nullcontext()), \
            coo_spmv.gather_precision(args.kernel_precision == "bf16"), \
            matmul_precision(args.precision):
        return _run(dynamics_kind, args, device)


def _run(dynamics_kind: str, args: argparse.Namespace,
         device: torch.device) -> Dict[str, Any]:

    from ndcn_tpu_torch.graph import generators, operators
    from ndcn_tpu_torch.graph.sparse import as_operator
    from ndcn_tpu_torch.models import (init_ndcn, init_temporal_gcn,
                                       ndcn_forward, temporal_gcn_forward)
    from ndcn_tpu_torch.report import results as results_lib
    from ndcn_tpu_torch.train.budget import (probe_step_budget,
                                             scan_train_bytes)
    from ndcn_tpu_torch.train.chunk import TrainChunk
    from ndcn_tpu_torch.train.checkpoint import (restore_with_extra,
                                                 save_checkpoint)
    from ndcn_tpu_torch.train.elastic import ElasticBudget
    from ndcn_tpu_torch.parallel.coo_shard import (gather_nodes, node_group,
                                                   take_rows)
    from ndcn_tpu_torch.parallel.mesh import (make_mesh, rank, shard_mean,
                                              world_size)
    from ndcn_tpu_torch.parallel.sweep import shard_operator
    from ndcn_tpu_torch.train.losses import l1_loss
    from ndcn_tpu_torch.train.optim import make_sgd_step, torch_adam
    from ndcn_tpu_torch.train.sampling import sample_times
    from ndcn_tpu_torch.utils.timing import profile_trace

    t_start = time.time()
    continuous = args.baseline not in TEMPORAL_BASELINES

    # ---------------------------------------------------------------- graph
    print(f"Choose graph: {args.network}")
    adj = generators.build_network(args.network, args.n, seed=args.seed,
                                   layout=args.layout)
    # small_world has 400 nodes whatever --n is: the x0 block pattern and
    # everything after it follow the graph's own node count
    n = adj.shape[0]
    side = int(np.ceil(np.sqrt(n)))

    # ---------------------------------------------------------- time splits
    print(f"Build {args.sampled_time}ly-sampled -time dynamics")
    splits = sample_times(args.T, args.time_tick, args.sampled_time,
                          seed=args.seed)
    id_train, id_test, id_test2 = splits.id_train, splits.id_test, \
        splits.id_test2

    # ------------------------------------------------------------- operators
    om_np = operators.build_dynamics_operator(adj, args.operator)
    if not continuous:
        # the temporal baselines always use the Kipf operator
        # (heat_dynamics.py:169-173)
        om_np = operators.zipf_smoothing(adj)
    op = as_operator(om_np, sparse=args.sparse, format=args.sparse_format,
                     device=device)
    # heat diffusion integrates over L = D - A (the RHS owns the minus sign);
    # mutualistic and gene couple through the raw adjacency. Mutualistic
    # gathers neighbour states per edge, which BSR blocks do not expose.
    physics_matrix = (operators.laplacian_dense(adj)
                      if dynamics_kind == "heat" else adj)
    physics_fmt = args.sparse_format
    if dynamics_kind == "mutualistic" and physics_fmt == "bsr":
        print("mutualistic physics cannot use BSR; using COO for the "
              "ground-truth operator")
        physics_fmt = "coo"
    physics_cpu = as_operator(physics_matrix, sparse=args.sparse,
                              format=physics_fmt)

    # --------------------------------------------------------- ground truth
    # the block initial condition on the side×side grid, first n entries
    x0_np = generators.grid_block_initial_value(side)[:n].astype(np.float32)
    t0 = time.perf_counter()
    solution, gt_stats = ground_truth(dynamics_kind, physics_cpu,
                                      torch.as_tensor(x0_np), splits.t)
    gt_s = time.perf_counter() - t0
    print(f"{tuple(solution.shape)} ground truth: {gt_stats.nfe} RHS evals "
          f"in {gt_s:.3f}s ({gt_stats.nfe * n / max(gt_s, 1e-9):,.0f} "
          f"node-evals/s)")

    true_y = solution[..., 0].T.to(device)              # (n, T_all)
    true_y0 = torch.as_tensor(x0_np, device=device)     # (n, 1)
    true_y_train = true_y[:, id_train]
    true_y_test = true_y[:, id_test]
    true_y_test2 = true_y[:, id_test2] if id_test2 is not None else None
    t_train = splits.t[id_train]

    # ------------------------------------------------------------------ mesh
    # replicas over the ranks' data axis, and the operator's rows and every
    # node-major tensor over their model axis, the parameters replicated
    # (true_y stays whole: the dump records it)
    mesh = None
    if args.mesh and world_size() > 1:
        mesh = make_mesh(device, data_divides=args.replicas,
                         model_divides=n)
        print(f"mesh: {mesh.shape}")
        op = shard_operator(mesh, op)
        true_y0, true_y_train, true_y_test = (
            take_rows(a, op) for a in (true_y0, true_y_train, true_y_test))
        if true_y_test2 is not None:
            true_y_test2 = take_rows(true_y_test2, op)
    elif args.mesh:
        print("--mesh: single device visible; running unsharded")
    group = node_group(op)
    lead = rank() == 0              # the rank that writes files

    # ----------------------------------------------------------------- model
    flags = dict(no_embed=args.baseline == "no_embed",
                 no_graph=args.baseline == "no_graph",
                 no_control=args.baseline == "no_control")
    print("Choose model:" + args.baseline)
    init_gen = torch.Generator().manual_seed(args.seed)
    max_steps, budget_is_auto = args.max_steps, False
    if continuous:
        model = init_ndcn(init_gen, 1, args.hidden, 1,
                          no_embed=flags["no_embed"],
                          no_control=flags["no_control"], device=device)
    else:
        rnn_type = args.baseline.split("_")[0]
        hidden_size_gnn, hidden_size_rnn = 5, 10
        model = init_temporal_gcn(init_gen, 1, hidden_size_gnn, n,
                                  hidden_size_rnn, rnn_type, device=device)
        max_steps = 0          # nothing is solved: no step budget
    fused = "auto" if args.fused_kernel else False
    solve_kw = dict(rtol=args.rtol, atol=args.atol, method=args.method,
                    fused=fused, **flags)
    train_kw = dict(solve_kw, adjoint=args.adjoint)
    levers = dict(
        emission_dtype=(torch.bfloat16 if args.emission_precision == "bf16"
                        else None),
        residual_dtype=(torch.bfloat16 if args.residual_precision == "bf16"
                        else None))

    if args.replicas > 1:
        return _run_replicas(dynamics_kind, args, device, dict(
            t_start=t_start, op=op, mesh=mesh, splits=splits, true_y=true_y,
            true_y0=true_y0, true_y_train=true_y_train,
            true_y_test=true_y_test, true_y_test2=true_y_test2,
            solve_kw=solve_kw, levers=levers))
    if continuous and max_steps <= 0 and args.method not in ("dopri5", "tsit5"):
        max_steps = 256        # the fixed-grid methods take no budget
    elif continuous and max_steps <= 0:
        # the probe runs on the training operator and device, BSR included
        def probe():
            return ndcn_forward(model, op, splits.t, true_y0, nondiff=True,
                                max_steps=1 << 14, **solve_kw)[1]

        # snug budget: exhaustion is recoverable (elastic rollback below)
        max_steps = probe_step_budget(probe, floor=8, headroom=2.5, slack=4,
                                      quantum=4)
        budget_is_auto = True
        print(f"auto step budget: max_steps={max_steps}")

    n_params = sum(p.numel() for p in model.parameters())
    print(f"Total {n_params:d} Trainable {n_params:d}")

    elastic = ElasticBudget(max_steps, enabled=budget_is_auto)

    chunked = args.scan_chunk > 0
    if continuous:
        def forward(m, vt, rng=None, scan=False):
            out, stats = ndcn_forward(m, op, vt, true_y0,
                                      dropout=args.dropout, rng=rng,
                                      max_steps=elastic.max_steps, scan=scan,
                                      **train_kw, **levers)
            return out[..., 0].T, stats                  # (n, T)

        # --scan_chunk: the bounded solve over the train grid, a tensor on
        # the run's device (a CUDA graph reads it; nothing is copied in)
        t_train_arg = (torch.as_tensor(t_train, dtype=torch.float32,
                                       device=device) if chunked else t_train)

        def train_loss(m, rng):
            pred, stats = forward(m, t_train_arg, rng, scan=chunked)
            loss = l1_loss(pred, true_y_train, group)
            # a blown step budget must be loud (NaN), not silently wrong;
            # the bounded solve's flag stays on the device
            loss = nan_unless_ok(stats.success, loss)
            return loss, loss / shard_mean(true_y_train, group)

        def predict():
            """(predictions on the test and interpolation columns, NFE)."""
            pred, stats = forward(model, splits.t)
            if not stats.success:
                # budget exhaustion is loud here too: the full-grid solve
                # can outgrow a budget the train solve still fits
                pred = torch.full_like(pred, float("nan"))
            return (pred[:, id_test],
                    pred[:, id_test2] if id_test2 is not None else None,
                    stats.nfe)
    else:
        def train_loss(m, rng):
            # one step ahead over the observed train grid
            pred = temporal_gcn_forward(m, op, true_y_train[:, :-1],
                                        rnn_type, dropout=args.dropout,
                                        generator=rng, deterministic=False)
            target = true_y_train[:, 1:]
            loss = l1_loss(pred, target, group)
            return loss, loss / shard_mean(target, group)

        def predict():
            # teacher-force the whole train grid, then roll out the
            # extrapolation steps: they are the trailing columns
            pred = temporal_gcn_forward(model, op, true_y_train, rnn_type,
                                        future=len(id_test))
            return (pred[:, -len(id_test):],
                    (torch.zeros_like(true_y_test2) if id_test2 is not None
                     else None), 0)

    def evaluate():
        with torch.no_grad():
            pred_test, pred_test2, nfe = predict()
            loss_t = l1_loss(pred_test, true_y_test, group)
            # the records and figures take every rank's rows
            ev = dict(loss=float(loss_t),
                      rel=float(loss_t / shard_mean(true_y_test, group)),
                      loss2=0.0, rel2=0.0,
                      pred_test=gather_nodes(pred_test, op),
                      pred_test2=(None if pred_test2 is None
                                  else gather_nodes(pred_test2, op)),
                      nfe=nfe)
            if id_test2 is not None and continuous:
                loss2 = l1_loss(pred_test2, true_y_test2, group)
                ev["loss2"] = float(loss2)
                ev["rel2"] = float(loss2 / shard_mean(true_y_test2, group))
        return ev

    results = results_lib.new_results_dict(vars(args))
    results["true_y"].append(results_lib.as_numpy(true_y))
    results["nfe_train"] = []

    def report(itr, loss, rel) -> bool:
        """Evaluate, record (--dump) and print at test_freq; False when the
        evaluation solve exhausted the shared budget (roll back)."""
        if itr % args.test_freq != 0:
            return True
        ev = evaluate()
        if elastic.exhausted(ev["loss"]):
            return False
        if args.dump:
            has2 = id_test2 is not None
            results_lib.record_eval(
                results, itr, ev["loss"], ev["rel"], ev["pred_test"], model,
                abs_error2=ev["loss2"] if has2 else None,
                rel_error2=ev["rel2"] if has2 else None,
                predict_y2=ev["pred_test2"] if has2 else None)
            results["nfe_train"].append(int(ev["nfe"]))
        if args.sampled_time == "irregular":
            print("Iter {:04d}| Train Loss {:.6f}({:.6f} Relative) "
                  "| Test Loss {:.6f}({:.6f} Relative) "
                  "| Test Loss2 {:.6f}({:.6f} Relative) "
                  "| Time {:.4f}"
                  .format(itr, float(loss), float(rel), ev["loss"], ev["rel"],
                          ev["loss2"], ev["rel2"], time.time() - t_start))
        else:
            print("Iter {:04d}| Train Loss {:.6f}({:.6f} Relative) "
                  "| Test Loss {:.6f}({:.6f} Relative) "
                  "| Time {:.4f}"
                  .format(itr, float(loss), float(rel), ev["loss"], ev["rel"],
                          time.time() - t_start))
        return True

    # ------------------------------------------------------------- training
    opt = torch_adam(model.parameters(), args.lr, args.weight_decay,
                     capturable=chunked)
    train_step = make_sgd_step(opt, lambda g: train_loss(model, g), group)
    # a CUDA graph draws its dropout masks from a generator on the card
    # (registered with the graph); otherwise they come from the CPU, so
    # that a card run and a CPU run at one seed drop the same elements
    rng = torch.Generator(
        device if chunked and device.type == "cuda" and args.dropout > 0
        else "cpu").manual_seed(args.seed + 1)
    # resume from the newest checkpoint: weights, Adam's state, and the
    # dropout generator and step budget the interrupted run had there
    start_iter, extra = restore_with_extra(args.ckpt_dir, model, opt)
    if "rng" in extra:
        rng.set_state(extra["rng"])
    if "max_steps" in extra:
        elastic.max_steps = int(extra["max_steps"])

    def train_state():
        return model.state_dict(), opt.state_dict()

    def checkpoint(itr, loss) -> None:
        # never persist a NaN-poisoned state: an exhausted budget is only
        # detected at test_freq boundaries, and ckpt_freq can fall between
        if not np.isfinite(float(loss)):
            print(f"[ckpt] skipping iter {itr}: loss is non-finite (budget "
                  f"exhaustion pending recovery)", flush=True)
            return
        if not lead:
            return
        save_checkpoint(args.ckpt_dir, itr, model, opt,
                        extra={"rng": rng.get_state(),
                               "max_steps": elastic.max_steps})

    def make_chunk(m, o, g) -> TrainChunk:
        """--scan_chunk: the train step of model ``m`` with optimizer ``o``
        and generator ``g`` as a ``TrainChunk`` (one CUDA graph on the
        card), guarded by the bounded solve's ``scan_train_bytes``."""
        step = make_sgd_step(o, lambda gen: train_loss(m, gen), group)
        width = 1 if flags["no_embed"] else args.hidden
        step_bytes = (scan_train_bytes(
            args.method, elastic.max_steps,
            torch.empty((true_y0.shape[0], width), device="meta"),
            n_obs=len(t_train)) if continuous else 0)
        return TrainChunk(lambda: step(g), m.parameters(), o, g, step_bytes)

    def profile_steps() -> None:
        """Trace three steady training steps (with --scan_chunk one chunk,
        its capture left out) on copies of the model, the optimizer and the
        dropout generator: the profiled steps must not advance the run's
        own state, or a profiled run would train three steps more and an
        elastic replay would part from the original."""
        m = copy.deepcopy(model)
        o = torch_adam(m.parameters(), args.lr, args.weight_decay,
                       capturable=chunked)
        # a deep copy: load_state_dict keeps the tensors it is given
        o.load_state_dict(copy.deepcopy(opt.state_dict()))
        g = torch.Generator(rng.device).set_state(rng.get_state())
        if chunked:
            prof_chunk = make_chunk(m, o, g)
            if device.type == "cuda":
                prof_chunk.capture()
            with profile_trace(args.profile_dir) as path:
                prof_chunk(args.scan_chunk)
            prof_chunk.release()
        else:
            step = make_sgd_step(o, lambda gen: train_loss(m, gen), group)
            with profile_trace(args.profile_dir) as path:
                for _ in range(3):
                    ploss, _ = step(g)
                float(ploss)
        print(f"[profile] trace written to {path}")

    # Elastic step-budget recovery (auto budgets only): exhaustion surfaces
    # as a NaN train loss; roll back to the last finite-loss snapshot, double
    # the budget and replay with the same generator state.
    elastic.snapshot(start_iter, rng.get_state(), train_state())
    loss = rel = torch.tensor(0.0)
    itr = start_iter
    train_losses = []
    profiled = False
    chunk = make_chunk(model, opt, rng) if chunked else None
    chunk_stats = dict(chunks=0, host_reads=0, captures=0, steps=0)

    def retire(c) -> None:
        chunk_stats["host_reads"] += c.host_reads
        chunk_stats["captures"] += c.graph is not None
        c.release()

    while itr < args.niters:
        if chunked:
            # the JAX driver's chunk bounds: the same log and checkpoint
            # iterations as one step at a time
            bound = min(itr + args.scan_chunk,
                        (itr // args.test_freq + 1) * args.test_freq,
                        args.niters)
            if args.ckpt_dir and args.ckpt_freq:
                bound = min(bound,
                            (itr // args.ckpt_freq + 1) * args.ckpt_freq)
            loss, rel = chunk(bound - itr)
            chunk_stats["chunks"] += 1
            chunk_stats["steps"] += bound - itr
            itr = bound
        else:
            itr += 1
            loss, rel = train_step(rng)
        if args.profile_dir and not profiled and itr > 2:
            profile_steps()
            profiled = True
        ckpt_due = bool(args.ckpt_dir) and itr % args.ckpt_freq == 0
        if itr % args.test_freq == 0 or itr >= args.niters:
            # the loss read syncs the device: only at report cadence
            exhausted = elastic.exhausted(float(loss))
            if not exhausted and ckpt_due:
                checkpoint(itr, loss)
            if exhausted or not report(itr, loss, rel):
                prev = itr
                itr, rng_state, (model_sd, opt_sd) = elastic.rollback()
                model.load_state_dict(model_sd)
                opt.load_state_dict(opt_sd)
                rng.set_state(rng_state)
                if chunked:
                    # Adam's tensors were replaced and the budget doubled:
                    # capture again (the JAX driver recompiles)
                    retire(chunk)
                    chunk = make_chunk(model, opt, rng)
                print(f"[elastic] step budget exhausted by iter {prev}; "
                      f"rolled back to iter {itr} with "
                      f"max_steps={elastic.max_steps}", flush=True)
                continue
            train_losses.append(float(loss))
            elastic.snapshot(itr, rng.get_state(), train_state())
        elif ckpt_due:
            checkpoint(itr, loss)

    if chunked:
        retire(chunk)
        print("[scan_chunk] {chunks} chunks, {steps} steps, {host_reads} "
              "host reads, {captures} captures".format(**chunk_stats))
    # ---------------------------------------------------------------- final
    ev = evaluate()
    if not np.isfinite(ev["loss"]):
        print("[warn] final evaluation is non-finite (step budget exhausted "
              "after the last recovery boundary?); results recorded as-is",
              flush=True)
    t_total = time.time() - t_start
    print("Total Time {:.4f}".format(t_total))
    final = {"abs_error": ev["loss"], "rel_error": ev["rel"],
             "abs_error2": ev["loss2"], "rel_error2": ev["rel2"],
             "train_loss": float(loss), "train_rel": float(rel)}
    results.update(total_time=t_total, final=final,
                   elastic_retries=elastic.total_rollbacks)
    out = {"final": final, "train_losses": train_losses,
           "final_nfe": int(ev["nfe"]), "max_steps": elastic.max_steps,
           "scan_chunk": chunk_stats if chunked else None,
           "elastic_retries": elastic.total_rollbacks, "total_time": t_total,
           "device": str(device), "n_params": n_params}

    if args.dump and lead:
        results_dir = (args.results_dir
                       or f"results/{dynamics_kind}/{args.network}")
        path = results_lib.results_path(results_dir, args.baseline)
        results_lib.dump_results(results, path)
        print("Dump results as: " + path)
        if results_lib.load_results(path)["v_iter"] != results["v_iter"]:
            raise RuntimeError(f"the dump {path} does not read back")
        out["results_path"] = path

    if args.viz and lead:
        from ndcn_tpu_torch.report import viz
        viz.adjacency_heatmap(adj, args.network)
        viz.dynamics_surfaces(dynamics_kind, args.network, side,
                              results_lib.as_numpy(true_y),
                              results_lib.as_numpy(ev["pred_test"]))

    if args.export:
        # the trained model's trajectory forward over the run's full
        # observation grid (the reference's eval protocol) becomes the
        # serving artifact; its runtime input is x0 alone
        from ndcn_tpu_torch.serve import export_ndcn, save_artifact

        blob = export_ndcn(model, op, splits.t, tuple(true_y0.shape),
                           rtol=args.rtol, atol=args.atol, method=args.method,
                           max_steps=1 << 14, **flags)
        save_artifact(args.export, blob)
        print(f"exported serving artifact ({len(blob):,} bytes) -> "
              f"{args.export}", flush=True)
        out["export"] = args.export
    return out


def _run_replicas(dynamics_kind: str, args: argparse.Namespace,
                  device: torch.device, ctx: Dict[str, Any]) -> Dict[str, Any]:
    """``--replicas R``: the JAX driver's vmapped sweep, as one stacked
    model and one launch stream (see the module docstring); under a mesh,
    this data rank's replicas on this model rank's rows."""
    from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
    from ndcn_tpu_torch.ode import nan_unless
    from ndcn_tpu_torch.parallel.coo_shard import gather_nodes, node_group
    from ndcn_tpu_torch.parallel.mesh import (gather_replicas, rank,
                                              replica_range, shard_mean)
    from ndcn_tpu_torch.parallel.sweep import (batched_init, gather_stacked,
                                               replica_l1,
                                               replica_generators,
                                               unstack_model)
    from ndcn_tpu_torch.report import results as results_lib
    from ndcn_tpu_torch.train.budget import probe_step_budget_multi
    from ndcn_tpu_torch.train.optim import make_replica_sgd_step, torch_adam

    r = args.replicas
    op, splits, true_y0 = ctx["op"], ctx["splits"], ctx["true_y0"]
    true_y_train, true_y_test = ctx["true_y_train"], ctx["true_y_test"]
    true_y_test2 = ctx["true_y_test2"]
    id_test, id_test2 = splits.id_test, splits.id_test2
    solve_kw, levers = ctx["solve_kw"], ctx["levers"]
    flags = {k: solve_kw[k] for k in ("no_embed", "no_control")}
    mesh, group = ctx["mesh"], node_group(op)
    lo, hi = (0, r) if mesh is None else replica_range(mesh, r)
    data_group = None if mesh is None else mesh.data_group

    def init_one(g):
        return init_ndcn(g, 1, args.hidden, 1, device=device, **flags)

    gens = replica_generators(args.seed, r)
    max_steps = args.max_steps
    if max_steps <= 0 and args.method in ("dopri5", "tsit5"):
        # one replica cannot be rolled back: size the shared budget for the
        # hardest of several probed inits (the sweep's own), with headroom
        def probe_with(g):
            model = init_one(torch.Generator().set_state(g.get_state()))
            return lambda: ndcn_forward(model, op, splits.t, true_y0,
                                        nondiff=True, max_steps=1 << 14,
                                        **solve_kw)[1]

        max_steps = probe_step_budget_multi(
            [probe_with(g) for g in gens[:min(4, r)]])
        print(f"auto step budget: max_steps={max_steps}")
    elif max_steps <= 0:
        max_steps = 256
    model = batched_init(init_one, gens[lo:hi])
    rngs = replica_generators(args.seed + 1, r)[lo:hi]
    n_params = sum(p.numel() for p in model.parameters()) // (hi - lo)
    print(f"Total {n_params:d} Trainable {n_params:d} (x {r} replicas)")

    def forward(vt, rng=None, adjoint=False):
        out, stats = ndcn_forward(model, op, vt, true_y0,
                                  dropout=args.dropout, rng=rng,
                                  adjoint=adjoint, max_steps=max_steps,
                                  **solve_kw, **levers)
        return out[..., 0].permute(1, 2, 0), stats       # (R, n, T)

    def train_loss():
        pred, stats = forward(splits.t[splits.id_train], rngs,
                              adjoint=args.adjoint)
        losses = nan_unless(stats.success,
                            replica_l1(pred, true_y_train, group))
        return losses, losses / shard_mean(true_y_train, group)

    def evaluate():
        """Every replica's test metrics (gathered over the data axis) and
        predictions (over both axes)."""
        with torch.no_grad():
            pred, stats = forward(splits.t)
            pred = nan_unless(stats.success, pred)
            ev = {"pred_test": pred[..., id_test]}
            ev["loss"] = replica_l1(ev["pred_test"], true_y_test, group)
            ev["rel"] = ev["loss"] / shard_mean(true_y_test, group)
            if id_test2 is not None:
                ev["pred_test2"] = pred[..., id_test2]
                ev["loss2"] = replica_l1(ev["pred_test2"], true_y_test2,
                                         group)
                ev["rel2"] = ev["loss2"] / shard_mean(true_y_test2, group)
            else:
                ev["loss2"] = ev["rel2"] = torch.zeros(hi - lo,
                                                       device=pred.device)
            for k in ("pred_test", "pred_test2"):
                if k in ev:
                    ev[k] = gather_nodes(ev[k], op, axis=1)
        return {k: gather_replicas(v, data_group).cpu().numpy()
                for k, v in ev.items()}

    opt = torch_adam(model.parameters(), args.lr, args.weight_decay)
    step = make_replica_sgd_step(opt, train_loss, group)
    t_start = ctx["t_start"]
    train_losses = []
    for itr in range(1, args.niters + 1):
        losses, rels = step()
        if itr % args.test_freq == 0:
            ev = evaluate()
            rels = gather_replicas(rels, data_group).cpu().numpy()
            train_losses.append(
                gather_replicas(losses, data_group).cpu().numpy().tolist())
            print(f"Iter {itr:04d}| {r} replicas | train rel "
                  f"{float(np.mean(rels)):.6f}±{float(np.std(rels)):.6f} "
                  f"| test rel {float(np.mean(ev['rel'])):.6f}"
                  f"±{float(np.std(ev['rel'])):.6f} "
                  f"| Time {time.time() - t_start:.4f}", flush=True)

    ev = evaluate()
    t_total = time.time() - t_start
    print("Total Time {:.4f}".format(t_total))
    out = {"final": {
        "abs_error": float(np.mean(ev["loss"])),
        "rel_error": float(np.mean(ev["rel"])),
        "rel_error_std": float(np.std(ev["rel"])),
        "abs_error2": float(np.mean(ev["loss2"])),
        "rel_error2": float(np.mean(ev["rel2"])),
    }, "replicas": r, "total_time": t_total, "max_steps": max_steps,
        "train_losses": train_losses, "device": str(device)}
    if args.dump:
        every = gather_stacked(model, data_group)
        results_dir = (args.results_dir
                       or f"results/{dynamics_kind}/{args.network}")
        has2 = id_test2 is not None
        paths = []
        for i in range(r if rank() == 0 else 0):
            res_i = results_lib.new_results_dict(vars(args))
            results_lib.record_eval(
                res_i, args.niters, float(ev["loss"][i]), float(ev["rel"][i]),
                ev["pred_test"][i], unstack_model(every, i),
                abs_error2=float(ev["loss2"][i]) if has2 else None,
                rel_error2=float(ev["rel2"][i]) if has2 else None,
                predict_y2=ev["pred_test2"][i] if has2 else None)
            res_i["total_time"] = t_total / r
            paths.append(results_lib.dump_results(
                res_i, results_lib.results_path(results_dir, args.baseline,
                                                appendix=f"replica{i:03d}")))
        if paths:
            print(f"Dumped {r} replica results under {results_dir}")
        out["results_paths"] = paths
    return out


def main(dynamics_kind: str, title: str, argv=None) -> Dict[str, Any]:
    args = build_parser(title).parse_args(argv)
    return run(dynamics_kind, args)
