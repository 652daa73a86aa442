"""The dynamics experiments (heat, mutualistic, gene), as
``ndcn_tpu/experiments/dynamics.py``.

Same flag surface, defaults, split semantics, losses and printed progress
lines as the JAX package's experiment (and the reference's). The flow: graph →
``sample_times`` → operator → ground truth (the inference solve of the
physics at rtol 1e-7, atol 1e-9, on the CPU as the JAX package does) → NDCN
from a ``torch.Generator`` → step budget (probed on the training device for
the adaptive solve, 256 otherwise) → train loop with elastic rollback and an
evaluation every ``test_freq`` iterations. The physics propagates through
L = D - A for heat and through the raw adjacency for mutualistic and gene;
mutualistic cannot use BSR blocks, so there its physics operator is COO.

``--platform gpu`` (the default) trains on the first CUDA device and raises
without one; ``--platform cpu`` runs the kernels' plain versions. Matrix
products are pinned to full fp32 on both. What is not ported raises
``NotImplementedError`` naming its ROADMAP item before any work is done.
"""

from __future__ import annotations

import argparse
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
    p.add_argument("--scan_chunk", type=int, default=0)
    p.add_argument("--mesh", action="store_true")
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--export", type=str, default=None, metavar="PATH")
    p.add_argument("--platform", type=str, default="gpu",
                   choices=["gpu", "cpu"],
                   help="gpu: the first CUDA device and the CUDA kernels "
                        "(raises without one); cpu: the plain versions")
    p.add_argument("--precision", type=str, default="default",
                   choices=["default", "high", "float32", "highest"],
                   help="matmul precision; the port pins full fp32 "
                        "(default = highest = float32); high (TF32) is not "
                        "ported")
    return p


def _refuse_unported(dynamics_kind: str, args: argparse.Namespace) -> None:
    """Raise before any work for what the port does not have yet."""
    from ndcn_tpu_torch.ode.api import require_ported

    if args.emission_precision != "f32" and (
            args.method not in ("dopri5", "tsit5") or args.adjoint):
        # the emission options reach the differentiable adaptive solve only;
        # accepting the flag elsewhere would be a silent no-op
        raise SystemExit("--emission_precision bf16 applies only to the "
                         "differentiable adaptive solve (--method dopri5/"
                         "tsit5, without --adjoint); it would be a silent "
                         "no-op for this configuration")
    refused = [
        (args.baseline in TEMPORAL_BASELINES,
         f"--baseline {args.baseline} (temporal GNN baselines): ROADMAP "
         f"item 7"),
        (args.adjoint, "--adjoint: ROADMAP item 5"),
        (args.replicas > 1, "--replicas: ROADMAP item 8"),
        (args.mesh, "--mesh: ROADMAP item 8"),
        (args.export, "--export: ROADMAP item 8"),
        (args.ckpt_dir, "--ckpt_dir: ROADMAP item 3"),
        (args.scan_chunk > 0,
         "--scan_chunk (steps per dispatch; CUDA graphs here): ROADMAP "
         "item 4"),
        (args.profile_dir, "--profile_dir: ROADMAP item 7"),
        (args.dump or args.viz, "--dump / --viz (report/): ROADMAP item 7"),
        (args.precision == "high", "--precision high (TF32): ROADMAP item 4"),
    ]
    for cond, what in refused:
        if cond:
            raise NotImplementedError(f"not ported yet: {what}")
    require_ported(args.method)


def select_device(platform: str) -> torch.device:
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--platform gpu needs a CUDA device and none is "
                           "visible; pass --platform cpu to run the plain "
                           "versions on the CPU")
    return torch.device("cuda", 0)


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

    _refuse_unported(dynamics_kind, args)
    device = select_device(args.platform)
    # --kernel_precision bf16 sets the JAX package's GATHER_BF16 for the run
    with coo_spmv.gather_precision(args.kernel_precision == "bf16"):
        return _run(dynamics_kind, args, device)


def _run(dynamics_kind: str, args: argparse.Namespace,
         device: torch.device) -> Dict[str, Any]:

    from ndcn_tpu_torch.graph import generators, operators
    from ndcn_tpu_torch.graph.sparse import as_operator
    from ndcn_tpu_torch.kernels.platform import pin_fp32
    from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
    from ndcn_tpu_torch.train.budget import probe_step_budget
    from ndcn_tpu_torch.train.elastic import ElasticBudget
    from ndcn_tpu_torch.train.losses import l1_loss
    from ndcn_tpu_torch.train.optim import make_sgd_step, torch_adam
    from ndcn_tpu_torch.train.sampling import sample_times

    pin_fp32()
    t_start = time.time()

    # ---------------------------------------------------------------- graph
    print(f"Choose graph: {args.network}")
    adj = generators.build_network(args.network, args.n)
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

    # ----------------------------------------------------------------- model
    flags = dict(no_embed=args.baseline == "no_embed",
                 no_graph=args.baseline == "no_graph",
                 no_control=args.baseline == "no_control")
    print("Choose model:" + args.baseline)
    model = init_ndcn(torch.Generator().manual_seed(args.seed), 1,
                      args.hidden, 1, no_embed=flags["no_embed"],
                      no_control=flags["no_control"], device=device)
    fused = "auto" if args.fused_kernel else False
    solve_kw = dict(rtol=args.rtol, atol=args.atol, method=args.method,
                    fused=fused, **flags)
    levers = dict(
        emission_dtype=(torch.bfloat16 if args.emission_precision == "bf16"
                        else None),
        residual_dtype=(torch.bfloat16 if args.residual_precision == "bf16"
                        else None))

    max_steps, budget_is_auto = args.max_steps, False
    if max_steps <= 0 and args.method not in ("dopri5", "tsit5"):
        max_steps = 256        # the fixed-grid methods take no budget
    elif max_steps <= 0:
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

    def forward(vt, rng=None):
        out, stats = ndcn_forward(model, op, vt, true_y0,
                                  dropout=args.dropout, rng=rng,
                                  max_steps=elastic.max_steps, **solve_kw,
                                  **levers)
        return out[..., 0].T, stats                      # (n, T)

    def train_loss(rng):
        pred, stats = forward(t_train, rng)
        loss = l1_loss(pred, true_y_train)
        # a blown step budget must be loud (NaN), not silently wrong
        loss = torch.where(torch.tensor(stats.success, device=device), loss,
                           torch.full_like(loss, float("nan")))
        return loss, loss / torch.mean(true_y_train)

    def evaluate():
        with torch.no_grad():
            pred, stats = forward(splits.t)
            if not stats.success:
                # budget exhaustion is loud here too: the full-grid solve
                # can outgrow a budget the train solve still fits
                pred = torch.full_like(pred, float("nan"))
            loss_t = l1_loss(pred[:, id_test], true_y_test)
            ev = dict(loss=float(loss_t),
                      rel=float(loss_t / torch.mean(true_y_test)),
                      loss2=0.0, rel2=0.0)
            if id_test2 is not None:
                loss2 = l1_loss(pred[:, id_test2], true_y_test2)
                ev["loss2"] = float(loss2)
                ev["rel2"] = float(loss2 / torch.mean(true_y_test2))
        return ev

    def report(itr, loss, rel) -> bool:
        """Evaluate and print at test_freq; False when the evaluation solve
        exhausted the shared budget (roll back)."""
        if itr % args.test_freq != 0:
            return True
        ev = evaluate()
        if elastic.exhausted(ev["loss"]):
            return False
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
    opt = torch_adam(model.parameters(), args.lr, args.weight_decay)
    train_step = make_sgd_step(opt, train_loss)
    rng = torch.Generator().manual_seed(args.seed + 1)

    def train_state():
        return model.state_dict(), opt.state_dict()

    # Elastic step-budget recovery (auto budgets only): exhaustion surfaces
    # as a NaN train loss; roll back to the last finite-loss snapshot, double
    # the budget and replay with the same generator state.
    elastic.snapshot(0, rng.get_state(), train_state())
    loss = rel = torch.tensor(0.0)
    itr = 0
    train_losses = []
    while itr < args.niters:
        itr += 1
        loss, rel = train_step(rng)
        if itr % args.test_freq == 0 or itr >= args.niters:
            # the loss read syncs the device: only at report cadence
            if elastic.exhausted(float(loss)) or not report(itr, loss, rel):
                prev = itr
                itr, rng_state, (model_sd, opt_sd) = elastic.rollback()
                model.load_state_dict(model_sd)
                opt.load_state_dict(opt_sd)
                rng.set_state(rng_state)
                print(f"[elastic] step budget exhausted by iter {prev}; "
                      f"rolled back to iter {itr} with "
                      f"max_steps={elastic.max_steps}", flush=True)
                continue
            train_losses.append(float(loss))
            elastic.snapshot(itr, rng.get_state(), train_state())

    # ---------------------------------------------------------------- final
    ev = evaluate()
    if not np.isfinite(ev["loss"]):
        print("[warn] final evaluation is non-finite (step budget exhausted "
              "after the last recovery boundary?); results recorded as-is",
              flush=True)
    t_total = time.time() - t_start
    print("Total Time {:.4f}".format(t_total))
    return {
        "final": {"abs_error": ev["loss"], "rel_error": ev["rel"],
                  "abs_error2": ev["loss2"], "rel_error2": ev["rel2"],
                  "train_loss": float(loss), "train_rel": float(rel)},
        "train_losses": train_losses, "max_steps": elastic.max_steps,
        "elastic_retries": elastic.total_rollbacks, "total_time": t_total,
        "device": str(device),
    }


def main(dynamics_kind: str, title: str, argv=None) -> Dict[str, Any]:
    args = build_parser(title).parse_args(argv)
    return run(dynamics_kind, args)
