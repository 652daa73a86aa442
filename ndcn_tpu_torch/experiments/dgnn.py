"""Semi-supervised node classification on the citation networks, as
``ndcn_tpu/experiments/dgnn.py`` (reference: dgnn.py).

The JAX driver's flag surface and defaults (hidden 16, dropout 0.5, weight
decay 5e-4, T 2, tick 5, dopri5 with rtol = atol = 0.1, alpha 0.5), its model
list (the GCN zoo, ``odeGCN`` and ``differential_gcn``), its epoch protocol
(a train step; an evaluation re-forward unless ``--fastmode``; the five
epoch statistics read in one host transfer), its per-epoch log line, the
``--iter`` loop that keeps training one model across iterations, the auto
step budget with elastic rollback and budget doubling, ``--ckpt_dir`` /
``--ckpt_freq`` (global step ``it·epochs + epoch``; the dropout generator's
state and the result rows ride in the checkpoint) and ``--dump`` (the
results txt and the accuracy summary). ``--export PATH`` writes the last
iteration's model (odeGCN, differential_gcn) as the serving artifact,
features → (logits, success) (``serve.export_ndcn``, every ``--method``).

Dense below 8193 nodes unless ``--sparse``; sparse formats coo (K1), ell
(gather and einsum) and bsr (K3). ``--platform gpu`` (the default) trains on
the first CUDA device and raises without one; ``--platform cpu`` runs the
kernels' plain versions. Matrix products are pinned to full fp32.

``--batch_iters`` trains ``--iter`` independent replicas at once (the JAX
driver's vmapped sweep, for GCN, DeepGCN, DeepGCN2, DeepGCN4, odeGCN and
differential_gcn): replica i is initialised and drops out from generators
seeded ``--seed`` + i and + 1 + i (``--seed`` -1 counts as 0), i.e. as the
single-model run at seed ``--seed`` + i; one stacked model, one launch
stream an epoch (``parallel.sweep``). The ODE models run every
``--method`` (adams through ``ode.vcabm.solve_vcabm_batched``); their step
budget is sized, for dopri5 and tsit5, from the hardest of min(4, R)
probed inits (64 for the other methods), or with ``--budget_buckets B``
from every replica's own probe, the replicas grouped into at most B
buckets that train one after another, each at its own budget. A replica
that exhausts its budget cannot be rolled back: its logits read NaN and the
driver names it. On the card the sweep is refused before it trains when
its estimate exceeds 0.85 of the card's memory: the measured training
step of a sweep of the first min(4, R) replicas, per replica, times R (the
largest bucket's size).

The port's solver is a host loop that knows at once whether a solve
exhausted its budget, so a NaN epoch is rolled back before the next epoch
starts: snapshots and checkpoints only ever hold a state whose epoch was
verified finite.

``--mesh`` under ``torchrun --nproc_per_node P`` (P > 1) lays the ranks
out as ``make_mesh(data_divides=R, model_divides=n)`` (R the ``--iter``
replicas of ``--batch_iters``, else 1) and shards the operator, the
features and the labels over the model axis
(``parallel.sweep.shard_operator``: K1 on each rank's row block, dense rows
through ``torch.matmul``); the losses and accuracies are over every rank's
split nodes and the replicated parameters' gradients are summed over the
model axis; with ``--batch_iters`` each data rank trains its R / data
replicas (``--budget_buckets`` is ignored, as in JAX) and the report
gathers every replica; rank 0 writes the checkpoints and the dump. The
GCN zoo runs on the rank's rows too (``models.gcn_zoo``), with and
without ``--batch_iters``. A world of one prints the JAX driver's notice
and runs unsharded.

Usage: python -m ndcn_tpu_torch.experiments.dgnn --dataset cora \\
           --model differential_gcn --iter 5 --dropout 0 --hidden 256 \\
           --T 1.2 --time_tick 16 --epochs 100 --weight_decay 0.024 \\
           --no_control --method dopri5 --alpha 0 [--platform cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import os
import time
from typing import Any, Dict

import numpy as np
import torch

MODELS = ("DeepGCN", "GCN", "DeepGCN2", "DeepGCN3", "DeepGCN4", "resGCN",
          "odeGCN", "differential_gcn")
# the models --batch_iters trains (the JAX driver's list)
BATCHED_MODELS = ("differential_gcn", "odeGCN", "GCN", "DeepGCN", "DeepGCN2",
                  "DeepGCN4")


def build_parser() -> argparse.ArgumentParser:
    """The JAX driver's flags (dgnn.py:31-104), with ``--platform`` and
    ``--precision`` as the port's dynamics experiments have them."""
    p = argparse.ArgumentParser("dgnn")
    p.add_argument("--fastmode", action="store_true", default=False,
                   help="skip the eval-mode re-forward for val metrics")
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--rtol", type=float, default=0.1)
    p.add_argument("--atol", type=float, default=0.1)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("-nhl", "--nHiddenLayers", type=int, default=0)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--dataset", type=str, default="cora")
    p.add_argument("--model", type=str, default="GCN", choices=list(MODELS))
    p.add_argument("--iter", type=int, default=1)
    p.add_argument("--dump", action="store_true", default=False)
    p.add_argument("--delta", type=float, default=1.0)
    p.add_argument("--normalize", action="store_true", default=False)
    p.add_argument("--Euler", action="store_true", default=False)
    p.add_argument("--T", type=float, default=2.0)
    p.add_argument("--time_tick", type=int, default=5)
    p.add_argument("--no_control", action="store_true")
    p.add_argument("--method", type=str, default="dopri5",
                   choices=["dopri5", "adams", "explicit_adams", "fixed_adams",
                            "tsit5", "euler", "midpoint", "rk4"])
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--sparse", action="store_true",
                   help="sparse operator (auto for > 8192 nodes)")
    p.add_argument("--sparse_format", type=str, default="coo",
                   choices=["coo", "ell", "bsr"],
                   help="sparse layout: coo (K1), ell (gather and einsum) "
                        "or bsr (K3, 128 x 128 blocks)")
    p.add_argument("--max_steps", type=int, default=0,
                   help="adaptive step budget for the differentiable solve "
                        "(0 = auto-size from a probe solve at init)")
    p.add_argument("--batch_iters", action="store_true",
                   help="train --iter independent replicas at once (one "
                        "stacked model and one launch stream; differs from "
                        "the reference's accumulating --iter loop)")
    p.add_argument("--budget_buckets", type=int, default=1,
                   help="with --batch_iters and an auto budget: probe every "
                        "replica init and train the sweep as up to this "
                        "many batched programs grouped by step budget")
    p.add_argument("--mesh", action="store_true",
                   help="shard the nodes over the torchrun ranks (a world "
                        "of one runs unsharded)")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="enable periodic checkpoint / resume in this "
                        "directory")
    p.add_argument("--ckpt_freq", type=int, default=25,
                   help="checkpoint every this many epochs (global step = "
                        "iter*epochs + epoch, so resume lands mid-ITER too)")
    p.add_argument("--export", type=str, default=None, metavar="PATH",
                   help="serialize the trained inference forward "
                        "(serve.export_ndcn) to PATH")
    p.add_argument("--platform", type=str, default="gpu",
                   choices=["gpu", "cpu"],
                   help="gpu: the first CUDA device and the CUDA kernels "
                        "(raises without one); cpu: the plain versions")
    p.add_argument("--precision", type=str, default="default",
                   choices=["default", "high", "float32", "highest"],
                   help="matmul precision of PyTorch's float32 "
                        "products: full fp32 (default = highest = float32) "
                        "or high (TF32); the hand-written kernels keep "
                        "theirs")
    return p


def _refuse(args: argparse.Namespace) -> None:
    """The JAX driver's own argument errors (dgnn.py:108-124), then what
    the port does not have yet, all before any data loads."""
    if args.export:
        if args.model not in ("differential_gcn", "odeGCN"):
            raise SystemExit("--export serializes the continuous-time "
                             "inference forward; use --model "
                             "differential_gcn or odeGCN")
        if args.batch_iters:
            raise SystemExit("--export needs the single-model path "
                             "(drop --batch_iters)")
        if args.mesh:
            raise SystemExit("--export produces a single-device serving "
                             "artifact (drop --mesh)")
    if args.ckpt_dir and args.batch_iters:
        raise SystemExit("--ckpt_dir needs the single-model path "
                         "(drop --batch_iters)")
    if args.batch_iters and args.model not in BATCHED_MODELS:
        raise SystemExit(f"--batch_iters unsupported for {args.model}")


def run(args: argparse.Namespace) -> Dict[str, Any]:
    from ndcn_tpu_torch.experiments.dynamics import select_device
    from ndcn_tpu_torch.kernels.platform import matmul_precision
    from ndcn_tpu_torch.parallel.mesh import process_group, world_size

    _refuse(args)
    device = select_device(args.platform)
    with (process_group(device) if args.mesh and world_size() > 1
          else contextlib.nullcontext()), matmul_precision(args.precision):
        return _run(args, device)


def _run(args: argparse.Namespace, device: torch.device) -> Dict[str, Any]:
    from ndcn_tpu_torch.data import load_planetoid
    from ndcn_tpu_torch.graph.sparse import as_operator
    from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
    from ndcn_tpu_torch.models.gcn_zoo import build_zoo_model
    from ndcn_tpu_torch.parallel.coo_shard import (node_group, take_index,
                                                   take_rows)
    from ndcn_tpu_torch.parallel.mesh import (all_reduce_grads, make_mesh,
                                              rank, world_size)
    from ndcn_tpu_torch.parallel.sweep import shard_operator
    from ndcn_tpu_torch.train.budget import probe_step_budget
    from ndcn_tpu_torch.train.checkpoint import (restore_with_extra,
                                                 save_checkpoint)
    from ndcn_tpu_torch.train.elastic import ElasticBudget
    from ndcn_tpu_torch.train.losses import accuracy, cross_entropy
    from ndcn_tpu_torch.train.optim import torch_adam

    if args.seed != -1:
        np.random.seed(args.seed)
    t_very_beginning = time.time()

    data = load_planetoid(args.dataset, alpha=args.alpha,
                          data_dir=args.data_dir)
    print("Load data done")
    n, in_dim = data.features.shape
    num_classes = int(data.labels.max()) + 1
    use_sparse = args.sparse or n > 8192
    op = as_operator(data.operator, sparse=use_sparse,
                     format=args.sparse_format, device=device)

    features = torch.as_tensor(data.features, device=device)
    labels = torch.as_tensor(data.labels, device=device).long()
    # the validation split is the 500 nodes after the train nodes, which a
    # small graph may not have: clamp to the last node, as the JAX driver's
    # gathers clamp an index out of range
    idx_train, idx_val, idx_test = (
        torch.as_tensor(np.minimum(idx, n - 1), device=device).long()
        for idx in (data.idx_train, data.idx_val, data.idx_test))

    if args.mesh and world_size() > 1:
        # --batch_iters' replicas over the ranks' data axis, the
        # operator's rows and the node-major arrays over their model axis,
        # the parameters replicated; each split keeps this rank's nodes
        mesh = make_mesh(device, data_divides=(args.iter if args.batch_iters
                                               else 1), model_divides=n)
        print(f"mesh: {mesh.shape}")
        op = shard_operator(mesh, op)
        features, labels = take_rows(features, op), take_rows(labels, op)
        idx_train, idx_val, idx_test = (take_index(i, op) for i in
                                        (idx_train, idx_val, idx_test))
    else:
        mesh = None
        if args.mesh:
            print("--mesh: single device visible; running unsharded")
    group = node_group(op)
    lead = rank() == 0              # the rank that writes files

    seed = args.seed if args.seed != -1 else 0
    if args.batch_iters:
        return _run_batched(args, device, data, op, features, labels,
                            (idx_train, idx_test), seed, t_very_beginning,
                            mesh)
    init_gen = torch.Generator().manual_seed(seed)
    # the dropout masks: drawn on the CPU, so card and CPU drop alike
    rng = torch.Generator().manual_seed(seed + 1)

    # ------------------------------------------------------------ model zoo
    model_name = args.model
    budget_is_auto, max_steps = False, 0
    if model_name in ("odeGCN", "differential_gcn"):
        if model_name == "odeGCN":
            # the reference's odeGCN wiring cannot run (ODEBlock.forward
            # takes (vt, x) inside nn.Sequential); this is its evident
            # intent, as in the JAX package: encoder → ODE(relu(dropout(A
            # h))) over linspace(0, 1.9, 10), terminal state → decoder
            no_control, enc_layers = True, 2
            vt_model = np.linspace(0, 1.9, 10).astype(np.float32)
        else:
            print("T : {}, time tick: {}".format(args.T, args.time_tick))
            no_control, enc_layers = args.no_control, 1
            vt_model = np.linspace(0, args.T, args.time_tick).astype(
                np.float32)
        model = init_ndcn(init_gen, in_dim, args.hidden, num_classes,
                          no_control=no_control, encoder_layers=enc_layers,
                          device=device)
        solve_kw = dict(rtol=args.rtol, atol=args.atol, method=args.method,
                        terminal=True, no_control=no_control)

        max_steps = args.max_steps
        if max_steps <= 0 and args.method in ("dopri5", "tsit5"):
            def probe():
                return ndcn_forward(model, op, vt_model, features,
                                    max_steps=1 << 14, nondiff=True,
                                    **solve_kw)[1]

            # snug budget: the epoch loop recovers from exhaustion by
            # rollback and budget doubling (train/elastic.py)
            max_steps = probe_step_budget(probe, floor=8, headroom=2.5,
                                          slack=4, quantum=4)
            budget_is_auto = True
            print(f"auto step budget: max_steps={max_steps}")
        elif max_steps <= 0:
            max_steps = 64

        def apply(gen, deterministic, ms):
            out, stats = ndcn_forward(
                model, op, vt_model, features,
                dropout=0.0 if deterministic else args.dropout, rng=gen,
                max_steps=ms, **solve_kw)
            return out, stats.success
    else:
        model = build_zoo_model(model_name, in_dim, args.hidden, num_classes,
                                n, args.nHiddenLayers, generator=init_gen,
                                dropout=args.dropout, euler=args.Euler,
                                normalize=args.normalize).to(device)

        def apply(gen, deterministic, ms):
            return model(op, features, gen, deterministic), True

    opt = torch_adam(model.parameters(), args.lr, args.weight_decay)
    elastic = ElasticBudget(max_steps, enabled=budget_is_auto)
    snap_freq = 10

    def nan_unless(ok: bool, t: torch.Tensor) -> torch.Tensor:
        """``t``, or NaN where the solve exhausted its budget: a blown
        budget must be loud, never a silently truncated trajectory."""
        return torch.where(torch.tensor(bool(ok), device=t.device), t,
                           torch.full_like(t, float("nan")))

    def eval_logits() -> torch.Tensor:
        # the deterministic re-forward shares the snug budget and can
        # outgrow it where the dropout-masked train solve fits: its
        # exhaustion poisons the metrics, which the elastic check reads
        with torch.no_grad():
            logits, ok = apply(None, True, elastic.max_steps)
        return nan_unless(ok, logits)

    def epoch_step() -> np.ndarray:
        """The train step, the eval re-forward (unless --fastmode) and the
        five epoch statistics, read in one host transfer."""
        opt.zero_grad(set_to_none=True)
        logits, ok = apply(rng, False, elastic.max_steps)
        loss = nan_unless(ok, cross_entropy(logits[idx_train],
                                            labels[idx_train], group))
        loss.backward()
        all_reduce_grads(model.parameters(), group)
        opt.step()
        with torch.no_grad():
            logits = logits.detach() if args.fastmode else eval_logits()
            st = torch.stack([
                loss.detach(),
                cross_entropy(logits[idx_train], labels[idx_train], group),
                accuracy(logits[idx_train], labels[idx_train], group),
                cross_entropy(logits[idx_val], labels[idx_val], group),
                accuracy(logits[idx_val], labels[idx_val], group)])
        return st.cpu().numpy()

    def metrics(logits, idx):
        return (float(cross_entropy(logits[idx], labels[idx], group)),
                float(accuracy(logits[idx], labels[idx], group)))

    n_params = sum(p.numel() for p in model.parameters())
    print(f"{model_name}: {n_params:d} parameters on {device}")

    fout = fname = None
    if args.dump and lead:
        os.makedirs("results", exist_ok=True)
        stamp = datetime.datetime.now().__str__().replace(":", "-")
        fname = f"results/results_{stamp}.txt"
        fout = open(fname, "w")
        fout.write(vars(args).__str__() + "\n")
        fout.write("Time\tLoss\tAccuracy\tStep\n")

    def print_epoch(it, epoch, st, dt):
        print("ITER: {:04d}".format(it + 1),
              "Epoch: {:04d}".format(epoch + 1),
              "loss_train: {:.4f}".format(st[0]),
              "acc_train: {:.4f}".format(st[2]),
              "loss_val: {:.4f}".format(st[3]),
              "acc_val: {:.4f}".format(st[4]),
              "time: {:.4f}s".format(dt))

    def state():
        return model.state_dict(), opt.state_dict()

    def extra(rows):
        return {"rng": rng.get_state(), "rows": [list(r) for r in rows],
                "max_steps": elastic.max_steps}

    # --------------------------------------------------- checkpoint / resume
    # the global step is it·epochs + epoch; the dropout generator's state,
    # the step budget and the finished rows ride in the checkpoint's extra,
    # so a killed run resumes mid-ITER on the uninterrupted run's trajectory
    rows = []
    start_global, ckpt_extra = restore_with_extra(args.ckpt_dir, model, opt)
    if start_global:
        if "rng" in ckpt_extra:
            rng.set_state(ckpt_extra["rng"])
        if "max_steps" in ckpt_extra:
            elastic.max_steps = int(ckpt_extra["max_steps"])
        rows = [tuple(float(v) for v in r) for r in ckpt_extra.get("rows", [])]

    train_losses = []
    try:
        for it in range(args.iter):
            g0 = it * args.epochs
            if start_global >= g0 + args.epochs:
                continue  # finished before the checkpoint (rows restored)
            t_start = time.time()
            epoch = max(0, start_global - g0)
            elastic.snapshot(g0 + epoch, rng.get_state(), state())
            while epoch < args.epochs:
                t_epoch = time.time()
                # the state entering this epoch: every earlier epoch's
                # statistics were verified finite
                if elastic.enabled and epoch % snap_freq == 0:
                    elastic.snapshot(g0 + epoch, rng.get_state(), state())
                if (args.ckpt_dir and lead
                        and (g0 + epoch) % args.ckpt_freq == 0):
                    save_checkpoint(args.ckpt_dir, g0 + epoch, model, opt,
                                    extra=extra(rows))
                st = epoch_step()
                if elastic.exhausted(st):
                    cursor, rng_state, (model_sd, opt_sd) = elastic.rollback()
                    model.load_state_dict(model_sd)
                    opt.load_state_dict(opt_sd)
                    rng.set_state(rng_state)
                    print(f"[elastic] step budget exhausted at epoch {epoch}; "
                          f"rolled back to epoch {cursor - g0} with "
                          f"max_steps={elastic.max_steps}", flush=True)
                    epoch = cursor - g0
                    continue
                print_epoch(it, epoch, st, time.time() - t_epoch)
                train_losses.append(float(st[0]))
                epoch += 1
            print("Optimization Finished!")
            t_total = time.time() - t_start
            print("Total time elapsed: {:.4f}s".format(t_total))

            logits = eval_logits()
            loss_test, acc_test = metrics(logits, idx_test)
            if not np.isfinite(loss_test):
                print("[warn] final test eval is non-finite (step budget "
                      "exhausted on the last step?); row recorded as-is",
                      flush=True)
            print("Test set results:", "loss= {:.4f}".format(loss_test),
                  "accuracy= {:.4f}".format(acc_test))
            rows.append((t_total, loss_test, acc_test, 0.0))
            if fout is not None:
                fout.write("{:.5f}\t{:.5f}\t{:.5f}\t{:.5f}\n".format(*rows[-1]))
                fout.flush()
            if args.ckpt_dir and lead and np.isfinite(loss_test):
                # the iteration boundary: its row is durable, so a run
                # interrupted between iterations resumes at the next one
                save_checkpoint(args.ckpt_dir, g0 + args.epochs, model, opt,
                                extra=extra(rows))
    finally:
        if fout is not None:
            fout.close()

    total = time.time() - t_very_beginning
    print("DONE!\nTotal time: {:.4f}s;\n".format(total))
    summary: Dict[str, Any] = {
        "rows": rows, "total_time": total, "fname": fname,
        "elastic_retries": elastic.total_rollbacks,
        "max_steps": elastic.max_steps, "train_losses": train_losses,
        "device": str(device)}
    if args.export:
        # the last iteration's trained model becomes the serving artifact
        from ndcn_tpu_torch.serve import export_ndcn, save_artifact

        blob = export_ndcn(model, op, vt_model, tuple(features.shape),
                           terminal=True, no_control=no_control,
                           rtol=args.rtol, atol=args.atol, method=args.method,
                           max_steps=1 << 14)
        save_artifact(args.export, blob)
        print(f"exported serving artifact ({len(blob):,} bytes) -> "
              f"{args.export}")
        summary["export"] = args.export
    if args.dump and rows:
        accs = np.array([r[2] for r in rows])
        steps = np.array([r[3] for r in rows])
        summary.update(acc_mean=float(accs.mean()),
                       acc_std=(float(accs.std(ddof=1)) if len(accs) > 1
                                else 0.0),
                       acc_median=float(np.median(accs)),
                       acc_min=float(accs.min()), acc_max=float(accs.max()))
        print(vars(args).__str__())
        print("results: {:.3f}% +/- {:.3f}%, {:.3f}% (Median);".format(
            summary["acc_mean"] * 100, summary["acc_std"] * 100,
            summary["acc_median"] * 100))
        print("Min_Acc: {:.3f}%, Max_Acc: {:.3f}%".format(
            summary["acc_min"] * 100, summary["acc_max"] * 100))
        print("Time_Step: {:.5f};".format(float(steps.mean())))
    return summary


def _run_batched(args: argparse.Namespace, device: torch.device, data, op,
                 features: torch.Tensor, labels: torch.Tensor, idx,
                 seed: int, t_very_beginning: float,
                 mesh=None) -> Dict[str, Any]:
    """``--batch_iters``: ``--iter`` independent replicas in one stacked
    model, in budget buckets one after another (see the module docstring);
    the JAX driver's log lines, report and summary. Under a mesh, this data
    rank's replicas on this model rank's nodes, in one bucket."""
    from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
    from ndcn_tpu_torch.models.gcn_zoo import build_zoo_model
    from ndcn_tpu_torch.ode import nan_unless
    from ndcn_tpu_torch.parallel.coo_shard import node_group
    from ndcn_tpu_torch.parallel.mesh import (all_true, gather_replicas,
                                              replica_range, shard_mean)
    from ndcn_tpu_torch.parallel.sweep import (batched_init,
                                               replica_generators)
    from ndcn_tpu_torch.train.budget import (bucket_budgets,
                                             check_sweep_memory,
                                             probe_step_budget_each,
                                             probe_step_budget_multi,
                                             sweep_memory_estimate)
    from ndcn_tpu_torch.train.losses import accuracy, cross_entropy
    from ndcn_tpu_torch.train.optim import make_replica_sgd_step, torch_adam

    idx_train, idx_test = idx
    r = args.iter
    group = node_group(op)
    lo, hi = (0, r) if mesh is None else replica_range(mesh, r)
    data_group = None if mesh is None else mesh.data_group
    n, in_dim = data.features.shape
    num_classes = int(data.labels.max()) + 1
    model_name = args.model
    ode_model = model_name in ("odeGCN", "differential_gcn")
    init_gens = replica_generators(seed, r)
    drop_gens = replica_generators(seed + 1, r)

    def fresh(g: torch.Generator) -> torch.Generator:
        """A copy of ``g``: probes must not advance the sweep's streams."""
        return torch.Generator().set_state(g.get_state())

    max_steps, replica_budgets = 0, None
    if ode_model:
        if model_name == "odeGCN":
            no_control, enc_layers = True, 2
            vt_model = np.linspace(0, 1.9, 10).astype(np.float32)
        else:
            print("T : {}, time tick: {}".format(args.T, args.time_tick))
            no_control, enc_layers = args.no_control, 1
            vt_model = np.linspace(0, args.T, args.time_tick).astype(
                np.float32)
        solve_kw = dict(rtol=args.rtol, atol=args.atol, method=args.method,
                        terminal=True, no_control=no_control)

        def init_one(g):
            return init_ndcn(g, in_dim, args.hidden, num_classes,
                             no_control=no_control, encoder_layers=enc_layers,
                             device=device)

        max_steps = args.max_steps
        if max_steps <= 0 and args.method in ("dopri5", "tsit5"):
            def probe_with(g):
                model = init_one(fresh(g))
                return lambda: ndcn_forward(model, op, vt_model, features,
                                            max_steps=1 << 14, nondiff=True,
                                            **solve_kw)[1]

            if args.budget_buckets > 1 and mesh is None:
                # every replica's own budget, grouped into buckets below
                replica_budgets = probe_step_budget_each(
                    [probe_with(g) for g in init_gens])
                max_steps = int(max(replica_budgets))
            else:
                # one shared budget for the hardest of a few probed inits
                max_steps = probe_step_budget_multi(
                    [probe_with(g) for g in init_gens[:min(4, r)]])
            print(f"auto step budget: max_steps={max_steps}")
        elif max_steps <= 0:
            max_steps = 64

        def apply(model, gens, deterministic, ms):
            out, stats = ndcn_forward(
                model, op, vt_model, features,
                dropout=0.0 if deterministic else args.dropout, rng=gens,
                max_steps=ms, **solve_kw)
            return nan_unless(stats.success, out)
    else:
        def init_one(g):
            return build_zoo_model(model_name, in_dim, args.hidden,
                                   num_classes, n, args.nHiddenLayers,
                                   generator=g, dropout=args.dropout,
                                   euler=args.Euler,
                                   normalize=args.normalize).to(device)

        def apply(model, gens, deterministic, ms):
            return model(op, features, gens, deterministic)

    def replica_ce(logits: torch.Tensor) -> torch.Tensor:
        """Each replica's cross-entropy on the train rows (every rank's),
        (R,)."""
        rows = logits[:, idx_train]
        per_row = torch.nn.functional.cross_entropy(
            rows.reshape(-1, num_classes),
            labels[idx_train].repeat(rows.shape[0]), reduction="none")
        return shard_mean(per_row.view(rows.shape[0], -1), group,
                          per_replica=True)

    buckets = [(max_steps, np.arange(lo, hi))]
    if args.budget_buckets > 1 and mesh is not None:
        print("--budget_buckets ignored under --mesh (single shared "
              "budget)", flush=True)
    elif args.budget_buckets > 1 and replica_budgets is not None:
        buckets = bucket_budgets(replica_budgets, args.budget_buckets)
        print("budget buckets: " + ", ".join(
            f"{len(ix)} replica(s) @ max_steps {b}" for b, ix in buckets),
            flush=True)

    memory = None
    if ode_model:
        # the memory guard: the training step of a sweep of the first few
        # replicas, measured, per replica times the largest bucket (buckets
        # train one after another)
        widest = max(len(ix) for _, ix in buckets)
        probed = min(4, widest)

        def probe_step():
            model = batched_init(init_one,
                                 [fresh(g) for g in init_gens[:probed]])
            out = apply(model, [fresh(g) for g in drop_gens[:probed]], False,
                        max(b for b, _ in buckets))
            replica_ce(out).sum().backward()

        memory = sweep_memory_estimate(probe_step, widest, device, probed)
        if memory is not None:
            print(f"memory guard: ~{memory['estimate'] / 1e9:.2f} GB for "
                  f"{widest} replicas ({memory['per_replica'] / 1e6:.0f} MB "
                  f"each, limit {memory['limit'] / 1e9:.1f} GB)", flush=True)
        check_sweep_memory(memory, widest)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    logits_by_idx = {}
    t_start = time.time()
    epoch_losses = []   # each epoch's mean train loss over the bucket
    for bi, (ms_b, idxs) in enumerate(buckets):
        model = batched_init(init_one, [init_gens[i] for i in idxs])
        gens = [drop_gens[i] for i in idxs]
        opt = torch_adam(model.parameters(), args.lr, args.weight_decay)

        def objective(model=model, gens=gens, ms_b=ms_b):
            losses = replica_ce(apply(model, gens, False, ms_b))
            return losses, losses

        step = make_replica_sgd_step(opt, objective, group)
        tag = "" if len(buckets) == 1 else f" [bucket {bi}: ms {ms_b}]"
        for epoch in range(args.epochs):
            losses, _ = step()
            epoch_losses.append(losses.detach().mean())
            if (epoch + 1) % max(1, args.epochs // 10) == 0:
                losses = gather_replicas(losses, data_group)
                print(f"Epoch {epoch + 1:04d} | mean train loss "
                      f"{float(losses.mean()):.4f} | {len(losses)} replicas"
                      f"{tag} | time {time.time() - t_start:.2f}s",
                      flush=True)
        with torch.no_grad():
            logits_bucket = apply(model, None, True, ms_b)
        for j, i in enumerate(idxs):
            logits_by_idx[int(i)] = logits_bucket[j]
    # each replica's test metrics (over every model rank's test nodes),
    # then every data rank's replicas
    logits_b = [logits_by_idx[i] for i in sorted(logits_by_idx)]
    t_total = time.time() - t_start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    with torch.no_grad():
        test = [torch.stack([metric(lg[idx_test], labels[idx_test], group)
                             for lg in logits_b])
                for metric in (cross_entropy, accuracy)]
        finite = all_true(torch.stack([torch.isfinite(lg).all()
                                       for lg in logits_b]), group)
    losses_test, accs_test, finite = (
        gather_replicas(t, data_group).cpu().numpy()
        for t in (*test, finite))
    # a replica that exhausted its budget cannot be rolled back: name it
    dead = [i for i in range(r) if not finite[i]]
    if dead and ode_model:
        if args.max_steps > 0:
            origin = f"--max_steps {max_steps} was given explicitly"
        elif args.method not in ("dopri5", "tsit5"):
            origin = (f"default max_steps={max_steps} (no probe for "
                      f"method={args.method})")
        elif len(buckets) > 1:
            origin = "probe-sized one per bucket"
        else:
            origin = (f"probe-sized max_steps={max_steps} from the hardest "
                      f"of {min(4, r)} probed inits")
        print(f"[budget] replicas {dead} exhausted their step budget during "
              f"training — their rows are NaN; re-run with a larger "
              f"--max_steps (budgets: {origin})", flush=True)
    elif dead:
        print(f"[warn] replicas {dead} produced non-finite logits",
              flush=True)
    rows = []
    for i in range(r):
        loss_test, acc_test = float(losses_test[i]), float(accs_test[i])
        rows.append((t_total / r, loss_test, acc_test, 0.0))
        print(f"Replica {i}: test loss= {loss_test:.4f} "
              f"accuracy= {acc_test:.4f}")
    accs = np.array([row[2] for row in rows])
    print("results: {:.3f}% +/- {:.3f}%, {:.3f}% (Median);".format(
        accs.mean() * 100, accs.std(ddof=1) * 100 if r > 1 else 0.0,
        float(np.median(accs)) * 100))
    print(f"batched sweep: {r} replicas x {args.epochs} epochs in "
          f"{t_total:.2f}s total ({t_total / r:.3f}s per replica)")
    return {"rows": rows, "total_time": time.time() - t_very_beginning,
            "fname": None,
            "acc_mean": float(accs.mean()),
            "acc_std": float(accs.std(ddof=1)) if r > 1 else 0.0,
            "acc_median": float(np.median(accs)),
            "acc_min": float(accs.min()), "acc_max": float(accs.max()),
            "sweep_seconds": t_total, "max_steps": max_steps,
            "train_losses": torch.stack(epoch_losses).tolist(),
            "buckets": [(int(b), [int(i) for i in ix]) for b, ix in buckets],
            "dead": dead, "memory": memory, "peak_bytes": peak,
            "device": str(device)}


def main(argv=None) -> Dict[str, Any]:
    args, _ = build_parser().parse_known_args(argv)
    return run(args)


if __name__ == "__main__":
    main()
