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
results txt and the accuracy summary).

Dense below 8193 nodes unless ``--sparse``; sparse formats coo (K1), ell
(gather and einsum) and bsr (K3). ``--platform gpu`` (the default) trains on
the first CUDA device and raises without one; ``--platform cpu`` runs the
kernels' plain versions. Matrix products are pinned to full fp32.

The port's solver is a host loop that knows at once whether a solve
exhausted its budget, so a NaN epoch is rolled back before the next epoch
starts: snapshots and checkpoints only ever hold a state whose epoch was
verified finite. What is not ported raises ``NotImplementedError`` naming
its ROADMAP entry before any data loads.

Usage: python -m ndcn_tpu_torch.experiments.dgnn --dataset cora \\
           --model differential_gcn --iter 5 --dropout 0 --hidden 256 \\
           --T 1.2 --time_tick 16 --epochs 100 --weight_decay 0.024 \\
           --no_control --method dopri5 --alpha 0 [--platform cpu]
"""

from __future__ import annotations

import argparse
import datetime
import os
import time
from typing import Any, Dict

import numpy as np
import torch

MODELS = ("DeepGCN", "GCN", "DeepGCN2", "DeepGCN3", "DeepGCN4", "resGCN",
          "odeGCN", "differential_gcn")


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
                   help="train --iter independent replicas at once (not "
                        "ported)")
    p.add_argument("--budget_buckets", type=int, default=1,
                   help="with --batch_iters: group replicas by step budget "
                        "(not ported)")
    p.add_argument("--mesh", action="store_true",
                   help="shard over several devices (not ported)")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="enable periodic checkpoint / resume in this "
                        "directory")
    p.add_argument("--ckpt_freq", type=int, default=25,
                   help="checkpoint every this many epochs (global step = "
                        "iter*epochs + epoch, so resume lands mid-ITER too)")
    p.add_argument("--export", type=str, default=None, metavar="PATH",
                   help="serialize the trained inference forward (not "
                        "ported)")
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
    refused = [
        (args.batch_iters, "--batch_iters (replica sweeps): ROADMAP §1 "
                           "entry 11"),
        (args.budget_buckets > 1, "--budget_buckets (replica sweeps): "
                                  "ROADMAP §1 entry 11"),
        (args.mesh, "--mesh: ROADMAP §1 entry 11"),
        (args.export, "--export (the serving artifact): ROADMAP §1 "
                      "entry 11"),
        (args.precision == "high", "--precision high (TF32): ROADMAP §1 "
                                   "entry 6"),
    ]
    for cond, what in refused:
        if cond:
            raise NotImplementedError(f"not ported yet: {what}")


def run(args: argparse.Namespace) -> Dict[str, Any]:
    from ndcn_tpu_torch.experiments.dynamics import select_device

    _refuse(args)
    device = select_device(args.platform)
    return _run(args, device)


def _run(args: argparse.Namespace, device: torch.device) -> Dict[str, Any]:
    from ndcn_tpu_torch.data import load_planetoid
    from ndcn_tpu_torch.graph.sparse import as_operator
    from ndcn_tpu_torch.kernels.platform import pin_fp32
    from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
    from ndcn_tpu_torch.models.gcn_zoo import build_zoo_model
    from ndcn_tpu_torch.train.budget import probe_step_budget
    from ndcn_tpu_torch.train.checkpoint import (restore_with_extra,
                                                 save_checkpoint)
    from ndcn_tpu_torch.train.elastic import ElasticBudget
    from ndcn_tpu_torch.train.losses import accuracy, cross_entropy
    from ndcn_tpu_torch.train.optim import torch_adam

    pin_fp32()
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

    seed = args.seed if args.seed != -1 else 0
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
                                            labels[idx_train]))
        loss.backward()
        opt.step()
        with torch.no_grad():
            logits = logits.detach() if args.fastmode else eval_logits()
            st = torch.stack([
                loss.detach(),
                cross_entropy(logits[idx_train], labels[idx_train]),
                accuracy(logits[idx_train], labels[idx_train]),
                cross_entropy(logits[idx_val], labels[idx_val]),
                accuracy(logits[idx_val], labels[idx_val])])
        return st.cpu().numpy()

    def metrics(logits, idx):
        return (float(cross_entropy(logits[idx], labels[idx])),
                float(accuracy(logits[idx], labels[idx])))

    n_params = sum(p.numel() for p in model.parameters())
    print(f"{model_name}: {n_params:d} parameters on {device}")

    fout = fname = None
    if args.dump:
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
                if args.ckpt_dir and (g0 + epoch) % args.ckpt_freq == 0:
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
            if args.ckpt_dir and np.isfinite(loss_test):
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


def main(argv=None) -> Dict[str, Any]:
    args, _ = build_parser().parse_known_args(argv)
    return run(args)


if __name__ == "__main__":
    main()
