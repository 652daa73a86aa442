"""Where the ``--mesh`` train step's overhead lives, as the JAX
repository's ``tools/analyze_mesh_tax.py``: the scale driver's 200k step
(``experiments.large_graph``: ``build_problem``, ``new_model``,
``train_objective``; dopri5, hidden 20, ``--max_steps`` 8) built in
variants and timed, and profiled, on the same card:

  step_u   the unsharded operator and arrays;
  step_s   the sharded operator (``parallel.sweep.shard_operator``: K1 on
           each rank's row block against the all-gathered state) and this
           rank's rows of x0 and the target, as ``--mesh`` trains;
  step_so  the sharded operator against an x0 and a target every rank
           holds whole: the step cuts x0's rows itself and all-gathers the
           block outputs before the loss (``coo_shard.gather_nodes``). On
           more than one rank that is one more all-gather of the
           trajectory, and its gradient one more all-reduce; each rank then
           holds the whole loss, so its backward carries 1/p of it (the
           gather's backward sums the ranks' cotangents);
  fwd_u    the objective's forward alone (no backward, no update),
  fwd_s    likewise on the sharded operator and rows.

The variants run over the process group: torchrun's ranks (``torchrun
--nproc_per_node P -m ndcn_tpu_torch.tools.analyze_mesh_tax``), or a
plain process's world of one, NCCL on the card and gloo with ``--platform
cpu``. On one rank the row block is given the world group itself, as
``chip_smoke.py`` [22] does, so that every collective of the sharded path
runs (a model axis of one would run none).

The synthetic target (uniform on [0, 25), drawn after x0 from the same
``RandomState(seed)``) times the same program a real one would: the
forward solve never reads it. ``--time`` times each variant on the host
clock to ``torch.cuda.synchronize()``: the first call (with its warm-up)
and ``--reps`` calls, whose median is the record's. ``--hist PREFIX``
runs one call of each variant under ``torch.profiler`` and writes
``PREFIX_<variant>.kernels.json``: each device kernel's launches and
device ms, the collectives apart (``c10d`` operators, NCCL kernels), and
the port's kernel counters (``kernels.launch_counts``, which tell K1's
row-block launches from the whole operator's). That histogram stands in
for the JAX tool's ``--hlo``, an op histogram of XLA's compiled program.

Not ported: the JAX tool's ``step_ud``, ``step_sd``, ``step_sdh`` and
``step_sdd``, which bisect jit-argument hoisting and buffer donation, two
properties of an XLA program with no counterpart in an eager step.

Usage:
  python -m ndcn_tpu_torch.tools.analyze_mesh_tax --n 200000 \\
      --kernel_precision bf16 --time --reps 3 --out mesh_tax.json
  python -m ndcn_tpu_torch.tools.analyze_mesh_tax --variants step_u,step_s \\
      --hist build/mesh_tax
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from ndcn_tpu_torch.tools import card, log

VARIANTS = ("step_u", "step_s", "step_so", "fwd_u", "fwd_s")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("analyze_mesh_tax")
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--deg", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hidden", type=int, default=20)
    ap.add_argument("--time_tick", type=int, default=40)
    ap.add_argument("--T", type=float, default=5.0)
    ap.add_argument("--max_steps", type=int, default=8)
    ap.add_argument("--kernel_precision", default="bf16",
                    choices=["split2", "bf16"])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--hist", type=str, default=None,
                    help="prefix: write <prefix>_<variant>.kernels.json")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"])
    ap.add_argument("--precision", default="default",
                    choices=["default", "high", "float32", "highest"])
    return ap


def histogram(fn, device: torch.device, path: str) -> dict:
    """One call of ``fn`` under ``torch.profiler``: each device kernel's
    launches and device ms, the collectives apart, the port's kernel
    counters; written to ``path`` as JSON and returned."""
    from torch.profiler import ProfilerActivity, profile

    from ndcn_tpu_torch import kernels

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    before = kernels.launch_counts()
    with profile(activities=activities) as prof:
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    ours = {k: c - before[k] for k, c in kernels.launch_counts().items()
            if c > before[k]}
    trace = path + ".trace.json"
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    os.remove(trace)
    kern, coll = {}, {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "kernel":
            into = coll if "nccl" in name.lower() else kern
            row = into.setdefault(name[:120], {"launches": 0,
                                               "device_ms": 0.0})
            row["launches"] += 1
            row["device_ms"] += e.get("dur", 0) / 1e3
        elif e.get("cat") == "cpu_op" and (name.startswith("c10d::")
                                           or name == "record_param_comms"):
            row = coll.setdefault(name, {"count": 0, "host_ms": 0.0})
            row["count"] += 1
            row["host_ms"] += e.get("dur", 0) / 1e3
    hist = {"kernels": dict(sorted(kern.items(),
                                   key=lambda kv: -kv[1]["device_ms"])),
            "collectives": coll, "port_launches": ours,
            "device_kernel_ms": sum(r["device_ms"] for r in kern.values()),
            "kernel_launches": sum(r["launches"] for r in kern.values())}
    with open(path, "w") as f:
        json.dump(hist, f, indent=1)
    return hist


def main(argv=None) -> dict:
    from ndcn_tpu_torch.experiments.dynamics import select_device
    from ndcn_tpu_torch.kernels import coo_spmv
    from ndcn_tpu_torch.kernels.platform import matmul_precision
    from ndcn_tpu_torch.parallel.mesh import process_group

    args = build_parser().parse_args(argv)
    wanted = [v.strip() for v in args.variants.split(",") if v.strip()]
    unknown = sorted(set(wanted) - set(VARIANTS))
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; choose from "
                         f"{list(VARIANTS)} (the JAX tool's step_ud, "
                         f"step_sd, step_sdh and step_sdd bisect XLA's "
                         f"argument hoisting and donation: not ported)")
    device = select_device(args.platform)
    with process_group(device), \
            coo_spmv.gather_precision(args.kernel_precision == "bf16"), \
            matmul_precision(args.precision):
        return _main(args, wanted, device)


def _main(args, wanted, device) -> dict:
    import torch.distributed as dist

    from ndcn_tpu_torch.experiments import large_graph
    from ndcn_tpu_torch.models import ndcn_forward
    from ndcn_tpu_torch.parallel.coo_shard import (gather_nodes, node_group,
                                                   take_rows)
    from ndcn_tpu_torch.parallel.mesh import group_size, make_mesh
    from ndcn_tpu_torch.parallel.sweep import shard_operator
    from ndcn_tpu_torch.train.losses import l1_loss, relative_l1
    from ndcn_tpu_torch.train.optim import make_sgd_step, torch_adam

    largs = large_graph.build_parser().parse_args(
        ["--n", str(args.n), "--deg", str(args.deg), "--seed",
         str(args.seed), "--hidden", str(args.hidden), "--time_tick",
         str(args.time_tick), "--T", str(args.T), "--kernel_precision",
         args.kernel_precision, "--platform", args.platform])
    prob_u = large_graph.build_problem(largs, device)
    n = prob_u.n
    rng = np.random.RandomState(args.seed)
    rng.uniform(0.0, 25.0, size=(n, 1))                 # x0's draw
    target_u = torch.as_tensor(rng.uniform(0.0, 25.0, size=(
        len(prob_u.t_train), n, 1)).astype(np.float32), device=device)
    model0 = large_graph.new_model(largs, device)

    mesh = make_mesh(device, data_divides=1, model_divides=n)
    op_s = shard_operator(mesh, prob_u.op)
    if mesh.model == 1:
        # a model axis of one runs no collective: give the block the world
        # group, so that the sharded path's collectives all run
        op_s = op_s._replace(group=dist.group.WORLD)
    log(f"mesh: {mesh.shape}, world {dist.get_world_size()} "
        f"({dist.get_backend()}); graph {n:,} nodes {prob_u.nnz:,} edges")
    prob_s = prob_u._replace(op=op_s, physics_op=None,
                             x0=take_rows(prob_u.x0, op_s))
    target_s = take_rows(target_u, op_s, axis=1)
    group = node_group(op_s)
    kw = large_graph.solve_kwargs(largs, args.max_steps)

    def whole_state_objective(model, box):
        """step_so's loss_fn: x0 and the target whole on every rank."""
        scale = 1.0 / group_size(group)

        def loss_fn():
            out, stats = ndcn_forward(model, op_s, prob_u.t_train,
                                      take_rows(prob_u.x0, op_s), **kw)
            box.append(stats)
            out = gather_nodes(out, op_s, axis=1)
            loss = l1_loss(out, target_u)
            if not stats.success:
                loss = torch.full_like(loss, float("nan"))
            return loss * scale, relative_l1(out.detach(), target_u)
        return loss_fn, scale

    def build(name):
        """(call, the stats list it fills, the loss's scale)."""
        model = copy.deepcopy(model0)
        box = []
        sharded = name in ("step_s", "step_so", "fwd_s")
        if name == "step_so":
            loss_fn, scale = whole_state_objective(model, box)
        else:
            prob, tgt = ((prob_s, target_s) if sharded
                         else (prob_u, target_u))
            loss_fn = large_graph.train_objective(largs, prob, model, tgt,
                                                  args.max_steps,
                                                  stats_out=box)
            scale = 1.0
        if name.startswith("fwd"):
            def call():
                return loss_fn()[0].detach()
        else:
            step = make_sgd_step(torch_adam(model.parameters(), 0.01, 1e-3),
                                 loss_fn, group=group if sharded else None)

            def call():
                return step()[0]
        return call, box, scale

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    results = {}
    for name in wanted:
        call, box, scale = build(name)
        rec = {}
        t0 = time.perf_counter()
        loss = call()
        sync()
        rec["first_s"] = round(time.perf_counter() - t0, 3)
        rec["loss"] = float(loss) / scale
        rec["nfe"] = int(box[0].nfe)
        rec["success"] = bool(box[0].success)
        if args.time:
            times = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                call()
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            rec.update(ms_median=round(statistics.median(times), 2),
                       ms_all=[round(t, 2) for t in times])
            log(f"[{name}] {rec['ms_median']} ms median of {args.reps} "
                f"(first {rec['first_s']} s), nfe {rec['nfe']}")
        if args.hist:
            path = f"{args.hist}_{name}.kernels.json"
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            hist = histogram(call, device, path)
            rec.update(hist=path,
                       kernel_launches=hist["kernel_launches"],
                       device_kernel_ms=round(hist["device_kernel_ms"], 3),
                       collectives={k: v.get("count", v.get("launches"))
                                    for k, v in hist["collectives"].items()},
                       port_launches=hist["port_launches"])
            log(f"[{name}] {path}: {hist['kernel_launches']} kernels, "
                f"{rec['device_kernel_ms']} device ms, port "
                f"{hist['port_launches']}")
        results[name] = rec
    out = {"n": n, "nnz": prob_u.nnz, "max_steps": args.max_steps,
           "kernel_precision": args.kernel_precision,
           "world": dist.get_world_size(), "backend": dist.get_backend(),
           "mesh": mesh.shape,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "card": card() if device.type == "cuda" else None,
           "variants": results}
    if dist.get_rank() != 0:
        return out                          # rank 0 reports
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
