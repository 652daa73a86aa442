"""Where the model axis's adjoint step spends its time on the card: the
200k / 2.0M COO ``--adjoint`` train step of ``chip_smoke.py`` [22] a
(dopri5, hidden 20, rtol 0.01, atol 0.001; the heat ground truth of [10]
as its target) on a row block over the one-rank NCCL world group itself,
so that every collective of the sharded path runs, against the same step
on the whole operator.

The two steps are timed on the host clock to ``torch.cuda.synchronize()``
in turns (whole, sharded, sharded, whole) over ``ROUNDS`` rounds, after one
warm step each; their NFE must be equal. Then one sharded step runs under
``torch.profiler``: the collectives it issues (``c10d`` all-gathers and
all-reduces) and the host operations by self time. One card makes a
one-rank group, so the collectives move nothing: what they cost is the
host's work to issue them. Prints one JSON line on stdout.

Usage: python -m ndcn_tpu_torch.tools.profile_model_axis_step [n]
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from ndcn_tpu_torch.tools import log, require_cuda

ROUNDS = 3   # rounds of whole, sharded, sharded, whole


def _self_device_ms(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0)) / 1e3


def main(argv=None) -> dict:
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from ndcn_tpu_torch.experiments.dynamics import heat_ground_truth
    from ndcn_tpu_torch.graph.generators import build_sparse_graph
    from ndcn_tpu_torch.graph.operators import normalized_laplacian_sparse
    from ndcn_tpu_torch.graph.sparse import from_scipy_coo
    from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
    from ndcn_tpu_torch.parallel import coo_shard
    from ndcn_tpu_torch.parallel.mesh import all_reduce_grads, process_group
    from ndcn_tpu_torch.train.losses import l1_loss
    from ndcn_tpu_torch.train.sampling import sample_times

    argv = sys.argv[1:] if argv is None else argv
    dev = require_cuda()
    n = int(argv[0]) if argv else 200_000
    op = from_scipy_coo(normalized_laplacian_sparse(
        build_sparse_graph(n, 10, seed=0)), device=dev)
    splits = sample_times(5.0, 40, "irregular", seed=0)
    x0 = torch.as_tensor(np.random.RandomState(0).uniform(
        0.0, 25.0, (n, 1)).astype(np.float32), device=dev)
    truth, _ = heat_ground_truth(op, x0, splits.t, rtol=1e-6, atol=1e-8)
    t_train, target = splits.t[splits.id_train], truth[splits.id_train]
    del truth

    def step(o):
        """One adjoint train step on ``o``: (ms, NFE, backward NFE)."""
        group = coo_shard.node_group(o)
        model = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1,
                          device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, stats = ndcn_forward(model, o, t_train, x0, adjoint=True,
                                  max_steps=64, rtol=0.01, atol=0.001,
                                  method="dopri5")
        l1_loss(out, target, group).backward()
        all_reduce_grads(model.parameters(), group)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3, stats.nfe,
                sum(b.nfe for b in stats.backward))

    runs = {"whole": [], "sharded": []}
    with process_group(dev):
        sharded = coo_shard.shard_coo_at(op, 1, 0, None)._replace(
            group=dist.group.WORLD)
        ops = {"whole": op, "sharded": sharded}
        step(op)
        step(sharded)
        for _ in range(ROUNDS):
            for which in ("whole", "sharded", "sharded", "whole"):
                runs[which].append(step(ops[which]))
        nfes = {k: sorted({r[1:] for r in v}) for k, v in runs.items()}
        if nfes["whole"] != nfes["sharded"]:
            raise RuntimeError(f"the sharded step's NFE parted: {nfes}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(sharded)
    events = prof.key_averages()
    collectives = {e.key: dict(count=e.count,
                               self_host_ms=e.self_cpu_time_total / 1e3)
                   for e in events if e.key.startswith("c10d::")
                   or e.key == "record_param_comms"}
    host_top = [dict(op=e.key, count=e.count,
                     self_host_ms=e.self_cpu_time_total / 1e3,
                     self_device_ms=_self_device_ms(e))
                for e in sorted(events, key=lambda e: -e.self_cpu_time_total)
                [:12]]
    med = {k: statistics.median(r[0] for r in v) for k, v in runs.items()}
    rec = dict(n=n, device=torch.cuda.get_device_name(0),
               step_ms={k: [r[0] for r in v] for k, v in runs.items()},
               median_ms=med, sharded_over_whole=med["sharded"] / med["whole"],
               nfe_forward_backward=nfes["whole"], collectives=collectives,
               host_top=host_top)
    log(f"adjoint step at {n}: whole {med['whole']:.1f} ms, sharded "
        f"{med['sharded']:.1f} ms; collectives {collectives}")
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
