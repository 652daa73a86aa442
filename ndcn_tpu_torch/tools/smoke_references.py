"""The CPU references ``chip_smoke.py`` holds the card against in [15] b
and [21] a, computed once on the CPU and kept as a fixture, so that the
smoke's call spends no time on them:

- [15] b: the grid400 dense serving problem (the ``ndcn_forward_grid400``
  weights and x0) served on the CPU with tsit5, adams, fixed_adams and
  explicit_adams: the answer, its success flag and NFE, and the same solve
  in float64 (its float32-vs-float64 rel-L1, the bar's second term);
- [21] a: the heat driver's replica step at R = 4 (grid400, T 5, tick
  100, irregular, seed 0; replica i seeded i) on each of [21]'s settings:
  the first step's losses, gradients and NFE on the CPU (the plain
  versions of the kernels), and the gradients of the same step in
  float64 on the dense unfused route.

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


def heat_replica_problem():
    """([21] a, and [18] b) the heat driver's grid400 problem on the CPU:
    the normalized Laplacian, the train grid, x0 and the target."""
    from ndcn_tpu_torch.experiments.dynamics import heat_ground_truth
    from ndcn_tpu_torch.graph.generators import (build_network,
                                                 grid_block_initial_value)
    from ndcn_tpu_torch.graph.operators import (laplacian_dense,
                                                normalized_laplacian)
    from ndcn_tpu_torch.graph.sparse import as_operator
    from ndcn_tpu_torch.train.sampling import sample_times

    adj = build_network("grid", 400)
    hs = sample_times(5.0, 100, "irregular", seed=0)
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


def compute(keys: Optional[Sequence[str]] = None,
            log=print) -> Dict[str, np.ndarray]:
    """The references as flat npz keys ``serve/<method>/...`` and
    ``replicas/<label>/...``; ``keys`` limits them to those settings."""
    out: Dict[str, np.ndarray] = {}
    problem = None
    for method in SERVE_METHODS:
        if keys is None or f"serve/{method}" in keys:
            t0 = time.perf_counter()
            out.update({f"serve/{method}/{k}": v
                        for k, v in serve_reference(method).items()})
            log(f"serve/{method}: {time.perf_counter() - t0:.1f} s")
    for label in REPLICA_SETTINGS:
        if keys is None or f"replicas/{label}" in keys:
            t0 = time.perf_counter()
            problem = problem or heat_replica_problem()
            out.update({f"replicas/{label}/{k}": v
                        for k, v in replica_reference(label,
                                                      problem).items()})
            log(f"replicas/{label}: {time.perf_counter() - t0:.1f} s")
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
