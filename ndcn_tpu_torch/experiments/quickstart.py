"""Quickstart: learn heat diffusion on a graph with NDCN, as the JAX
repository's ``examples/quickstart.py``.

Run:  python -m ndcn_tpu_torch.experiments.quickstart           (the card)
      python -m ndcn_tpu_torch.experiments.quickstart --platform cpu

1. A 400-node grid, the three-block initial state and ground-truth heat
   diffusion over 50 times in [0, 5] (dopri5 at rtol 1e-7 / atol 1e-9,
   the inference solve).
2. NDCN (hidden 20, from seed 0) over the normalized Laplacian, its RHS
   through K2 (``fused="auto"``) where the card's plan picks it.
3. Adam(0.01, weight decay 1e-3), backprop straight through the adaptive
   solver with a budget of 24 step attempts. The loss is NaN when the solve
   runs out of that budget, and the run asserts it finite at every report:
   the relative L1 alone would keep printing plausible numbers while the
   gradients are zero and nothing trains.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

MAX_STEPS = 24


def problem(device: torch.device, t=None):
    """The grid's normalized-Laplacian operator, the time grid, x0 and the
    ground truth (T, 400, 1) on ``device``; ``t`` replaces the grid."""
    from ndcn_tpu_torch.dynamics import make_rhs
    from ndcn_tpu_torch.graph import generators, operators
    from ndcn_tpu_torch.graph.sparse import from_dense
    from ndcn_tpu_torch.ode import odeint

    adj = generators.build_network("grid", 400, seed=0)
    x0 = torch.as_tensor(generators.grid_block_initial_value(20),
                         device=device)
    t = torch.linspace(0.0, 5.0, 50) if t is None else torch.tensor(
        np.asarray(t))
    truth = odeint(make_rhs("heat", from_dense(operators.laplacian_dense(adj),
                                               device=device)),
                   x0, t, rtol=1e-7, atol=1e-9, method="dopri5",
                   options={"differentiable": False})
    op = from_dense(operators.normalized_laplacian(adj), device=device)
    return op, t, x0, truth


def objective(model, op, t, x0, truth):
    """loss_fn for ``make_sgd_step``: (the L1 loss, NaN when the solve ran
    out of its budget; the relative L1)."""
    from ndcn_tpu_torch.models import ndcn_forward
    from ndcn_tpu_torch.train.losses import l1_loss

    def loss_fn():
        # fused="auto": K2 where ``fused_profitable`` picks it (the JAX
        # example leaves its kernel off; the same function)
        pred, stats = ndcn_forward(model, op, t, x0, rtol=0.01, atol=0.001,
                                   method="dopri5", max_steps=MAX_STEPS,
                                   fused="auto")
        loss = l1_loss(pred, truth)
        rel = loss.detach() / torch.mean(truth)
        if not stats.success:
            loss = torch.full_like(loss, float("nan"))
        return loss, rel

    return loss_fn


def main(iters: int = 300, platform: str = "gpu", every: int = 50) -> dict:
    """Train ``iters`` steps; the relative L1 every ``every`` iterations.
    Returns the reported iterations, losses and relative L1s."""
    from ndcn_tpu_torch.experiments.dynamics import select_device
    from ndcn_tpu_torch.models import init_ndcn
    from ndcn_tpu_torch.train.optim import make_sgd_step, torch_adam

    device = select_device(platform)
    op, t, x0, truth = problem(device)
    model = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1,
                      device=device)
    step = make_sgd_step(torch_adam(model.parameters(), lr=0.01,
                                    weight_decay=1e-3),
                         objective(model, op, t, x0, truth))
    report = {"iter": [], "loss": [], "rel": []}
    for i in range(1, iters + 1):
        loss, rel = step()
        if i % every == 0:
            assert np.isfinite(float(loss)), \
                f"step budget exhausted (max_steps={MAX_STEPS}): raise it " \
                f"for this config"
            print(f"iter {i:4d}  relative L1 {float(rel):.4f}")
            report["iter"].append(i)
            report["loss"].append(float(loss))
            report["rel"].append(float(rel))
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser("quickstart")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"])
    cli = ap.parse_args()
    main(cli.iters, cli.platform)
