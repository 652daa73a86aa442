"""The Lotka-Volterra neural-ODE demo, as ``ndcn_tpu/experiments/lv.py``
(the reference's LV_model.py).

Ground truth: the 2-species system dx/dt = 2/3·x - 4/3·x·y, dy/dt = x·y - y
from (0.9, 1.8) over t in [-5, 5] (dopri5 at rtol 1e-7, atol 1e-9). A
2→20→2 tanh MLP is trained as the ODE's right-hand side on random minibatches
of trajectory windows (``train.sampling.sample_trajectory_windows``) with L1
loss and Adam(lr 1e-2, weight decay 1e-3), through ``--method`` (rk4,
euler, dopri5, adams); ``--adjoint`` takes the gradients by the continuous
adjoint (``ode.odeint_adjoint``, rtol 1e-7, atol 1e-9). Every
``test_freq`` iterations the learned system is solved over the whole span
(dopri5, rtol 1e-5, atol 1e-7) and its mean |error| printed.

``--platform gpu`` (the default) runs on the first CUDA device and raises
without one; ``--platform cpu`` runs on the CPU. ``--precision high`` runs
the float32 products in TF32 for the run
(``kernels.platform.matmul_precision``).

Usage: python -m ndcn_tpu_torch.experiments.lv --niters 400 --platform cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch
from torch import nn


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("ODE demo")
    p.add_argument("--method", type=str,
                   choices=["dopri5", "adams", "rk4", "euler"],
                   default="rk4")
    p.add_argument("--data_size", type=int, default=1000)
    p.add_argument("--batch_time", type=int, default=25)
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--niters", type=int, default=2000)
    p.add_argument("--test_freq", type=int, default=20)
    p.add_argument("--viz", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--adjoint", action="store_true")
    p.add_argument("--platform", type=str, default="gpu",
                   choices=["gpu", "cpu"],
                   help="gpu: the first CUDA device (raises without one); "
                        "cpu: the CPU")
    p.add_argument("--precision", type=str, default="default",
                   choices=["default", "high", "float32", "highest"],
                   help="matmul precision of PyTorch's float32 "
                        "products: full fp32 (default = highest = float32) "
                        "or high (TF32); the hand-written kernels keep "
                        "theirs")
    return p


def lv_rhs(t, y: torch.Tensor) -> torch.Tensor:
    """The Lotka-Volterra vector field on (..., 2) states."""
    x, z = y[..., 0], y[..., 1]
    return torch.stack([2.0 / 3.0 * x - 4.0 / 3.0 * x * z, x * z - z], dim=-1)


class LVFunc(nn.Module):
    """The learned right-hand side: Linear(2, 20) → tanh → Linear(20, 2),
    weights from ``generator`` (``models.nn.linear_init``)."""

    def __init__(self, *, generator: torch.Generator):
        super().__init__()
        from ndcn_tpu_torch.models.nn import linear_init

        self.l1 = linear_init(2, 20, generator=generator)
        self.l2 = linear_init(20, 2, generator=generator)

    def jax_tree(self) -> dict:
        """The parameters by their keys in the JAX demo's dict."""
        return {"l1": self.l1, "l2": self.l2}

    def forward(self, t, y: torch.Tensor) -> torch.Tensor:
        from ndcn_tpu_torch.models.nn import linear_apply

        return linear_apply(self.l2, torch.tanh(linear_apply(self.l1, y)))


def lv_loss(func: LVFunc, batch_y0: torch.Tensor, batch_y: torch.Tensor,
            batch_t: torch.Tensor, method: str,
            adjoint: bool = False) -> torch.Tensor:
    """L1 between the solve of ``func`` from each window's start over
    ``batch_t`` and the windows (batch_time, B, 2)."""
    from ndcn_tpu_torch.ode import odeint, odeint_adjoint
    from ndcn_tpu_torch.train.losses import l1_loss

    if adjoint:
        pred = odeint_adjoint(func, batch_y0, batch_t,
                              tuple(func.parameters()), rtol=1e-7,
                              atol=1e-9, method=method)
    else:
        pred = odeint(func, batch_y0, batch_t, method=method)
    return l1_loss(pred, batch_y)


def run(args: argparse.Namespace) -> Dict[str, Any]:
    from ndcn_tpu_torch.experiments.dynamics import select_device
    from ndcn_tpu_torch.kernels.platform import matmul_precision

    device = select_device(args.platform)
    with matmul_precision(args.precision):
        return _run(args, device)


def _run(args: argparse.Namespace, device: torch.device) -> Dict[str, Any]:
    from ndcn_tpu_torch.ode import odeint, odeint_with_stats
    from ndcn_tpu_torch.train.optim import torch_adam
    from ndcn_tpu_torch.train.sampling import sample_trajectory_windows

    t_start = time.time()
    true_y0 = torch.tensor([[0.9, 1.8]], device=device)
    t = torch.as_tensor(np.linspace(-5.0, 5.0, args.data_size)
                        .astype(np.float32), device=device)

    true_y, gt_stats = odeint_with_stats(lv_rhs, true_y0, t, rtol=1e-7,
                                         atol=1e-9, method="dopri5",
                                         options={"differentiable": False})
    print(tuple(true_y.shape), "ground truth,", gt_stats.nfe, "RHS evals")

    func = LVFunc(generator=torch.Generator().manual_seed(args.seed)
                  ).to(device)
    opt = torch_adam(func.parameters(), 1e-2, 1e-3)
    batch_t = t[:args.batch_time] - t[0]  # window times, from 0
    rng = np.random.RandomState(args.seed)
    traj_host = true_y[:, 0].cpu().numpy()  # (data_size, 2)

    def get_batch():
        """Random trajectory windows (LV_model.py:80-89)."""
        y0, window = sample_trajectory_windows(rng, traj_host,
                                               args.batch_time,
                                               args.batch_size)
        return (torch.as_tensor(y0, device=device),
                torch.as_tensor(window, device=device))

    def full_eval():
        with torch.no_grad():
            pred = odeint(func, true_y0, t - t[0], rtol=1e-5, atol=1e-7,
                          method="dopri5")
            return torch.mean(torch.abs(pred - true_y)), pred

    train_losses, eval_losses, final_loss = [], [], None
    for itr in range(1, args.niters + 1):
        by0, by = get_batch()
        opt.zero_grad(set_to_none=True)
        loss = lv_loss(func, by0, by, batch_t, args.method, args.adjoint)
        loss.backward()
        opt.step()
        train_losses.append(loss.detach())
        if itr % args.test_freq == 0:
            total, _ = full_eval()
            final_loss = float(total)
            eval_losses.append(final_loss)
            print("Iter {:04d} | Total Loss {:.6f}".format(itr, final_loss))

    if args.viz:
        _phase_portrait(full_eval()[1], true_y, t)

    print("Total Time {:.4f}".format(time.time() - t_start))
    return {"final_loss": final_loss, "eval_losses": eval_losses,
            "train_losses": [float(v) for v in train_losses],
            "func": func, "device": str(device)}


def _phase_portrait(pred: torch.Tensor, true_y: torch.Tensor,
                    t: torch.Tensor) -> None:
    """figure/lv/phase_portrait.png: the learned and the true orbits and
    trajectories (matplotlib imported here; without it, a skip)."""
    import os

    from ndcn_tpu_torch.report.viz import pyplot

    plt = pyplot()
    if plt is None:
        return
    os.makedirs("figure/lv", exist_ok=True)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    ty = true_y[:, 0].cpu().numpy()
    py = pred[:, 0].cpu().numpy()
    ax1.plot(ty[:, 0], ty[:, 1], "g-", label="true")
    ax1.plot(py[:, 0], py[:, 1], "b--", label="learned")
    ax1.set_title("phase portrait")
    ax1.legend()
    tn = t.cpu().numpy()
    ax2.plot(tn, ty[:, 0], "g-", tn, ty[:, 1], "g-")
    ax2.plot(tn, py[:, 0], "b--", tn, py[:, 1], "b--")
    ax2.set_title("trajectories")
    fig.savefig("figure/lv/phase_portrait.png", transparent=True)
    plt.close(fig)
    print("wrote figure/lv/phase_portrait.png")


def main(argv=None) -> Dict[str, Any]:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
